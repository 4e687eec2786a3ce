"""Synthetic multi-source, multi-fidelity atomistic datasets (port of
``repro.data.synthetic_atoms``).

Five sources named after the paper's datasets, each drawing from its own
chemical domain (element palette, atom-count range, compact cluster
geometry), with dense radius-graph edges. A shared ground-truth potential
(Morse-like pairs plus per-element site energies) gives E_true and
F_true = -dE/dpos; each source then applies its own fidelity transform
(per-element shifts, a global scale, noise), so a single shared head cannot
fit the conflicting labels and per-source heads can.

The rng draws are ``repro``'s, in ``repro``'s order (structures, then the
fidelity transform), so species, positions, edges and the transform's draws
are identical to ``repro``'s for the same seed. The potential is evaluated
in float32, as ``repro`` does (JAX without x64); forces come from torch
autograd where ``repro`` uses ``jax.grad`` — equal up to fp32 rounding.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

# element palettes (atomic numbers), per paper §4.1
SOURCES = {
    "ani1x": dict(elements=(1, 6, 7, 8), n_atoms=(8, 24), scale=1.00,
                  shift_mag=0.00, noise=0.002),
    "qm7x": dict(elements=(1, 6, 7, 8, 16, 17), n_atoms=(4, 16), scale=1.02,
                 shift_mag=0.8, noise=0.004),
    "transition1x": dict(elements=(1, 3, 6, 7, 8, 9, 11, 15, 16, 17),
                         n_atoms=(6, 20), scale=0.97, shift_mag=0.5,
                         noise=0.006),
    "mptrj": dict(elements=tuple(range(3, 40, 2)), n_atoms=(12, 32),
                  scale=1.10, shift_mag=2.0, noise=0.010),
    "alexandria": dict(elements=tuple(range(4, 48, 3)), n_atoms=(10, 28),
                       scale=0.92, shift_mag=1.5, noise=0.008),
}
N_SPECIES = 64  # supported atomic numbers (0 = pad)

# approximate RELATIVE sizes of the paper's five training sets (§4.1)
PAPER_REL_SIZES = {
    "ani1x": 4.9, "qm7x": 4.2, "transition1x": 9.7,
    "mptrj": 1.6, "alexandria": 3.1,
}


# ---------------------------------------------------------------------------
# Ground-truth potential (shared across sources)
# ---------------------------------------------------------------------------

def _element_params(n_species: int = N_SPECIES, seed: int = 7):
    """Per-element site energy, Morse depth and radius factors, float32."""
    rng = np.random.default_rng(seed)
    site = rng.normal(0.0, 1.0, n_species)
    depth = 0.2 + 0.8 * rng.random(n_species)
    radius = 0.9 + 0.6 * rng.random(n_species)
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (site, depth, radius))


_SITE, _DEPTH, _RADIUS = _element_params()


def true_energy(species: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """species: (..., A) int (0 = pad); pos: (..., A, 3) float32 -> (...,)
    total energy. Smooth, bounded potential; batched over leading dims."""
    mask = species > 0
    sp = species.long()
    site = _SITE[sp] * mask
    d = pos[..., :, None, :] - pos[..., None, :, :]
    r2 = (d * d).sum(-1) + 1e-6
    r = torch.sqrt(r2)
    dep_s, rad_s = _DEPTH[sp], _RADIUS[sp]
    dep = torch.sqrt(dep_s[..., :, None] * dep_s[..., None, :])
    r0 = 0.5 * (rad_s[..., :, None] + rad_s[..., None, :])
    a = 1.5
    morse = dep * (torch.exp(-2 * a * (r - r0)) - 2 * torch.exp(-a * (r - r0)))
    eye = torch.eye(species.shape[-1], dtype=torch.bool)
    pair_mask = mask[..., :, None] & mask[..., None, :] & ~eye
    cutoff = torch.exp(-r2 / 16.0)                   # smooth locality
    e_pair = 0.5 * torch.where(pair_mask, morse * cutoff,
                               torch.zeros(())).sum((-2, -1))
    return site.sum(-1) + e_pair


def true_forces(species: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """F = -dE/dpos through torch autograd: (..., A, 3)."""
    with torch.enable_grad():
        p = pos.detach().clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(true_energy(species, p).sum(), p)
    return -grad


# ---------------------------------------------------------------------------
# Structure + graph generation
# ---------------------------------------------------------------------------

def _radius_edges(pos: np.ndarray, mask: np.ndarray, cutoff: float,
                  max_edges: int):
    """Dense radius graph on one padded structure -> (src, dst, emask)."""
    A = pos.shape[0]
    d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
    adj = (d2 < cutoff ** 2) & mask[:, None] & mask[None, :]
    np.fill_diagonal(adj, False)
    src, dst = np.nonzero(adj)
    n = min(len(src), max_edges)
    s = np.full(max_edges, A, np.int32)
    t = np.full(max_edges, A, np.int32)
    em = np.zeros(max_edges, bool)
    s[:n], t[:n], em[:n] = src[:n], dst[:n], True
    return s, t, em


@dataclasses.dataclass
class SourceData:
    name: str
    species: np.ndarray     # (N, A) int32
    pos: np.ndarray         # (N, A, 3) f32
    edge_src: np.ndarray    # (N, E)
    edge_dst: np.ndarray    # (N, E)
    node_mask: np.ndarray   # (N, A) bool
    edge_mask: np.ndarray   # (N, E) bool
    energy: np.ndarray      # (N,) f32 — per-atom, source-fidelity labels
    forces: np.ndarray      # (N, A, 3) f32
    e_true: np.ndarray      # (N,) f32 — per-atom ground truth (for eval)


def generate_source(name: str, n_samples: int, *, max_atoms=32,
                    max_edges=256, cutoff=2.5, seed=0) -> SourceData:
    spec = SOURCES[name]
    # crc32, not hash(): Python's str hash is salted per process
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2 ** 16)
    lo, hi = spec["n_atoms"]
    hi = min(hi, max_atoms)
    lo = min(lo, hi)
    species = np.zeros((n_samples, max_atoms), np.int32)
    pos = np.zeros((n_samples, max_atoms, 3), np.float32)
    nmask = np.zeros((n_samples, max_atoms), bool)
    for i in range(n_samples):
        n = rng.integers(lo, hi + 1)
        species[i, :n] = rng.choice(spec["elements"], n)
        p = rng.normal(0, 1.0, (n, 3)) * (n ** (1 / 3))
        pos[i, :n] = p * 0.8
        nmask[i, :n] = True

    sp_t, pos_t = torch.from_numpy(species), torch.from_numpy(pos)
    e_true_total = true_energy(sp_t, pos_t).numpy()
    f_true = true_forces(sp_t, pos_t).numpy()
    n_atoms = np.maximum(nmask.sum(1), 1)

    # fidelity transform: per-element shift + scale + noise
    shift = rng.normal(0, spec["shift_mag"], N_SPECIES)
    comp = np.zeros((n_samples, N_SPECIES))
    for z in np.unique(species):
        if z > 0:
            comp[:, z] = (species == z).sum(1)
    e_obs_total = (spec["scale"] * e_true_total + comp @ shift
                   + rng.normal(0, spec["noise"], n_samples) * n_atoms)
    f_obs = spec["scale"] * f_true + rng.normal(0, spec["noise"],
                                                f_true.shape)
    f_obs = f_obs * nmask[..., None]

    es = np.zeros((n_samples, max_edges), np.int32)
    ed = np.zeros((n_samples, max_edges), np.int32)
    em = np.zeros((n_samples, max_edges), bool)
    for i in range(n_samples):
        es[i], ed[i], em[i] = _radius_edges(pos[i], nmask[i], cutoff,
                                            max_edges)
    return SourceData(
        name=name, species=species, pos=pos, edge_src=es, edge_dst=ed,
        node_mask=nmask, edge_mask=em,
        energy=(e_obs_total / n_atoms).astype(np.float32),
        forces=f_obs.astype(np.float32),
        e_true=(e_true_total / n_atoms).astype(np.float32))


def generate_all(n_per_source: int, *, max_atoms=32, max_edges=256, seed=0,
                 sources=None) -> dict[str, SourceData]:
    return {name: generate_source(name, n_per_source, max_atoms=max_atoms,
                                  max_edges=max_edges, seed=seed)
            for name in (sources or SOURCES)}


def generate_mixture(total: int, *, max_atoms=32, max_edges=256, seed=0,
                     rel_sizes=None) -> dict[str, SourceData]:
    """Five-source paper-shaped mixture: per-source counts proportional to
    the paper's dataset-size imbalance (largest-remainder apportionment of
    ``total``; every source gets >= 1 sample)."""
    rel = rel_sizes or PAPER_REL_SIZES
    names = list(rel)
    w = np.asarray([rel[n] for n in names], np.float64)
    w = w / w.sum()
    counts = np.maximum(np.floor(total * w).astype(int), 1)
    for i in np.argsort(-(total * w - counts), kind="stable"):
        if counts.sum() >= total:
            break
        counts[i] += 1
    return {name: generate_source(name, int(c), max_atoms=max_atoms,
                                  max_edges=max_edges, seed=seed)
            for name, c in zip(names, counts)}


def source_dicts(data: dict[str, SourceData], *, keys=(
        "species", "pos", "edge_src", "edge_dst", "node_mask", "edge_mask",
        "energy", "forces")) -> list[dict]:
    """SourceData objects -> the list-of-dicts shape Session and the
    batchers take (one dict of numpy arrays per source, insertion order
    preserved)."""
    return [{k: getattr(sd, k) for k in keys} for sd in data.values()]
