"""Synthetic multi-source atomistic structures (port of the structure half
of ``repro.data.synthetic_atoms``).

Five sources named after the paper's datasets, each drawing from its own
chemical domain (element palette, atom-count range, compact cluster
geometry), with dense radius-graph edges. The rng draws are ``repro``'s, in
``repro``'s order: every structure is drawn before any label, so the
species, positions and edges here are identical to ``repro``'s for the same
seed. Energies and forces (the ground-truth potential, ``jax.grad`` there,
torch autograd here) come with the training slice.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# element palettes (atomic numbers), per paper §4.1
SOURCES = {
    "ani1x": dict(elements=(1, 6, 7, 8), n_atoms=(8, 24)),
    "qm7x": dict(elements=(1, 6, 7, 8, 16, 17), n_atoms=(4, 16)),
    "transition1x": dict(elements=(1, 3, 6, 7, 8, 9, 11, 15, 16, 17),
                         n_atoms=(6, 20)),
    "mptrj": dict(elements=tuple(range(3, 40, 2)), n_atoms=(12, 32)),
    "alexandria": dict(elements=tuple(range(4, 48, 3)), n_atoms=(10, 28)),
}
N_SPECIES = 64  # supported atomic numbers (0 = pad)

# approximate RELATIVE sizes of the paper's five training sets (§4.1)
PAPER_REL_SIZES = {
    "ani1x": 4.9, "qm7x": 4.2, "transition1x": 9.7,
    "mptrj": 1.6, "alexandria": 3.1,
}


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
class SourceStructures:
    name: str
    species: np.ndarray     # (N, A) int32
    pos: np.ndarray         # (N, A, 3) f32
    edge_src: np.ndarray    # (N, E)
    edge_dst: np.ndarray    # (N, E)
    node_mask: np.ndarray   # (N, A) bool
    edge_mask: np.ndarray   # (N, E) bool


def generate_source(name: str, n_samples: int, *, max_atoms=32,
                    max_edges=256, cutoff=2.5, seed=0) -> SourceStructures:
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
    es = np.zeros((n_samples, max_edges), np.int32)
    ed = np.zeros((n_samples, max_edges), np.int32)
    em = np.zeros((n_samples, max_edges), bool)
    for i in range(n_samples):
        es[i], ed[i], em[i] = _radius_edges(pos[i], nmask[i], cutoff,
                                            max_edges)
    return SourceStructures(name=name, species=species, pos=pos, edge_src=es,
                            edge_dst=ed, node_mask=nmask, edge_mask=em)


def generate_all(n_per_source: int, *, max_atoms=32, max_edges=256, seed=0,
                 sources=None) -> dict[str, SourceStructures]:
    return {name: generate_source(name, n_per_source, max_atoms=max_atoms,
                                  max_edges=max_edges, seed=seed)
            for name in (sources or SOURCES)}


def generate_mixture(total: int, *, max_atoms=32, max_edges=256, seed=0,
                     rel_sizes=None) -> dict[str, SourceStructures]:
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


def source_dicts(data: dict[str, SourceStructures], *, keys=(
        "species", "pos", "edge_src", "edge_dst", "node_mask",
        "edge_mask")) -> list[dict]:
    """SourceStructures -> one dict of numpy arrays per source."""
    return [{k: getattr(sd, k) for k in keys} for sd in data.values()]
