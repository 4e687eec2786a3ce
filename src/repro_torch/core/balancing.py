"""Multi-source loss balancing, cross-fidelity energy alignment and the
head-placement solver (the port's own copy of ``repro.core.balancing``).

The paper "consistently aligned the energy per atom values across all the
datasets" (§4) before pre-training. Different DFT settings shift total
energies by per-element offsets; the standard alignment fits per-source
reference atomic energies by least squares on element composition and
subtracts them:

    E_source(s) ≈ Σ_z n_z(s) · e_ref[source, z]  ->  E_aligned = E - Σ n_z e_ref

The alignment and the solver are numpy, as in ``repro`` (the same
operations in the same order, so the same numbers); the uncertainty
weighting (Kendall et al.) is torch.
"""
from __future__ import annotations

import numpy as np
import torch


def composition_matrix(species: np.ndarray, n_species: int) -> np.ndarray:
    """species: (n_samples, A) int (0 = pad) -> (n_samples, n_species) counts."""
    out = np.zeros((species.shape[0], n_species), np.float64)
    for z in range(1, n_species):
        out[:, z] = (species == z).sum(axis=1)
    return out


def fit_reference_energies(species: np.ndarray, total_energy: np.ndarray,
                           n_species: int, ridge: float = 1e-6) -> np.ndarray:
    """Least-squares per-element reference energies for ONE source.
    total_energy: (n_samples,) TOTAL (not per-atom) energies."""
    X = composition_matrix(species, n_species)
    A = X.T @ X + ridge * np.eye(n_species)
    b = X.T @ total_energy
    return np.linalg.solve(A, b)


def align_energies(species: np.ndarray, total_energy: np.ndarray,
                   e_ref: np.ndarray) -> np.ndarray:
    """Subtract composition-weighted reference energies -> aligned totals."""
    X = composition_matrix(species, e_ref.shape[0]).astype(total_energy.dtype)
    return total_energy - X @ e_ref


def align_sources(per_source: list[dict], n_species: int) -> list[dict]:
    """For each source {'species': (N,A), 'energy': (N,)} fit + subtract its
    own reference energies; returns new dicts with aligned per-atom energy."""
    out = []
    for src in per_source:
        e_ref = fit_reference_energies(src["species"], src["energy"], n_species)
        aligned = align_energies(src["species"], src["energy"], e_ref)
        n_atoms = np.maximum((src["species"] > 0).sum(axis=1), 1)
        out.append(dict(src, energy=aligned / n_atoms, e_ref=e_ref))
    return out


# ---------------------------------------------------------------------------
# Imbalance-aware head placement (hierarchical multi-task parallelism)
# ---------------------------------------------------------------------------

def _water_fill(w, n_devices, rng, refine_iters):
    """n_devices >= n_heads: one group per head; devices dealt by greedy
    water-filling, then single-device moves toward the bottleneck."""
    n_heads = w.size
    counts = np.ones(n_heads, np.int64)
    for _ in range(n_devices - n_heads):
        counts[int(np.argmax(w / counts))] += 1
    for _ in range(refine_iters):
        per_dev = w / counts
        hot = int(np.argmax(per_dev))
        donors = [g for g in range(n_heads)
                  if counts[g] > 1 and g != hot
                  and w[g] / (counts[g] - 1) < per_dev[hot]]
        if not donors:
            break
        donor = donors[int(rng.integers(len(donors)))]
        counts[donor] -= 1
        counts[hot] += 1
    return [(t,) for t in range(n_heads)], [int(c) for c in counts]


def _best_move(w, group_heads, gload, hot):
    """The single-head move or pairwise swap off the hot group that lowers
    the max load the most: (new_max, kind, payload) or None."""
    best = None
    cur = gload[hot]
    n_devices = len(group_heads)
    for t in group_heads[hot]:
        if len(group_heads[hot]) > 1:     # never strand a device
            for g in range(n_devices):
                if g == hot:
                    continue
                new_max = max(cur - w[t], gload[g] + w[t])
                if new_max < cur and (best is None or new_max < best[0]):
                    best = (new_max, "move", (t, g))
        for g in range(n_devices):
            if g == hot:
                continue
            for u in group_heads[g]:
                if w[t] <= w[u]:
                    continue
                new_max = max(cur - w[t] + w[u], gload[g] + w[t] - w[u])
                if new_max < cur and (best is None or new_max < best[0]):
                    best = (new_max, "swap", (t, hot, u, g))
    return best


def _pack(w, n_devices, refine_iters):
    """n_heads > n_devices: single-device groups; heads packed LPT-style,
    then single-head moves and pairwise swaps."""
    group_heads = [[] for _ in range(n_devices)]
    gload = np.zeros(n_devices, np.float64)
    for t in np.argsort(-w, kind="stable"):
        # ties (e.g. zero-load heads) break toward the emptiest group so
        # every device ends up owning at least one head
        g = min(range(n_devices),
                key=lambda i: (gload[i], len(group_heads[i]), i))
        group_heads[g].append(int(t))
        gload[g] += w[t]
    for _ in range(refine_iters):
        hot = int(np.argmax(gload))
        best = _best_move(w, group_heads, gload, hot)
        if best is None:
            break
        if best[1] == "move":
            t, g = best[2]
            group_heads[hot].remove(t)
            group_heads[g].append(t)
            gload[hot] -= w[t]
            gload[g] += w[t]
        else:
            t, gh, u, g = best[2]
            group_heads[gh].remove(t)
            group_heads[g].remove(u)
            group_heads[gh].append(u)
            group_heads[g].append(t)
            gload[gh] += w[u] - w[t]
            gload[g] += w[t] - w[u]
    if not all(group_heads):
        raise RuntimeError("internal: a device group lost all heads")
    return [tuple(sorted(g)) for g in group_heads], [1] * n_devices


def solve_placement(n_devices: int, loads, *, seed: int = 0,
                    refine_iters: int = 64):
    """Assign heads to device groups so the bottleneck device is as idle as
    possible: minimize ``max_g Σ_{t∈g} load_t / n_g``, the modeled per-
    device load of the busiest group.

    ``loads`` is the per-head load model (the per-source batch mix,
    ``data.mixing`` weights). Two regimes, both deterministic for a fixed
    ``seed``: ``n_devices >= n_heads`` — one group per head, devices dealt
    by greedy water-filling, then a seeded local search over single-device
    moves; ``n_heads > n_devices`` — one single-device group per device,
    heads packed LPT-style, then single-head moves and pairwise swaps. The
    result is never worse than ``round_robin_placement`` on the modeled
    max-group load (the solver keeps whichever wins; ties go to its own
    layout). ``repro``'s solver, step for step: the same placements."""
    from .taskpar import HeadPlacement, round_robin_placement

    w = np.asarray([float(x) for x in loads], np.float64)
    if w.ndim != 1 or w.size < 1:
        raise ValueError(f"bad loads {loads!r}")
    if not ((w >= 0).all() and w.sum() > 0):
        raise ValueError(f"loads must be non-negative with a positive sum, "
                         f"got {w}")
    w = w / w.sum()
    n_heads = w.size
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    rng = np.random.default_rng(seed)
    if n_devices >= n_heads:
        groups, counts = _water_fill(w, n_devices, rng, refine_iters)
    else:
        groups, counts = _pack(w, n_devices, refine_iters)
    placed = HeadPlacement(groups=tuple(groups), device_counts=tuple(counts),
                           loads=tuple(w))
    rr = round_robin_placement(n_heads, n_devices)
    if rr.max_group_load(tuple(w)) < placed.max_group_load():
        placed = HeadPlacement(groups=rr.groups,
                               device_counts=rr.device_counts,
                               loads=tuple(w))
    return placed


# ---------------------------------------------------------------------------
# Loss weighting
# ---------------------------------------------------------------------------

def uncertainty_weights_init(n_terms: int, device="cpu"):
    return {"log_sigma2": torch.zeros((n_terms,), dtype=torch.float32,
                                      device=device)}


def uncertainty_weighted_loss(params, losses):
    """Kendall homoscedastic-uncertainty MTL weighting:
    Σ_i [ exp(-s_i)·L_i + s_i ] with s_i = log σ_i²."""
    s = params["log_sigma2"]
    return torch.sum(torch.exp(-s) * losses + s)
