"""Size-bucketed padded shapes: ``BucketSpec`` and ``BucketOverflowError``.

A copy of the grid half of ``repro.data.bucketing`` (the port does not
import ``repro``): a small grid of padded graph shapes (atom ceilings x edge
ceilings) planned from the data's per-sample node/edge count quantiles. The
serving queue bins every request into the smallest bucket that holds it, so
the engine sees at most ``n_shapes`` distinct padded shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class BucketOverflowError(ValueError):
    """A sample's atom/edge count exceeds the grid's largest bucket — at
    serving time the admission-control signal: the request cannot be padded
    to any shape of the grid and is rejected, not silently truncated."""


def _ceil_grid(counts: np.ndarray, n_buckets: int, cap: int,
               multiple: int) -> tuple:
    """Ascending pad ceilings covering ``counts``: quantile cut points
    rounded up to ``multiple``, deduplicated, capped by (and always
    including) ``cap`` so every sample has a bucket."""
    qs = np.quantile(counts, np.linspace(0, 1, n_buckets + 1)[1:])
    grid = sorted({min(int(-(-max(q, 1) // multiple) * multiple), cap)
                   for q in qs} | {cap})
    return tuple(grid)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """``atom_buckets``/``edge_buckets``: ascending pad ceilings; the last
    entry must dominate every sample."""
    atom_buckets: tuple
    edge_buckets: tuple

    def __post_init__(self):
        for name, g in (("atom", self.atom_buckets),
                        ("edge", self.edge_buckets)):
            if not (len(g) >= 1 and list(g) == sorted(set(g))):
                raise ValueError(
                    f"{name}_buckets must be ascending and unique, got {g}")

    @property
    def n_shapes(self) -> int:
        return len(self.atom_buckets) * len(self.edge_buckets)

    def bucket_for(self, n_atoms: int, n_edges: int) -> tuple:
        """The smallest (A_pad, E_pad) bucket covering the content
        (ceilings are inclusive); beyond the cap raises
        ``BucketOverflowError``."""
        if n_atoms < 0 or n_edges < 0:
            raise ValueError(f"negative content counts: "
                             f"({n_atoms} atoms, {n_edges} edges)")
        a = next((b for b in self.atom_buckets if b >= n_atoms), None)
        e = next((b for b in self.edge_buckets if b >= n_edges), None)
        if a is None:
            raise BucketOverflowError(
                f"{n_atoms} atoms exceeds the grid cap "
                f"{self.atom_buckets[-1]} (atom_buckets={self.atom_buckets})")
        if e is None:
            raise BucketOverflowError(
                f"{n_edges} edges exceeds the grid cap "
                f"{self.edge_buckets[-1]} (edge_buckets={self.edge_buckets})")
        return a, e

    @classmethod
    def from_sources(cls, sources, *, n_atom_buckets: int = 4,
                     n_edge_buckets: int = 4, atom_multiple: int = 8,
                     edge_multiple: int = 64) -> "BucketSpec":
        """Plan the grid from per-sample node/edge counts. sources: dicts
        with ``node_mask``/``edge_mask`` arrays, or objects with those
        attributes."""
        def counts(s):
            nm = np.asarray(s["node_mask"] if isinstance(s, dict)
                            else s.node_mask)
            em = np.asarray(s["edge_mask"] if isinstance(s, dict)
                            else s.edge_mask)
            return (nm.sum(-1).ravel(), em.sum(-1).ravel(),
                    nm.shape[-1], em.shape[-1])

        per_source = [counts(s) for s in sources]
        atoms = np.concatenate([p[0] for p in per_source])
        edges = np.concatenate([p[1] for p in per_source])
        a_cap, e_cap = per_source[0][2], per_source[0][3]
        return cls(_ceil_grid(atoms, n_atom_buckets, a_cap, atom_multiple),
                   _ceil_grid(edges, n_edge_buckets, e_cap, edge_multiple))
