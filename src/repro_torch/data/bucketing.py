"""Size-bucketed padded shapes (port of ``repro.data.bucketing``).

Every stored graph is padded to one global shape (``max_atoms``,
``max_edges``), (64, 2048) for hydragnn-gfm, though the synthetic sources
hold 5–32 atoms and at most a few hundred edges. The fused edge kernels do
O(E) work on pad edges and O(A) on pad nodes, so padding is time:

  * ``BucketSpec`` — a small grid of padded shapes (atom ceilings x edge
    ceilings) planned from the data's per-sample node/edge count
    quantiles. The serving queue bins every request into the smallest
    bucket that holds it;
  * ``BucketingBatcher`` — wraps any ``next_batch()`` batcher and re-pads
    each batch down to the smallest bucket shape that holds its content.
    Samples, their order and their values are untouched (only trailing
    padding goes), so the stream is the single-shape stream minus pad and
    ``state()``/``restore()`` delegate to the wrapped batcher. It takes
    numpy batches and batches already placed as torch tensors (a
    ``PrefetchingBatcher``'s), on any device;
  * ``pad_fraction`` — the share of pad rows in a batch.

Contract with the kernels: pad rows are TRAILING (masks front-packed, as
every source here emits) and masked edges are re-pointed at the trimmed
batch's sentinel ``A_pad`` (the ``>= n_nodes`` contract of ``segment_sum``
and the fused ``egnn_edge`` kernels).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ATOM_KEYS = ("species", "pos", "node_mask", "forces")
EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask")


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

    def ceil(self, n_atoms: int, n_edges: int) -> tuple:
        """Alias of ``bucket_for`` (the batch path's name)."""
        return self.bucket_for(n_atoms, n_edges)

    @classmethod
    def from_sources(cls, sources, *, n_atom_buckets: int = 4,
                     n_edge_buckets: int = 4, atom_multiple: int = 8,
                     edge_multiple: int = 64) -> "BucketSpec":
        """Plan the grid from per-sample node/edge counts. sources: dicts
        with ``node_mask``/``edge_mask`` arrays, objects with those
        attributes, or gather-style readers (``__len__`` + ``gather``, read
        in chunks of 4096 samples; only the counts are kept)."""
        def counts(s):
            if hasattr(s, "gather"):
                a_counts, e_counts = [], []
                a_cap = e_cap = 0
                for start in range(0, len(s), 4096):
                    sub = s.gather(np.arange(start, min(start + 4096,
                                                        len(s))))
                    nm, em = np.asarray(sub["node_mask"]), \
                        np.asarray(sub["edge_mask"])
                    a_counts.append(nm.sum(-1).ravel())
                    e_counts.append(em.sum(-1).ravel())
                    a_cap, e_cap = nm.shape[-1], em.shape[-1]
                return (np.concatenate(a_counts), np.concatenate(e_counts),
                        a_cap, e_cap)
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


def pad_fraction(batch: dict) -> dict:
    """Share of pad rows in one batch: ``{"atoms": ..., "edges": ...}``
    (numpy arrays or torch tensors; counted in float64, as ``repro``
    does)."""
    def mean(m):
        if isinstance(m, torch.Tensor):
            return float(m.double().mean())
        return float(np.mean(m))
    return {"atoms": 1.0 - mean(batch["node_mask"]),
            "edges": 1.0 - mean(batch["edge_mask"])}


class BucketingBatcher:
    """Re-pad every batch of a wrapped batcher down to its bucket shape.

    Works on flat ``(B, A, ...)`` and task-major ``(T, B, A, ...)`` batches
    (the atom/edge axis is found from ``node_mask``'s rank), of numpy
    arrays or torch tensors. Keys outside ``ATOM_KEYS``/``EDGE_KEYS`` pass
    through (e.g. ``energy``, ``source_id``). Trimmed torch tensors are
    made contiguous (a copy on their device); numpy ones stay views.

    strict (default True): check per batch that the trim dropped no real
    atom or edge (masks front-packed); raises ``ValueError`` otherwise."""

    def __init__(self, batcher, spec: BucketSpec, *, strict: bool = True):
        self.batcher = batcher
        self.spec = spec
        self.strict = strict
        self.shapes_seen: set = set()   # distinct (A_pad, E_pad) emitted

    def next_batch(self) -> dict:
        b = self.batcher.next_batch()
        nm, em = b["node_mask"], b["edge_mask"]
        placed = isinstance(nm, torch.Tensor)
        if placed:
            # one host read for both maxima
            a_max, e_max = (int(x) for x in torch.stack(
                [nm.sum(-1).max(), em.sum(-1).max()]).tolist()) \
                if nm.numel() and em.numel() else (0, 0)
        else:
            nm, em = np.asarray(nm), np.asarray(em)
            a_max = int(nm.sum(-1).max(initial=0))
            e_max = int(em.sum(-1).max(initial=0))
        axis = nm.ndim - 1               # atom/edge axis: 1 flat, 2 task-major
        a_pad, e_pad = self.spec.bucket_for(a_max, e_max)
        self.shapes_seen.add((a_pad, e_pad))
        lead = (slice(None),) * axis
        out = {}
        for k, v in b.items():
            if not placed:
                v = np.asarray(v)
            if k in ATOM_KEYS:
                v = v[lead + (slice(0, a_pad),)]
            elif k in EDGE_KEYS:
                v = v[lead + (slice(0, e_pad),)]
            out[k] = v.contiguous() if placed else v
        # masked edges -> the TRIMMED pad sentinel (>= n_nodes contract)
        em_t = out["edge_mask"]
        for k in ("edge_src", "edge_dst"):
            x = out[k]
            out[k] = torch.where(em_t, x, torch.full_like(x, a_pad)) \
                if placed else np.where(em_t, x, a_pad).astype(x.dtype)
        if self.strict:
            if placed:
                kept = torch.stack([out["node_mask"].sum(), em_t.sum(),
                                    nm.sum(), em.sum()]).tolist()
            else:
                kept = [out["node_mask"].sum(), em_t.sum(), nm.sum(),
                        em.sum()]
            if kept[0] != kept[2]:
                raise ValueError("bucket trim dropped real atoms — "
                                 "node_mask not front-packed")
            if kept[1] != kept[3]:
                raise ValueError("bucket trim dropped real edges — "
                                 "edge_mask not front-packed")
        return out

    # -- delegation ---------------------------------------------------------

    def state(self) -> dict:
        # the stream is a function of the wrapped batcher, but shapes_seen
        # is session state (the padded shapes a run has met): a resumed run
        # keeps it
        return {"kind": "BucketingBatcher",
                "shapes_seen": sorted(list(s) for s in self.shapes_seen),
                "inner": self.batcher.state()}

    def restore(self, state: dict):
        if isinstance(state, dict) and state.get("kind") == "BucketingBatcher":
            self.shapes_seen = {tuple(s) for s in state["shapes_seen"]}
            self.batcher.restore(state["inner"])
        else:
            # a bare inner state (repro's older snapshots): no shapes kept
            self.batcher.restore(state)

    @property
    def sources(self):
        return self.batcher.sources

    def close(self):
        if hasattr(self.batcher, "close"):
            self.batcher.close()
