"""Multi-source mixing sampler (port of ``repro.data.mixing``).

The paper pre-trains on five sources whose sizes differ by ~6x. For a
SINGLE-branch model over mixed data (the paper's GFM-Baseline-All) the
batch composition itself is the knob that balances them:

  * ``mix_weights`` — per-source sampling weights from source sizes,
    ``w_s ∝ n_s^(1/temperature)``, normalized: ``temperature=1`` is
    proportional sampling, ``temperature→∞`` uniform;
  * ``MixingBatcher`` — a flat (or, with ``task_major=True``, a one-row
    task-major) batcher whose batches follow those weights by a
    DETERMINISTIC smooth weighted round-robin: after k batches source s has
    given ``k*B*w_s`` samples to within ``len(sources)``. Within a source,
    samples follow ``GroupBatcher``'s shuffled-cyclic epochs.

Every draw is ``repro``'s, in ``repro``'s order, so the same sources and
seed give byte-identical batches in both packages, and a ``state()``
snapshot from one restores in the other. For multi-head sessions the same
weights become per-task LOSS weights instead (``engine.Session``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .loader import _rows, _source_len


@dataclasses.dataclass(frozen=True)
class MixingConfig:
    """Declarative mixing policy. ``weights=None`` derives weights from the
    source sizes via ``mix_weights(sizes, temperature)``; explicit
    ``weights`` (any positive scale — they are normalized) win.
    emit_source: add a ``"source_id"`` (B,) int32 key to every batch."""
    temperature: float = 1.0
    weights: tuple | None = None
    emit_source: bool = False

    def resolve(self, sizes) -> np.ndarray:
        return mix_weights(sizes, temperature=self.temperature,
                           weights=self.weights)


def mix_weights(sizes, *, temperature: float = 1.0,
                weights=None) -> np.ndarray:
    """Normalized per-source sampling weights: explicit ``weights`` are
    only normalized; otherwise ``w_s ∝ sizes[s] ** (1/temperature)``."""
    if weights is not None:
        w = np.asarray(weights, np.float64)
        if not (w.ndim == 1 and (w > 0).all()):
            raise ValueError(
                f"explicit mixing weights must be positive, got {w}")
    else:
        if not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        n = np.asarray([float(s) for s in sizes], np.float64)
        if not (n > 0).all():
            raise ValueError(f"source sizes must be positive, got {n}")
        w = n ** (1.0 / temperature)
    return w / w.sum()


class MixingBatcher:
    """Weighted mixture batcher over N sources -> flat ``(B, ...)`` batches
    (``(1, B, ...)`` with ``task_major=True``, the shape a single-branch
    ``MultiTaskModel`` takes).

    sources: dicts of equal-structure numpy arrays or gather-style readers
    (``__len__`` + ``gather(idx) -> dict``); all share a key set (drop
    extras with ``drop_keys``). Each of the B slots goes to the source of
    highest accumulated credit (``credit += w`` a slot, the winner pays 1),
    then the batch's order is a seeded shuffle."""

    def __init__(self, sources: list, batch: int, *,
                 mixing: MixingConfig | None = None, seed: int = 0,
                 drop_keys=(), task_major: bool = False):
        if len(sources) < 1:
            raise ValueError("MixingBatcher needs at least one source")
        self.sources = list(sources)
        self.B = batch
        self.mixing = mixing or MixingConfig()
        self.task_major = task_major
        self.sizes = [_source_len(s) for s in self.sources]
        self.weights = self.mixing.resolve(self.sizes)
        self.drop = set(drop_keys)
        # one rng for the composition shuffle, one per source for its epoch
        # permutations; _perm_rng[s] is the state BEFORE the current
        # permutation was drawn (state() stores that, not the permutation)
        self.rng = np.random.default_rng(seed)
        self.rngs = [np.random.default_rng(seed + 1 + i)
                     for i in range(len(self.sources))]
        self._perm_rng = [r.bit_generator.state for r in self.rngs]
        self.perm = [r.permutation(n) for r, n in zip(self.rngs, self.sizes)]
        self.cursor = [0] * len(self.sources)
        self.credit = np.zeros(len(self.sources), np.float64)

    def _counts(self) -> np.ndarray:
        """Per-source sample counts of the next batch (sum B). A zero-weight
        (quarantined) source gains no credit and is masked out of the
        argmax, so residual credit cannot win it one last slot."""
        counts = np.zeros(len(self.weights), np.int64)
        live = self.weights > 0
        for _ in range(self.B):
            self.credit += self.weights
            pick = int(np.argmax(np.where(live, self.credit, -np.inf)))
            self.credit[pick] -= 1.0
            counts[pick] += 1
        return counts

    def set_weights(self, weights):
        """Replace the sampling weights (renormalized) — the quarantine
        lever: a zero-weight source stops appearing from the NEXT draw on.
        A source coming back (weight 0 -> positive) restarts with zero
        credit, so stale credit cannot burst-win early slots."""
        w = np.asarray(weights, np.float64)
        if w.shape != self.weights.shape:
            raise ValueError(f"{w.shape} weights for {self.weights.shape} "
                             "sources")
        if not (w >= 0).all():
            raise ValueError(f"weights must be >= 0, got {w}")
        if not w.sum() > 0:
            raise ValueError("cannot zero every source's weight")
        reenabled = (self.weights <= 0) & (w > 0)
        self.weights = w / w.sum()
        self.credit[reenabled] = 0.0

    def _take(self, s: int, k: int) -> np.ndarray:
        """k sample indices from source s, shuffled-cyclic."""
        n = len(self.perm[s])
        idx = []
        c = self.cursor[s]
        while len(idx) < k:
            take = min(k - len(idx), n - c)
            idx.extend(self.perm[s][c: c + take])
            c += take
            if c >= n:
                self._perm_rng[s] = self.rngs[s].bit_generator.state
                self.perm[s] = self.rngs[s].permutation(n)
                c = 0
        self.cursor[s] = c
        return np.asarray(idx, np.int64)

    def next_batch(self) -> dict:
        counts = self._counts()
        rows, src_ids = [], []
        for s, k in enumerate(counts):
            if k == 0:
                continue
            row = _rows(self.sources[s], self._take(s, int(k)))
            rows.append({kk: np.asarray(v) for kk, v in row.items()
                         if kk not in self.drop})
            src_ids.append(np.full(int(k), s, np.int32))
        order = self.rng.permutation(self.B)
        batch = {k: np.concatenate([r[k] for r in rows], axis=0)[order]
                 for k in rows[0]}
        if self.mixing.emit_source:
            batch["source_id"] = np.concatenate(src_ids)[order]
        if self.task_major:
            batch = {k: v[None] for k, v in batch.items()}
        return batch

    # -- checkpointing (JSON-serializable, repro's layout) -------------------

    def state(self) -> dict:
        return {
            "kind": "MixingBatcher",
            "rng": self.rng.bit_generator.state,
            "perm_rng": list(self._perm_rng),
            "cursor": list(self.cursor),
            "credit": self.credit.tolist(),
            "weights": self.weights.tolist(),
        }

    def restore(self, state: dict):
        if state.get("kind") != "MixingBatcher":
            raise ValueError(f"not a MixingBatcher state: {state.get('kind')}")
        if len(state["perm_rng"]) != len(self.rngs):
            raise ValueError(
                f"snapshot has {len(state['perm_rng'])} sources, batcher has "
                f"{len(self.rngs)} — restore into a matching construction")
        self.rng.bit_generator.state = state["rng"]
        for s, st in enumerate(state["perm_rng"]):
            self.rngs[s].bit_generator.state = st
            self._perm_rng[s] = st
            self.perm[s] = self.rngs[s].permutation(self.sizes[s])
        self.cursor = list(state["cursor"])
        self.credit = np.asarray(state["credit"], np.float64)
        if "weights" in state:   # absent in snapshots older than resilience
            self.weights = np.asarray(state["weights"], np.float64)
