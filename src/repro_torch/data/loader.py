"""Group-aware batcher (port of ``repro.data.loader``: ``GroupBatcher`` and
``SingleBatcher``).

The paper serves batches through DDStore so that each task's sub-group only
ever receives batches from ITS dataset. Here the same contract is an
in-memory, task-major batcher: ``next_batch()`` returns a dict whose every
leaf is (n_tasks, B, ...), with row t drawn only from source t.

Batch assembly is pure NumPy; device placement belongs to the consumer
(``repro_torch.data.prefetch.DevicePlacer``, on the prefetch thread). The
permutation streams are ``repro``'s, draw for draw, so the same sources and
seed give byte-identical batches in both packages, and a ``state()``
snapshot from one restores in the other.

Epoch semantics: per-source shuffled cyclic iteration (sources of different
sizes wrap independently, so every head stays busy every step).
"""
from __future__ import annotations

import numpy as np


def _source_len(s) -> int:
    """Samples in a source: a dict of arrays, or any object with __len__
    and ``gather(idx) -> dict`` (e.g. ``data.store.ShardedSource``)."""
    return len(s) if hasattr(s, "gather") else len(next(iter(s.values())))


def _rows(s, idx) -> dict:
    """Samples ``idx`` of one source, as a dict of numpy arrays."""
    return s.gather(idx) if hasattr(s, "gather") else \
        {k: v[idx] for k, v in s.items()}


class GroupBatcher:
    def __init__(self, sources: list, batch_per_task: int, *, seed=0,
                 drop_keys=()):
        """sources: one per task/source — dicts of equal-structure numpy
        arrays (dim 0 = sample dim) or gather-style readers (objects with
        ``__len__`` and ``gather(idx) -> dict``, e.g. ``ShardedSource``).
        drop_keys: keys left out of every batch."""
        self.sources = sources
        self.B = batch_per_task
        self.rngs = [np.random.default_rng(seed + i)
                     for i in range(len(sources))]
        # _perm_rng[t] = rng state BEFORE the current permutation was drawn:
        # state() serializes that (O(1) per source) instead of the
        # permutation itself, and restore() regenerates the permutation
        self._perm_rng = [r.bit_generator.state for r in self.rngs]
        self.perm = [r.permutation(_source_len(s))
                     for r, s in zip(self.rngs, sources)]
        self.cursor = [0] * len(sources)
        self.drop = set(drop_keys)

    def _take(self, t: int) -> np.ndarray:
        n = len(self.perm[t])
        idx = []
        c = self.cursor[t]
        while len(idx) < self.B:
            take = min(self.B - len(idx), n - c)
            idx.extend(self.perm[t][c: c + take])
            c += take
            if c >= n:
                self._perm_rng[t] = self.rngs[t].bit_generator.state
                self.perm[t] = self.rngs[t].permutation(n)
                c = 0
        self.cursor[t] = c
        return np.asarray(idx)

    def next_batch(self) -> dict:
        rows = []
        for t, s in enumerate(self.sources):
            row = _rows(s, self._take(t))
            rows.append({k: v for k, v in row.items() if k not in self.drop})
        return {k: np.stack([np.asarray(r[k]) for r in rows], axis=0)
                for k in rows[0]}

    # -- checkpointing (JSON-serializable, repro's layout) -------------------

    def state(self) -> dict:
        """O(n_sources) snapshot — permutations are regenerated from the
        stored rng states on restore, never serialized."""
        return {"kind": "GroupBatcher",
                "perm_rng": list(self._perm_rng),
                "cursor": list(self.cursor)}

    def restore(self, state: dict):
        if state.get("kind") != "GroupBatcher":
            raise ValueError(f"not a GroupBatcher state: {state.get('kind')}")
        if len(state["perm_rng"]) != len(self.rngs):
            raise ValueError(
                f"snapshot has {len(state['perm_rng'])} sources, batcher has "
                f"{len(self.rngs)} — restore into a matching construction")
        for t, st in enumerate(state["perm_rng"]):
            self.rngs[t].bit_generator.state = st
            self._perm_rng[t] = st
            self.perm[t] = self.rngs[t].permutation(len(self.perm[t]))
        self.cursor = list(state["cursor"])


class SingleBatcher:
    """Flat (no task dim) uniform-random batcher over one source dict — the
    single-task analogue of ``GroupBatcher`` (``repro``'s draws, so the
    same seed gives the same stream in both packages)."""

    def __init__(self, source: dict, batch: int, *, seed=0):
        self.source = source
        self.B = batch
        self.n = len(next(iter(source.values())))
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> dict:
        idx = self.rng.integers(0, self.n, self.B)
        return {k: np.asarray(v[idx]) for k, v in self.source.items()}

    def state(self) -> dict:
        return {"kind": "SingleBatcher", "rng": self.rng.bit_generator.state}

    def restore(self, state: dict):
        if state.get("kind") != "SingleBatcher":
            raise ValueError(f"not a SingleBatcher state: {state.get('kind')}")
        self.rng.bit_generator.state = state["rng"]
