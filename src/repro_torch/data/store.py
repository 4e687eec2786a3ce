"""Sharded sample store — the ADIOS + DDStore analogue (port of
``repro.data.store``).

The paper serialises every dataset into ADIOS files and serves training
batches through DDStore, an in-memory distributed cache, so the steady
state never touches the filesystem. At container scale:

  * ``write_store`` — one source into N ``.npz`` shards + a JSON manifest
    (published atomically);
  * ``ShardedSource`` — maps shards lazily, caches each in memory after its
    first touch, and serves arbitrary sample indices by routing to the
    owning shard (a gather-style source: ``__len__`` + ``gather``);
  * ``PrefetchingBatcher`` — a ``GroupBatcher`` over ``ShardedSource``s
    behind the port's ``Prefetcher``, whose producer thread reads the
    shards and places each batch on the device (``DevicePlacer``: pinned
    memory, a side stream). Its ``next_batch()`` returns tensors on the
    device, ready on the caller's stream.

The file layout is ``repro``'s: a store written by either package is read
by the other, and the same seed gives the same batches from both.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch import resolve_device

from .loader import GroupBatcher
from .prefetch import DevicePlacer, Prefetcher


def write_store(path: str, arrays: dict, *, shard_size: int = 256) -> dict:
    """arrays: dict of equal-length (dim 0) numpy arrays -> shard files +
    manifest. Returns the manifest. The manifest is published through a
    same-directory temp file and ``os.replace``; shards are not
    transactional, so write a fresh directory to replace a store."""
    os.makedirs(path, exist_ok=True)
    n = len(next(iter(arrays.values())))
    for k, v in arrays.items():
        if len(v) != n:
            raise ValueError(f"{k} length {len(v)} != {n}")
    shards = []
    for i, start in enumerate(range(0, n, shard_size)):
        stop = min(start + shard_size, n)
        fname = f"shard_{i:05d}.npz"
        np.savez(os.path.join(path, fname),
                 **{k: v[start:stop] for k, v in arrays.items()})
        shards.append({"file": fname, "start": start, "stop": stop})
    manifest = {"n_samples": n, "keys": sorted(arrays),
                "shard_size": shard_size, "shards": shards}
    final = os.path.join(path, "manifest.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return manifest


class ShardedSource:
    """Lazy, caching reader over one store directory (the DDStore cache)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self._cache: dict[int, dict] = {}
        self.fetches = 0          # filesystem reads (plateau at the shards)
        self.hits = 0             # in-memory serves

    def __len__(self):
        return self.manifest["n_samples"]

    @property
    def keys(self):
        return self.manifest["keys"]

    def _shard(self, si: int) -> dict:
        if si not in self._cache:
            with np.load(os.path.join(
                    self.path, self.manifest["shards"][si]["file"])) as f:
                self._cache[si] = {k: f[k] for k in self.keys}
            self.fetches += 1
        else:
            self.hits += 1
        return self._cache[si]

    def gather(self, idx: np.ndarray) -> dict:
        """Samples ``idx`` in the order given, routed per owning shard."""
        idx = np.asarray(idx)
        ss = self.manifest["shard_size"]
        out = {k: [] for k in self.keys}
        order = np.argsort(idx // ss, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        for si in np.unique(idx // ss):
            sh = self._shard(int(si))
            local = idx[idx // ss == si] - si * ss
            for k in self.keys:
                out[k].append(sh[k][local])
        return {k: np.concatenate(v)[inv] for k, v in out.items()}


class PrefetchingBatcher(Prefetcher):
    """``GroupBatcher`` over ``ShardedSource``s with a background producer
    that reads and places each batch: ``next_batch()`` -> a task-major dict
    of tensors on ``device``, row t drawn only from source t.
    ``state()``/``restore()`` are the ``Prefetcher``'s (the consumed
    position of the inner ``GroupBatcher``, whose snapshot either package
    restores). ``device=None`` means ``cuda`` and raises without a GPU."""

    def __init__(self, sources: list, batch_per_task: int, *, seed: int = 0,
                 depth: int = 1, device=None):
        self.sources = sources
        self.device = resolve_device(device)
        self.placer = DevicePlacer(self.device)
        super().__init__(GroupBatcher(sources, batch_per_task, seed=seed),
                         transform=self.placer, depth=depth)

    def next_batch(self) -> dict:
        return self.placer.ready(super().next_batch())
