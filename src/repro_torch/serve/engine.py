"""ServeSession — the request-serving engine, single device (port of
``repro.serve.engine``).

Turns a trained ``{"shared", "heads"}`` parameter tree into a
property-prediction server:

  caller threads ── submit(sample, head) ──► RequestQueue (bounded, admits
                                             via BucketSpec.bucket_for)
                                                 │
                               worker thread ────┤ SizeBinnedBatcher
                                                 │   coalesce per (bucket,
                                                 │   head); flush on full
                                                 │   batch or max_wait
                                                 ▼
                     forward on the device (egnn_apply + branch_apply)
                                                 │
                     scatter rows back to request futures + ServeMetrics

PyTorch runs eagerly, so there is no executable to compile; the
``compilations`` counter keeps its meaning from ``repro`` — the number of
distinct padded bucket shapes the forward has seen, bounded by the bucket
grid. Every batch is padded to the static ``max_batch`` rows with inert
rows, so a batch and a lone request (``predict_one``) run the same shapes
through the same kernels, and each row's result is bitwise the same: the
forward is row-independent and every kernel sums in a fixed order.

Batches move host -> device as ``non_blocking`` copies from pinned memory;
results come back with ``.cpu()``. One injected ``clock`` is the time base
of queue, batcher and metrics. ``close()`` stops admissions, drains every
queued or binned request through the forward, joins the worker and is an
idempotent no-op on re-entry.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch import interop, resolve_device
from repro_torch.data.bucketing import BucketSpec
from repro_torch.models import gnn, heads as heads_mod

from .batching import AdaptivePolicy, AssembledBatch, SizeBinnedBatcher
from .metrics import ServeMetrics
from .queue import DeadlineExceededError, RequestQueue, ServeClosedError

# head-parameter keys that are training-only (loss weighting), never part
# of the serving forward
_NON_FORWARD_HEAD_KEYS = ("log_sigma2",)


def _head_slices(head_params, n_heads: int) -> list:
    """Stacked (n_heads, ...) head tree -> per-head parameter trees (views)
    with training-only leaves dropped."""
    def take(tree, t):
        if isinstance(tree, dict):
            return {k: take(v, t) for k, v in tree.items()}
        return tree[t]
    fwd = {k: v for k, v in head_params.items()
           if k not in _NON_FORWARD_HEAD_KEYS}
    return [take(fwd, t) for t in range(n_heads)]


class ServeSession:
    """High-throughput property-prediction serving for one trained model.

    params: ``{"shared": egnn params, "heads": stacked branch params}``
        (leading head dim on every heads leaf), as numpy arrays, tensors or
        any array ``np.asarray`` takes — copied onto ``device``.
    arch:   the port's ``ArchConfig`` the params were trained with.
    spec:   the ``BucketSpec`` coalescing grid; None = one bucket at
        (arch.max_atoms, arch.max_edges).
    max_batch / max_wait_ms / queue_depth / max_queue_wait_ms /
    admission_timeout_ms / adaptive / clock: as in ``repro``.
    mesh: multi-device serving belongs to a later slice; not None raises.
    device: where the forward runs; None = ``cuda`` (raises without a GPU).
    """

    def __init__(self, params: dict, arch, *, spec: BucketSpec | None = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 queue_depth: int = 256,
                 max_queue_wait_ms: float | None = None,
                 admission_timeout_ms: float | None = None,
                 mesh=None, adaptive: bool = False,
                 metrics: ServeMetrics | None = None,
                 clock=time.monotonic, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (rows sharded over several devices) is not ported "
                "yet; this ServeSession serves on one device")
        if not (isinstance(params, dict) and
                {"shared", "heads"} <= set(params)):
            raise ValueError('params must be the MultiTaskModel layout '
                             '{"shared": ..., "heads": ...}')
        self.device = resolve_device(device)
        params = interop.to_torch(params, self.device)
        fwd_heads = {k: v for k, v in params["heads"].items()
                     if k not in _NON_FORWARD_HEAD_KEYS}
        leaves = list(interop.leaves(fwd_heads).values())
        n_heads = int(leaves[0].shape[0])
        if any(int(l.shape[0]) != n_heads for l in leaves):
            raise ValueError("heads leaves disagree on the leading head dim")
        if spec is None:
            if not (arch.max_atoms > 0 and arch.max_edges > 0):
                raise ValueError("spec=None needs arch.max_atoms/max_edges "
                                 "to form a bucket")
            spec = BucketSpec((arch.max_atoms,), (arch.max_edges,))
        self.arch = arch
        self.spec = spec
        self.n_heads = n_heads
        self.max_batch = max_batch
        self._clock = clock
        self._shared = params["shared"]
        self._heads = _head_slices(params["heads"], n_heads)
        self.metrics = metrics if metrics is not None else \
            ServeMetrics(seed=seed, clock=clock)
        max_wait = max_wait_ms * 1e-3
        policy = AdaptivePolicy(max_batch=max_batch, max_wait=max_wait) \
            if adaptive else None
        self.queue = RequestQueue(
            spec, depth=queue_depth, n_heads=n_heads, clock=clock,
            metrics=self.metrics,
            max_queue_wait=None if max_queue_wait_ms is None
            else max_queue_wait_ms * 1e-3,
            admission_timeout=None if admission_timeout_ms is None
            else admission_timeout_ms * 1e-3)
        self.batcher = SizeBinnedBatcher(max_batch=max_batch,
                                         max_wait=max_wait, clock=clock,
                                         policy=policy)
        self._policy = policy
        self._exec: dict[tuple, object] = {}   # (bucket, head) -> callable
        self._shapes_compiled: set = set()
        self._closed = False
        self._worker_error: BaseException | None = None
        # requests dequeued but not yet filed into the batcher (failed from
        # here if the worker crashes)
        self._inflight: list = []
        self._closing = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="serve-worker", daemon=True)
        self._worker.start()

    # -- construction helpers -----------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, arch, *, model: str = "gfm-mtl",
                        n_heads: int | None = None, **kw) -> "ServeSession":
        """Serve the ``{"params": ...}`` tree of a checkpoint written by
        ``repro``'s ``Session``/``checkpoint.save`` (or the port's). The
        template is the model's init on the ``meta`` device — shapes only."""
        from repro_torch.core.mtl import gfm_mtl_init
        from repro_torch.train import checkpoint
        if model not in ("gfm-mtl", "gfm-baseline"):
            raise ValueError(f"model '{model}': the port serves 'gfm-mtl' "
                             f"and 'gfm-baseline'")
        n = 1 if model == "gfm-baseline" else (n_heads or arch.n_tasks)
        template = gfm_mtl_init(arch, n, device="meta")
        params = checkpoint.restore(path, {"params": template})["params"]
        return cls(params, arch, **kw)

    # -- public API ----------------------------------------------------------

    def submit(self, sample: dict, head: int = 0):
        """Admit one structure; returns a Future resolving to
        ``{"energy": float, "forces": (n_atoms, 3) float32}``."""
        self._check_alive()
        return self.queue.submit(sample, head)

    def submit_many(self, samples, heads=0) -> list:
        self._check_alive()
        return self.queue.submit_many(samples, heads)

    def predict_one(self, sample: dict, head: int = 0) -> dict:
        """Synchronous single-request forward on the same padded shape a
        batched run uses (one real row, ``max_batch - 1`` inert pad rows) —
        the parity reference for the batched-and-scattered path. Bypasses
        the queue/worker."""
        from .batching import assemble
        from .queue import Request, _as_sample
        canon, n_atoms, n_edges = _as_sample(sample)
        bucket = self.spec.bucket_for(n_atoms, n_edges)
        req = Request(sample=canon, head=head, bucket=bucket,
                      n_atoms=n_atoms, n_edges=n_edges, future=None,
                      t_submit=self._clock())
        ab = assemble([req], bucket, self.max_batch)
        e, f = self._executable(bucket, head)(ab.batch)
        return {"energy": float(e[0]), "forces": f[0, :n_atoms]}

    def warmup(self, buckets=None) -> int:
        """Run the forward once (head 0) on every given bucket shape
        (default: the full grid) so first requests meet warm caches and
        built kernels. Returns the number of shapes seen afterwards."""
        if buckets is None:
            buckets = [(a, e) for a in self.spec.atom_buckets
                       for e in self.spec.edge_buckets]
        for a_pad, e_pad in buckets:
            B = self.max_batch
            dummy = {"species": np.zeros((B, a_pad), np.int32),
                     "pos": np.zeros((B, a_pad, 3), np.float32),
                     "edge_src": np.full((B, e_pad), a_pad, np.int32),
                     "edge_dst": np.full((B, e_pad), a_pad, np.int32),
                     "node_mask": np.zeros((B, a_pad), bool),
                     "edge_mask": np.zeros((B, e_pad), bool)}
            self._executable((a_pad, e_pad), 0)(dummy)
        return len(self._shapes_compiled)

    def stats(self) -> dict:
        """Metrics snapshot + shape-cache occupancy (plain dict)."""
        out = self.metrics.snapshot()
        out["executable_cache"] = {
            "entries": len(self._exec),
            "compiled_shapes": len(self._shapes_compiled),
            "budget": self.spec.n_shapes * self.n_heads,
            "compile_budget": self.spec.n_shapes,
        }
        out["plan"] = {"mode": "single", "devices": 1,
                       "device": str(self.device)}
        if self._policy is not None:
            out["adaptive"] = self._policy.snapshot()
        return out

    def close(self):
        """Graceful shutdown: stop admissions, drain every queued/binned
        request through the forward (all accepted futures resolve), join
        the worker. Idempotent no-op on re-entry."""
        if self._closed:
            return
        self._closed = True
        self.queue.close()
        self._closing.set()
        self._worker.join(timeout=60.0)
        if self._worker.is_alive():
            raise RuntimeError("serve worker did not drain within 60s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- forward ---------------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _forward(self, head_params, batch: dict):
        with torch.inference_mode():
            tb = self._to_device(batch)
            feats = gnn.egnn_apply(self._shared, tb, cfg=self.arch)
            e, f = heads_mod.branch_apply(head_params, feats,
                                          tb["node_mask"], cfg=self.arch)
            return e.cpu().numpy(), f.cpu().numpy()

    def _executable(self, bucket: tuple, head: int):
        """The per-(bucket, head) cache entry: the forward with this head's
        parameter slice bound. Counts a compilation only when the bucket
        SHAPE is new — other heads on a seen shape reuse it."""
        key = (bucket, head)
        fn = self._exec.get(key)
        if fn is None:
            if bucket not in self._shapes_compiled:
                self._shapes_compiled.add(bucket)
                self.metrics.inc("compilations")
            hp = self._heads[head]

            def fn(batch, _h=hp):
                return self._forward(_h, batch)

            self._exec[key] = fn
        return fn

    # -- worker ---------------------------------------------------------------

    def _check_alive(self):
        if self._closed:
            raise ServeClosedError("ServeSession is closed")
        if self._worker_error is not None:
            raise ServeClosedError(
                "serve worker died — session is closed to new work"
            ) from self._worker_error

    def _execute(self, ab: AssembledBatch):
        """Run one assembled batch and scatter rows to futures."""
        t0 = self._clock()
        try:
            e, f = self._executable(ab.bucket, ab.head)(ab.batch)
        except Exception as err:
            for r in ab.requests:
                r.future.set_exception(err)
            self.metrics.inc("failed", len(ab.requests))
            return
        t1 = self._clock()
        self.metrics.observe("compute", t1 - t0)
        self.metrics.inc("batches")
        self.metrics.inc("batch_slots", self.max_batch)
        self.metrics.inc("batch_real", ab.n_real)
        for i, r in enumerate(ab.requests):
            r.t_done = self._clock()
            r.future.set_result(
                {"energy": float(e[i]), "forces": f[i, :r.n_atoms]})
            self.metrics.observe("e2e", r.t_done - r.t_submit)
        self.metrics.inc("completed", ab.n_real)

    def _file(self, req) -> AssembledBatch | None:
        req.t_dequeue = self._clock()
        self.metrics.observe("queue_wait", req.t_dequeue - req.t_submit)
        if req.deadline is not None and req.t_dequeue > req.deadline:
            req.future.set_exception(DeadlineExceededError(
                f"request waited {req.t_dequeue - req.t_submit:.3f}s in "
                f"queue, past its max_queue_wait deadline"))
            self.metrics.inc("shed_deadline")
            return None
        t0 = self._clock()
        ab = self.batcher.add(req)
        if ab is not None:
            self.metrics.observe("assembly", self._clock() - t0)
        return ab

    def _serve_loop(self):
        try:
            while not self._closing.is_set():
                deadline = self.batcher.next_deadline(self._clock())
                timeout = 0.05 if deadline is None \
                    else min(max(deadline, 0.0), 0.05)
                req = self.queue.get(timeout=timeout)
                if req is not None:
                    # greedy drain: file the whole backlog before computing
                    # so bins can fill to max_batch under load
                    self._inflight = [req] + self.queue.drain()
                    ready = []
                    while self._inflight:
                        ab = self._file(self._inflight[0])
                        self._inflight.pop(0)
                        if ab is not None:
                            ready.append(ab)
                    for ab in ready:
                        self._execute(ab)
                t0 = self._clock()
                expired = self.batcher.expired(self._clock())
                if expired:
                    dt = (self._clock() - t0) / len(expired)
                    for ab in expired:
                        self.metrics.observe("assembly", dt)
                        self._execute(ab)
            # graceful drain: admissions are closed, the queue only shrinks
            for req in self.queue.drain():
                ab = self._file(req)
                if ab is not None:
                    self._execute(ab)
            for ab in self.batcher.flush():
                self._execute(ab)
        except BaseException as err:   # fail loudly, never hang futures
            self._worker_error = err
            self.queue.close()
            self.metrics.inc("worker_failures")
            pending = (self._inflight + self.queue.drain() +
                       self.batcher.pending_requests())
            self._inflight = []
            for req in pending:
                req.future.set_exception(err)
            self.metrics.inc("failed", len(pending))
            raise
