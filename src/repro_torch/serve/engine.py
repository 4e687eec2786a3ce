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

A multi-device session is one more PLAN, not more shapes: ``mesh=`` (a
``launch.mesh.ServeMesh``) splits each batch's rows over the mesh's
entries, the params copied once per distinct device, so the budget stays
the bucket grid; ``serve.scaleout`` runs one session per replica on top.

The worker runs each batch's host -> device copies (``non_blocking``, from
pinned memory), forward and ``.cpu()`` on a CUDA stream of its own, one
per mesh entry, so sessions on one card overlap instead of queueing on
the default stream; ``predict_one`` runs the same kernels at the same
shapes on the caller's stream. The streams come from ``STREAMS``, a pool
that outlives the sessions: one stream a (card, the running thread's
cuBLAS handle, entry slot). PyTorch keeps a 32 MiB cuBLAS workspace for
each (handle, stream) pair that ran a GEMM, until the process ends, and
hands a thread's handle to a later thread once the first ends: with the
stream a function of the handle, sessions opened and closed again reuse
the pairs, and the workspaces stay as many as the threads that ran at
once. One injected ``clock`` is the time base of queue, batcher and
metrics. ``close()`` stops admissions, drains every queued or binned
request through the forward, joins the worker and is an idempotent no-op
on re-entry; ``restart_worker()`` brings a crashed worker back.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

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


def _row_chunks(batch: dict, n: int) -> list:
    """An assembled batch's rows cut into ``n`` contiguous chunks, one per
    mesh entry (one chunk, all rows, on a single device): ``repro``'s
    ``serve_batch_spec`` rule
    (``repro/configs/sharding.py:143-153``, rows data-parallel over the
    serving mesh) with the params replicated. ``ServeSession`` refuses a
    ``max_batch`` that does not tile, so the rule's replicate case never
    arises."""
    rows = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for i in range(n)]


class _Entry(NamedTuple):
    """One mesh entry: its device, its slot (the entry's index among the
    session's entries on that device: the stream it takes from ``STREAMS``)
    and the params on that device (shared by the entries of one device)."""
    device: torch.device
    slot: int
    shared: dict
    heads: list


def _blas_handle(device: torch.device) -> int:
    """The calling thread's cuBLAS handle on ``device``."""
    with torch.cuda.device(device):
        return torch.cuda.current_blas_handle()


class StreamPool:
    """CUDA streams that outlive the serving sessions: ``stream(device,
    slot)`` is one stream a (device, the calling thread's cuBLAS handle,
    slot), made on first use and handed back ever after. Two live threads
    never share a handle, so two threads never share a stream; a thread
    that starts after another ended may get its handle, and then its
    streams, whose (handle, stream) pairs already have their cuBLAS
    workspaces. ``make`` and ``handle`` (device -> a new stream, the
    calling thread's handle) are PyTorch's by default."""

    def __init__(self, make=None, handle=None):
        self._make = make or (lambda d: torch.cuda.Stream(device=d))
        self._handle = handle or _blas_handle
        self._streams: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def stream(self, device, slot: int = 0):
        handles = self._local.__dict__.setdefault("handles", {})
        if device not in handles:       # a thread keeps its handle
            handles[device] = self._handle(device)
        key = (device, handles[device], slot)
        with self._lock:
            if key not in self._streams:
                self._streams[key] = self._make(device)
            return self._streams[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._streams)


STREAMS = StreamPool()


def _copied(device: torch.device):
    """An event on ``device``'s current stream, marking the copies queued
    before it (None off CUDA, where a copy has finished on return)."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record()
    return done


def _pinned(device) -> torch.device:
    """``device`` with the CUDA index made explicit (``cuda`` -> the
    current card), so entries naming one card compare equal. A CUDA entry
    without a GPU raises, as ``resolve_device`` does."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the serving mesh names a CUDA device and no "
                               "CUDA device is available; name 'cpu' "
                               "entries (device='cpu') to serve on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


class _Forward:
    """A serving session's forward as ``jit_functions()`` hands it out."""

    def __init__(self, session):
        self.session = session

    def __call__(self, head: int, batch: dict, own_streams: bool = True):
        return self.session._predict(head, batch, own_streams)

    def cache_size(self) -> int:
        """Bucket shapes the session has run (``_shapes_compiled``)."""
        return len(self.session._shapes_compiled)


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
    mesh: a ``ServeMesh`` (``launch.mesh.make_replica_meshes``), or None.
        One entry pins the session to that device. With n > 1 entries each
        batch's rows are split into n contiguous chunks, one per entry, on
        the entry's own stream, and gathered in row order; ``max_batch``
        must tile evenly. Rows stay bitwise equal to this session's
        ``predict_one`` (same plan); against a single-device session they
        agree within float32 rounding, not bitwise: a chunk of
        max_batch / n rows may sum in another order (#3 plans its split-K
        from the rows it gets).
    device: where the forward runs when ``mesh`` is None; None = ``cuda``
        (raises without a GPU). With a mesh, its entries name the devices
        and ``device`` must be None.
    """

    def __init__(self, params: dict, arch, *, spec: BucketSpec | None = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 queue_depth: int = 256,
                 max_queue_wait_ms: float | None = None,
                 admission_timeout_ms: float | None = None,
                 mesh=None, adaptive: bool = False,
                 metrics: ServeMetrics | None = None,
                 clock=time.monotonic, seed: int = 0, device=None):
        if not (isinstance(params, dict) and
                {"shared", "heads"} <= set(params)):
            raise ValueError('params must be the MultiTaskModel layout '
                             '{"shared": ..., "heads": ...}')
        if mesh is None:
            devices = (resolve_device(device),)
        elif device is not None:
            raise ValueError("pass mesh= or device=, not both: the mesh's "
                             "entries name the devices")
        else:
            devices = tuple(mesh.devices)
        devices = tuple(_pinned(d) for d in devices)
        if not devices:
            raise ValueError("the serving mesh has no device")
        self.plan_devices = len(devices)
        if max_batch % self.plan_devices:
            raise ValueError(
                f"max_batch={max_batch} must tile evenly over the "
                f"{self.plan_devices}-device serving mesh (rows are "
                f"data-parallel)")
        copies: dict = {}       # one params copy per distinct device
        for d in devices:
            if d not in copies:
                copies[d] = interop.to_torch(params, d)
                if d.type == "cuda":    # the copies land before any stream
                    # lint: allow(TRC003): once a card, building the session
                    torch.cuda.synchronize(d)
        fwd_heads = {k: v for k, v in copies[devices[0]]["heads"].items()
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
        self.device = devices[0]
        self._clock = clock
        heads = {d: _head_slices(p["heads"], n_heads)
                 for d, p in copies.items()}
        self._entries = [
            _Entry(d, devices[:i].count(d), copies[d]["shared"], heads[d])
            for i, d in enumerate(devices)]
        # the streams the worker thread ran the entries on
        self.worker_streams: set = set()
        self.metrics = metrics if metrics is not None else \
            ServeMetrics(seed=seed, clock=clock)
        # retained so restart_worker() can rebuild the queue/batcher pair
        self._queue_depth = queue_depth
        self._max_queue_wait = None if max_queue_wait_ms is None \
            else max_queue_wait_ms * 1e-3
        self._admission_timeout = None if admission_timeout_ms is None \
            else admission_timeout_ms * 1e-3
        self._max_wait = max_wait_ms * 1e-3
        # measurement state: survives restart_worker(), only the batcher it
        # advises is rebuilt
        self._policy = AdaptivePolicy(max_batch=max_batch,
                                      max_wait=self._max_wait) \
            if adaptive else None
        self.queue = self._make_queue()
        self.batcher = self._make_batcher()
        self._exec: dict[tuple, object] = {}   # (bucket, head) -> callable
        self._exec_lock = threading.Lock()
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

    def _make_queue(self) -> RequestQueue:
        return RequestQueue(self.spec, depth=self._queue_depth,
                            n_heads=self.n_heads, clock=self._clock,
                            metrics=self.metrics,
                            max_queue_wait=self._max_queue_wait,
                            admission_timeout=self._admission_timeout)

    def _make_batcher(self) -> SizeBinnedBatcher:
        return SizeBinnedBatcher(max_batch=self.max_batch,
                                 max_wait=self._max_wait,
                                 clock=self._clock, policy=self._policy)

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
        """Synchronous single-request forward on the same padded shape and
        plan a batched run uses (one real row, ``max_batch - 1`` inert pad
        rows), on the caller's stream — the parity reference for the
        batched-and-scattered path. Bypasses the queue/worker."""
        from .batching import assemble
        from .queue import Request, _as_sample
        canon, n_atoms, n_edges = _as_sample(sample)
        bucket = self.spec.bucket_for(n_atoms, n_edges)
        req = Request(sample=canon, head=head, bucket=bucket,
                      n_atoms=n_atoms, n_edges=n_edges, future=None,
                      t_submit=self._clock())
        ab = assemble([req], bucket, self.max_batch)
        e, f = self._executable(bucket, head)(ab.batch, own_streams=False)
        return {"energy": float(e[0]), "forces": f[0, :n_atoms]}

    def warmup(self, buckets=None) -> int:
        """Run the forward once (head 0) on every given bucket shape
        (default: the full grid), on the session's streams, so first
        requests meet warm caches and built kernels. Returns the number of
        shapes seen afterwards."""
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

    def jit_functions(self):
        """The session's forward callables (``repro``'s jit seam): one
        ``_Forward``, called as ``_predict``, whose ``cache_size()`` is the
        padded bucket shapes this session has run — the counterpart of
        ``repro``'s ``_predict._cache_size()``, read by
        ``repro_torch.analysis.RecompileSanitizer``."""
        return (_Forward(self),)

    def stats(self) -> dict:
        """Metrics snapshot + shape-cache occupancy (plain dict)."""
        out = self.metrics.snapshot()
        out["executable_cache"] = {
            "entries": len(self._exec),
            "compiled_shapes": len(self._shapes_compiled),
            "budget": self.spec.n_shapes * self.n_heads,
            "compile_budget": self.spec.n_shapes,
        }
        if self.plan_devices == 1:
            out["plan"] = {"mode": "single", "devices": 1,
                           "device": str(self.device)}
        else:
            out["plan"] = {"mode": "sharded", "devices": self.plan_devices,
                           "device": [str(e.device) for e in self._entries]}
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

    @staticmethod
    def _to_device(batch: dict, device: torch.device) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    def _on(self, entry: _Entry, own_streams: bool):
        """Where an entry's work is queued: the pool's stream for this
        thread and the entry's slot, or the caller's current stream on its
        device."""
        if entry.device.type != "cuda":
            return contextlib.nullcontext()
        if not own_streams:
            return torch.cuda.device(entry.device)
        stream = STREAMS.stream(entry.device, entry.slot)
        if threading.current_thread() is self._worker:
            self.worker_streams.add(stream)
        return torch.cuda.stream(stream)

    def _predict(self, head: int, batch: dict, own_streams: bool = True):
        """The forward of one assembled batch under ``head``: each mesh
        entry's rows copied in, run and copied out on its stream (every
        entry's forward is queued before the first copy back waits), the
        rows gathered in order. Returns host (energy, forces)."""
        chunks = _row_chunks(batch, len(self._entries))
        outs = []
        with torch.inference_mode():
            for ent, chunk in zip(self._entries, chunks):
                with self._on(ent, own_streams):
                    tb = self._to_device(chunk, ent.device)
                    feats = gnn.egnn_apply(ent.shared, tb, cfg=self.arch)
                    outs.append(heads_mod.branch_apply(
                        ent.heads[head], feats, tb["node_mask"],
                        cfg=self.arch))
            # every entry's copy back is queued before the host waits for
            # the first (pinned host memory: the copies do not block)
            host = []
            for ent, (e, f) in zip(self._entries, outs):
                with self._on(ent, own_streams):
                    host.append((e.to("cpu", non_blocking=True),
                                 f.to("cpu", non_blocking=True),
                                 _copied(ent.device)))
            for _, _, done in host:
                if done is not None:
                    done.synchronize()
        return (np.concatenate([e.numpy() for e, _, _ in host]),
                np.concatenate([f.numpy() for _, f, _ in host]))

    def _executable(self, bucket: tuple, head: int):
        """The per-(bucket, head) cache entry: the forward with this head
        bound. Counts a compilation only when the bucket SHAPE is new —
        other heads on a seen shape reuse it. The worker, ``warmup`` and
        ``predict_one`` may ask from three threads at once."""
        key = (bucket, head)
        with self._exec_lock:
            fn = self._exec.get(key)
            if fn is None:
                if bucket not in self._shapes_compiled:
                    self._shapes_compiled.add(bucket)
                    self.metrics.inc("compilations")

                def fn(batch, own_streams=True, _h=head):
                    return self._predict(_h, batch, own_streams)

                self._exec[key] = fn
        return fn

    # -- worker ---------------------------------------------------------------

    def _check_alive(self):
        if self._closed:
            raise ServeClosedError("ServeSession is closed")
        if self._worker_error is not None:
            raise ServeClosedError(
                "serve worker died — session is closed to new work "
                "(restart_worker() recovers it)") from self._worker_error

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

    # -- recovery -------------------------------------------------------------

    def restart_worker(self) -> bool:
        """Recover from a dead worker: clear the fail-fast state and stand
        up a fresh queue + batcher + worker thread. The shape cache and the
        params are kept, so recovery rebuilds nothing on the device. The
        crashed worker's pending futures were already failed — nothing is
        replayed. Returns True if a restart happened (False: the worker
        was healthy)."""
        if self._closed:
            raise ServeClosedError("ServeSession is closed")
        if self._worker_error is None and self._worker.is_alive():
            return False
        self._worker.join(timeout=5.0)
        self._worker_error = None
        self._inflight = []
        self.queue = self._make_queue()
        self.batcher = self._make_batcher()
        self._closing = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="serve-worker", daemon=True)
        self._worker.start()
        self.metrics.inc("worker_restarts")
        return True
