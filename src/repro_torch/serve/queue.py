"""Bounded async request queue with per-request futures (a copy of
``repro.serve.queue``; the port does not import ``repro``).

The serving sibling of ``repro.data.prefetch.Prefetcher``: one producer/
consumer handoff with a bounded ``queue.Queue``, the same responsive-put
discipline (short timeouts so shutdown never deadlocks a blocked caller)
and the same idempotent ``close()`` contract. The direction is reversed —
many caller threads produce *requests*, one engine worker consumes them —
so the per-item result channel is a ``concurrent.futures.Future`` resolved
by the worker after the batched forward.

Admission control happens here, at ``submit()`` time, not in the engine:
the request's real atom/edge counts (mask sums) are binned through
``BucketSpec.bucket_for`` immediately, so a structure that exceeds the
bucket grid's cap fails fast in the caller's thread with
``BucketOverflowError`` — it never occupies queue capacity, and the engine
only ever sees requests it has a compiled shape for.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.data.bucketing import BucketSpec

# the single-structure sample contract (unbatched; (A,)/(A,3)/(E,) arrays)
SAMPLE_KEYS = ("species", "pos", "edge_src", "edge_dst",
               "node_mask", "edge_mask")


class ServeClosedError(RuntimeError):
    """The queue/session is closed (shutdown, or the worker died). A
    RuntimeError whose message contains "closed", so callers matching the
    historical ``RuntimeError`` contract keep working."""


class DeadlineExceededError(RuntimeError):
    """The request's latency budget expired: either ``submit()`` could not
    find a queue slot within ``admission_timeout`` (raised in the caller's
    thread), or the request aged past ``max_queue_wait`` in the queue and
    the worker shed it (set on the request's future)."""


@dataclasses.dataclass
class Request:
    """One admitted property-prediction request.

    ``sample`` holds the validated single-structure arrays; ``bucket`` is
    the (A_pad, E_pad) bin assigned at admission; ``head`` names the
    per-source branch whose prediction was asked for. Timestamps (engine
    clock) drive the metrics stages: ``t_submit`` set here, ``t_dequeue`` /
    ``t_done`` stamped by the engine worker."""
    sample: dict
    head: int
    bucket: tuple
    n_atoms: int
    n_edges: int
    future: Future
    t_submit: float
    t_dequeue: float = 0.0
    t_done: float = 0.0
    # engine-clock instant after which the worker sheds this request
    # instead of computing it (None = no deadline)
    deadline: float | None = None


def _as_sample(sample: dict) -> tuple[dict, int, int]:
    """Validate + canonicalize one structure dict -> (sample, n_atoms,
    n_edges). Masks are derived when absent (species>0 / in-range edge
    endpoints), dtypes are normalized so every admitted sample hits the
    same compiled signature."""
    if "species" not in sample or "pos" not in sample:
        raise ValueError(f"sample needs at least species+pos; "
                         f"got keys {sorted(sample)}")
    species = np.asarray(sample["species"], np.int32)
    pos = np.asarray(sample["pos"], np.float32)
    if species.ndim != 1 or pos.shape != species.shape + (3,):
        raise ValueError(
            f"sample must be a SINGLE structure: species (A,), pos (A,3); "
            f"got species {species.shape}, pos {pos.shape}")
    A = species.shape[0]
    src = np.asarray(sample.get("edge_src", np.zeros(0)), np.int32)
    dst = np.asarray(sample.get("edge_dst", np.zeros(0)), np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"edge_src/edge_dst must be matching (E,) arrays; "
                         f"got {src.shape} vs {dst.shape}")
    nm = np.asarray(sample["node_mask"], bool) if "node_mask" in sample \
        else species > 0
    em = np.asarray(sample["edge_mask"], bool) if "edge_mask" in sample \
        else (src < A) & (dst < A)
    if nm.shape != species.shape or em.shape != src.shape:
        raise ValueError("mask shapes must match species/edge arrays")
    n_atoms, n_edges = int(nm.sum()), int(em.sum())
    # the repo-wide kernel contract: pad rows TRAILING. Enforced here so
    # batch assembly (which slices [:A_pad]) can never drop real content —
    # a scrambled sample is the CALLER's bug and fails in the caller's
    # thread, not the engine worker's
    if not (nm[:n_atoms].all() and em[:n_edges].all()):
        raise ValueError("sample masks must be front-packed "
                         "(real atoms/edges first, pad trailing)")
    out = {"species": species, "pos": pos, "edge_src": src, "edge_dst": dst,
           "node_mask": nm, "edge_mask": em}
    return out, n_atoms, n_edges


class RequestQueue:
    """Bounded admission queue feeding one engine worker.

    ``submit()`` is thread-safe and applies backpressure: when ``depth``
    requests are already queued it blocks (responsively — it keeps checking
    for shutdown) rather than growing without bound. ``close()`` stops
    admissions immediately and is an idempotent no-op on re-entry (the
    ``Prefetcher.close`` discipline); requests already queued stay queued so
    the engine can drain them."""

    def __init__(self, spec: BucketSpec, *, depth: int = 256,
                 n_heads: int = 1, clock=time.monotonic, metrics=None,
                 max_queue_wait: float | None = None,
                 admission_timeout: float | None = None):
        assert depth >= 1, f"queue depth must be >= 1, got {depth}"
        assert max_queue_wait is None or max_queue_wait > 0
        assert admission_timeout is None or admission_timeout > 0
        self.spec = spec
        self.n_heads = n_heads
        self._clock = clock
        self._metrics = metrics
        # per-request queue-wait budget (seconds): the worker sheds requests
        # that aged past it instead of computing stale answers under overload
        self.max_queue_wait = max_queue_wait
        # submit-side budget (seconds): bound how long a caller blocks on
        # backpressure before shedding in ITS thread
        self.admission_timeout = admission_timeout
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = threading.Event()

    def submit(self, sample: dict, head: int = 0) -> Future:
        """Admit one structure for prediction by ``head``; returns a Future
        resolving to ``{"energy": float, "forces": (n_atoms, 3)}``.

        Raises ``BucketOverflowError`` (oversized structure), ``ValueError``
        (malformed sample / unknown head), ``ServeClosedError`` (queue
        closed) or ``DeadlineExceededError`` (no slot freed within
        ``admission_timeout``) — all in the caller's thread, before any
        queue slot is taken."""
        return self.put(self.make_request(sample, head)).future

    def make_request(self, sample: dict, head: int = 0) -> Request:
        """Validate + canonicalize + bin one structure into an admitted
        ``Request`` WITHOUT enqueuing it. Stamps ``t_submit``/``deadline``
        on the queue clock. The replica scheduler uses this to validate once
        in the caller's thread before routing the request to whichever
        replica's queue it picks (``put``)."""
        if self._closed.is_set():
            raise ServeClosedError("RequestQueue is closed")
        try:
            if not 0 <= head < self.n_heads:
                raise ValueError(f"head {head} out of range "
                                 f"(engine has {self.n_heads} heads)")
            canon, n_atoms, n_edges = _as_sample(sample)
            bucket = self.spec.bucket_for(n_atoms, n_edges)
        except ValueError:
            if self._metrics is not None:
                self._metrics.inc("rejected")
            raise
        t_submit = self._clock()
        return Request(sample=canon, head=head, bucket=bucket,
                       n_atoms=n_atoms, n_edges=n_edges, future=Future(),
                       t_submit=t_submit,
                       deadline=None if self.max_queue_wait is None
                       else t_submit + self.max_queue_wait)

    def put(self, req: Request) -> Request:
        """Enqueue an already-validated ``Request`` with backpressure.
        Raises ``ServeClosedError``/``DeadlineExceededError`` like
        ``submit``; admission-timeout is measured from ``req.t_submit`` so
        a rerouted request keeps its original budget."""
        while True:
            if self._closed.is_set():
                raise ServeClosedError("RequestQueue closed while waiting "
                                       "for a free slot")
            if self.admission_timeout is not None and \
                    self._clock() - req.t_submit > self.admission_timeout:
                if self._metrics is not None:
                    self._metrics.inc("shed_admission")
                raise DeadlineExceededError(
                    f"no queue slot freed within admission_timeout="
                    f"{self.admission_timeout}s — server is saturated")
            try:
                self._q.put(req, timeout=0.05)
                break
            except queue.Full:
                continue
        if self._metrics is not None:
            self._metrics.inc("submitted")
        return req

    def submit_many(self, samples, heads) -> list[Future]:
        """Vector ``submit``: heads may be one int for all samples or a
        per-sample sequence."""
        if isinstance(heads, (int, np.integer)):
            heads = [int(heads)] * len(samples)
        if len(heads) != len(samples):
            raise ValueError(f"{len(samples)} samples vs {len(heads)} heads")
        return [self.submit(s, h) for s, h in zip(samples, heads)]

    # -- consumer side (engine worker) --------------------------------------

    def get(self, timeout: float | None = None) -> Request | None:
        """Next queued request, or None on timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list[Request]:
        """Everything currently queued, without blocking."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def __len__(self) -> int:
        return self._q.qsize()

    # -- shutdown -----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self):
        """Stop admissions. Idempotent no-op on re-entry; already-queued
        requests remain for the engine to drain."""
        self._closed.set()
