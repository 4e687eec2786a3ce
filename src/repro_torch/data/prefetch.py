"""Async double-buffered input pipeline (port of ``repro.data.prefetch``).

``Prefetcher`` moves batch assembly and host->device transfer onto a
background thread with a bounded queue (default depth 2: one batch in
flight to the device while the step consumes the previous one).
``DevicePlacer`` is the transform it runs on that thread: pinned host
memory, ``non_blocking`` copies on a side CUDA stream, and an event the
consumer's stream waits on before it reads the batch.

Determinism: the producer thread is the only caller of
``batcher.next_batch``, so the batch stream is byte-identical to the
synchronous path — prefetching changes when batches are built, never which.
When the wrapped batcher is checkpointable (``state()``/``restore()``), the
producer snapshots its state after drawing each batch and ships it with the
batch; ``Prefetcher.state()`` returns the snapshot of the last batch the
CONSUMER received, never crediting read-ahead, and ``restore(state)`` halts
the producer, discards its read-ahead, rewinds the batcher and restarts.
Hold ONE Prefetcher for the batcher's lifetime: ``close()`` discards the
batches already drawn. ``inject_producer_fault`` makes the producer die
before its next draw (the fault-injection hook of ``repro_torch.resilience``);
``restore(state())`` then restarts it and the stream goes on unchanged.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class DevicePlacer:
    """Prefetcher transform: a dict of numpy arrays -> a dict of tensors on
    ``device``. On CUDA each array is pinned and copied ``non_blocking`` on
    a side stream, and an event marks the copies' end; ``ready()`` (called
    by the consumer) makes the consumer's current stream wait on that event
    and records the tensors' use on it, so the caching allocator does not
    hand their memory out again while the step still reads them. Without
    the wait a step could read a batch before it lands."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def __call__(self, batch: dict):
        """Leaves already placed (tensors on ``device``, e.g. from a
        ``PrefetchingBatcher``) pass through as they are."""
        if not self.cuda:
            return {k: v.to(self.device) if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v)).to(self.device)
                    for k, v in batch.items()}, None
        if any(isinstance(v, torch.Tensor) for v in batch.values()):
            # placed leaves were made on this thread's current stream (a
            # PrefetchingBatcher's ready(), a BucketingBatcher's trim): the
            # side stream's event must cover them too
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True)
                   if isinstance(v, torch.Tensor) else
                   torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def ready(self, item) -> dict:
        """The placed batch, safe to read on the current stream."""
        out, done = item
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in out.values():
                t.record_stream(cur)
        return out


class Prefetcher:
    """Wrap any batcher (the ``next_batch()`` contract) with a depth-``depth``
    background producer.

    transform: optional callable applied to each batch ON THE PRODUCER
    THREAD — a ``DevicePlacer`` so host->device transfer overlaps the
    running step.

    Exceptions in the producer (including inside ``transform``) are captured
    and re-raised from ``next_batch()``. Use as a context manager or call
    ``close()`` to stop the producer; batches already queued are
    discarded."""

    _DONE = object()   # queued after a producer exception

    def __init__(self, batcher, *, transform=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.batcher = batcher
        self.transform = transform
        self.depth = depth
        # consumer-visible stream position: state as of the last batch
        # handed out by next_batch() (initially: before any batch)
        try:
            self._consumed_state = batcher.state()
            self._trackable = True
        except (AttributeError, TypeError):
            self._consumed_state = None
            self._trackable = False
        self._err: BaseException | None = None
        self._fault: BaseException | None = None
        self._closed = False
        self._start()

    def _start(self):
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce,
                                        name="prefetcher", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to close(); False if stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            while not self._stop.is_set():
                if self._fault is not None:
                    exc, self._fault = self._fault, None
                    raise exc
                b = self.batcher.next_batch()
                # snapshot after the draw, before placement: restoring to
                # it replays the stream from the NEXT batch
                st = self.batcher.state() if self._trackable else None
                if self.transform is not None:
                    b = self.transform(b)
                self._put((b, st))
        except BaseException as e:  # propagate to the consumer
            if isinstance(e, StopIteration):
                # re-raised bare from __next__ it would silently end a
                # for-loop over the Prefetcher: wrap it
                wrapped = RuntimeError(
                    "prefetch producer raised StopIteration "
                    "(exhausted/broken source?)")
                wrapped.__cause__ = e
                e = wrapped
            self._err = e
            self._put((self._DONE, None))

    def inject_producer_fault(self, exc: BaseException):
        """The producer raises ``exc`` before its next draw, as if it had
        crashed: the consumer sees it from ``next_batch()`` once the
        batches already queued are drained, and ``restore(state())``
        recovers the stream in place."""
        self._fault = exc

    def clear_producer_fault(self):
        """Drop an injected fault the producer has not raised yet: a
        recovery that another rank's dead producer forced covers it."""
        self._fault = None

    def next_batch(self):
        if self._err is not None and self._q.empty():
            raise self._err          # producer already died; don't block
        if self._stop.is_set():      # closed: drain or raise, never hang
            try:
                item, st = self._q.get_nowait()
            except queue.Empty:
                raise RuntimeError("Prefetcher is closed") from self._err
        else:
            item, st = self._q.get()
        if item is self._DONE:
            self._stop.set()
            raise self._err
        if st is not None:
            self._consumed_state = st
        return item

    # iterator protocol, so a Prefetcher drops into train_loop(batches=...)
    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    # -- checkpointing ------------------------------------------------------

    def state(self) -> dict:
        """Wrapped-batcher state as of the last batch the consumer received
        (producer read-ahead is NOT credited)."""
        if not self._trackable:
            raise TypeError(
                f"{type(self.batcher).__name__} has no state()/restore(); "
                "wrap a checkpointable batcher to checkpoint the pipeline")
        return self._consumed_state

    def restore(self, state: dict):
        """Rewind the pipeline to a ``state()`` snapshot: halt the producer,
        discard its read-ahead, restore the batcher, restart. Also revives a
        closed Prefetcher."""
        if not self._trackable:
            raise TypeError(
                f"{type(self.batcher).__name__} has no state()/restore()")
        self._halt()
        if self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer did not stop within the join timeout; "
                "cannot restore safely while it may still draw batches")
        self.batcher.restore(state)
        self._consumed_state = self.batcher.state()
        self._err = None
        self._closed = False
        self._start()

    # -- shutdown -----------------------------------------------------------

    def _halt(self):
        """Stop the producer and discard queued batches (drained twice: the
        first drain can free a slot the producer's in-flight put fills)."""
        self._stop.set()
        for _ in range(2):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)

    def close(self):
        """Stop the producer and discard queued batches; a second call is a
        no-op. ``restore()`` revives a closed Prefetcher."""
        if self._closed:
            return
        self._closed = True
        self._halt()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
