"""In-process serving metrics: counters + staged latency histograms (a
copy of ``repro.serve.metrics``; the port does not import ``repro``).

No external metrics stack in the container, so this is the plain-dict
analogue of a Prometheus client: thread-safe counters and per-stage latency
reservoirs, snapshotted by benchmarks (``benchmarks/bench_serve.py``),
tests, and callers that want to scrape.

The request lifecycle is instrumented at four stages (docs/serving.md has
the lifecycle diagram):

  * ``queue_wait`` — submit() to the worker dequeuing the request;
  * ``assembly``   — host-side pad-and-stack of a bucket batch;
  * ``compute``    — the compiled forward, blocked until ready;
  * ``e2e``        — submit() to the request future resolving.

Percentiles come from a **deterministic reservoir**: fixed capacity,
Vitter's algorithm R driven by a seeded ``np.random.default_rng`` — two
runs over the same observation stream produce the same reservoir, so
benchmark JSON and test assertions are reproducible (no wall-clock or
global-RNG coupling). Up to ``capacity`` observations the reservoir is
exact; beyond it, a uniform sample.
"""
from __future__ import annotations

import threading
import time

import numpy as np

STAGES = ("queue_wait", "assembly", "compute", "e2e")


class Reservoir:
    """Deterministic fixed-size uniform sample of a float stream."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        assert capacity >= 1
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._buf: list[float] = []
        self.count = 0          # observations offered (not just retained)
        self.total = 0.0
        self.max = 0.0

    def add(self, x: float):
        x = float(x)
        self.count += 1
        self.total += x
        self.max = max(self.max, x)
        if len(self._buf) < self.capacity:
            self._buf.append(x)
        else:
            # algorithm R: keep slot j with probability capacity/count
            j = int(self._rng.integers(0, self.count))
            if j < self.capacity:
                self._buf[j] = x

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        if not self._buf:
            return {f"p{q}": 0.0 for q in qs}
        arr = np.asarray(self._buf)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        out = self.percentiles()
        out.update(count=self.count, max=self.max,
                   mean=self.total / self.count if self.count else 0.0)
        return out


class ServeMetrics:
    """Counters + per-stage latency reservoirs for one ``ServeSession``.

    Counter vocabulary (all monotonic):
      submitted / completed / failed / rejected — request outcomes
      shed_admission / shed_deadline            — load shedding (no queue
                                                  slot in time / aged past
                                                  the queue-wait budget)
      worker_failures / worker_restarts         — engine-worker crashes and
                                                  restart_worker() recoveries
      batches                                   — compiled executions run
      batch_slots / batch_real                  — padded vs occupied rows
      compilations                              — distinct compiled shapes
      routed / failovers                        — replica-scheduler decisions
                                                  (multi-device mode only)
    ``snapshot()`` returns a plain nested dict (JSON-serializable) with
    latencies in **milliseconds**.

    ``clock`` is the ONE serve time base (engine/queue/batcher share it, see
    docs/serving.md): rates in ``snapshot()`` are measured against it only —
    never mixed with another base.
    """

    def __init__(self, *, reservoir_capacity: int = 4096, seed: int = 0,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self.counters: dict[str, int] = {
            k: 0 for k in ("submitted", "completed", "failed", "rejected",
                           "shed_admission", "shed_deadline",
                           "worker_failures", "worker_restarts",
                           "batches", "batch_slots", "batch_real",
                           "compilations", "routed", "failovers")}
        # one seed per stage, derived deterministically from the base seed
        self.stages = {name: Reservoir(reservoir_capacity, seed=seed + i)
                       for i, name in enumerate(STAGES)}

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, stage: str, seconds: float):
        with self._lock:
            self.stages[stage].add(seconds * 1e3)   # stored as ms

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            lat = {name: {f"{k}_ms" if k in ("p50", "p95", "p99", "max",
                                             "mean") else k: v
                          for k, v in r.summary().items()}
                   for name, r in self.stages.items()}
            elapsed = self._clock() - self._t0
        occ = (counters["batch_real"] / counters["batch_slots"]
               if counters["batch_slots"] else 0.0)
        # rates against the injected clock ONLY (same base as t_submit /
        # deadlines) — cross-base arithmetic is exactly the skew this
        # module's clock injection exists to rule out
        rates = {"elapsed_s": elapsed}
        if elapsed > 0:
            rates["submitted_per_s"] = counters["submitted"] / elapsed
            rates["completed_per_s"] = counters["completed"] / elapsed
        return {"counters": counters, "latency": lat,
                "batch_occupancy": occ, "rates": rates}
