"""Multi-device serving scale-out: replica workers behind one admission
scheduler (port of ``repro.serve.scaleout``).

``ServeSession(mesh=...)`` (engine.py) scales a SINGLE worker by splitting
each assembled bin's rows over a mesh — good when bins run full. This
module scales the other axis: ``ReplicaServeSession`` runs one complete
engine (queue + binner + worker + params + streams) per ``ServeMesh`` from
``launch.mesh.make_replica_meshes``, fed by a size-aware
``ReplicaScheduler`` that routes each admitted request per (bucket, head)
to the least-loaded replica. No collective runs anywhere: the replicas
are independent and coordinate only at the host-side router, so they all
live in one process, each on its own device (or its own stream of a
shared card), and no process group is needed.

Routing is STICKY per (bucket, head) while the chosen replica's bin is
filling: the scheduler re-picks the least-loaded replica only after
``max_batch`` rows have been routed under a key, so scale-out does not
shred coalescing (a round-robin router would split a would-be-full bin
into n_replicas partial flushes).

Failure semantics degrade instead of failing: a dead replica (its queue
closes when its worker crashes) is marked and its keys fail over to live
replicas (counted as ``failovers``); only when EVERY replica is dead does
``submit`` raise. Shape budget: each replica counts its own shapes, so
the session-wide budget is ``distinct bucket shapes x n_replicas``.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.data.bucketing import BucketSpec

from .engine import ServeSession
from .metrics import ServeMetrics
from .queue import ServeClosedError


class ReplicaScheduler:
    """Size-aware least-loaded router with sticky (bucket, head) bins.

    Thread-safe (callers submit from many threads). Load is the number of
    routed-but-unresolved requests per replica, maintained by the session's
    future done-callbacks. ``route``/``complete``/``fail`` are the whole
    protocol:

      r = sched.route(key)       # reserves one outstanding slot on r
      ... queue.put ok ...       # request delivered; slot rides the future
      sched.complete(r)          # future resolved (any outcome)
      sched.fail(r)              # put() failed: replica dead, slot released
    """

    def __init__(self, n_replicas: int, *, max_batch: int = 8):
        if n_replicas < 1 or max_batch < 1:
            raise ValueError("need >= 1 replica and max_batch >= 1")
        self.n_replicas = n_replicas
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self.outstanding = [0] * n_replicas
        self.dead: set[int] = set()
        # key -> [replica, rows routed into the replica's current bin]
        self._assign: dict[tuple, list] = {}

    def route(self, key: tuple) -> int:
        """Pick the replica for one request under ``key`` and reserve an
        outstanding slot on it. Raises ``ServeClosedError`` when every
        replica is dead."""
        with self._lock:
            cur = self._assign.get(key)
            if cur is not None and cur[0] not in self.dead \
                    and cur[1] < self.max_batch:
                cur[1] += 1
                self.outstanding[cur[0]] += 1
                return cur[0]
            live = [r for r in range(self.n_replicas) if r not in self.dead]
            if not live:
                raise ServeClosedError("every serving replica is dead")
            # least outstanding; ties broken by index for determinism
            r = min(live, key=lambda i: (self.outstanding[i], i))
            self._assign[key] = [r, 1]
            self.outstanding[r] += 1
            return r

    def complete(self, replica: int):
        with self._lock:
            self.outstanding[replica] -= 1

    def fail(self, replica: int):
        """The routed put() failed: release the reservation, mark the
        replica dead, and forget its sticky assignments so live replicas
        take over its keys."""
        with self._lock:
            self.outstanding[replica] -= 1
            self.dead.add(replica)
            for key in [k for k, v in self._assign.items()
                        if v[0] == replica]:
                del self._assign[key]

    def revive(self, replica: int):
        with self._lock:
            self.dead.discard(replica)

    def snapshot(self) -> dict:
        with self._lock:
            return {"outstanding": list(self.outstanding),
                    "dead": sorted(self.dead),
                    "sticky_keys": len(self._assign)}


class ReplicaServeSession:
    """N independent ``ServeSession`` replicas behind one scheduler.

    Mirrors the single-session public API (``submit``/``submit_many``/
    ``predict_one``/``warmup``/``stats``/``close``/context manager). All
    replicas share ONE ``ServeMetrics`` (and one clock), so counters and
    latencies aggregate; per-replica detail lives under
    ``stats()["scheduler"]``.

    meshes: one entry per replica: a ``ServeMesh``
        (``launch.mesh.make_replica_meshes``) — a replica runs single-device
        when its mesh has one entry, rows split when it has several; the
        two scale-out modes compose — or None, a replica on ``device``.
    device: the device of every None entry; None = ``cuda`` (raises
        without a GPU).
    Remaining keyword arguments are forwarded to every ``ServeSession``.
    """

    def __init__(self, params: dict, arch, *, meshes,
                 spec: BucketSpec | None = None, max_batch: int = 8,
                 metrics: ServeMetrics | None = None,
                 clock=time.monotonic, seed: int = 0, device=None, **kw):
        if len(meshes) < 1:
            raise ValueError("need at least one replica mesh")
        self.metrics = metrics if metrics is not None else \
            ServeMetrics(seed=seed, clock=clock)
        self.replicas = []
        try:
            for m in meshes:
                self.replicas.append(ServeSession(
                    params, arch, spec=spec, max_batch=max_batch, mesh=m,
                    metrics=self.metrics, clock=clock, seed=seed,
                    device=device if m is None else None, **kw))
        except BaseException:
            for srv in self.replicas:   # stop the workers already started
                srv.close()
            raise
        self.spec = self.replicas[0].spec
        self.n_heads = self.replicas[0].n_heads
        # admission-only queue (never enqueued, never closed): validation
        # must not depend on any particular replica being alive
        self._admission = self.replicas[0]._make_queue()
        self.max_batch = max_batch
        self.scheduler = ReplicaScheduler(len(self.replicas),
                                          max_batch=max_batch)
        self._closed = False

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    # -- public API ----------------------------------------------------------

    def submit(self, sample: dict, head: int = 0):
        """Validate once (caller's thread), then route to the least-loaded
        live replica for this (bucket, head). Fails over past dead replicas;
        raises ``ServeClosedError`` only when none are left."""
        if self._closed:
            raise ServeClosedError("ReplicaServeSession is closed")
        req = self._admission.make_request(sample, head)
        key = (req.bucket, req.head)
        while True:
            r = self.scheduler.route(key)
            try:
                self.replicas[r].queue.put(req)
            except ServeClosedError:
                self.scheduler.fail(r)
                self.metrics.inc("failovers")
                continue
            break
        self.metrics.inc("routed")
        req.future.add_done_callback(
            lambda _f, _r=r: self.scheduler.complete(_r))
        return req.future

    def submit_many(self, samples, heads=0) -> list:
        if isinstance(heads, (int, np.integer)):
            heads = [int(heads)] * len(samples)
        if len(heads) != len(samples):
            raise ValueError(f"{len(samples)} samples vs {len(heads)} heads")
        return [self.submit(s, h) for s, h in zip(samples, heads)]

    def predict_one(self, sample: dict, head: int = 0) -> dict:
        """Synchronous single-request forward on the first LIVE replica —
        the bitwise parity reference every replica's batched rows are held
        to."""
        for r, srv in enumerate(self.replicas):
            if r not in self.scheduler.dead:
                return srv.predict_one(sample, head)
        raise ServeClosedError("every serving replica is dead")

    def warmup(self, buckets=None) -> int:
        """Warm every replica concurrently, one thread each (each replica
        runs on its own streams, so the warm-ups overlap on the device).
        Returns the shapes seen across replicas; re-raises the first
        replica's error."""
        errors: list = [None] * self.n_replicas

        def run(r):
            try:
                self.replicas[r].warmup(buckets)
            except Exception as err:   # handed to the caller below
                errors[r] = err

        threads = [threading.Thread(target=run, args=(r,),
                                    name=f"serve-warmup-{r}")
                   for r in range(self.n_replicas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for err in errors:
            if err is not None:
                raise err
        return sum(len(srv._shapes_compiled) for srv in self.replicas)

    def jit_functions(self):
        """Every replica's forward callable, as
        ``ServeSession.jit_functions`` gives them (each with the
        ``cache_size()`` of its replica's shapes)."""
        return tuple(f for srv in self.replicas for f in srv.jit_functions())

    def stats(self) -> dict:
        """Shared-metrics snapshot + aggregate shape-cache occupancy. The
        budget scales with PLANS (one shape cache per replica), not heads:
        ``n_shapes x n_replicas``."""
        out = self.metrics.snapshot()
        out["executable_cache"] = {
            "entries": sum(len(s._exec) for s in self.replicas),
            "compiled_shapes": sum(len(s._shapes_compiled)
                                   for s in self.replicas),
            "budget": self.spec.n_shapes * self.n_heads * self.n_replicas,
            "compile_budget": self.spec.n_shapes * self.n_replicas,
        }
        out["plan"] = {"mode": "replica", "n_replicas": self.n_replicas,
                       "devices": sum(s.plan_devices for s in self.replicas)}
        out["scheduler"] = self.scheduler.snapshot()
        if self.replicas[0]._policy is not None:
            out["adaptive"] = {f"replica{r}": s._policy.snapshot()
                               for r, s in enumerate(self.replicas)}
        return out

    def restart_workers(self) -> int:
        """Recover dead replicas (``ServeSession.restart_worker`` each) and
        put them back in rotation. Returns how many restarted."""
        if self._closed:
            raise ServeClosedError("ReplicaServeSession is closed")
        n = 0
        for r, srv in enumerate(self.replicas):
            if srv.restart_worker():
                n += 1
            self.scheduler.revive(r)
        return n

    def close(self):
        """Stop admissions on every replica first (no request can land in a
        doomed queue mid-shutdown), then drain them all. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for srv in self.replicas:
            srv.queue.close()
        for srv in self.replicas:
            srv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
