"""The port's sanitizers and memory model (``repro_torch.analysis``,
``repro_torch.launch.memory``) against ``repro``'s.

  * ``RecompileSanitizer`` and ``ThreadSanitizer`` give ``repro``'s counts,
    reports, exceptions and violation kinds on the same fake seams and
    threads (as ``tests/test_sanitizers.py`` and
    ``tests/test_thread_sanitizer.py`` set them up);
  * the port's seams: a 20-step small-width ``Session`` adds 0 after its
    first step and a quarantine's rebuild counts 1; a serving session's
    ``jit_functions()`` count its shapes; the kernel plans' caches and
    ``kernels._build``;
  * the port's thread contracts: a ``Prefetcher`` has one producer across
    ``restore()``; a ``RequestQueue`` is drained by one worker, and two
    workers draining it are caught;
  * ``hier_group_memory`` equals ``repro``'s for the placements the solver
    gives for the paper's sizes on 8, 5 and 2 devices, and
    ``param_bytes_per_device`` a group's bytes as ``repro`` counts them;
  * a placement change on 4 gloo ranks rebuilds the group step on exactly
    the ranks whose (heads, ranks) key changed (``repro``'s
    ``test_hier_placement_change_rebuilds_exactly_affected`` keeps head 2's
    executable; here rank 3, head 2's, keeps its step).

The 4 ranks run in one subprocess (this file as a script; the ranks import
it, so ``repro`` and JAX are imported inside the tests only).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch import analysis as tan

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PAPER_DEVICES = (8, 5, 2)


def _both():
    """(id, analysis module) for each package."""
    import repro.analysis as jan
    return [("repro", jan), ("repro_torch", tan)]


# ---------------------------------------------------------------------------
# RecompileSanitizer: the same accounting as repro's
# ---------------------------------------------------------------------------

class FakeJit:
    """A cache-size seam (``CompiledStep.cache_size``'s duck type)."""

    def __init__(self, n=0):
        self.n = n

    def cache_size(self):
        return self.n


class FakeSession:
    """``compiled_functions()`` re-read live; ``rebuild()`` swaps in a new
    step, as a quarantine does."""

    def __init__(self):
        self.step = FakeJit(1)

    def compiled_functions(self):
        return (self.step,)

    def rebuild(self):
        self.step = FakeJit(1)


def _recompile_trace(an):
    """What one package's sanitizer says over a fixed script of cache
    growth: counts, reports and the exceptions it raises."""
    out = []

    def raised(fn):
        try:
            fn()
        except an.RecompileBudgetError as e:
            return ("budget", "step=2" in str(e) or "session=1" in str(e))
        except KeyError:
            return ("key",)
        return None

    fn = FakeJit(n=3)                       # warmed before tracking
    san = an.RecompileSanitizer(budget=1)
    out += [san.track(fn, "step"), san.compilations()]
    fn.n = 4
    out += [san.compilations(), san.report(), raised(san.check)]
    fn.n = 5
    out += [san.compilations(), raised(san.check)]
    un = an.RecompileSanitizer(budget=0)
    out += [un.track(object()), un.report()]

    def ctx(exc):
        fn = FakeJit()
        with an.RecompileSanitizer(budget=0, label="unit") as s:
            s.track(fn)
            fn.n = 1
            if exc:
                raise KeyError("boom")
    out += [raised(lambda: ctx(False)), raised(lambda: ctx(True))]
    sess = FakeSession()
    live = an.RecompileSanitizer(budget=0)
    live.track_session(sess)
    out.append(live.compilations())
    sess.rebuild()
    out += [live.compilations(), live.report(), raised(live.check)]
    return out


def test_recompile_sanitizer_matches_repro():
    (_, jan), (_, port) = _both()
    want = _recompile_trace(jan)
    assert _recompile_trace(port) == want
    assert want[1:5] == [0, 1, {"step": 1}, None]


def test_recompile_sanitizer_reads_lru_caches_and_build():
    import functools

    from repro_torch.kernels import _build
    from repro_torch.kernels.egnn_edge import gemm_plan

    @functools.lru_cache(maxsize=None)
    def plan(n):
        return n + 1
    san = tan.RecompileSanitizer(budget=1)
    assert san.track(plan, "plan") and san.track(_build, "build")
    assert san.track(gemm_plan.fwd_splits, "fwd_splits")
    plan(1), plan(1)
    assert san.report() == {"plan": 1, "build": 0, "fwd_splits": 0}
    plan(2)
    with pytest.raises(tan.RecompileBudgetError, match="plan=2"):
        san.check()
    assert _build.cache_size() == len(_build._libs)


# ---------------------------------------------------------------------------
# ThreadSanitizer: the same violations as repro's
# ---------------------------------------------------------------------------

class Counter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1


class SlowWorker:
    """work() holds both callers inside simultaneously via the barrier."""

    def __init__(self, barrier):
        self.barrier = barrier

    def work(self):
        self.barrier.wait(timeout=5)


def _violations(an, fn):
    san = an.ThreadSanitizer()
    fn(san)
    try:
        san.check()
    except an.ThreadContractViolation as e:
        return sorted((v.kind, v.target) for v in e.violations)
    return []


def _tracked_lock(an):
    lock, seen = an.TrackedLock(), []
    seen.append(lock.held())
    with lock:
        with lock:                       # reentrant bookkeeping
            seen.append(lock.held())
        seen.append(lock.held())
        t = threading.Thread(target=lambda: seen.append(lock.held()))
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    seen.append(lock.held())
    return seen


def _guarded(an, locked):
    def run(san):
        lock = an.TrackedLock()
        c = san.guard_attrs(Counter(), ("n",), lock)
        if locked:
            with lock:
                c.bump()
        else:
            c.bump()
    return run


def _concurrent(an):
    def run(san):
        w = san.wrap_mutual_exclusion(SlowWorker(threading.Barrier(2)),
                                      ("work",))
        ts = [threading.Thread(target=w.work) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
            assert not t.is_alive()
    return run


def _sequential(an):
    class W:
        def a(self):
            self.b()                     # same-thread re-entry

        def b(self):
            pass

    def run(san):
        w = san.wrap_mutual_exclusion(W(), ("a", "b"))
        w.a()
        t = threading.Thread(target=w.a)     # a LATER thread
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    return run


@pytest.mark.parametrize("case", ["tracked_lock", "guarded", "unguarded",
                                  "concurrent", "sequential"])
def test_thread_sanitizer_matches_repro(case):
    def result(an):
        if case == "tracked_lock":
            return _tracked_lock(an)
        make = {"guarded": lambda a: _guarded(a, True),
                "unguarded": lambda a: _guarded(a, False),
                "concurrent": _concurrent, "sequential": _sequential}[case]
        return _violations(an, make(an))
    (_, jan), (_, port) = _both()
    want = result(jan)
    assert result(port) == want
    expected = {"tracked_lock": [False, True, True, False, False],
                "guarded": [], "sequential": [],
                "unguarded": [("unguarded-read", "Counter.n"),
                              ("unguarded-write", "Counter.n")],
                "concurrent": [("concurrent-entry", "SlowWorker.work")]}
    assert want == expected[case]


# ---------------------------------------------------------------------------
# the port's thread contracts
# ---------------------------------------------------------------------------

class CountBatcher:
    def __init__(self):
        self.i = 0
        self.threads = set()

    def next_batch(self):
        self.threads.add(threading.current_thread())
        self.i += 1
        return {"i": self.i}

    def state(self):
        return {"i": self.i}

    def restore(self, st):
        self.i = st["i"]


def test_prefetcher_single_producer_through_restore():
    from repro_torch.data.prefetch import Prefetcher
    san = tan.ThreadSanitizer()
    batcher = san.wrap_mutual_exclusion(CountBatcher(), ("next_batch",),
                                        group="prefetch-producer")
    with Prefetcher(batcher, depth=2) as pf:
        first = [pf.next_batch()["i"] for _ in range(3)]
        snap = pf.state()
        more = [pf.next_batch()["i"] for _ in range(2)]
        pf.restore(snap)                 # halts the producer, starts anew
        replay = [pf.next_batch()["i"] for _ in range(2)]
    assert first == [1, 2, 3] and replay == more
    assert len(batcher.threads) == 2     # two producer generations ...
    san.check()                          # ... whose draws never overlapped


def test_prefetcher_contract_catches_second_producer():
    from repro_torch.data.prefetch import Prefetcher
    san = tan.ThreadSanitizer()
    barrier = threading.Barrier(2)

    class BlockingBatcher(CountBatcher):
        def next_batch(self):
            if self.i < 2:               # pin the FIRST two drawers inside
                try:
                    barrier.wait(timeout=5)
                except threading.BrokenBarrierError:
                    pass
            return super().next_batch()

    batcher = san.wrap_mutual_exclusion(BlockingBatcher(), ("next_batch",),
                                        group="prefetch-producer")
    with Prefetcher(batcher, depth=1) as pf:
        rogue = threading.Thread(target=batcher.next_batch)
        rogue.start()
        rogue.join(timeout=10)
        assert not rogue.is_alive()
        pf.next_batch()
    with pytest.raises(tan.ThreadContractViolation,
                       match="prefetch-producer"):
        san.check()


def _queue():
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.serve.queue import RequestQueue
    return RequestQueue(BucketSpec((8,), (16,)), depth=8)


def _sample(n=3):
    return {"species": np.ones(n, np.int32),
            "pos": np.zeros((n, 3), np.float32)}


def test_request_queue_single_worker_drain_clean():
    san = tan.ThreadSanitizer()
    q = _queue()
    futures = [q.submit(_sample()) for _ in range(4)]
    san.wrap_mutual_exclusion(q, ("get", "drain"), group="engine-worker")

    def worker():
        while (req := q.get(timeout=0.05)) is not None:
            req.future.set_result({"ok": True})
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert all(f.result(timeout=1)["ok"] for f in futures)
    q.close()
    assert q.drain() == []               # the closing drain, same thread
    san.check()


def test_request_queue_two_workers_draining_violate():
    san = tan.ThreadSanitizer()
    q = _queue()
    san.wrap_mutual_exclusion(q, ("get", "drain"), group="engine-worker")
    start = threading.Barrier(2)

    def worker():
        start.wait(timeout=5)
        q.get(timeout=0.5)               # empty queue: both block inside
    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive()
    with pytest.raises(tan.ThreadContractViolation, match="engine-worker"):
        san.check()


# ---------------------------------------------------------------------------
# the recompile seams: Session and ServeSession
# ---------------------------------------------------------------------------

def _arch():
    import torch

    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="g", family="gnn", gnn_hidden=24, gnn_layers=2,
                      n_species=64, head_hidden=12, head_layers=2,
                      remat=False, compute_dtype=torch.float32)


def _sources(n_tasks=3):
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(
        24, max_atoms=10, max_edges=40,
        sources=["ani1x", "qm7x", "mptrj", "alexandria"][:n_tasks]))


def test_session_adds_nothing_after_its_first_step():
    """20 fixed-shape steps build the step once: tracked after the first,
    19 more add 0; a quarantine's rebuild counts exactly 1 and breaks a
    budget of 0 (``repro``'s ``test_track_session_sees_rebuilt_step``)."""
    from repro_torch.engine import CompiledStep, Session, SessionConfig
    scfg = SessionConfig(model="gfm-mtl", arch=_arch(), steps=1,
                         batch_per_task=8, lr=3e-3, verbose=False)
    with Session(scfg, sources=_sources(), device="cpu") as sess:
        assert isinstance(sess.step_fn, CompiledStep)
        assert [f.cache_size() for f in sess.compiled_functions()] == [1]
        sess.run()
        san = tan.RecompileSanitizer(budget=0, label="20-step session")
        san.track_session(sess)
        sess.cfg = scfg.replace(steps=19)
        res = sess.run()
        assert san.compilations() == 0, san.report()
        san.check()
        assert np.isfinite(res.final_loss) and res.state.step == 20
        sess.quarantine_tasks([2])
        sess.cfg = scfg.replace(steps=1)
        sess.run()
        assert san.report() == {"session": 1}
        with pytest.raises(tan.RecompileBudgetError, match="session=1"):
            san.check()


def test_serving_jit_functions_count_shapes():
    """``jit_functions()`` carries the shapes a session (or each replica)
    has run: warm-up builds them, requests on warmed shapes add 0."""
    from repro_torch.configs import hydragnn_gfm
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.serve import ReplicaServeSession
    cfg = hydragnn_gfm.smoke()
    params = gfm_mtl_init(cfg, 3, seed=0)
    spec = BucketSpec((8, 16), (32, 64))
    one = {"species": np.ones(5, np.int32),
           "pos": np.arange(15, dtype=np.float32).reshape(5, 3)}
    with ReplicaServeSession(params, cfg, meshes=[None, None], spec=spec,
                             max_batch=4, device="cpu") as rep:
        fns = rep.jit_functions()
        assert [f.cache_size() for f in fns] == [0, 0]
        rep.warmup()
        san = tan.RecompileSanitizer(budget=0)
        assert all(san.track(f, f"replica {r}") for r, f in enumerate(fns))
        assert [f.cache_size() for f in fns] == [spec.n_shapes] * 2
        futs = [rep.submit(one, head=h) for h in (0, 1, 2, 0)]
        assert all(np.isfinite(f.result(timeout=60)["energy"])
                   for f in futs)
        san.check()


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------

def _paper_loads():
    from repro_torch.data.synthetic_atoms import PAPER_REL_SIZES
    return list(PAPER_REL_SIZES.values())


def _templates():
    """hydragnn-gfm at full width, 5 heads: repro's ``eval_shape`` tree and
    the port's ``meta`` tree."""
    import jax

    from repro.configs import get as j_get
    from repro.core import make_gfm_mtl
    from repro_torch.configs import get as t_get
    from repro_torch.core.mtl import gfm_mtl_init
    j = jax.eval_shape(make_gfm_mtl(j_get("hydragnn-gfm"), 5).init,
                       jax.random.PRNGKey(0))
    t = gfm_mtl_init(t_get("hydragnn-gfm"), 5, device="meta")
    return j, t


@pytest.mark.parametrize("n_devices", PAPER_DEVICES)
def test_hier_group_memory_matches_repro(n_devices):
    """The solver's placement for the paper's source sizes on 8, 5 and 2
    devices: the same groups in both packages, and the same per-group
    dicts from ``hier_group_memory``; each group's ``param_bytes`` is the
    bytes of the tree its ranks hold (``param_bytes_per_device``, as
    ``repro`` counts a group's template)."""
    import jax

    from repro.core import solve_placement as j_solve
    from repro.engine.hier import _take_heads
    from repro.launch.hlo_stats import hier_group_memory as j_mem
    from repro.launch.hlo_stats import param_bytes_per_device as j_bytes
    from repro_torch.core.balancing import solve_placement
    from repro_torch.core.taskpar import take_heads
    from repro_torch.launch.memory import (hier_group_memory,
                                           param_bytes_per_device)
    jp = j_solve(n_devices, _paper_loads())
    tp = solve_placement(n_devices, _paper_loads())
    assert (tp.groups, tp.device_counts) == (jp.groups, jp.device_counts)
    jt, tt = _templates()
    shared = param_bytes_per_device(tt["shared"])
    head = param_bytes_per_device(tt["heads"]) // 5
    assert shared == j_bytes(jt["shared"])
    assert head * 5 == j_bytes(jt["heads"])
    mem = hier_group_memory(tp, shared, head)
    assert mem == j_mem(jp, shared, head)
    assert hier_group_memory(tp, shared, [head] * 5, opt_factor=1.0) == \
        j_mem(jp, shared, [head] * 5, opt_factor=1.0)
    for g, heads in zip(mem, tp.groups):
        j_group = {"shared": jt["shared"], "heads": jax.tree_util.tree_map(
            lambda l: _take_heads(l, heads), jt["heads"])}
        t_group = {"shared": tt["shared"],
                   "heads": take_heads(tt["heads"], heads)}
        assert param_bytes_per_device(t_group) == j_bytes(j_group) == \
            g["param_bytes"]


def test_plan_placement_of_one_device_and_hier_plans():
    from repro_torch.core import HeadPlacement, MTPConfig
    from repro_torch.engine import ShardingPlan
    from repro_torch.launch.memory import plan_placement
    p = HeadPlacement(groups=((0,), (1, 2)), device_counts=(3, 1))
    assert plan_placement(ShardingPlan(placement=p)) is p
    one = plan_placement(ShardingPlan(mtp=MTPConfig(n_tasks=3)))
    assert (one.groups, one.device_counts) == (((0, 1, 2),), (1,))
    with pytest.raises(ValueError, match="head_bytes"):
        from repro_torch.launch.memory import hier_group_memory
        hier_group_memory(p, 100, [1, 2])


# ---------------------------------------------------------------------------
# a placement change on 4 gloo ranks
# ---------------------------------------------------------------------------

P1 = (((0,), (1,), (2,)), (2, 1, 1))     # ranks {0,1} {2} {3}
P2 = (((0,), (1,), (2,)), (1, 2, 1))     # ranks {0} {1,2} {3}: head 2 kept


def _swap_rank(rank, world):
    """One rank: a hierarchical Session under P1 for a step, then P2 and a
    step, its step functions tracked live from the start."""
    from repro_torch.core import HeadPlacement
    from repro_torch.engine import Session, SessionConfig
    p1, p2 = (HeadPlacement(groups=g, device_counts=c) for g, c in (P1, P2))
    scfg = SessionConfig(model="gfm-mtl", arch=_arch(), steps=1,
                         batch_per_task=8, lr=3e-3, verbose=False,
                         placement=p1)
    with Session(scfg, sources=_sources(), device="cpu") as sess:
        san = tan.RecompileSanitizer(budget=1, label="hier placement swap")
        san.track_session(sess)
        sess.run()
        first = san.compilations()
        sess.set_placement(p2)
        sess.run()
        return {"rank": rank, "first": first, "after": san.compilations(),
                "functions": len(sess.compiled_functions()),
                "heads": list(sess.plan.shard.heads)}


def test_hier_placement_change_rebuilds_exactly_affected():
    """(2, 1, 1) -> (1, 2, 1) over 4 ranks: ranks 0–2 change their (heads,
    ranks) key and build a second group step; rank 3 (head 2 on rank {3}
    under both) keeps its one — the port's counterpart of repro's 4 -> 6
    executables with head 2's reused."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    ranks = json.loads(line[0][len("RESULT "):])
    assert [r["first"] for r in ranks] == [1, 1, 1, 1]
    assert [r["after"] for r in ranks] == [2, 2, 2, 1]
    assert [r["functions"] for r in ranks] == [2, 2, 2, 1]
    assert [r["heads"] for r in ranks] == [[0], [1], [1], [2]]


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_ranks
    print("RESULT " + json.dumps(run_ranks(_swap_rank, 4, device="cpu",
                                           timeout=240)))
