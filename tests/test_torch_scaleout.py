"""The port's multi-device serving (on the CPU) against ``repro``'s: the
replica scheduler, ``ReplicaServeSession``, ``ServeSession(mesh=)`` and
``make_replica_meshes``, with ``tests/test_serve_scaleout.py``'s contracts.

``repro`` runs its 8-device block on 8 forced host devices in a
subprocess; the port serves in one process, so the same assertions run
here on ``devices=["cpu"] * 8``: replica rows bitwise equal to a plain
single-device ``predict_one``, the shape budget ``shapes x replicas``,
parameter storage of its own per replica, ``close`` draining every future,
and the sharded plan's rows, budget and uneven ``max_batch``.

Held against ``repro``: every replica-served and sharded row within
``TOL = 1e-4`` of ``repro``'s single-device ``ServeSession.predict_one`` on
the same params (fp32 forward of two EGNN layers and the heads, sums in
another order), and ``ReplicaScheduler``'s decisions exactly equal to
``repro``'s. Sharded rows are bitwise equal to their own session's
``predict_one`` (the same plan) but only within ``TOL`` of a single-device
session: a chunk of max_batch / n rows may sum in another order than
max_batch rows (on the card #3 plans its split-K from the rows it gets)."""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.mtl import make_gfm_mtl
from repro.data.bucketing import BucketSpec as JBucketSpec
from repro.serve import ReplicaScheduler as JReplicaScheduler
from repro.serve import ServeClosedError as JServeClosedError
from repro.serve import ServeSession as JServeSession

from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic_atoms as t_atoms
from repro_torch.data.bucketing import BucketSpec
from repro_torch.kernels import _build
from repro_torch.kernels.egnn_edge import egnn_edge_agg
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.launch.mesh import ServeMesh, make_replica_meshes
from repro_torch.serve import (ReplicaScheduler, ReplicaServeSession,
                               ServeClosedError, ServeSession)
from repro_torch.serve.queue import DeadlineExceededError

JCFG = JArchConfig(name="scaleout-test", family="gnn", gnn_hidden=16,
                   gnn_layers=2, n_species=64, head_hidden=8, head_layers=2,
                   remat=False, compute_dtype=jnp.float32)
CFG = ArchConfig(name="scaleout-test", gnn_hidden=16, gnn_layers=2,
                 n_species=64, head_hidden=8, head_layers=2,
                 compute_dtype=torch.float32)
SPEC = BucketSpec((8, 16), (32, 64))
TOL = 1e-4
KEYS = ("species", "pos", "edge_src", "edge_dst", "node_mask", "edge_mask")


class FakeClock:
    """Deterministic injectable clock (same base for every component)."""

    def __init__(self, t0: float = 1e6):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


@pytest.fixture(scope="module")
def served():
    """The port's structures (equal to ``repro``'s, tests/test_torch_serve)
    and ``repro``'s params crossed over to tensors."""
    sources = t_atoms.source_dicts(t_atoms.generate_mixture(
        40, max_atoms=16, max_edges=64))
    jparams = make_gfm_mtl(JCFG, len(sources)).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, interop.to_torch(jparams), sources


def _sample(sources, t, i=0):
    s = sources[t]
    i = i % s["species"].shape[0]
    return {k: s[k][i] for k in KEYS}


def _jobs(sources, per_source=4):
    return [(t, _sample(sources, t, i)) for t in range(len(sources))
            for i in range(per_source)]


def _bitwise(got, ref) -> bool:
    return got["energy"] == ref["energy"] and \
        np.array_equal(got["forces"], ref["forces"])


def _first_leaf(tree) -> torch.Tensor:
    return next(iter(interop.leaves(tree).values()))


def _close(got, ref):
    np.testing.assert_allclose(got["energy"], ref["energy"], atol=TOL,
                               rtol=TOL)
    assert got["forces"].shape == ref["forces"].shape
    np.testing.assert_allclose(got["forces"], ref["forces"], atol=TOL,
                               rtol=TOL)


@pytest.fixture(scope="module")
def repro_rows(served):
    """``repro``'s single-device ``predict_one`` for every job."""
    jparams, _, sources = served
    with JServeSession(jparams, JCFG, spec=JBucketSpec((8, 16), (32, 64)),
                       max_batch=4) as ref:
        return [ref.predict_one(sm, head=t) for t, sm in _jobs(sources)]


# ---------------------------------------------------------------------------
# ReplicaScheduler: sticky least-loaded routing
# ---------------------------------------------------------------------------

def test_scheduler_sticks_to_one_replica_while_a_bin_fills():
    s = ReplicaScheduler(4, max_batch=3)
    key = ((8, 32), 0)
    first = [s.route(key) for _ in range(3)]
    assert len(set(first)) == 1            # one bin, one replica
    # bin full: the 4th route re-picks the least loaded, another replica
    assert s.route(key) != first[0]


def test_scheduler_routes_to_least_loaded():
    s = ReplicaScheduler(3, max_batch=8)
    r0 = s.route(((8, 32), 0))
    r1 = s.route(((8, 32), 1))             # fresh key: avoids loaded r0
    assert r1 != r0
    s.complete(r0)
    assert s.outstanding[r0] == 0
    assert s.route(((16, 64), 2)) == r0    # back to the now-idle replica


def test_scheduler_failover_and_all_dead():
    s = ReplicaScheduler(2, max_batch=4)
    key = ((8, 32), 0)
    r = s.route(key)
    s.fail(r)                              # put() failed: dead + released
    assert s.outstanding[r] == 0 and r in s.dead
    r2 = s.route(key)                      # sticky entry dropped, re-routed
    assert r2 != r
    s.fail(r2)
    with pytest.raises(ServeClosedError, match="dead"):
        s.route(key)
    s.revive(r)
    assert s.route(key) == r


def test_scheduler_rejects_an_empty_pool():
    with pytest.raises(ValueError):
        ReplicaScheduler(0)


@pytest.mark.parametrize("n_replicas,max_batch,seed",
                         [(2, 2, 0), (3, 4, 1), (8, 8, 2), (5, 3, 3)])
def test_scheduler_decides_as_repro_does(n_replicas, max_batch, seed):
    """One seeded sequence of route / complete / fail / revive calls on
    both schedulers: the same replica picked at every step, the same
    refusals, the same snapshots."""
    rng = np.random.default_rng(seed)
    ours = ReplicaScheduler(n_replicas, max_batch=max_batch)
    theirs = JReplicaScheduler(n_replicas, max_batch=max_batch)
    keys = [((a, e), h) for a in (8, 16) for e in (32, 64) for h in range(3)]
    held: list = []                        # replicas holding a slot
    for _ in range(400):
        op = rng.choice(["route"] * 6 + ["complete"] * 3 + ["fail", "revive"])
        if op == "route":
            key = keys[int(rng.integers(len(keys)))]
            try:
                got = ours.route(key)
            except ServeClosedError:
                got = "closed"
            try:
                want = theirs.route(key)
            except JServeClosedError:
                want = "closed"
            assert got == want
            if got != "closed":
                held.append(got)
        elif op in ("complete", "fail") and held:
            r = held.pop(int(rng.integers(len(held))))
            getattr(ours, op)(r)
            getattr(theirs, op)(r)
        elif op == "revive":
            r = int(rng.integers(n_replicas))
            ours.revive(r)
            theirs.revive(r)
        assert ours.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------------
# serving meshes
# ---------------------------------------------------------------------------

def test_make_replica_meshes_cuts_the_device_list():
    devs = [f"cpu:{i}" for i in range(8)]
    meshes = make_replica_meshes(4, devices_per_replica=2, devices=devs)
    assert [tuple(str(d) for d in m.devices) for m in meshes] == \
        [tuple(devs[2 * r:2 * r + 2]) for r in range(4)]
    assert all(isinstance(m, ServeMesh) and m.shape == {"data": 2}
               for m in meshes)
    # one device named more than once: each entry is its own stream
    rep = make_replica_meshes(3, devices=["cpu"] * 3)
    assert [m.devices for m in rep] == [(torch.device("cpu"),)] * 3
    with pytest.raises(ValueError, match="devices"):
        make_replica_meshes(3, devices_per_replica=3, devices=devs)
    with pytest.raises(ValueError):
        make_replica_meshes(0, devices=devs)


def test_make_replica_meshes_needs_a_gpu_unless_devices_are_named():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: devices=None takes its cards")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_replica_meshes(1)


def test_session_on_a_one_device_mesh_serves(served):
    """mesh= with one entry pins the session to that device — the replica
    building block."""
    _, params, sources = served
    mesh = make_replica_meshes(1, devices=["cpu"])[0]
    with ServeSession(params, CFG, spec=SPEC, max_batch=3,
                      mesh=mesh) as srv:
        sm = _sample(sources, 0)
        got = srv.submit(sm, head=0).result(timeout=60)
        assert _bitwise(got, srv.predict_one(sm, head=0))
        plan = srv.stats()["plan"]
        assert (plan["mode"], plan["devices"], plan["device"]) == \
            ("single", 1, "cpu")
        (fwd,) = srv.jit_functions()    # the forward, with its shape count
        assert fwd.cache_size() == len(srv._shapes_compiled) == 1
    with pytest.raises(ValueError, match="not both"):
        ServeSession(params, CFG, spec=SPEC, mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# ReplicaServeSession lifecycle (two replicas on the CPU)
# ---------------------------------------------------------------------------

def test_replica_session_parity_and_routing(served):
    _, params, sources = served
    with ReplicaServeSession(params, CFG, meshes=[None, None], spec=SPEC,
                             max_batch=4, max_wait_ms=2.0,
                             device="cpu") as srv:
        jobs = [(t, _sample(sources, t, i))
                for t in range(3) for i in range(3)]
        futs = [(t, sm, srv.submit(sm, head=t)) for t, sm in jobs]
        for t, sm, fut in futs:
            assert _bitwise(fut.result(timeout=60),
                            srv.predict_one(sm, head=t))
        st = srv.stats()
        assert st["counters"]["routed"] == len(jobs)
        assert st["plan"]["mode"] == "replica"
        assert st["executable_cache"]["compiled_shapes"] <= \
            st["executable_cache"]["compile_budget"] == SPEC.n_shapes * 2
        assert len(srv.jit_functions()) == 2


def _crash_replica(srv, r, sm):
    """Crash replica ``r`` deterministically: its next batcher.add raises,
    the worker's fail-fast handler closes its queue. Blocks until the
    queue is observably closed."""
    def boom(req):
        raise RuntimeError("injected replica fault")
    srv.replicas[r].batcher.add = boom
    # the trigger is the least-loaded pick for its key; the crash handler
    # must fail it
    fut = srv.submit(sm, head=r % srv.n_heads)
    assert isinstance(fut.exception(timeout=60), RuntimeError)
    deadline = time.monotonic() + 10.0
    while not srv.replicas[r].queue.closed:
        assert time.monotonic() < deadline, "crashed queue never closed"
        time.sleep(0.005)


def test_replica_failover_then_all_dead_then_restart(served):
    _, params, sources = served
    srv = ReplicaServeSession(params, CFG, meshes=[None, None], spec=SPEC,
                              max_batch=8, max_wait_ms=1.0, device="cpu")
    try:
        sm = _sample(sources, 0)
        _crash_replica(srv, 0, sm)
        # the sticky pick still points at replica 0: its put fails, it is
        # marked dead and the request fails over to replica 1, served right
        got = srv.submit(sm, head=0).result(timeout=60)
        assert _bitwise(got, srv.predict_one(sm, head=0))
        assert 0 in srv.scheduler.dead
        assert srv.metrics.counters["failovers"] >= 1
        _crash_replica(srv, 1, sm)
        with pytest.raises(ServeClosedError, match="dead"):
            srv.submit(sm, head=0)
        with pytest.raises(ServeClosedError, match="dead"):
            srv.predict_one(sm, head=0)
        # recovery: a fresh queue + batcher + worker per dead replica (the
        # crash patch dies with the old batcher)
        assert srv.restart_workers() == 2
        assert srv.scheduler.dead == set()
        got = srv.submit(sm, head=0).result(timeout=60)
        assert _bitwise(got, srv.predict_one(sm, head=0))
        assert srv.stats()["counters"]["worker_restarts"] == 2
    finally:
        srv.close()
    with pytest.raises(ServeClosedError):
        srv.restart_workers()


def test_replica_shed_and_close_semantics(served):
    _, params, sources = served
    fc = FakeClock()
    srv = ReplicaServeSession(params, CFG, meshes=[None, None], spec=SPEC,
                              max_batch=4, max_queue_wait_ms=50.0, clock=fc,
                              device="cpu")
    # quiesce replica 0's worker so _file is ours, then shed a stale request
    srv.replicas[0].close()
    req = srv._admission.make_request(_sample(sources, 0), 0)
    assert req.deadline == pytest.approx(fc() + 0.05)
    fc.advance(0.1)                        # aged past the deadline
    assert srv.replicas[0]._file(req) is None
    with pytest.raises(DeadlineExceededError):
        req.future.result(timeout=0)
    assert srv.metrics.counters["shed_deadline"] == 1
    srv.close()
    with pytest.raises(ServeClosedError):
        srv.submit(_sample(sources, 0), head=0)
    srv.close()                            # idempotent re-entry


def test_replica_session_needs_a_gpu_unless_cpu_is_asked_for(served):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None legitimately runs there")
    _, params, _ = served
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaServeSession(params, CFG, meshes=[None, None], spec=SPEC)
    # the first replica fails before any worker starts; none is left over
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# eight entries on the CPU: repro's subprocess block, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replica8(served):
    """8 replicas of one device each, 20 mixed-head jobs; then a burst
    closed at once under 4 replicas."""
    _, params, sources = served
    jobs = _jobs(sources)
    with ServeSession(params, CFG, spec=SPEC, max_batch=4,
                      device="cpu") as plain:
        refs = [plain.predict_one(sm, head=t) for t, sm in jobs]
    rep = ReplicaServeSession(
        params, CFG, meshes=make_replica_meshes(8, devices=["cpu"] * 8),
        spec=SPEC, max_batch=4, max_wait_ms=2.0)
    try:
        warm = rep.warmup()
        outs = [f.result(timeout=300)
                for f in [rep.submit(sm, head=t) for t, sm in jobs]]
        st = rep.stats()
        storages = {_first_leaf(s._entries[0].shared).untyped_storage()
                    .data_ptr() for s in rep.replicas}
    finally:
        rep.close()
    rep2 = ReplicaServeSession(
        params, CFG, meshes=make_replica_meshes(4, devices=["cpu"] * 4),
        spec=SPEC, max_batch=4, max_wait_ms=100.0)
    futs = [rep2.submit(sm, head=t) for t, sm in jobs]
    rep2.close()
    try:
        rep2.submit(jobs[0][1], head=0)
        after_close = "accepted"
    except ServeClosedError as e:
        after_close = type(e).__name__
    return {"jobs": jobs, "refs": refs, "outs": outs, "stats": st,
            "warm": warm, "storages": storages, "close_futs": futs,
            "after_close": after_close}


def test_replica_rows_bitwise_match_single_device(replica8):
    """Every replica-served row equals the plain single-device predict_one
    BITWISE: routing moves rows, it must not change a bit."""
    r = replica8
    assert all(_bitwise(o, ref) for o, ref in zip(r["outs"], r["refs"]))
    assert r["stats"]["counters"]["routed"] == len(r["jobs"])


def test_replica_rows_match_repro(replica8, repro_rows):
    for (t, _), got, want in zip(replica8["jobs"], replica8["outs"],
                                 repro_rows):
        _close(got, want)


def test_replica_compile_budget_is_shapes_times_plans(replica8):
    st = replica8["stats"]
    cache = st["executable_cache"]
    assert replica8["warm"] == SPEC.n_shapes * 8
    assert st["counters"]["compilations"] <= cache["compile_budget"] \
        == SPEC.n_shapes * 8
    assert cache["entries"] <= cache["budget"]
    assert st["plan"] == {"mode": "replica", "n_replicas": 8, "devices": 8}


def test_each_replica_owns_its_own_params(replica8):
    assert len(replica8["storages"]) == 8
    assert replica8["stats"]["scheduler"]["outstanding"] == [0] * 8


def test_replica_close_drains_everything(replica8):
    futs = replica8["close_futs"]
    assert all(f.done() for f in futs)
    assert all(f.exception() is None for f in futs)
    assert replica8["after_close"] == "ServeClosedError"


@pytest.fixture(scope="module", params=[2, 4, 8])
def sharded(request, served):
    """Rows split over an n-entry CPU mesh at max_batch=8."""
    n = request.param
    _, params, sources = served
    jobs = _jobs(sources)
    mesh = make_replica_meshes(1, devices_per_replica=n,
                               devices=["cpu"] * n)[0]
    with ServeSession(params, CFG, spec=SPEC, max_batch=8,
                      device="cpu") as plain:
        single = [plain.predict_one(sm, head=t) for t, sm in jobs]
    with ServeSession(params, CFG, spec=SPEC, max_batch=8, mesh=mesh,
                      max_wait_ms=2.0) as sh:
        outs = [f.result(timeout=300)
                for f in [sh.submit(sm, head=t) for t, sm in jobs]]
        own = [sh.predict_one(sm, head=t) for t, sm in jobs]
        st = sh.stats()
        storages = {_first_leaf(e.shared).untyped_storage().data_ptr()
                    for e in sh._entries}
    return {"n": n, "mesh": mesh, "jobs": jobs, "outs": outs, "own": own,
            "single": single, "stats": st, "storages": storages}


def test_sharded_rows_bitwise_match_own_predict_one(sharded):
    assert all(_bitwise(o, r) for o, r in zip(sharded["outs"],
                                              sharded["own"]))
    assert sharded["stats"]["plan"]["mode"] == "sharded"
    assert sharded["stats"]["plan"]["devices"] == sharded["n"]


def test_sharded_rows_within_tol_of_single_device(sharded):
    for got, want in zip(sharded["outs"], sharded["single"]):
        _close(got, want)


def test_sharded_rows_match_repro(sharded, repro_rows):
    for got, want in zip(sharded["outs"], repro_rows):
        _close(got, want)


def test_sharded_compile_budget_is_the_bucket_grid(sharded, served):
    st = sharded["stats"]
    assert st["counters"]["compilations"] <= SPEC.n_shapes
    assert st["executable_cache"]["compiled_shapes"] <= SPEC.n_shapes
    assert st["executable_cache"]["compile_budget"] == SPEC.n_shapes
    # the params are copied once per distinct device: one CPU copy
    assert len(sharded["storages"]) == 1
    _, params, _ = served
    with pytest.raises(ValueError, match="tile evenly"):
        ServeSession(params, CFG, spec=SPEC, max_batch=3 * sharded["n"] // 2,
                     mesh=sharded["mesh"])


# ---------------------------------------------------------------------------
# launch counts from several threads
# ---------------------------------------------------------------------------

def test_launch_counts_are_exact_across_threads():
    """8 threads add to one wrapper's count at once, with the interpreter
    switching threads as often as it can: no increment is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    per_thread = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(per_thread)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 8 * per_thread


def test_plain_path_from_8_threads_counts_nothing_and_agrees():
    """The kernels' plain versions (CPU tensors) run from 8 threads at once:
    they launch nothing, so the counts stay 0, and every thread gets the
    bits one thread alone gets."""
    rng = np.random.default_rng(0)
    B, A, E, H = 2, 8, 32, 16
    h = torch.from_numpy(rng.standard_normal((B, A, H)).astype(np.float32))
    pos = torch.from_numpy(rng.standard_normal((B, A, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, A, (B, E)))
    dst = torch.from_numpy(rng.integers(0, A, (B, E)))
    em = torch.from_numpy(rng.random((B, E)) < 0.8)
    phi = {"fc0": {"w": torch.randn(2 * H + 1, H, generator=torch.Generator(
        ).manual_seed(1)), "b": torch.zeros(H)},
        "fc1": {"w": torch.randn(H, H, generator=torch.Generator(
        ).manual_seed(2)), "b": torch.zeros(H)}}
    msg = torch.from_numpy(rng.standard_normal((B, E, H)).astype(np.float32))
    counters = (egnn_edge_agg, segment_sum)
    for c in counters:
        c.launches = 0

    def run():
        with torch.inference_mode():
            return (egnn_edge_agg(h, pos, src, dst, em, phi),
                    segment_sum(msg, dst, A, edge_mask=em))
    want = run()
    got = [None] * 8

    def worker(i):
        got[i] = run()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    assert [c.launches for c in counters] == [0, 0]


# ---------------------------------------------------------------------------
# the serving streams' pool
# ---------------------------------------------------------------------------

class _HandlePool:
    """PyTorch's cuBLAS handle pool, as the pool sees it: a thread takes a
    handle on its first ask (the last one handed back, else a new one)
    and hands it back when it ends."""

    def __init__(self):
        self.free, self.made = [], 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def handle(self, device):
        if not hasattr(self.local, "h"):
            with self.lock:
                if self.free:
                    self.local.h = self.free.pop()
                else:
                    self.made += 1
                    self.local.h = self.made
        return self.local.h

    def release(self):
        with self.lock:
            self.free.append(self.local.h)


def test_stream_pool_hands_back_the_same_streams():
    """Five cycles of 8 threads, each asking for its streams at two slots
    and ending: every cycle after the first hands back streams the first
    made, so the (handle, stream) pairs, and with them PyTorch's cuBLAS
    workspaces, stay the first cycle's; two live threads never share a
    stream; one thread gets one stream a (device, slot), ask after ask."""
    from repro_torch.serve.engine import StreamPool
    handles = _HandlePool()
    made = []
    pool = StreamPool(make=lambda d: made.append(object()) or made[-1],
                      handle=handles.handle)
    pairs, sizes = [], []
    for _ in range(5):
        got, start = [None] * 8, threading.Barrier(8)

        def run(i):
            start.wait()             # all 8 live at once
            s = [pool.stream("cuda:0", slot) for slot in (0, 1)]
            assert pool.stream("cuda:0", 0) is s[0]
            got[i] = (handles.handle("cuda:0"), s)
            start.wait()
            handles.release()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len({id(s) for _, ss in got for s in ss}) == 16
        pairs.append({(h, id(s)) for h, ss in got for s in ss})
        sizes.append(len(pool))
    assert sizes == [16] * 5 and len(made) == 16 and handles.made == 8
    assert all(p == pairs[0] for p in pairs)
    # another device: streams of its own
    assert pool.stream("cuda:1", 0) is not pool.stream("cuda:0", 0)
