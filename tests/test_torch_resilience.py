"""The port's fault tolerance (``repro_torch.resilience``) against
``repro.resilience``, on the same seeded inputs.

  * retry, fault schedules (explicit and ``FaultSchedule.random``) and the
    batch injectors: equal to ``repro``'s (delays, ticks and kinds exactly;
    injected values bit for bit);
  * the guarded step on a scripted loss stream: step, EMA, ``good`` and
    ``trips`` exactly ``repro``'s, params within 1e-6 x max(1, |ref|);
    on the model (smoke width, one clean and one NaN batch): step,
    ``good`` and ``trips`` exact, params within 1e-4 relative, the EMA
    within 1e-5 relative (the two losses differ in fp32 rounding), and a
    tripped step leaves params, moments and step bitwise as they were; a
    guarded run that never trips is bitwise the unguarded run;
  * ``StepGuard``'s attribution, ``CheckpointManager``'s retries,
    retention and best-metric choice, as ``repro``'s;
  * a full-state resilient checkpoint (params, moments, step, rng, guard)
    written by either package restores in the other, f32 bit for bit;
  * the soak: one run hit by every fault class (NaN gradients, a corrupt
    batch, a producer kill, checkpoint-write failures, a preemption, then
    ``resume()``) ends with params, moments and step bitwise equal to the
    port's clean run, and its report's event kinds and ticks equal
    ``repro``'s faulted run's;
  * quarantine, the preemption flush, an unrecoverable write and the
    signal handler; ``train_loop``'s ``logger=`` and ``should_stop=``.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import resilience as jres
from repro.configs import hydragnn_gfm as j_gfm
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import MTPConfig
from repro.core import make_gfm_mtl as j_make_gfm_mtl
from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.data.synthetic_atoms import generate_all, source_dicts
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.engine import ShardingPlan
from repro.engine import TrainState as JTrainState
from repro.optim import adamw as j_adamw

from repro_torch import interop
from repro_torch import resilience as tres
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mtl import make_gfm_mtl
from repro_torch.engine import (GuardState, Session, SessionConfig,
                                TrainState, make_guarded_train_step,
                                make_step)
from repro_torch.engine.state import StepOutput, prng_key
from repro_torch.optim import adamw
from repro_torch.train.loop import MetricLogger, train_loop

CFG = ArchConfig(name="g", family="gnn", gnn_hidden=16, gnn_layers=2,
                 n_species=64, head_hidden=8, head_layers=2,
                 compute_dtype=torch.float32)
J_CFG = JArchConfig(name="g", family="gnn", gnn_hidden=16, gnn_layers=2,
                    n_species=64, head_hidden=8, head_layers=2,
                    remat=False, compute_dtype=jnp.float32)
STEPS = 14


def _sources():
    return source_dicts(generate_all(18, max_atoms=8, max_edges=24,
                                     sources=["ani1x", "qm7x", "mptrj"]))


# ---------------------------------------------------------------------------
# retry, schedules, injectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fails", [0, 2, 5])
def test_with_retry_matches_repro(fails):
    def run(mod):
        sleeps, calls, seen = [], [0], []

        def flaky():
            calls[0] += 1
            if calls[0] <= fails:
                raise OSError(f"transient {calls[0]}")
            return "ok"
        fn = mod.with_retry(flaky, attempts=4, base_delay=0.5, factor=3.0,
                            sleep=sleeps.append,
                            on_retry=lambda i, e: seen.append(i))
        try:
            out = fn()
        except mod.RetryError as e:
            out = ("RetryError", e.attempts, str(e.__cause__))
        return out, sleeps, calls[0], seen
    assert run(tres) == run(jres)
    with pytest.raises(ValueError):
        tres.with_retry(lambda: 0, attempts=0)
    with pytest.raises(KeyError):      # not transient: no retry
        tres.with_retry(lambda: {}["k"], sleep=lambda s: None)()


@pytest.mark.parametrize("seed,rates", [(0, None), (3, {"nan_grad": 0.2,
                                                         "preempt": 0.05}),
                                        (11, {k: 0.3 for k in jres.KINDS})])
def test_fault_schedules_match_repro(seed, rates):
    t = tres.FaultSchedule.random(seed, 60, rates)
    j = jres.FaultSchedule.random(seed, 60, rates)
    as_rows = lambda s: [(f.tick, f.kind, f.source, f.magnitude,  # noqa
                          f.repeats) for tick in sorted(s._by_tick)
                         for f in s._by_tick[tick]]
    assert as_rows(t) == as_rows(j) and len(t) == len(j)
    for tick in range(1, 61):
        assert [f.kind for f in t.take(tick)] == \
            [f.kind for f in j.take(tick)]
    assert t.pending() == j.pending() == 0
    d = {3: "nan_grad", 1: "preempt", 7: "kill_producer"}
    assert as_rows(tres.FaultSchedule.from_dict(d)) == \
        as_rows(jres.FaultSchedule.from_dict(d))
    assert tres.KINDS == jres.KINDS
    with pytest.raises(ValueError):
        tres.Fault(tick=0, kind="nan_grad")
    with pytest.raises(ValueError):
        tres.Fault(tick=1, kind="meteor")


@pytest.mark.parametrize("source", [None, 1])
def test_batch_injectors_match_repro(source):
    b = JGroupBatcher(_sources(), 3, seed=0).next_batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    pairs = [(tres.poison_nan(tb, source), jres.poison_nan(jb, source)),
             (tres.scale_floats(tb, 1e4, source),
              jres.scale_floats(jb, 1e4, source)),
             (tres.corrupt_batch(tb, tres.Fault(1, "corrupt_batch",
                                                source=source)),
              jres.corrupt_batch(jb, jres.Fault(1, "corrupt_batch",
                                                source=source))),
             (tres.zero_task_slices(tb, [] if source is None else [source]),
              jres.zero_task_slices(jb, [] if source is None
                                    else [source]))]
    for got, want in pairs:
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
            assert got[k].dtype == interop.to_torch(np.asarray(
                want[k])).dtype
    for k, v in b.items():          # the placed batch itself is untouched
        np.testing.assert_array_equal(tb[k].numpy(), v)
    with pytest.raises(ValueError, match="not a batch-corruption"):
        tres.corrupt_batch(tb, tres.Fault(1, "preempt"))


# ---------------------------------------------------------------------------
# the guarded step
# ---------------------------------------------------------------------------

GUARDS = {"default": {}, "warm3-spike2": dict(warmup_steps=3,
                                              spike_factor=2.0),
          "slack": dict(warmup_steps=1, spike_factor=1.5, spike_slack=0.5,
                        ema_decay=0.9)}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_guarded_step_matches_repro_on_a_scripted_stream(guard):
    rng = np.random.default_rng(0)
    losses = (rng.standard_normal(60) * 3 + 10).astype(np.float32)
    losses[[7, 30]] = np.nan
    losses[[20, 41]] = 500.0
    grads = rng.standard_normal((60, 4, 3)).astype(np.float32)
    grads[45, 0, 0] = np.inf
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    lj, gj = jnp.asarray(losses), jnp.asarray(grads)
    jstep = jax.jit(jres.make_guarded_train_step(
        lambda p, i: (lj[i], {}, {"w": gj[i]}), j_adamw(1e-2),
        jres.GuardConfig(**GUARDS[guard])))
    tstep = make_guarded_train_step(
        lambda p, i: (torch.tensor(losses[i]), {},
                      {"w": torch.from_numpy(grads[i])}),
        adamw(1e-2), tres.GuardConfig(**GUARDS[guard]))
    js = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, p0),
                            j_adamw(1e-2), guard=jres.GuardState.init())
    ts = TrainState.create(interop.to_torch(p0), adamw(1e-2),
                           guard=GuardState.init())
    trips = 0
    for i in range(60):
        js, jo = jstep(js, jnp.int32(i))
        ts, to = tstep(ts, i)
        assert ts.step == int(js.step) == ts.opt_state.step
        assert ts.guard.ema == np.float32(js.guard.ema), i
        assert (ts.guard.good, ts.guard.trips) == (int(js.guard.good),
                                                   int(js.guard.trips))
        assert float(to.metrics["guard_ok"]) == float(jo.metrics["guard_ok"])
        assert float(to.metrics["guard_threshold"]) == \
            float(jo.metrics["guard_threshold"])
        trips += float(to.metrics["guard_ok"]) == 0
        np.testing.assert_allclose(ts.params["w"].numpy(),
                                   np.asarray(js.params["w"]), rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(
                                       np.asarray(js.params["w"])).max())))
    assert trips >= 5


@pytest.fixture(scope="module")
def model_pair():
    sources = source_dicts(generate_all(8, max_atoms=16, max_edges=64,
                                        seed=0))[:3]
    jmodel = j_make_gfm_mtl(j_gfm.smoke(), 3)
    tmodel = make_gfm_mtl(t_gfm.smoke().replace(segment_sum_impl="fused"), 3)
    params = jmodel.init(jax.random.PRNGKey(1))
    batch = JGroupBatcher(sources, 4, seed=2).next_batch()
    return jmodel, tmodel, params, batch


def test_guarded_step_on_the_model_matches_repro(model_pair):
    jmodel, tmodel, params, batch = model_pair
    gcfg = dict(warmup_steps=1, spike_factor=3.0)
    plan = ShardingPlan(mtp=MTPConfig(n_tasks=3), donate=False)
    jstep = plan.compile(jres.make_guarded_step(
        jmodel, j_adamw(1e-3), plan, guard=jres.GuardConfig(**gcfg)))
    tstep = tres.make_guarded_step(tmodel, adamw(1e-3),
                                   guard=tres.GuardConfig(**gcfg))
    js = JTrainState.create(params, j_adamw(1e-3),
                            guard=jres.GuardState.init())
    ts = TrainState.create(interop.to_torch(params), adamw(1e-3),
                           guard=GuardState.init())
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for kind in ("clean", "clean", "nan", "spike", "clean"):
        jx, tx = jb, tb
        if kind == "nan":
            jx, tx = jres.poison_nan(jb, 0), tres.poison_nan(tb, 0)
        elif kind == "spike":
            jx, tx = jres.scale_floats(jb, 1e3), tres.scale_floats(tb, 1e3)
        before = ts
        js, jo = jstep(js, jx)
        ts, to = tstep(ts, tx)
        ok = float(to.metrics["guard_ok"])
        assert ok == float(jo.metrics["guard_ok"]) == (kind == "clean")
        assert ts.step == int(js.step)
        assert (ts.guard.good, ts.guard.trips) == (int(js.guard.good),
                                                   int(js.guard.trips))
        np.testing.assert_allclose(ts.guard.ema, float(js.guard.ema),
                                   rtol=1e-5)
        if not ok:     # a trip keeps every tree and the step by reference
            assert ts.params is before.params
            assert ts.opt_state is before.opt_state
            assert ts.step == before.step
        for k, v in interop.leaves(jax.tree_util.tree_map(
                np.asarray, js.params)).items():
            got = interop.leaves(ts.params)[k].numpy()
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-4 * max(
                float(np.abs(v).max()), 1e-30), err_msg=k)


def test_guarded_run_that_never_trips_is_the_unguarded_run(model_pair):
    _, tmodel, params, batch = model_pair
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g = tres.make_guarded_step(tmodel, adamw(1e-3),
                               guard=tres.GuardConfig(warmup_steps=100))
    u = make_step(tmodel, adamw(1e-3))
    sg = TrainState.create(interop.to_torch(params), adamw(1e-3),
                           guard=GuardState.init())
    su = TrainState.create(interop.to_torch(params), adamw(1e-3))
    for _ in range(3):
        sg, _ = g(sg, tb)
        su, _ = u(su, tb)
    for tree in ("params",):
        for k, v in interop.leaves(getattr(su, tree)).items():
            assert torch.equal(interop.leaves(getattr(sg, tree))[k], v), k
    for a, b in ((sg.opt_state.m, su.opt_state.m),
                 (sg.opt_state.v, su.opt_state.v)):
        assert all(torch.equal(interop.leaves(a)[k], v)
                   for k, v in interop.leaves(b).items())
    assert sg.step == su.step == 3 and sg.guard.good == 3


@pytest.mark.parametrize("pts", [[1.0, np.nan, 2.0], [1.0, 7.0, 2.0],
                                 [np.inf, np.nan, 0.5], None])
def test_step_guard_attribution_matches_repro(pts):
    def observe(mod, ok):
        g = mod.StepGuard(mod.GuardConfig(max_consecutive_trips=2,
                                          quarantine_after=2), n_sources=3)
        m = {"guard_ok": np.float32(ok)}
        if pts is not None:
            m["per_task_loss"] = np.asarray(pts, np.float32)
        outs = [g.observe(StepOutput(loss=0.0, metrics=m)) for _ in range(2)]
        return (outs, g.should_rollback(), g.quarantine_candidates(),
                g.report())
    for ok in (0.0, 1.0):
        assert observe(tres, ok) == observe(jres, ok)
    g = tres.StepGuard(tres.GuardConfig(quarantine_after=1), n_sources=2)
    g.observe(StepOutput(0.0, {"guard_ok": torch.tensor(0.0),
                               "per_task_loss": torch.tensor([1., 3.])}))
    assert g.quarantine_candidates() == [1]
    g.mark_quarantined([1])
    g.on_rollback()
    assert g.quarantine_candidates() == [] and g.rollbacks == 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tiny_state(seed, guard=True):
    rng = np.random.default_rng(seed)
    p = {"shared": {"w": rng.standard_normal((5, 4)).astype(np.float32)},
         "heads": {"b": rng.standard_normal((3, 2)).astype(np.float32)}}
    st = TrainState.create(interop.to_torch(p), adamw(1e-3),
                           rng=prng_key(seed),
                           guard=GuardState.init() if guard else None)
    return st._replace(step=seed)


def test_checkpoint_manager_retries_prunes_and_keeps_the_best(tmp_path):
    sleeps = []
    mgr = tres.CheckpointManager(str(tmp_path), tres.CheckpointPolicy(
        every_steps=2, keep_last=2), attempts=3, base_delay=0.1,
        sleep=sleeps.append)
    for step, metric in ((1, 5.0), (2, 1.0), (3, 4.0), (4, 3.0)):
        if step == 3:
            mgr.arm_failures(2)
        mgr.save(_tiny_state(step), datapipe={"kind": "x", "s": step},
                 metric=metric)
    assert mgr.io_retries == 2 and sleeps == [0.1, 0.2]
    assert [s for s, _ in mgr.checkpoints()] == [2, 3, 4]   # 2 is the best
    assert mgr.best() == mgr.path_for(2) and mgr.latest_step() == 4
    assert len(mgr.save_ms) == 4
    path, back = mgr.load_latest(template=_tiny_state(0))
    want = _tiny_state(4)
    assert path == mgr.path_for(4) and back.step == 4
    assert back.opt_state.step == 0 and isinstance(back.step, int)
    np.testing.assert_array_equal(back.rng, prng_key(4))
    assert back.guard == GuardState.init()
    assert torch.equal(back.params["shared"]["w"], want.params["shared"]["w"])
    mgr.arm_failures(5)
    with pytest.raises(tres.RetryError):
        mgr.save(_tiny_state(6))
    with pytest.raises(FileNotFoundError):
        tres.CheckpointManager(str(tmp_path / "empty")).load_latest(want)
    with pytest.raises(ValueError):
        prng_key(-1)
    assert np.array_equal(prng_key(7), np.asarray(jax.random.PRNGKey(7)))


def _res(mod, ckpt_dir, faults=None, **guard_kw):
    gk = dict(warmup_steps=3, spike_factor=50.0, max_consecutive_trips=1)
    gk.update(guard_kw)
    return mod.ResilienceConfig(
        ckpt_dir=str(ckpt_dir), guard=mod.GuardConfig(**gk),
        policy=mod.CheckpointPolicy(every_steps=5, keep_last=2),
        faults=faults, retry_base_delay=0.0)


def _run_port(res, resume=False, steps=STEPS, **kw):
    """A port session from repro's initial params (so per-source losses,
    and the trips they are charged to, follow repro's)."""
    cfg = SessionConfig(model="gfm-mtl", arch=CFG, steps=steps,
                        batch_per_task=6, eval_every=100, log_every=100,
                        verbose=False, resilience=res, **kw)
    with Session.from_config(cfg, sources=_sources(), device="cpu") as sess:
        p0 = interop.to_torch(j_make_gfm_mtl(J_CFG, 3).init(
            jax.random.PRNGKey(0)))
        sess.state = sess.state._replace(params=p0,
                                         opt_state=sess.optimizer.init(p0))
        if resume:
            sess.resume()
        return sess.run(), sess


def _run_repro(res, resume=False, steps=STEPS):
    cfg = JSessionConfig(model="gfm-mtl", arch=J_CFG, steps=steps,
                         batch_per_task=6, eval_every=100, log_every=100,
                         verbose=False, resilience=res)
    with JSession.from_config(cfg, sources=_sources()) as sess:
        if resume:
            sess.resume()
        return sess.run()


def test_full_state_checkpoint_restores_across_packages(tmp_path):
    # repro writes, the port reads
    jr = _run_repro(_res(jres, tmp_path / "j"), steps=3)
    _, sess = _run_port(_res(tres, tmp_path / "t"), steps=3)
    mgr = tres.CheckpointManager(str(tmp_path / "j"))
    path, back = mgr.load_latest(template=sess.state)
    js = jr.state
    assert back.step == int(js.step) == 3 and back.opt_state.step == 3
    np.testing.assert_array_equal(back.rng, np.asarray(js.rng))
    assert back.guard.ema == np.float32(js.guard.ema)
    assert (back.guard.good, back.guard.trips) == (3, 0)
    for tree, want in (("params", js.params), ("m", js.opt_state.m),
                       ("v", js.opt_state.v)):
        got = back.params if tree == "params" else getattr(back.opt_state,
                                                           tree)
        for k, v in interop.leaves(jax.tree_util.tree_map(
                np.asarray, want)).items():
            np.testing.assert_array_equal(interop.leaves(got)[k].numpy(), v,
                                          err_msg=f"{tree}/{k}")
    assert sess.resume(str(tmp_path / "j")) == 3
    # the port writes, repro reads (into repro's live state as template)
    tmgr = tres.CheckpointManager(str(tmp_path / "t"))
    jmgr = jres.CheckpointManager(str(tmp_path / "t"))
    _, jback = jmgr.load_latest(template=js)
    _, tback = tmgr.load_latest(template=sess.state)
    assert int(jback.step) == tback.step == 3
    np.testing.assert_array_equal(np.asarray(jback.rng), prng_key(1))
    assert np.float32(jback.guard.ema) == tback.guard.ema
    for k, v in interop.leaves(tback.opt_state.v).items():
        np.testing.assert_array_equal(
            np.asarray(interop.leaves(jback.opt_state.v)[k]), v.numpy())
    dp = json.load(open(tmgr.latest() + ".datapipe.json"))
    assert dp["step"] == 3 and dp["state"]["kind"] == "GroupBatcher"


# ---------------------------------------------------------------------------
# the soak and the runner's other paths
# ---------------------------------------------------------------------------

SOAK = [(5, "nan_grad", {}), (9, "corrupt_batch", {"magnitude": 1e6}),
        (12, "kill_producer", {}), (15, "ckpt_write_fail", {}),
        (18, "preempt", {})]


def _events(report):
    return [(e["kind"], e["tick"]) for e in report["events"]]


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    d = tmp_path_factory.mktemp("soak")
    faulted, _ = _run_port(_res(tres, d / "f", tres.FaultSchedule(
        [tres.Fault(tick=t, kind=k, **kw) for t, k, kw in SOAK])))
    resumed, _ = _run_port(_res(tres, d / "f"), resume=True)
    clean, _ = _run_port(_res(tres, d / "c"))
    ref = _run_repro(_res(jres, d / "j", jres.FaultSchedule(
        [jres.Fault(tick=t, kind=k, **kw) for t, k, kw in SOAK])))
    return faulted, resumed, clean, ref


def test_soak_ends_bitwise_equal_to_the_clean_run(soak):
    faulted, resumed, clean, _ = soak
    assert faulted.preempted and not resumed.preempted
    rep = faulted.resilience
    assert rep["faults_fired"] == 5 and rep["faults_pending"] == 0
    assert rep["rollbacks"] >= 2 and rep["pipeline_recoveries"] >= 1
    assert rep["io_retries"] >= 1
    assert clean.resilience["trips"] == 0
    a, b = resumed.state, clean.state
    assert a.step == b.step == STEPS and a.opt_state.step == STEPS
    for x, y in ((a.params, b.params), (a.opt_state.m, b.opt_state.m),
                 (a.opt_state.v, b.opt_state.v)):
        for k, v in interop.leaves(y).items():
            assert torch.equal(interop.leaves(x)[k], v), k
    assert a.guard == b.guard


def test_soak_events_match_repro(soak):
    faulted, _, _, ref = soak
    assert _events(faulted.resilience) == _events(ref.resilience)
    for key in ("ticks", "steps", "preempted", "checkpoints_saved",
                "io_retries", "pipeline_recoveries", "faults_fired",
                "trips", "rollbacks", "source_trips", "quarantined"):
        assert faulted.resilience[key] == ref.resilience[key], key
    rb = [e for e in faulted.resilience["events"] if e["kind"] == "rollback"]
    assert [e["to_step"] for e in rb] == \
        [e["to_step"] for e in ref.resilience["events"]
         if e["kind"] == "rollback"]


@pytest.mark.parametrize("prefetch", [True, False])
def test_quarantine_of_a_bad_source_matches_repro(tmp_path, prefetch):
    faults = [(t, "nan_grad", {"source": 1}) for t in (4, 6, 8)]
    t_out, sess = _run_port(_res(tres, tmp_path / "t", tres.FaultSchedule(
        [tres.Fault(tick=t, kind=k, **kw) for t, k, kw in faults]),
        quarantine_after=2), prefetch=prefetch)
    j_out = _run_repro(_res(jres, tmp_path / "j", jres.FaultSchedule(
        [jres.Fault(tick=t, kind=k, **kw) for t, k, kw in faults]),
        quarantine_after=2))
    assert _events(t_out.resilience) == _events(j_out.resilience)
    assert t_out.resilience["quarantined"] == [1] and sess._quarantined == {1}
    assert sess.task_weights[1] == 0.0
    assert t_out.state.step == STEPS and np.isfinite(t_out.final_loss)


def test_preempt_flush_writes_a_resumable_checkpoint(tmp_path):
    out, _ = _run_port(_res(tres, tmp_path / "p", tres.FaultSchedule(
        [tres.Fault(tick=8, kind="preempt")])))
    assert out.preempted and out.state.step == 7
    names = sorted(f for f in os.listdir(tmp_path / "p")
                   if f.endswith(".npz"))
    assert f"ckpt-{7:08d}.npz" in names
    cfg = SessionConfig(model="gfm-mtl", arch=CFG, steps=STEPS,
                        batch_per_task=6, verbose=False,
                        resilience=_res(tres, tmp_path / "p"))
    with Session(cfg, sources=_sources(), device="cpu") as sess:
        assert sess.resume() == 7


def test_unrecoverable_checkpoint_failure_raises(tmp_path):
    res = _res(tres, tmp_path / "x", tres.FaultSchedule(
        [tres.Fault(tick=1, kind="ckpt_write_fail", repeats=10)])).replace(
        retry_attempts=2, policy=tres.CheckpointPolicy(every_steps=2))
    with pytest.raises(tres.RetryError):
        _run_port(res)


def test_preemption_handler_takes_a_signal():
    with tres.PreemptionHandler(install=True,
                                signals=(signal.SIGUSR1,)) as h:
        assert h.installed and not h.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.triggered and h.received == signal.SIGUSR1
        h.clear()
        h.trigger()
        assert h.triggered and h.received is None
    assert not h.installed


def test_train_loop_logger_and_should_stop():
    logger = MetricLogger()
    calls = []

    def step(state, batch):
        calls.append(batch)
        return state + 1, StepOutput(loss=torch.tensor(float(state)),
                                     metrics={})
    state, lg, _ = train_loop(step, 0, iter(range(100)), steps=10,
                              log_every=1, logger=logger,
                              should_stop=lambda: len(calls) >= 4)
    assert state == 4 and lg is logger and len(logger.history) == 4
