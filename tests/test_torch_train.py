"""The port's training slice against ``repro``'s, at the smoke size.

Both packages start from ``repro``'s initial parameters (carried into the
port with ``interop.to_torch``: the port draws its own from numpy seeds)
and see the same batches.

  * one step of ``make_step`` — loss, ``per_task_loss``, grads, new params
    and both AdamW moments — under ``uncertainty=True``, a zero task weight
    and ``grad_clip>0`` (fused edge path, repro's Pallas kernels in
    interpret mode), and under ``accum=2`` with a warmup schedule (plain
    one-hot path): 1e-5 x max(1, max|ref|) per leaf for losses and grads,
    2e-6 for params and moments (AdamW divides by sqrt(v), so a grad
    within 1e-5 moves an update by at most ~1e-5 x lr);
  * a ``Session`` loss trajectory of 4 steps on the same stream: 1e-4
    relative (four steps of fp32 drift);
  * checkpoints with their datapipe sidecar, written by either package's
    ``Session`` and restored in the other: params exact, stream identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.core.mtl import make_gfm_mtl as j_make_gfm_mtl
from repro.core.taskpar import MTPConfig
from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.data.synthetic_atoms import generate_all as j_generate_all
from repro.data.synthetic_atoms import source_dicts as j_source_dicts
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.engine import ShardingPlan
from repro.engine import TrainState as JTrainState
from repro.engine import make_step as j_make_step
from repro.engine import multitask_grad_fn as j_grad_fn
from repro.engine import with_grad_accum as j_with_grad_accum
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import checkpoint as j_ckpt

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.core.mtl import gfm_loss_terms, make_gfm_mtl
from repro_torch.data.loader import GroupBatcher
from repro_torch.engine import (Session, SessionConfig, TrainState,
                                make_step, multitask_grad_fn,
                                with_grad_accum)
from repro_torch.launch import train as t_launch
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import checkpoint as t_ckpt

T = 3


@pytest.fixture(scope="module")
def sources():
    cfg = j_gfm.smoke()
    return j_source_dicts(j_generate_all(12, max_atoms=cfg.max_atoms,
                                         max_edges=cfg.max_edges, seed=0))[:T]


def _close(got, want, tol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _close_tree(got, want, tol):
    wl = interop.leaves(jax.tree_util.tree_map(np.asarray, want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, v in wl.items():
        _close(gl[k].detach().numpy(), v, tol, k)


CASES = {
    # uncertainty weighting, a quarantined (zero-weight) task, clipping
    "fused-uncertainty-zero-weight-clip": dict(
        impl="fused", uncertainty=True, task_weights=(1.0, 0.0, 2.0),
        clip=0.05, accum=1, warmup=0),
    # two microbatches and the warmup-cosine schedule
    "jnp-accum2-warmup": dict(impl="jnp", uncertainty=False,
                              task_weights=None, clip=0.0, accum=2,
                              warmup=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_repro(sources, case):
    c = CASES[case]
    jcfg = j_gfm.smoke().replace(segment_sum_impl=c["impl"])
    tcfg = t_gfm.smoke().replace(segment_sum_impl=c["impl"])
    jmodel = j_make_gfm_mtl(jcfg, T, uncertainty=c["uncertainty"])
    tmodel = make_gfm_mtl(tcfg, T, uncertainty=c["uncertainty"])
    params = jmodel.init(jax.random.PRNGKey(1))
    batch = JGroupBatcher(sources, 4, seed=2).next_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lr_j = j_warmup_cosine(1e-3, c["warmup"], 10) if c["warmup"] else 1e-3
    lr_t = warmup_cosine(1e-3, c["warmup"], 10) if c["warmup"] else 1e-3
    jopt = j_adamw(lr_j, weight_decay=0.01, grad_clip=c["clip"])
    topt = adamw(lr_t, weight_decay=0.01, grad_clip=c["clip"])

    # grads
    jl, jm, jg = jax.jit(j_with_grad_accum(
        j_grad_fn(jmodel, T, c["task_weights"]), c["accum"], axis=1))(
        params, jbatch)
    tparams = interop.to_torch(params)
    tl, tm, tg = with_grad_accum(multitask_grad_fn(
        tmodel, T, c["task_weights"]), c["accum"])(tparams, tbatch)
    _close(tl.numpy(), jl, 1e-5, "loss")
    _close(tm["per_task_loss"].numpy(), jm["per_task_loss"], 1e-5,
           "per_task_loss")
    _close_tree(tg, jg, 1e-5)
    if c["task_weights"] is not None:   # the quarantined head gets nothing
        assert all(float(v[1].abs().max()) == 0.0 for k, v in
                   interop.leaves(tg["heads"]).items())

    # the whole step: new params and both moments
    plan = ShardingPlan(mtp=MTPConfig(n_tasks=T), donate=False)
    jstep = plan.compile(j_make_step(jmodel, jopt, plan, accum=c["accum"],
                                     task_weights=c["task_weights"]))
    jstate, jout = jstep(JTrainState.create(params, jopt), jbatch)
    tstep = make_step(tmodel, topt, accum=c["accum"],
                      task_weights=c["task_weights"])
    tstate, tout = tstep(TrainState.create(tparams, topt), tbatch)
    _close(tout.loss.numpy(), jout.loss, 1e-5, "step loss")
    _close(tout.metrics["per_task_loss"].numpy(),
           jout.metrics["per_task_loss"], 1e-5, "step per_task_loss")
    assert tstate.step == int(jstate.step) == 1
    _close_tree(tstate.params, jstate.params, 2e-6)
    _close_tree(tstate.opt_state.m, jstate.opt_state.m, 2e-6)
    _close_tree(tstate.opt_state.v, jstate.opt_state.v, 2e-6)


def test_loss_terms_match_repro(sources):
    from repro.core.mtl import gfm_loss_terms as j_terms
    rng = np.random.default_rng(0)
    b = {k: v[:4] for k, v in sources[0].items()}
    e = rng.standard_normal(4).astype(np.float32)
    f = rng.standard_normal(b["forces"].shape).astype(np.float32)
    want = j_terms(jnp.asarray(e), jnp.asarray(f),
                   jax.tree_util.tree_map(jnp.asarray, b), 0.5)
    got = gfm_loss_terms(torch.from_numpy(e), torch.from_numpy(f),
                         {k: torch.from_numpy(v) for k, v in b.items()}, 0.5)
    for a, w in zip(got, want):
        _close(a.numpy(), w, 1e-6, "loss terms")


@pytest.fixture(scope="module")
def sessions(sources, tmp_path_factory):
    """repro's and the port's Session over the same sources, 4 steps each,
    the port starting from repro's initial params; both write a
    checkpoint with its datapipe sidecar."""
    d = tmp_path_factory.mktemp("ckpt")
    common = dict(steps=4, batch_per_task=4, lr=1e-3, warmup=2,
                  log_every=1, verbose=False, seed=0)
    js = JSession.from_config(
        JSessionConfig(model="gfm-mtl", arch=j_gfm.smoke(),
                       ckpt_path=str(d / "repro"), **common),
        sources=sources)
    p0 = js.state.params
    ts = Session.from_config(
        SessionConfig(model="gfm-mtl", arch=t_gfm.smoke().replace(
            segment_sum_impl="fused"), ckpt_path=str(d / "port"), **common),
        sources=sources, device="cpu")
    ts.state = TrainState.create(interop.to_torch(p0), ts.optimizer)
    with js, ts:
        jr, tr = js.run(), ts.run()
    return jr, tr, d


def test_session_loss_trajectory_matches_repro(sessions):
    jr, tr, _ = sessions
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k in ("task0", "task1", "task2"):
        np.testing.assert_allclose([r[k] for r in tr.logger.history],
                                   [r[k] for r in jr.logger.history],
                                   rtol=1e-4, err_msg=k)


def test_checkpoints_restore_across_packages(sessions, sources):
    jr, tr, d = sessions
    # the port's checkpoint, read by repro
    tmpl = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jr.params)
    back = j_ckpt.restore(str(d / "port"), {"params": tmpl})["params"]
    for k, v in interop.leaves(tr.params).items():
        np.testing.assert_array_equal(np.asarray(interop.leaves(back)[k]),
                                      v.numpy(), err_msg=k)
    assert j_ckpt.load_datapipe_step(str(d / "port")) == 4
    jb = JGroupBatcher(sources, 4, seed=9)
    jb.restore(j_ckpt.load_datapipe(str(d / "port")))
    # repro's checkpoint, read by the port
    tmpl_t = interop.tree_map(lambda x: x.to("meta"), tr.params)
    back_t = t_ckpt.restore(str(d / "repro"), {"params": tmpl_t})["params"]
    for k, v in interop.leaves(jax.tree_util.tree_map(np.asarray,
                                                      jr.params)).items():
        np.testing.assert_array_equal(interop.leaves(back_t)[k], v,
                                      err_msg=k)
    assert t_ckpt.has_datapipe(str(d / "repro"))
    assert t_ckpt.load_datapipe_step(str(d / "repro")) == 4
    tb = GroupBatcher(sources, 4, seed=9)
    tb.restore(t_ckpt.load_datapipe(str(d / "repro")))
    # both sessions consumed the same 4 batches: each resumed stream
    # continues where the other package's run stopped
    for _ in range(2):
        a, b = tb.next_batch(), jb.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_session_restore_datapipe_from_repro_checkpoint(sessions, sources):
    _, _, d = sessions
    sess = Session.from_config(
        SessionConfig(model="gfm-mtl", arch=t_gfm.smoke(), steps=1,
                      batch_per_task=4, verbose=False, prefetch=False),
        sources=sources, device="cpu")
    sess.restore_datapipe(str(d / "repro"))
    jb = JGroupBatcher(sources, 4, seed=0)
    for _ in range(4):
        jb.next_batch()
    want = jb.next_batch()
    got = sess.batcher.next_batch()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launcher_trains_on_cpu_and_refuses_later_knobs(tmp_path, sources):
    loss = t_launch.main(["--mode", "gfm", "--device", "cpu", "--steps", "3",
                          "--samples", "8", "--batch", "2",
                          "--log-every", "1", "--ckpt",
                          str(tmp_path / "ck")])
    assert np.isfinite(loss)
    assert t_ckpt.load_metadata(str(tmp_path / "ck"))["step"] == 3
    with pytest.raises(SystemExit):
        t_launch.main(["--mode", "lm", "--device", "cpu"])
    base = SessionConfig(model="gfm-mtl", arch=t_gfm.smoke(), steps=1)
    # head placement and a mesh need a torch.distributed job and a
    # DeviceMesh (tests/test_torch_taskpar.py runs them in one)
    with pytest.raises(RuntimeError, match="init_distributed"):
        Session(base.replace(placement=2), sources=sources, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Session(base, sources=sources, device="cpu", mesh=object())
    # one branch over several sources needs the mixture, as in repro
    with pytest.raises(ValueError, match="cfg.mixing"):
        Session(base.replace(model="gfm-baseline"), sources=sources,
                device="cpu")
    # mixing, bucketing and resilience build a Session now
    from repro_torch.data.bucketing import BucketingBatcher
    from repro_torch.resilience import ResilienceConfig
    mixed = Session(base.replace(mixing=2.0), sources=sources, device="cpu")
    assert len(mixed.task_weights) == T
    assert isinstance(Session(base.replace(bucketing=2), sources=sources,
                              device="cpu").batcher, BucketingBatcher)
    guarded = Session(base.replace(resilience=ResilienceConfig(
        ckpt_dir=str(tmp_path / "res"))), sources=sources, device="cpu")
    assert guarded.state.guard is not None
    with pytest.raises(TypeError, match="ShardingPlan"):
        make_step(make_gfm_mtl(t_gfm.smoke(), T), adamw(1e-3), plan="pjit")
