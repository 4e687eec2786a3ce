"""The port's single-task training against ``repro``'s, at the smoke size:
the downstream fine-tuning model of ``examples/finetune_downstream.py``
(a fresh branch on a tuned EGNN trunk, one source's flat batches) as a
``SingleTaskModel``.

Both packages start from ``repro``'s parameters (carried into the port
with ``interop.to_torch``) and see the same batches. Tolerances (fp32),
per leaf as tol x max(1, max|ref|): a step's loss and gradients 1e-5 (the
same sums in another order, ``repro``'s Pallas kernels in interpret mode
against the port's plain versions); the params after one step 2e-6
(AdamW divides by sqrt(v), so a grad within 1e-5 moves an update by at
most ~1e-5 x lr) and after 5 fine-tuning steps 2e-5, wherever the
gradient stands above its tolerance (``_close_after_adamw`` says why and
bounds the rest); the held-out MAEs 1e-5 relative; a Session's 5-step loss trajectory 1e-4 relative (five
steps of fp32 drift, as tests/test_torch_train.py holds the multi-task
one). Batch streams and ``to_batch_dict`` are byte-equal.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.core.mtl import gfm_eval_fn as j_gfm_eval_fn
from repro.core.mtl import gfm_loss_terms as j_gfm_loss_terms
from repro.data.loader import SingleBatcher as JSingleBatcher
from repro.data.mixing import MixingBatcher as JMixingBatcher
from repro.data.mixing import MixingConfig as JMixingConfig
from repro.data.synthetic_atoms import generate_all as j_generate_all
from repro.data.synthetic_atoms import generate_source as j_generate_source
from repro.data.synthetic_atoms import source_dicts as j_source_dicts
from repro.data.synthetic_atoms import to_batch_dict as j_to_batch_dict
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.engine import ShardingPlan as JShardingPlan
from repro.engine import SingleTaskModel as JSingleTaskModel
from repro.engine import TrainState as JTrainState
from repro.engine import available_models as j_available_models
from repro.engine import make_grad_fn as j_make_grad_fn
from repro.engine import make_step as j_make_step
from repro.engine import with_grad_accum as j_with_grad_accum
from repro.models import gnn as jgnn
from repro.models import heads as jheads
from repro.optim import adamw as j_adamw

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.core import gfm_eval_fn
from repro_torch.data.loader import SingleBatcher
from repro_torch.data.mixing import MixingBatcher, MixingConfig
from repro_torch.data.synthetic_atoms import generate_source, to_batch_dict
from repro_torch.engine import (Session, SessionConfig, ShardingPlan,
                                TrainState, available_models, make_grad_fn,
                                make_guarded_step, make_step,
                                with_grad_accum)
from repro_torch.optim import adamw
from repro_torch.resilience import GuardConfig, ResilienceConfig

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "finetune_downstream_torch.py"


def _example():
    spec = importlib.util.spec_from_file_location("finetune_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FT = _example()


def _cfgs(impl="fused"):
    return (j_gfm.smoke().replace(segment_sum_impl=impl),
            t_gfm.smoke().replace(segment_sum_impl=impl))


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _close_tree(got, want, tol):
    wl = interop.leaves(jax.tree_util.tree_map(np.asarray, want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, v in wl.items():
        _close(gl[k].detach().numpy(), v, tol, k)


def _close_after_adamw(got, want, grads, tol, lr, steps):
    """Params after ``steps`` AdamW steps: within ``tol`` x max(1,
    max|ref|) wherever the first step's gradient stands above the
    gradient tolerance (1e-5 x max(1, max|g|)). Below it the gradient is
    summation noise whose sign AdamW's g / sqrt(v) keeps: such an entry
    moves by up to lr x (1 - b1) / sqrt(1 - b2) = 3.17 lr a step either
    way in either package (one entry of 8256 in the trunk, with a
    gradient of 2e-9 against a largest entry of 0.28)."""
    wl = interop.leaves(jax.tree_util.tree_map(np.asarray, want))
    gl, dl = interop.leaves(got), interop.leaves(grads)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        err = np.abs(gl[k].detach().numpy().astype(np.float64) - w)
        g = dl[k].abs().numpy()
        signal = g > 1e-5 * max(1.0, float(g.max()))
        assert err[signal].max(initial=0.0) <= \
            tol * max(1.0, float(np.abs(w).max())), k
        assert err.max() <= 2 * steps * lr * 0.1 / np.sqrt(1e-3), k
        assert (~signal & (err > tol)).sum() <= max(1, err.size // 1000), k


def _j_finetune_model(cfg, shared, seed=1):
    """``examples/finetune_downstream.py``'s model, verbatim."""
    def init(key):
        return {"branch": jheads.branch_init(jax.random.PRNGKey(seed), cfg),
                "shared": shared}

    def loss_fn(fp, batch):
        feats = jgnn.egnn_apply(fp["shared"], batch, cfg=cfg)
        e, f = jheads.branch_apply(fp["branch"], feats, batch["node_mask"],
                                   cfg=cfg)
        return j_gfm_loss_terms(e, f, batch)[0]

    return JSingleTaskModel(init=init, loss_fn=loss_fn, name="gfm-finetune")


@pytest.fixture(scope="module")
def downstream():
    """repro's transition1x source (seed 99, as the example draws it): 12
    training graphs and 16 held out, as numpy dicts."""
    cfg = j_gfm.smoke()
    sd = j_generate_source("transition1x", 28, max_atoms=cfg.max_atoms,
                           max_edges=cfg.max_edges, seed=99)
    train = {k: np.asarray(v) for k, v in
             j_to_batch_dict(sd, np.arange(12)).items()}
    test = {k: np.asarray(v) for k, v in
            j_to_batch_dict(sd, np.arange(12, 28)).items()}
    return sd, train, test


def _params(jcfg, trunk_seed=7):
    shared = jgnn.egnn_init(jax.random.PRNGKey(trunk_seed), jcfg)
    jmodel = _j_finetune_model(jcfg, shared)
    return jmodel, jmodel.init(None)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# one step, accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_single_task_step_matches_repro(downstream, impl):
    """``make_grad_fn`` and one ``make_step`` of the fine-tuning model:
    loss, every gradient leaf, and the params after the step."""
    _, train, _ = downstream
    jcfg, tcfg = _cfgs(impl)
    jmodel, jp = _params(jcfg)
    tmodel = FT.finetune_model(tcfg, None)
    jl, jm, jg = jax.jit(j_make_grad_fn(jmodel))(jp, _j(train))
    tl, tm, tg = make_grad_fn(tmodel)(interop.to_torch(jp), _t(train))
    assert tm == {} and jm == {}
    _close(tl.numpy(), jl, 1e-5, "loss")
    _close_tree(tg, jg, 1e-5)

    jopt, topt = j_adamw(3e-3), adamw(3e-3)
    plan = JShardingPlan(donate=False)
    jstate, jout = plan.compile(j_make_step(jmodel, jopt, plan))(
        JTrainState.create(jp, jopt), _j(train))
    tplan = ShardingPlan()
    tstate, tout = tplan.compile(make_step(tmodel, topt, tplan))(
        TrainState.create(interop.to_torch(jp), topt), _t(train))
    _close(tout.loss.numpy(), jout.loss, 1e-5, "step loss")
    _close_after_adamw(tstate.params, jstate.params, tg, 2e-6, 3e-3, 1)
    assert tstate.step == 1


def test_single_task_grad_accum_matches_repro(downstream):
    """``with_grad_accum`` on a flat batch (accum=2, axis 0) against
    ``repro``'s, and ``make_step(accum=2)`` picking that axis itself."""
    _, train, _ = downstream
    jcfg, tcfg = _cfgs("jnp")
    jmodel, jp = _params(jcfg)
    tmodel = FT.finetune_model(tcfg, None)
    jl, _, jg = jax.jit(j_with_grad_accum(j_make_grad_fn(jmodel), 2,
                                          axis=0))(jp, _j(train))
    tl, _, tg = with_grad_accum(make_grad_fn(tmodel), 2, axis=0)(
        interop.to_torch(jp), _t(train))
    _close(tl.numpy(), jl, 1e-5, "loss")
    _close_tree(tg, jg, 1e-5)
    # the halves' mean differs from the whole batch's gradient
    _, _, whole = make_grad_fn(tmodel)(interop.to_torch(jp), _t(train))
    assert any(float((a - b).abs().max()) > 1e-4 for a, b in zip(
        interop.leaves(whole).values(), interop.leaves(tg).values()))
    jopt, topt = j_adamw(3e-3), adamw(3e-3)
    jstate, _ = jax.jit(j_make_step(jmodel, jopt, accum=2))(
        JTrainState.create(jp, jopt), _j(train))
    tstate, _ = make_step(tmodel, topt, accum=2)(
        TrainState.create(interop.to_torch(jp), topt), _t(train))
    _close_after_adamw(tstate.params, jstate.params, tg, 2e-6, 3e-3, 1)
    with pytest.raises(ValueError, match="not divisible"):
        make_step(tmodel, topt, accum=5)(
            TrainState.create(interop.to_torch(jp), topt), _t(train))


def test_to_batch_dict_byte_equal_to_repro(downstream):
    sd, train, _ = downstream
    got = to_batch_dict(sd, np.arange(12))
    assert set(got) == set(train)
    for k, v in train.items():
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].numpy().dtype == v.dtype, k
    # the port's own draw of the source: the same structures
    mine = to_batch_dict(generate_source(
        "transition1x", 28, max_atoms=sd.species.shape[1],
        max_edges=sd.edge_src.shape[1], seed=99), np.arange(12))
    for k in ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask"):
        np.testing.assert_array_equal(mine[k].numpy(), train[k], err_msg=k)


# ---------------------------------------------------------------------------
# the fine-tuning protocol
# ---------------------------------------------------------------------------

def test_finetune_protocol_matches_repro(downstream):
    """A fresh branch on a tuned trunk, 5 steps (the example's loop, its
    ``finetune``), from ``repro``'s params: the params at the end and
    ``gfm_eval_fn``'s held-out MAEs."""
    _, train, test = downstream
    jcfg, tcfg = _cfgs("fused")
    jmodel, jp = _params(jcfg, trunk_seed=3)
    jopt = j_adamw(3e-3)
    plan = JShardingPlan(donate=False)
    jstep = plan.compile(j_make_step(jmodel, jopt, plan))
    jstate = JTrainState.create(jp, jopt)
    jlosses = []
    for _ in range(5):
        jstate, out = jstep(jstate, _j(train))
        jlosses.append(float(out.loss))

    tp = interop.to_torch(jp)
    state, losses = FT.finetune(tcfg, tp["shared"], _t(train), 5)
    # the example's fresh branch is its own draw: restart from repro's
    opt = adamw(3e-3)
    step = ShardingPlan().compile(make_step(
        FT.finetune_model(tcfg, tp["shared"]), opt))
    state = TrainState.create(tp, opt)
    tlosses = []
    for _ in range(5):
        state, out = step(state, _t(train))
        tlosses.append(float(out.loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _, _, g0 = make_grad_fn(FT.finetune_model(tcfg, None))(tp, _t(train))
    _close_after_adamw(state.params, jstate.params, g0, 2e-5, 3e-3, 5)
    want = j_gfm_eval_fn(jcfg)(jstate.params["shared"],
                               jstate.params["branch"], _j(test))
    got = gfm_eval_fn(tcfg)(state.params["shared"], state.params["branch"],
                            _t(test))
    for g, w, name in zip(got, want, ("energy MAE", "force MAE")):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    # the trunk moved, and the example's own run from its own branch too
    assert any(not torch.equal(a, b) for a, b in zip(
        interop.leaves(state.params["shared"]).values(),
        interop.leaves(tp["shared"]).values()))
    assert len(losses) == 5 and all(np.isfinite(float(x)) for x in losses)


# ---------------------------------------------------------------------------
# single-task sessions
# ---------------------------------------------------------------------------

def _session_pair(sources, **kw):
    jcfg, tcfg = _cfgs("fused")
    jmodel, jp = _params(jcfg)
    tmodel = FT.finetune_model(tcfg, None)
    common = dict(steps=5, batch_per_task=4, lr=3e-3, warmup=2,
                  log_every=1, verbose=False, seed=0, **kw)
    js = JSession.from_config(JSessionConfig(model="gfm-finetune",
                                             arch=jcfg, **common),
                              sources=sources, model=jmodel)
    # the model's init ignores the seed and takes the trunk it was given
    ts = Session.from_config(SessionConfig(model="gfm-finetune", arch=tcfg,
                                           **common),
                             sources=sources, model=FT.finetune_model(
                                 tcfg, interop.to_torch(jp["shared"])),
                             device="cpu")
    ts.state = TrainState.create(interop.to_torch(js.state.params),
                                 ts.optimizer)
    assert ts.task_names == ["task0"]
    assert tmodel.name == ts.model.name == "gfm-finetune"
    assert type(js.batcher).__name__ == type(ts.batcher).__name__
    with js, ts:
        return js.run(), ts.run(), ts


@pytest.mark.parametrize("mixed", [False, True])
def test_single_task_session_matches_repro(downstream, mixed):
    """One dict source (a ``SingleBatcher``), and three sources with
    ``cfg.mixing`` (a flat ``MixingBatcher``: one head over the
    mixture): batches byte-equal to ``repro``'s, 5 steps' losses."""
    _, train, _ = downstream
    if mixed:
        cfg = j_gfm.smoke()
        sources = j_source_dicts(j_generate_all(
            12, max_atoms=cfg.max_atoms, max_edges=cfg.max_edges,
            seed=0))[:3]
        jb = JMixingBatcher(sources, 4, seed=0,
                            mixing=JMixingConfig(temperature=1.0))
        tb = MixingBatcher(sources, 4, seed=0,
                           mixing=MixingConfig(temperature=1.0))
        kw = {"mixing": 1.0}
    else:
        sources = train
        jb, tb = JSingleBatcher(train, 4, seed=0), SingleBatcher(train, 4,
                                                                 seed=0)
        kw = {}
    for _ in range(6):
        a, b = tb.next_batch(), jb.next_batch()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                          err_msg=k)
    jr, tr, ts = _session_pair(sources, **kw)
    want = MixingBatcher if mixed else SingleBatcher
    assert isinstance(ts.batcher, want)
    assert ts.batcher.next_batch()["species"].ndim == 2    # flat batches
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_single_task_session_refusals_and_guard(downstream, tmp_path):
    """``cfg.placement`` and several sources without mixing raise, as
    ``repro`` asserts; a single-task model without ``batch_counts`` on a
    distributed plan raises naming the field (data parallelism needs the
    counts); the guarded step and the resilient runner take a single-task
    model."""
    _, train, _ = downstream
    _, tcfg = _cfgs("fused")
    jcfg = _cfgs("fused")[0]
    _, jp = _params(jcfg)
    model = FT.finetune_model(tcfg, interop.to_torch(jp["shared"]))
    base = SessionConfig(model="gfm-finetune", arch=tcfg, steps=3,
                         batch_per_task=4, verbose=False, log_every=1)
    with pytest.raises(ValueError, match="multi-task model"):
        Session(base.replace(placement=2), sources=train, model=model,
                device="cpu")
    with pytest.raises(ValueError, match="cfg.mixing"):
        Session(base, sources=[train, train], model=model, device="cpu")
    plan = ShardingPlan(mesh=object(), backend="pjit")
    with pytest.raises(ValueError, match="batch_counts"):
        make_grad_fn(model._replace(batch_counts=None), plan)
    sess = Session(base.replace(resilience=ResilienceConfig(
        ckpt_dir=str(tmp_path / "res"))), sources=train, model=model,
        device="cpu")
    with sess:
        res = sess.run()
    assert res.resilience["steps"] == 3 and np.isfinite(res.final_loss)
    with pytest.raises(ValueError, match="multi-task model"):
        sess.quarantine_tasks([0])
    opt = adamw(1e-3)
    step = make_guarded_step(model, opt, guard=GuardConfig())
    from repro_torch.engine import GuardState
    st = TrainState.create(model.init(None, "cpu"), opt,
                           guard=GuardState.init())
    st, out = step(st, _t(train))
    assert bool(out.metrics["guard_ok"]) and st.step == 1


def test_available_models_match_repro():
    """The port's models are ``repro``'s own: the names its registry module
    registers (a docs snippet run in the same process registers one more
    into ``repro``'s registry)."""
    from repro.engine.registry import _REGISTRY
    own = tuple(sorted(k for k, f in _REGISTRY.items()
                       if f.__module__ == "repro.engine.registry"))
    assert set(own) <= set(j_available_models())
    assert available_models() == own
    assert available_models() == ("gfm-baseline", "gfm-mtl", "lm", "lm-mtl")
