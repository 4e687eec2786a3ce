"""The port's LM training against ``repro``'s, at the smoke widths.

Both packages start from ``repro``'s parameters (``repro``'s ``lm_init``
tree carried into the port with ``interop.to_torch``) and see the same
numpy-seeded tokens (``data.lm_data``, the same draws in both).

Inputs and tolerances (and why the multi-task MoE cases run in f32 only):
``torch_lm_common``; the loss and gradient of every architecture in both
dtypes: ``test_torch_lm_grads.py`` (single-task) and
``test_torch_lm_mtl_grads.py`` (multi-task).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm_data import make_lm_sources as j_make_lm_sources
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.models import transformer as jt
from repro.train import checkpoint as j_ckpt

from repro_torch import interop
from repro_torch.core.mtl import make_lm_multitask, softmax_xent
from repro_torch.engine import (Session, SessionConfig, TrainState,
                                build_model)
from repro_torch.launch import train as t_launch
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.loop import make_lm_loss
from torch_lm_common import RECURRENT_ARCHS, _batch, _cfgs, _close

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_lm_multitask_init_layout_and_refusals():
    _, tcfg = _cfgs("qwen1.5-0.5b", "f32", n_tasks=3)
    p = make_lm_multitask(tcfg).init(0, "cpu")
    assert set(p) == {"shared", "heads"} and "task_heads" not in p["shared"]
    assert tuple(p["heads"]["w"].shape) == (3, tcfg.d_model,
                                            tcfg.padded_vocab)
    with pytest.raises(ValueError, match="n_tasks > 1"):
        make_lm_multitask(tcfg.replace(n_tasks=1))
    with pytest.raises(ValueError, match="head count"):
        build_model("lm-mtl", tcfg, n_tasks=2)
    # a batch's src_embed, refused until the encoder was ported, is now
    # read only by an enc-dec model (repro's rule): a decoder-only model's
    # loss ignores it (one head: the tied table's)
    loss = make_lm_loss(tcfg.replace(n_tasks=1))
    text = {"tokens": torch.zeros(1, 4, dtype=torch.long),
            "labels": torch.zeros(1, 4, dtype=torch.long)}
    assert torch.equal(loss(p["shared"], dict(
        text, src_embed=torch.zeros(1, 2, 8))), loss(p["shared"], text))


def test_softmax_xent_matches_repro():
    from repro.core.mtl import softmax_xent as j_softmax_xent
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 41)).astype(np.float32) * 4
    labels = rng.integers(0, 41, (3, 5)).astype(np.int32)
    want = j_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got.numpy(), want, 1e-6, "xent")


# ---------------------------------------------------------------------------
# the embedding's backward: kernel #1's function
# ---------------------------------------------------------------------------

def _embed_case(seed=0, V=300, d=24, shape=(6, 50)):
    """Ids with heavy repeats (a Zipf draw) and rows no id touches."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.3, shape), V - 40) - 1
    table = rng.standard_normal((V, d)).astype(np.float32)
    g = rng.standard_normal(shape + (d,)).astype(np.float32)
    counts = np.bincount(ids.reshape(-1), minlength=V)
    assert counts.max() > 20 and (counts == 0).sum() > 40
    return table, ids.astype(np.int32), g


def _jax_take_grad(table, ids, g, dtype):
    t = jnp.asarray(table, dtype)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0), t)
    return np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32))


def _port_embed_grad(table, ids, g, dtype):
    t = torch.from_numpy(table).requires_grad_(True)
    out = tcommon.embed({"table": t}, torch.from_numpy(ids), dtype)
    assert out.dtype == dtype
    assert torch.equal(out, t.detach().to(dtype)[torch.from_numpy(ids)
                                                  .long()])
    out.backward(torch.from_numpy(g).to(dtype))
    return t.grad.numpy()


def test_embed_backward_matches_repro_take_f32():
    table, ids, g = _embed_case()
    want = _jax_take_grad(table, ids, g, jnp.float32)
    got = _port_embed_grad(table, ids, g, torch.float32)
    _close(got, want, 1e-6, "embed grad")
    unused = np.bincount(ids.reshape(-1), minlength=len(table)) == 0
    assert not got[unused].any()


def test_embed_backward_matches_repro_take_bf16():
    """A bf16 table (the LM's compute dtype): the port's f32 sums rounded
    once to bf16 against XLA's bf16 scatter-add, both within one bf16
    rounding (2^-8 relative) of the exact f32 sums plus XLA's own
    per-add roundings, bounded by 2^-8 x the sum of |g| a row."""
    table, ids, g = _embed_case(seed=1)
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    exact = np.zeros_like(table)
    np.add.at(exact, ids.reshape(-1), gb.reshape(-1, g.shape[-1]))
    absum = np.zeros_like(table)
    np.add.at(absum, ids.reshape(-1), np.abs(gb).reshape(-1, g.shape[-1]))
    got = _port_embed_grad(table, ids, g, torch.bfloat16)
    want = _jax_take_grad(table, ids, g, jnp.bfloat16)
    # the port rounds once: within half a bf16 ulp of the exact sums
    assert np.all(np.abs(got - exact) <= 2.0 ** -8 * np.abs(exact) + 1e-30)
    # and within XLA's accumulated roundings of repro's
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * absum + 1e-30)
    unused = np.bincount(ids.reshape(-1), minlength=len(table)) == 0
    assert not got[unused].any() and not want[unused].any()


# ---------------------------------------------------------------------------
# sessions and the launcher
# ---------------------------------------------------------------------------

def _session_pair(model, jcfg, tcfg, sources, steps=5, batch=2, **kw):
    common = dict(dict(steps=steps, batch_per_task=batch, lr=2e-3, warmup=2,
                       log_every=1, verbose=False, seed=0), **kw)
    js = JSession.from_config(JSessionConfig(model=model, arch=jcfg,
                                             **common), sources=sources)
    ts = Session.from_config(SessionConfig(model=model, arch=tcfg,
                                           **common),
                             sources=sources, device="cpu")
    ts.state = TrainState.create(interop.to_torch(js.state.params),
                                 ts.optimizer)
    with js, ts:
        return js.run(), ts.run(), ts


@pytest.mark.parametrize("accum", [1, 2])
def test_lm_session_matches_repro(accum):
    """``model="lm"``: a ``SingleBatcher`` over one dict source, 5 steps
    (and with accum=2, split on the flat batch's axis 0)."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", "f32")
    source = j_make_lm_sources(1, 32, 16, jcfg.vocab)[0]
    jr, tr, ts = _session_pair("lm", jcfg, tcfg, source, batch=4,
                               accum=accum)
    assert type(ts.batcher).__name__ == "SingleBatcher"
    assert ts.task_names == ["task0"]
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 5 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_lm_mtl_session_matches_repro():
    jcfg, tcfg = _cfgs("h2o-danube-1.8b", "f32", n_tasks=3)
    sources = j_make_lm_sources(3, 16, 16, jcfg.vocab)
    jr, tr, ts = _session_pair("lm-mtl", jcfg, tcfg, sources)
    for key in ("loss", "task0", "task1", "task2"):
        np.testing.assert_allclose([r[key] for r in tr.logger.history],
                                   [r[key] for r in jr.logger.history],
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-236b"])
def test_moe_lm_session_matches_repro(arch):
    """``model="lm"`` on the MoE smoke configs, 3 steps: each step's loss
    (cross-entropy plus ``router_aux_coef`` x the balance term) within
    1e-4 relative of ``repro``'s."""
    jcfg, tcfg = _cfgs(arch, "f32")
    source = j_make_lm_sources(1, 16, 16, jcfg.vocab)[0]
    jr, tr, _ = _session_pair("lm", jcfg, tcfg, source, steps=3, batch=4)
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_granite_moe_at_its_expert_count_follows_repro():
    """The rise of the full-width granite-moe losses over 3 steps at lr
    3e-4 with no warmup (``chip_smoke.py``'s ``lm_moe``): granite at its
    own 40 experts, top-8, expert width 128, d=384 (6/2 heads of 64), 2
    layers, its real vocab (49,155), f32 compute; 3 ``Session`` steps of
    4 x 32 tokens at lr 3e-4, no warmup. Each step's loss within 1e-4
    relative of ``repro``'s: the port follows ``repro`` step for step."""
    kw = dict(d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
              n_experts=40, top_k=8, d_ff_expert=128, d_ff=128,
              vocab=49155, n_layers=2)
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", "f32", **kw)
    source = j_make_lm_sources(1, 12, 32, jcfg.vocab)[0]
    jr, tr, _ = _session_pair("lm", jcfg, tcfg, source, steps=3, batch=4,
                              lr=3e-4, warmup=0)
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_lm_session_matches_repro(arch):
    """``model="lm"`` on the recurrent smoke configs, 3 steps: each
    step's loss within 1e-4 relative of ``repro``'s."""
    jcfg, tcfg = _cfgs(arch, "f32")
    source = j_make_lm_sources(1, 16, 16, jcfg.vocab)[0]
    jr, tr, _ = _session_pair("lm", jcfg, tcfg, source, steps=3, batch=4)
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_checkpoints_restore_across_packages(arch, tmp_path):
    """An LM tree with the recurrent blocks' leaves (and zamba2's
    ``shared_attn``) written by either package restores bit for bit in
    the other, into a shape-only template."""
    jcfg, tcfg = _cfgs(arch, "f32")
    jp = jt.lm_init(jax.random.PRNGKey(2), jcfg)
    path = str(tmp_path / "from_repro")
    j_ckpt.save(path, {"params": jp}, metadata={"step": 3})
    template = tt.lm_init(np.random.default_rng(0), tcfg, device="meta")
    got = t_ckpt.restore(path, {"params": template})["params"]
    want = interop.leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert set(interop.leaves(got)) == set(want)
    for k, v in interop.leaves(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert t_ckpt.load_metadata(path) == {"step": 3}
    tp = tt.lm_init(np.random.default_rng(1), tcfg)
    path = str(tmp_path / "from_port.npz")
    t_ckpt.save(path, {"params": tp})
    back = j_ckpt.restore(path, {"params": jax.eval_shape(lambda: jp)})
    back = interop.leaves(jax.tree_util.tree_map(np.asarray,
                                                 back["params"]))
    for k, v in interop.leaves(tp).items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
def test_donated_adamw_steps_equal_pure_ones(monkeypatch, moment_dtype):
    """``adamw(donate=True)`` through ``make_step``: three steps of the
    deepseek-v2 smoke LM (bf16 params) update params and moments in their
    own storage, slice by slice (``DONATE_CHUNK`` cut to 1000 elements so
    every leaf spans several), bitwise equal to the pure update's."""
    import importlib
    from repro_torch.engine import make_step
    adamw_mod = importlib.import_module("repro_torch.optim.adamw")
    monkeypatch.setattr(adamw_mod, "DONATE_CHUNK", 1000)
    _, tcfg = _cfgs("deepseek-v2-236b", "bf16",
                    param_dtype=torch.bfloat16)
    model = build_model("lm", tcfg)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(tcfg, 2, 16).items()}
    states = []
    for donate in (False, True):
        opt = adamw_mod.adamw(1e-3, moment_dtype=moment_dtype,
                              donate=donate)
        state = TrainState.create(model.init(0, "cpu"), opt)
        first = interop.leaves(state.params)
        step = make_step(model, opt)
        for _ in range(3):
            state, out = step(state, batch)
        after = interop.leaves(state.params)
        assert all((after[k] is v) == donate for k, v in first.items())
        states.append(state)
    pure, donated = states
    assert donated.opt_state.step == pure.opt_state.step == 3
    for a, b in ((pure.params, donated.params),
                 (pure.opt_state.m, donated.opt_state.m),
                 (pure.opt_state.v, donated.opt_state.v)):
        la, lb = interop.leaves(a), interop.leaves(b)
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_launcher_lm_modes_train_on_cpu(tmp_path):
    for mode, extra in (("lm", ["--batch", "4"]),
                        ("lm-mtl", ["--batch", "2", "--tasks", "3",
                                    "--arch", "h2o-danube-1.8b",
                                    "--accum", "2"])):
        ck = str(tmp_path / mode)
        loss = t_launch.main(["--mode", mode, "--device", "cpu", "--steps",
                              "3", "--seq", "16", "--log-every", "1",
                              "--ckpt", ck] + extra)
        assert np.isfinite(loss)
        meta = t_ckpt.load_metadata(ck)
        assert meta["step"] == 3 and meta["model"] == mode
    with pytest.raises(SystemExit):
        t_launch.main(["--mode", "lm-mtl", "--arch", "hydragnn-gfm",
                       "--device", "cpu"])
