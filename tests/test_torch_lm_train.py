"""The port's LM training against ``repro``'s, at the smoke widths.

Both packages start from ``repro``'s parameters (``repro``'s ``lm_init``
tree carried into the port with ``interop.to_torch``) and see the same
numpy-seeded tokens (``data.lm_data``, the same draws in both).

Tolerances, per leaf as 1e-5 x max(1, max|ref|) in fp32 compute: loss,
per-task losses and every gradient leaf (the same sums in another order:
chunked attention, 128-wide contractions, the f32 logits over the padded
vocab). In bf16 compute (the configs' own) the packages round to bf16 at
the same points but sum in another order, and one flipped rounding moves
a value by 2^-8 of itself: the losses within 4e-2 x max(1, |ref|),
``repro``'s bf16 tolerance (tests/test_egnn_paper_shape.py); each
gradient leaf, whose entries are far below 1, held to its own size, its
largest error over its largest |ref| and its 2-norm error over its
2-norm both within 5e-2 (the worst readings at these widths: 2.3e-2 and
2.1e-2; a zero gradient reads 1). A Session's 5-step loss
trajectory: 1e-4 relative in fp32 (five AdamW steps of fp32 drift). The
embedding's backward: 1e-6 x max(1, max|ref|) in fp32, and for a bf16
table within one bf16 rounding of the f32 sums (the port sums in f32 and
rounds once, XLA's scatter adds in bf16).

The MoE configs (granite-moe, deepseek-v2) route each token to its top-k
experts, a choice that jumps where two router logits tie. In f32 the
packages' logits agree to ~1e-6 and every case here routes alike. In bf16
they drift by a rounding of the hidden state, and a token whose k-th and
(k+1)-th logits lie closer than that may take another expert in each
package: the granite-moe smoke multi-task case in bf16 does so for one of
96 tokens in its first layer (logit gap 1.5e-4, bf16 drift 2.8e-3), and
the gradients behind that token then differ by more than a rounding. The
multi-task MoE cases therefore run in f32 only; the single-task bf16 MoE
cases route alike at their seeds and are held to the bf16 tolerance.

The recurrent configs (zamba2-1.2b: Mamba2 and the shared attention
block, whose weights take a gradient summed over every application;
xlstm-125m: mLSTM and sLSTM) are held to the same tolerances, but for
their bf16 gradients. Some of their leaves' gradients are sums that
cancel: a shift of all of a head's mLSTM input gates leaves the
stabilised output unchanged wherever its denominator exceeds 1, so the
input-gate bias's f32 gradient is ~1e-9 and each package's bf16 value is
rounding noise; ``repro``'s own bf16 gradient of Mamba2's ``D`` and
``A_log`` departs from its f32 gradient by up to 0.9 of the leaf's
largest entry, and changing only where the port's bf16 conv rounds
moves its A_log gradient by 30-50% of an entry. So a bf16 gradient leaf
of these configs is held to ``repro``'s bf16 leaf within
``BF16_GRAD_TOL`` + 2 r of its size, in max and in 2-norm, r the largest
relative departure of ``repro``'s own bf16 gradient from its f32 one over
that parameter's leaves in every layer: the port no noisier than twice
the reference's own rounding of that parameter (the worst reading at
these seeds: 0.70 of the bound, mLSTM's input-gate bias under remat).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.mtl import make_lm_multitask as j_make_lm_multitask
from repro.data.lm_data import make_lm_sources as j_make_lm_sources
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.engine import multitask_grad_fn as j_multitask_grad_fn
from repro.models import transformer as jt
from repro.train import checkpoint as j_ckpt
from repro.train.loop import make_lm_loss as j_make_lm_loss

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core.mtl import make_lm_multitask, softmax_xent
from repro_torch.data.lm_data import make_lm_sources
from repro_torch.engine import (Session, SessionConfig, SingleTaskModel,
                                TrainState, build_model, multitask_grad_fn,
                                single_grad_fn)
from repro_torch.launch import train as t_launch
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.loop import make_lm_loss

F32_TOL = 1e-5
BF16_TOL = 4e-2
BF16_GRAD_TOL = 5e-2
ARCHS = ("qwen1.5-0.5b", "h2o-danube-1.8b", "granite-moe-3b-a800m",
         "deepseek-v2-236b", "zamba2-1.2b", "xlstm-125m")
RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-125m")
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b")
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _cfgs(arch, dtype, **kw):
    jd, td, _ = DTYPES[dtype]
    return (j_get_smoke(arch).replace(compute_dtype=jd, **kw),
            tconfigs.get_smoke(arch).replace(compute_dtype=td, **kw))


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _close_tree(got, want, tol):
    wl = interop.leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, v in wl.items():
        _close(gl[k].float().numpy(), v, tol, k)


def _close_grads(got, want, dtype):
    """Gradient leaves: in fp32 as ``_close_tree``; in bf16 each leaf's
    largest error over its largest |ref|, and its 2-norm error over its
    2-norm, within ``BF16_GRAD_TOL``."""
    if dtype == "f32":
        return _close_tree(got, want, F32_TOL)
    wl = interop.leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        g = gl[k].double().numpy()
        assert g.shape == w.shape, k
        top, norm = float(np.abs(w).max()), float(np.linalg.norm(w))
        assert top > 0, k
        assert float(np.abs(g - w).max()) <= BF16_GRAD_TOL * top, k
        assert float(np.linalg.norm(g - w)) <= BF16_GRAD_TOL * norm, k


def _kind(key):
    """A gradient leaf's parameter name without its layer: the same
    parameter of every repetition and remainder layer."""
    return re.sub(r"(scan/u\d+|rem/r\d+)/", "", key)


def _close_grads_to_noise(got, want, want_f32, shares=None):
    """bf16 gradient leaves of the recurrent configs: each within
    ``BF16_GRAD_TOL`` + 2 r of its size, in max and in 2-norm, r the
    largest relative departure of ``repro``'s own bf16 gradient from its
    f32 one (``want_f32``) over the leaves of that parameter in every
    layer. ``shares`` collects each leaf's error over its bound."""
    wl, fl = (interop.leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), t)) for t in (want, want_f32))
    gl = interop.leaves(got)
    assert set(gl) == set(wl) == set(fl)
    noise = {}
    for k, w in wl.items():
        top, norm = float(np.abs(w).max()), float(np.linalg.norm(w))
        assert top > 0, k
        r = (float(np.abs(w - fl[k]).max()) / top,
             float(np.linalg.norm(w - fl[k])) / norm)
        old = noise.get(_kind(k), (0.0, 0.0))
        noise[_kind(k)] = (max(old[0], r[0]), max(old[1], r[1]))
    for k, w in wl.items():
        g = gl[k].double().numpy()
        assert g.shape == w.shape, k
        r_max, r_norm = noise[_kind(k)]
        share = (float(np.abs(g - w).max()) / (
            (BF16_GRAD_TOL + 2 * r_max) * float(np.abs(w).max())),
            float(np.linalg.norm(g - w)) / (
            (BF16_GRAD_TOL + 2 * r_norm) * float(np.linalg.norm(w))))
        if shares is not None:
            shares[k] = share
        assert max(share) <= 1.0, (k, share)


def _live_lora(params, seed=0):
    """repro's tree with the shared attention block's LoRA ``b`` factors
    (zero at init, which zeroes the ``a`` factors' gradients) drawn, so
    every adapter leaf takes a gradient; other trees unchanged."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if re.search(r"'lora_._b'", jax.tree_util.keystr(path)):
            return jnp.asarray(0.02 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


def _batch(cfg, B, S, T=None, seed=3):
    src = make_lm_sources(T or 1, B, S, cfg.vocab, seed=seed)
    if T is None:
        return src[0]
    return {k: np.stack([s[k] for s in src]) for k in src[0]}


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_repro(arch, dtype, remat):
    """``make_lm_loss`` through ``single_grad_fn``: the loss and every
    gradient leaf, with and without per-block rematerialisation."""
    jcfg, tcfg = _cfgs(arch, dtype, remat=remat)
    params = _live_lora(jt.lm_init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(tcfg, 2, 24)
    jl, jg = jax.jit(jax.value_and_grad(j_make_lm_loss(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = SingleTaskModel(init=None, loss_fn=make_lm_loss(tcfg))
    tl, metrics, tg = single_grad_fn(model)(
        interop.to_torch(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = DTYPES[dtype][2]
    assert metrics == {}
    _close(tl.numpy(), jl, tol, "loss")
    if dtype == "bf16" and arch in RECURRENT_ARCHS:
        _, jg32 = jax.jit(jax.value_and_grad(j_make_lm_loss(
            jcfg.replace(compute_dtype=jnp.float32))))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        return _close_grads_to_noise(tg, jg, jg32)
    _close_grads(tg, jg, dtype)


@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in DTYPES
    if not (a in MOE_ARCHS and d == "bf16")])
def test_lm_multitask_matches_repro(arch, dtype):
    """``make_lm_multitask``: per-task losses (one trunk pass over the
    T·B rows in the port, ``repro`` vmaps per task), the weighted total and
    every gradient leaf, trunk and heads."""
    jcfg, tcfg = _cfgs(arch, dtype, n_tasks=3)
    jmodel = j_make_lm_multitask(jcfg)
    tmodel = make_lm_multitask(tcfg)
    params = _live_lora(jmodel.init(jax.random.PRNGKey(1)))
    batch = _batch(tcfg, 2, 16, T=3)
    tw = (1.0, 0.5, 2.0)
    jl, jm, jg = jax.jit(j_multitask_grad_fn(jmodel, 3, tw))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = multitask_grad_fn(tmodel, 3, tw)(
        interop.to_torch(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = DTYPES[dtype][2]
    _close(tl.numpy(), jl, tol, "loss")
    _close(tm["per_task_loss"].numpy(), jm["per_task_loss"], tol,
           "per_task_loss")
    if dtype == "bf16" and arch in RECURRENT_ARCHS:
        _, _, jg32 = jax.jit(j_multitask_grad_fn(j_make_lm_multitask(
            jcfg.replace(compute_dtype=jnp.float32)), 3, tw))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        return _close_grads_to_noise(tg, jg, jg32)
    _close_grads(tg, jg, dtype)


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
