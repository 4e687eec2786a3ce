"""gemma3-12b and stablelm-12b in the port against ``repro``, at the smoke
widths and at the configs' own head dims, and ``Session``'s donated AdamW
update.

Both packages start from ``repro``'s parameters (its ``lm_init`` tree with
every norm scale drawn, carried into the port with ``interop.to_torch``)
and see the same numpy-seeded tokens. ``repro`` runs its default
``"chunked"`` impl (its decode through ``sdpa_naive``) and, for #5's
function, its Pallas ``flash_attention`` in interpret mode, as its own
tests run it; its Pallas decode kernel does not run on this JAX, so a
decode is held to its ``"chunked"`` decode. The port runs every impl,
``"pallas"`` taking the kernels' plain versions on CPU tensors.

The smoke configs use head dim 32; the attention cases also run variants
at the configs' own head dim and group (``smoke().replace(head_dim=,
n_heads=, n_kv_heads=)``): gemma3's 256 at G=2, stablelm's 160 at G=4.

gemma3's smoke has window 32. A prompt shorter than the window decodes as
teacher forcing does; a prompt at least the window long makes
``extend_caches`` keep every k/v cache at the prompt's length, its one
full-attention layer in six included (``repro``'s rule), so a decode step
overwrites the oldest slot there and departs from teacher forcing. Decode
is then held to ``repro``'s decode under the same rule.

Tolerances. fp32 compute: attention outputs within 2e-5 (``repro``'s own
kernel-vs-oracle tolerance: sums in another order); logits 2e-4 atol /
2e-3 rtol (``tests/test_serve.py``'s for ``repro``'s own decode), caches
2e-5; the loss and every gradient leaf within 1e-5 x max(1, max|ref|); a
Session's 3-step losses 1e-4 relative. bf16 compute: attention outputs
within 3e-2 (``repro``'s bf16 flash tolerance: one rounding to 8 mantissa
bits of values of magnitude ~1); logits and a model's caches (projections
of a residual stream that both packages round at other points, layer
after layer) within 5e-2 x max|ref|; the loss
within 4e-2 x max(1, |ref|) and each gradient leaf to its own size (its
largest error over its largest |ref| and its 2-norm error over its 2-norm
within 5e-2), as ``tests/test_torch_lm_train.py`` holds them. A donated
``Session`` is held bitwise to a pure one.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.data.lm_data import make_lm_sources as j_make_lm_sources
from repro.engine import Session as JSession
from repro.engine import SessionConfig as JSessionConfig
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.train import serve as jserve
from repro.train.loop import make_lm_loss as j_make_lm_loss

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.data.lm_data import make_lm_sources
from repro_torch.data.synthetic_atoms import generate_all, source_dicts
from repro_torch.engine import (Session, SessionConfig, SingleTaskModel,
                                TrainState, single_grad_fn)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.resilience import GuardConfig, ResilienceConfig
from repro_torch.resilience.faults import Fault, corrupt_batch
from repro_torch.train import serve as tserve
from repro_torch.train.loop import make_lm_loss

GEMMA, STABLE = "gemma3-12b", "stablelm-12b"
ARCHS = (GEMMA, STABLE)
# the configs' own head dim and group on the smoke widths
REAL = {GEMMA: dict(head_dim=256, n_heads=4, n_kv_heads=2),     # G = 2
        STABLE: dict(head_dim=160, n_heads=8, n_kv_heads=2)}    # G = 4
IMPLS = ("naive", "chunked", "pallas")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"f32": 2e-5, "bf16": 3e-2}
ATOL, RTOL = 2e-4, 2e-3
CACHE_TOL = 2e-5
F32_TOL = 1e-5
BF16_TOL = 5e-2
BF16_LOSS_TOL = 4e-2
BF16_GRAD_TOL = 5e-2


def _cfgs(arch, dtype="f32", real=False, **kw):
    jd, td = DTYPES[dtype]
    kw = dict(REAL[arch] if real else {}, **kw)
    return (j_get_smoke(arch).replace(compute_dtype=jd, **kw),
            tconfigs.get_smoke(arch).replace(compute_dtype=td, **kw))


def _params(jcfg, seed=0):
    """repro's tree with every norm scale drawn, so each leaf matters."""
    p = jt.lm_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        x = np.asarray(x)
        if "'scale'" in jax.tree_util.keystr(path):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, p)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float64)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def _logits_close(got, want, dtype, msg=""):
    if dtype == "f32":
        return _close(got, want, msg=msg)
    scale = float(np.abs(_np(want)).max())
    _close(got, want, atol=BF16_TOL * scale, rtol=0, msg=msg)


def _scaled(got, want, tol, msg=""):
    """|got - want| <= tol x max(1, max|want|)."""
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (msg, err)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_repro(arch, smoke):
    """Every field of ``repro``'s config is the port's and equal to it
    (``fsdp``, ``train_accum``, ``long_context_ok``,
    ``swa_variant_window`` and, since the port's dry run,
    ``supports_decode`` included), and so are the derived ``hd``,
    ``padded_vocab`` and ``pattern``; the dtypes by name (fp32 weights,
    bf16 compute)."""
    j = j_get_smoke(arch) if smoke else j_get(arch)
    t = tconfigs.get_smoke(arch) if smoke else tconfigs.get(arch)
    names = [f.name for f in dataclasses.fields(t)]
    assert set(f.name for f in dataclasses.fields(j)) - set(names) == set()
    for f in ("fsdp", "train_accum", "long_context_ok",
              "swa_variant_window", "supports_decode"):
        assert f in names
    for f in names + ["hd", "padded_vocab", "pattern"]:
        want, got = getattr(j, f), getattr(t, f)
        if f.endswith("_dtype"):
            assert str(got) == f"torch.{jnp.dtype(want)}", f
        else:
            assert got == want, f
    assert t.param_dtype == torch.float32
    assert t.compute_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention at the configs' own head dims
# ---------------------------------------------------------------------------

def _qkv(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _repro_prefill(arch, dtype, window):
    """repro's causal attention over 2 x 40 tokens at the config's head
    dim and group: its Pallas kernel in interpret mode and its chunked
    path, computed once."""
    jcfg, _ = _cfgs(arch, dtype, real=True)
    q, k, v = (jnp.asarray(x, jcfg.compute_dtype)
               for x in _qkv(jcfg, 2, 40, seed=len(arch) + window))
    pos = jnp.arange(40)
    kw = dict(q_pos=pos, k_pos=pos, causal=True, window=window)
    return {"inputs": [np.asarray(x.astype(jnp.float32)) for x in (q, k, v)],
            "pallas": np.asarray(jattn.sdpa(q, k, v, impl="pallas", **kw)
                                 .astype(jnp.float32)),
            "chunked": np.asarray(jattn.sdpa(q, k, v, impl="chunked", **kw)
                                  .astype(jnp.float32))}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_attention_at_real_head_dims(arch, dtype, window, impl):
    """The port's ``sdpa`` (``"pallas"``: #5's plain version) at D=256 /
    G=2 and D=160 / G=4, causal and windowed, against ``repro``'s Pallas
    kernel (interpret mode) and its chunked path."""
    _, tcfg = _cfgs(arch, dtype, real=True)
    ref = _repro_prefill(arch, dtype, window)
    q, k, v = (torch.tensor(x).to(tcfg.compute_dtype)
               for x in ref["inputs"])
    pos = torch.arange(40)
    got = tattn.sdpa(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                     window=window, impl=impl)
    assert got.dtype == tcfg.compute_dtype and got.shape == q.shape
    for name in ("pallas", "chunked"):
        _close(got, ref[name], atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype],
               msg=name)


def _repro_gqa_decode(jcfg, jp, x, S, T, window, capacity):
    """repro's ``gqa_apply``: prefill of S tokens, the cache extended as
    ``extend_caches`` does it, then T decode steps (``"chunked"``)."""
    pos = jnp.arange(S)
    _, cache = jattn.gqa_apply(jp, jnp.asarray(x[:, :S]), cfg=jcfg,
                               positions=pos, window=window, cache="init")
    cache = jserve.extend_caches({"c": cache}, jcfg, capacity)["c"]
    step = jax.jit(lambda p, xt, t, c: jattn.gqa_apply(
        p, xt, cfg=jcfg, positions=jnp.reshape(t, (1,)), window=window,
        cache=c))
    outs = []
    for t in range(S, S + T):
        o, cache = step(jp, jnp.asarray(x[:, t:t + 1]), jnp.asarray(t),
                        cache)
        outs.append(np.asarray(o.astype(jnp.float32)))
    return outs, jax.tree_util.tree_map(np.asarray, cache)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("cache", ["full", "rolling"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_at_real_head_dims(arch, dtype, cache, impl):
    """``gqa_apply`` decode steps at D=256 / G=2 and D=160 / G=4
    (``"pallas"``: #6's plain version with the planner's splits): a full
    cache (a 12-token prompt, padded to 16) and a rolling one (a 40-token
    prompt past a window of 32: the cache keeps 40 slots and each step
    overwrites the oldest), against ``repro``'s decode; the outputs and
    the caches after 4 steps."""
    S, T = (12, 4) if cache == "full" else (40, 4)
    window = 0 if cache == "full" else 32
    jcfg, tcfg = _cfgs(arch, dtype, real=True, window=32)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(S).standard_normal(
        (2, S + T, jcfg.d_model)).astype(np.float32)
    want, want_cache = _repro_gqa_decode(jcfg, jp, x, S, T, window, S + T)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    xt = torch.from_numpy(x)
    _, c = tattn.gqa_apply(tp, xt[:, :S], cfg=tcfg, positions=torch.arange(S),
                           window=window, cache="init", impl=impl)
    c = tserve.extend_caches({"c": c}, tcfg, S + T)["c"]
    assert c["k"].shape[1] == (S if cache == "rolling" else S + T)
    for i, t in enumerate(range(S, S + T)):
        o, c = tattn.gqa_apply(tp, xt[:, t:t + 1], cfg=tcfg,
                               positions=torch.tensor([t]), window=window,
                               cache=c, impl=impl)
        if dtype == "f32":
            _close(o, want[i], atol=CACHE_TOL, rtol=CACHE_TOL, msg=f"{t}")
        else:
            _logits_close(o, want[i], dtype, msg=f"{t}")
    tol = CACHE_TOL if dtype == "f32" else ATTN_TOL[dtype]
    for key in ("k", "v"):
        _close(c[key], want_cache[key], atol=tol, rtol=tol, msg=key)
    assert int(c["pos"]) == int(want_cache["pos"]) == S + T


# ---------------------------------------------------------------------------
# the models: train, prefill, decode, generation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, S, T=5):
    """repro's outputs for one smoke config, computed once: teacher-forced
    logits over S + T tokens, prefill logits and caches of S, T decode
    steps after ``extend_caches``, 6 greedy tokens."""
    jcfg, _ = _cfgs(arch, dtype)
    jp = _params(jcfg)
    toks = _tokens(jcfg, 2, S + T, seed=S)
    full = jax.jit(lambda p, t: jt.lm_apply(p, t, cfg=jcfg)[0])(
        jp, jnp.asarray(toks))
    pre, caches = jax.jit(jserve.make_prefill_step(jcfg))(
        jp, jnp.asarray(toks[:, :S]))
    pre_caches = jax.tree_util.tree_map(np.asarray, caches)
    caches = jserve.extend_caches(caches, jcfg, S + T)
    decode = jax.jit(jserve.make_decode_step(jcfg))
    dec = []
    for t in range(S, S + T):
        lg, caches = decode(jp, jnp.asarray(toks[:, t:t + 1]), caches,
                            jnp.asarray(t))
        dec.append(np.asarray(lg[:, 0].astype(jnp.float32)))
    greedy = None if dtype != "f32" else np.asarray(jserve.greedy_generate(
        jp, jcfg, jnp.asarray(toks[:, :S]), 6))
    return dict(params=jax.tree_util.tree_map(np.asarray, jp), toks=toks,
                full=np.asarray(full, np.float32),
                prefill=np.asarray(pre, np.float32),
                caches=_flat(pre_caches), decode=dec, greedy=greedy)


def _flat(tree, prefix=""):
    """The leaves of nested dicts and tuples (a stacked unit's caches are a
    tuple) by path, as f32 numpy arrays (bf16 caches compared as f32; the
    position counters as they are)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        x = tree.float() if isinstance(tree, torch.Tensor) and \
            tree.is_floating_point() else tree
        x = np.asarray(x)
        return {prefix: x.astype(np.float32) if x.dtype.kind in "fV"
                or x.dtype.name == "bfloat16" else x}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _port_run(ref, tcfg, S, T, impl):
    tp = interop.to_torch(ref["params"])
    toks = torch.from_numpy(ref["toks"])
    full = tt.lm_apply(tp, toks, cfg=tcfg, impl=impl)[0]
    pre, caches = tserve.make_prefill_step(tcfg, impl)(tp, toks[:, :S])
    pre_caches = _flat(caches)
    caches = tserve.extend_caches(caches, tcfg, S + T)
    decode = tserve.make_decode_step(tcfg, impl)
    dec = []
    for t in range(S, S + T):
        lg, caches = decode(tp, toks[:, t:t + 1], caches, t)
        dec.append(lg[:, 0])
    return tp, full, pre, pre_caches, dec, caches


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_matches_repro(arch, dtype, impl):
    """``lm_apply`` in train mode, prefill (logits and every cache) and 5
    decode steps after a 16-token prompt, under the window: decode is held
    to ``repro``'s and to teacher forcing alike."""
    S, T = 16, 5
    ref = _reference(arch, dtype, S, T)
    _, tcfg = _cfgs(arch, dtype)
    _, full, pre, pre_caches, dec, _ = _port_run(ref, tcfg, S, T, impl)
    _logits_close(full, ref["full"], dtype, "train")
    _logits_close(pre, ref["prefill"], dtype, "prefill")
    want = ref["caches"]
    assert set(pre_caches) == set(want)
    for k, v in want.items():
        if dtype == "f32":
            _close(pre_caches[k], v, atol=CACHE_TOL, rtol=CACHE_TOL, msg=k)
        else:
            _logits_close(pre_caches[k], v, dtype, msg=k)
    for i in range(T):
        _logits_close(dec[i], ref["decode"][i], dtype, f"decode {i}")
        _logits_close(dec[i], ref["full"][:, S + i], dtype, f"teacher {i}")


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_repro(arch, impl):
    """``greedy_generate`` token for token (f32: the argmax of logits that
    agree to 2e-4 is the same token), its logits' argmax the same."""
    ref = _reference(arch, "f32", 16)
    _, tcfg = _cfgs(arch)
    tp = interop.to_torch(ref["params"])
    got, logits = tserve.greedy_generate(
        tp, tcfg, torch.from_numpy(ref["toks"][:, :16]), 6, impl=impl,
        device="cpu", return_logits=True)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), ref["greedy"])


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemma3_decode_past_the_window_matches_repro(dtype, impl):
    """gemma3's smoke (window 32) with a 36-token prompt: every k/v cache
    keeps the prompt's 36 slots (``repro``'s rule), the full-attention
    layer's too, and 5 decode steps overwrite its oldest slots. Prefill and
    every cache are ``repro``'s; decode is held to ``repro``'s decode
    under that rule, and departs from teacher forcing (the full-attention
    layer no longer sees the overwritten positions); greedy generation
    token for token in f32."""
    S, T = 36, 5
    ref = _reference(GEMMA, dtype, S, T)
    _, tcfg = _cfgs(GEMMA, dtype)
    tp, full, pre, pre_caches, dec, caches = _port_run(ref, tcfg, S, T,
                                                       impl)
    _logits_close(pre, ref["prefill"], dtype, "prefill")
    _logits_close(full, ref["full"], dtype, "train")
    # the 5:1 unit is one repetition of six layers; its sixth is "attn"
    assert tcfg.pattern[5] == "attn" and tcfg.window == 32
    assert caches["scan"][5]["k"].shape[2] == S
    assert all(c["k"].shape[2] == S for c in caches["scan"])
    for i in range(T):
        _logits_close(dec[i], ref["decode"][i], dtype, f"decode {i}")
    departure = max(float(np.abs(_np(dec[i]) - ref["full"][:, S + i]).max())
                    for i in range(T))
    assert departure > 1e-3
    if dtype == "f32":
        got = tserve.greedy_generate(tp, tcfg,
                                     torch.from_numpy(ref["toks"][:, :S]),
                                     6, impl=impl, device="cpu")
        np.testing.assert_array_equal(got.numpy(), ref["greedy"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _close_grads(got, want, dtype):
    """fp32: each leaf within 1e-5 x max(1, max|ref|); bf16: each leaf's
    largest error over its largest |ref|, and its 2-norm error over its
    2-norm, within 5e-2."""
    wl = interop.leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        g = gl[k].double().numpy()
        assert g.shape == w.shape, k
        if dtype == "f32":
            _scaled(g, w, F32_TOL, k)
            continue
        top, norm = float(np.abs(w).max()), float(np.linalg.norm(w))
        assert top > 0, k
        assert float(np.abs(g - w).max()) <= BF16_GRAD_TOL * top, k
        assert float(np.linalg.norm(g - w)) <= BF16_GRAD_TOL * norm, k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_repro(arch, dtype):
    """``make_lm_loss`` through ``single_grad_fn`` with per-block remat:
    the loss and every gradient leaf."""
    jcfg, tcfg = _cfgs(arch, dtype, remat=True)
    params = _params(jcfg, seed=1)
    batch = make_lm_sources(1, 2, 24, tcfg.vocab, seed=3)[0]
    jl, jg = jax.jit(jax.value_and_grad(j_make_lm_loss(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = SingleTaskModel(init=None, loss_fn=make_lm_loss(tcfg))
    tl, _, tg = single_grad_fn(model)(
        interop.to_torch(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _scaled(tl, jl, F32_TOL if dtype == "f32" else BF16_LOSS_TOL, "loss")
    _close_grads(tg, jg, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_session_matches_repro(arch):
    """``model="lm"`` through ``Session`` (donated AdamW, the default) for
    3 steps from ``repro``'s initial params: each step's loss within 1e-4
    relative of ``repro``'s."""
    jcfg, tcfg = _cfgs(arch)
    source = j_make_lm_sources(1, 16, 16, jcfg.vocab)[0]
    common = dict(steps=3, batch_per_task=4, lr=2e-3, warmup=2,
                  log_every=1, verbose=False, seed=0)
    js = JSession.from_config(JSessionConfig(model="lm", arch=jcfg,
                                             **common), sources=source)
    ts = Session.from_config(SessionConfig(model="lm", arch=tcfg, **common),
                             sources=source, device="cpu")
    assert ts.plan.donate and ts.cfg.donate
    ts.state = TrainState.create(interop.to_torch(js.state.params),
                                 ts.optimizer)
    with js, ts:
        jr, tr = js.run(), ts.run()
    jl = [r["loss"] for r in jr.logger.history]
    tl = [r["loss"] for r in tr.logger.history]
    assert len(tl) == len(jl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ---------------------------------------------------------------------------
# Session's donated AdamW update
# ---------------------------------------------------------------------------

def _gfm_sources():
    cfg = t_gfm.smoke()
    return source_dicts(generate_all(12, max_atoms=cfg.max_atoms,
                                     max_edges=cfg.max_edges,
                                     sources=["ani1x", "qm7x", "mptrj"]))


def _session_runs(model, donate, steps=3, **kw):
    """A 3-step session (prefetch off) from the session's own seeded init:
    its final state, losses, and whether the params kept their storage."""
    if model == "lm":
        arch = tconfigs.get_smoke(STABLE).replace(compute_dtype=torch.float32)
        sources = make_lm_sources(1, 16, 16, arch.vocab)[0]
    else:
        arch = t_gfm.smoke().replace(compute_dtype=torch.float32)
        sources = _gfm_sources()
    cfg = SessionConfig(model=model, arch=arch, steps=steps,
                        batch_per_task=4, lr=2e-3, warmup=2, grad_clip=1.0,
                        log_every=1, verbose=False, prefetch=False,
                        donate=donate, **kw)
    with Session.from_config(cfg, sources=sources, device="cpu") as sess:
        first = dict(interop.leaves(sess.state.params))
        res = sess.run()
        kept = all(interop.leaves(res.state.params)[k] is v
                   for k, v in first.items())
    return res.state, [r["loss"] for r in res.logger.history], kept


@pytest.mark.parametrize("model", ["gfm-mtl", "lm"])
def test_donated_session_is_bitwise_the_pure_one(model):
    """``SessionConfig.donate=True`` (the default) builds
    ``adamw(donate=True)``: params and moments keep their storage and
    take the pure update's bits, step for step (losses, then params and
    both moments after 3 steps)."""
    pure, pl, pure_kept = _session_runs(model, donate=False)
    don, dl, don_kept = _session_runs(model, donate=True)
    assert don_kept and not pure_kept
    assert pl == dl and don.opt_state.step == pure.opt_state.step == 3
    for a, b in ((pure.params, don.params), (pure.opt_state.m,
                                             don.opt_state.m),
                 (pure.opt_state.v, don.opt_state.v)):
        la, lb = interop.leaves(a), interop.leaves(b)
        assert set(la) == set(lb)
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_donating_session_owns_its_state():
    """A model whose init hands back tensors its caller holds (fine-tuning
    passes the pre-trained trunk): a donating session trains a copy and
    leaves the caller's tensors as they were."""
    arch = tconfigs.get_smoke(STABLE).replace(compute_dtype=torch.float32)
    base = tt.lm_init(np.random.default_rng(0), arch)
    before = {k: v.clone() for k, v in interop.leaves(base).items()}
    model = SingleTaskModel(init=lambda seed=0, device="cpu": base,
                            loss_fn=make_lm_loss(arch), name="lm")
    cfg = SessionConfig(model="lm", arch=arch, steps=2, batch_per_task=4,
                        lr=1e-2, log_every=1, verbose=False, prefetch=False)
    with Session.from_config(cfg, sources=make_lm_sources(
            1, 16, 16, arch.vocab)[0], model=model, device="cpu") as sess:
        res = sess.run()
    assert all(torch.equal(v, before[k])
               for k, v in interop.leaves(base).items())
    assert not all(torch.equal(v, before[k]) for k, v in
                   interop.leaves(res.state.params).items())


def test_guarded_donating_session_keeps_a_tripped_steps_state(tmp_path):
    """A guarded session (``cfg.resilience`` with a ``GuardConfig``) under
    ``donate=True``: a step on a NaN batch trips and leaves params, both
    moments and the step counter bitwise as they were (the update never
    ran); the next clean step is accepted and equals a pure session's."""
    arch = t_gfm.smoke().replace(compute_dtype=torch.float32)
    sources = _gfm_sources()
    states = []
    for donate in (True, False):
        cfg = SessionConfig(
            model="gfm-mtl", arch=arch, steps=2, batch_per_task=4,
            verbose=False, prefetch=False, donate=donate,
            resilience=ResilienceConfig(ckpt_dir=str(tmp_path / "ck"),
                                        guard=GuardConfig()))
        sess = Session.from_config(cfg, sources=sources, device="cpu")
        assert sess.optimizer is not None and sess.plan.donate == donate
        batch = sess._batches()()
        state = sess.state
        snap = [{k: v.clone() for k, v in interop.leaves(t).items()}
                for t in (state.params, state.opt_state.m,
                          state.opt_state.v)]
        bad = corrupt_batch(batch, Fault(tick=1, kind="nan_grad"))
        state, out = sess.step_fn(state, bad)
        assert not bool(out.metrics["guard_ok"])
        assert state.step == 0 and state.opt_state.step == 0
        for t, want in zip((state.params, state.opt_state.m,
                            state.opt_state.v), snap):
            assert all(torch.equal(v, want[k])
                       for k, v in interop.leaves(t).items())
        state, out = sess.step_fn(state, batch)
        assert bool(out.metrics["guard_ok"]) and state.step == 1
        states.append(state)
        sess.close()
    don, pure = states
    for a, b in ((don.params, pure.params), (don.opt_state.m,
                                             pure.opt_state.m)):
        la, lb = interop.leaves(a), interop.leaves(b)
        assert all(torch.equal(la[k], lb[k]) for k in la)


# ---------------------------------------------------------------------------
# the launchers and the examples
# ---------------------------------------------------------------------------

def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_dense", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_and_examples_take_the_archs(arch, capsys):
    """``--arch gemma3-12b`` / ``stablelm-12b`` through the registry, at
    smoke width on the CPU: the serving launcher and example generate, the
    training launcher (``lm``) trains and ends with its JSON summary (no
    peak memory off the card), the multi-task example trains."""
    from repro_torch.launch import serve_lm
    from repro_torch.launch import train as t_launch
    toks = serve_lm.main(["--device", "cpu", "--arch", arch, "--new", "3"])
    assert toks.shape == (4, 3)
    assert f'"arch": "{arch}"' in capsys.readouterr().out
    loss = t_launch.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                          "--steps", "2", "--batch", "2", "--seq", "16"])
    assert np.isfinite(loss)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"mode": "lm", "arch": arch, "width": "smoke",
                       "steps": 2, "final_loss": loss, "device": "cpu",
                       "peak_mem_bytes": None}
    _example("serve_lm_torch").main(["--device", "cpu", "--arch", arch,
                                     "--new", "3"])
    pt = _example("multitask_lm_torch").main(
        ["--device", "cpu", "--arch", arch, "--tasks", "2", "--steps", "2",
         "--seq", "16", "--batch", "2"])
    assert np.all(np.isfinite(pt)) and pt.shape == (2,)
