"""Parity of the port's LM serving slice with ``repro``.

The same parameters (``repro``'s ``lm_init`` tree, copied through
``repro_torch.interop``) and the same numpy-seeded tokens go through
``repro``'s model and serving functions and through the port's. The port's
``impl="pallas"`` runs the kernels' plain versions here (CPU tensors);
``repro`` is held at its default ``"chunked"`` impl.

Tolerances (fp32 compute): 2e-4 atol / 2e-3 rtol on logits, what
``tests/test_serve.py`` holds ``repro``'s own decode to against teacher
forcing; caches 2e-5 (one projection and RoPE, summed in another order);
the building blocks 1e-5. The bf16 case is stated where it is tested.
The recurrent configs (zamba2-1.2b: Mamba2 and the shared attention block;
xlstm-125m: mLSTM and sLSTM) carry fixed-size states as their caches,
held to the same 2e-5.

Shared inputs, references and tolerances: ``torch_lm_serve_common``; the
recurrent configs' decode paths and launchers:
``test_torch_lm_recurrent.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.data import lm_data as j_lm_data
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jt
from repro.train import serve as jserve

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import lm_data as t_lm_data
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as tt
from repro_torch.train import serve as tserve
from torch_lm_serve_common import (CACHE_KEYS, CASES, IMPLS, LM_ARCHS,
                                   _cfgs, _close, _params, _reference,
                                   _tokens)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", ["flat", "batched", "offset"])
def test_apply_rope_matches_repro(dtype, pos_shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = {"flat": np.arange(7), "batched": rng.integers(0, 5000, (2, 7)),
           "offset": np.arange(4090, 4097)}[pos_shape].astype(np.int32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jcommon.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = tcommon.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    # angles up to 4096 rad: f32 sin/cos differ by a few ulp of the angle
    _close(got.float(), np.asarray(want, np.float32), atol=tol * 4,
           rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_repro(dtype):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = tcommon.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == tx.dtype
    _close(got.float(), np.asarray(want, np.float32), atol=tol, rtol=tol)
    p = {"scale": scale, "bias": bias}
    got = tcommon.layernorm(interop.to_torch(p), tx)
    want = jcommon.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jx)
    _close(got.float(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_matches_repro(act):
    jp = jmlp.swiglu_init(jax.random.PRNGKey(3), 32, 80, jnp.float32, 4)
    x = np.random.default_rng(3).standard_normal((2, 6, 32)).astype(
        np.float32)
    want = jmlp.swiglu_apply(jp, jnp.asarray(x), act)
    got = tmlp.swiglu_apply(interop.to_torch(jp), torch.from_numpy(x), act)
    _close(got, want, atol=1e-5, rtol=1e-5)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    tp = tmlp.swiglu_init(np.random.default_rng(0), 32, 80, n_layers=4)
    assert interop.tree_map(lambda a: tuple(a.shape), tp) == shapes


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("impl,kw", [
    ("naive", {}), ("chunked", {"q_chunk": 8, "k_chunk": 16}),
    ("chunked", {}), ("pallas", {})])
def test_sdpa_impls_match_repro(impl, kw, window):
    """Every impl against repro's oracle on ragged lengths (37 queries:
    the chunked path pads both streams) with GQA, causal and windowed."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 37, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    pos = np.arange(37, dtype=np.int32)
    want = jattn.sdpa_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                            window=window)
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), q_pos=torch.from_numpy(pos),
                     k_pos=torch.from_numpy(pos), window=window, impl=impl,
                     **kw)
    _close(got, want, atol=1e-5, rtol=1e-5)
    if kw:
        same = jattn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_pos=jnp.asarray(pos),
                                  k_pos=jnp.asarray(pos), window=window,
                                  **kw)
        _close(got, same, atol=1e-5, rtol=1e-5)


def test_unembed_accumulates_in_f32_like_repro():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((300, 64)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        want = jcommon.unembed({"table": jnp.asarray(table)},
                               jnp.asarray(x, dtype=dt))
        got = tcommon.unembed({"table": torch.from_numpy(table)},
                              torch.from_numpy(x).to(getattr(torch, dt)))
        assert got.dtype == torch.float32
        _close(got, want, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# configs, data, interop
# ---------------------------------------------------------------------------

LM_FIELDS = ("name", "family", "citation", "n_layers", "d_model", "n_heads",
             "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias", "act",
             "norm", "rope_theta", "tie_embeddings", "window",
             "block_pattern", "hd", "padded_vocab", "pattern", "n_tasks",
             "n_experts", "top_k", "n_shared_experts", "d_ff_expert",
             "router_aux_coef", "capacity_factor", "kv_lora", "q_lora",
             "rope_dims", "v_head_dim", "naive_tp", "fsdp", "train_accum",
             "swa_variant_window", "long_context_ok", "remat", "ssm_state",
             "ssm_heads", "ssm_expand", "ssm_chunk", "conv_kernel",
             "mlstm_chunked")
DTYPE_FIELDS = ("param_dtype", "compute_dtype", "moment_dtype")


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_repro(arch, smoke):
    from repro.configs import get as j_get
    j = j_get_smoke(arch) if smoke else j_get(arch)
    t = tconfigs.get_smoke(arch) if smoke else tconfigs.get(arch)
    for f in LM_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    for f in DTYPE_FIELDS:
        assert str(getattr(t, f)) == f"torch.{jnp.dtype(getattr(j, f))}", f
    # deepseek-v2 holds its weights in bf16; the others in f32
    want = torch.bfloat16 if arch == "deepseek-v2-236b" and not smoke \
        else torch.float32
    assert t.param_dtype == want and t.compute_dtype == torch.bfloat16


def test_registry_knows_only_ported_archs():
    """Every arch of ``repro``'s registry is ported, in its order, and a
    name neither package knows raises ``KeyError`` in both."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import get as j_get
    assert tconfigs.ARCHS == J_ARCHS
    for get in (tconfigs.get, tconfigs.get_smoke, j_get):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gemma3-27b")


def test_lm_data_is_repro_s():
    want = j_lm_data.make_lm_sources(3, 4, 17, 500, seed=5)
    got = t_lm_data.make_lm_sources(3, 4, 17, 500, seed=5)
    for a, b in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_interop_carries_lm_trees_and_caches():
    ref = _reference("swa")
    tp = interop.to_torch(ref["params"])
    assert set(tp) == set(ref["params"])
    back = interop.to_numpy(tp)
    for (path, a) in jax.tree_util.tree_leaves_with_path(ref["params"]):
        b = back
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(a, b)
    caches = interop.to_torch(ref["caches"])
    assert isinstance(caches["scan"], tuple)
    assert caches["scan"][0]["pos"].shape == (3,)
    one = interop.to_torch({"pos": np.int32(7), "t": (np.ones(2), 3)})
    assert one["pos"].dim() == 0 and int(one["pos"]) == 7
    assert isinstance(one["t"], tuple) and int(one["t"][1]) == 3
    doubled = interop.tree_map(lambda a: a * 2, caches)
    assert isinstance(doubled["scan"], tuple)
    assert torch.equal(doubled["scan"][0]["pos"], 2 * caches["scan"][0]["pos"])


def test_lm_init_layout_matches_repro():
    for case in ("attn_swa_rem", "h2o_smoke", "zamba2_smoke",
                 "xlstm_smoke"):
        jcfg, tcfg = _cfgs(case)
        jcfg, tcfg = jcfg.replace(n_tasks=3), tcfg.replace(n_tasks=3)
        want = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            jt.lm_init(jax.random.PRNGKey(0), jcfg))
        def layout(tree):
            return interop.tree_map(
                lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                tree)
        assert layout(tt.lm_init(np.random.default_rng(0), tcfg)) == want
        # a seeded torch.Generator draws the same layout where it lives
        gen = torch.Generator().manual_seed(0)
        assert layout(tt.lm_init(gen, tcfg)) == want


# ---------------------------------------------------------------------------
# the slice: prefill, decode, generation, task heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_and_caches_match_repro(case, impl):
    ref = _reference(case)
    _, tcfg = _cfgs(case)
    tp = interop.to_torch(ref["params"])
    S = ref["S"]
    toks = torch.from_numpy(ref["toks"])
    full, caches, _ = tt.lm_apply(tp, toks, cfg=tcfg, impl=impl)
    _close(full, ref["full"], msg="teacher-forced logits")
    logits, caches = tserve.make_prefill_step(tcfg, impl)(tp, toks[:, :S])
    _close(logits, ref["prefill"], msg="prefill logits")
    want = ref["caches"]
    assert isinstance(caches["scan"], tuple)
    assert len(caches["scan"]) == len(want["scan"])
    assert set(caches) == set(want)
    # GQA caches hold k/v, MLA's the latent ckv/krope, a recurrent block
    # its state; each leaf in repro's dtype
    unit = tcfg.block_pattern
    rem = tcfg.pattern[len(tcfg.pattern) // len(unit) * len(unit):]
    pairs = list(zip(unit, caches["scan"], want["scan"])) + [
        (bt, caches["rem"][f"r{i}"], want["rem"][f"r{i}"])
        for i, bt in enumerate(rem)]
    for btype, got_u, want_u in pairs:
        assert set(got_u) == set(want_u) == CACHE_KEYS[btype]
        for k, w in want_u.items():
            assert tuple(got_u[k].shape) == w.shape, k
            assert str(got_u[k].dtype) == f"torch.{w.dtype}", k
            if k == "pos":
                np.testing.assert_array_equal(got_u[k].numpy(), w)
            else:
                _close(got_u[k].float(), np.asarray(w, np.float32),
                       atol=2e-5, rtol=2e-5, msg=k)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_repro(case, impl):
    """Prefill S tokens, extend the caches, decode T steps fed the true next
    token: each step's logits against repro's decode and (where repro's own
    decode reproduces it) repro's teacher-forced forward."""
    ref = _reference(case)
    jcfg, tcfg = _cfgs(case)
    tp = interop.to_torch(ref["params"])
    S, T = ref["S"], ref["T"]
    toks = torch.from_numpy(ref["toks"])
    _, caches = tserve.make_prefill_step(tcfg, impl)(tp, toks[:, :S])
    caches = tserve.extend_caches(caches, tcfg, S + T)
    decode = tserve.make_decode_step(tcfg, impl)
    # repro's extend_caches keeps every k/v cache at or past the window at
    # its length, the full-attention layers' of a mixed pattern too, so
    # its decode there departs from teacher forcing (ROADMAP.md, queue 3);
    # and a MoE config's full forward routes 512-token groups whose
    # capacity may drop tokens a decode step's group of B keeps
    mixed = ("attn" in jcfg.block_pattern and jcfg.window > 0) or (
        jcfg.n_experts > 0
        and jcfg.capacity_factor < jcfg.n_experts / jcfg.top_k)
    for t in range(T):
        logits, caches = decode(tp, toks[:, S + t:S + t + 1], caches,
                                torch.tensor(S + t))
        _close(logits[:, 0], ref["decode"][t], msg=f"decode step {t}")
        if not mixed:
            _close(logits[:, 0], ref["full"][:, S + t], msg=f"step {t}")


@pytest.mark.parametrize("impl", IMPLS)
def test_rolling_window_cache_decode_matches_teacher_forcing(impl):
    """SWA decode from token 0 with a cache of window size (8) over 24
    tokens: slots are overwritten, k_pos is not monotone."""
    ref = _reference("swa")
    jcfg, tcfg = _cfgs("swa")
    tp = interop.to_torch(ref["params"])
    toks = _tokens(jcfg, 1, 24, seed=1)
    full, _, _ = jt.lm_apply(ref["params"], jnp.asarray(toks), cfg=jcfg)
    caches = tt.lm_cache_init(tp, tcfg, 1, tcfg.window)
    assert caches["scan"][0]["k"].shape == (3, 1, 8, 2, 16)
    decode = tserve.make_decode_step(tcfg, impl)
    for t in range(24):
        logits, caches = decode(tp, torch.from_numpy(toks[:, t:t + 1]),
                                caches, t)
        _close(logits[:, 0], np.asarray(full[:, t]), msg=f"t={t}")
    assert caches["scan"][0]["pos"].tolist() == [24, 24, 24]


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_matches_repro(case, impl):
    ref = _reference(case)
    _, tcfg = _cfgs(case)
    tp = interop.to_torch(ref["params"])
    prompt = torch.from_numpy(ref["toks"][:, :ref["S"]])
    got, logits = tserve.greedy_generate(tp, tcfg, prompt, 6, impl=impl,
                                         device="cpu", return_logits=True)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])
    assert logits.shape == (2, 6, tcfg.padded_vocab)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), ref["greedy"])


def test_extend_caches_matches_repro():
    """Padding to capacity; a window cache at or past the window keeps its
    length (repro's rule)."""
    for case in ("swa", "attn", "attn_swa_rem", "deepseek_smoke",
                 "zamba2_smoke", "xlstm_smoke"):
        ref = _reference(case)
        jcfg, tcfg = _cfgs(case)
        for cap in (16, 21, 40):
            want = jserve.extend_caches(
                jax.tree_util.tree_map(jnp.asarray, ref["caches"]), jcfg, cap)
            got = tserve.extend_caches(interop.to_torch(ref["caches"]), tcfg,
                                       cap)
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                want, interop.to_numpy(got))


@pytest.mark.parametrize("impl", IMPLS)
def test_task_heads_match_repro(impl):
    """The paper's per-source LM heads: ``lm_logits(task=)`` for each head
    and the task-major (T, B, S, d) layout, and one decode step under
    ``make_decode_step(task=)``."""
    jcfg, tcfg = _cfgs("h2o_smoke")
    jcfg, tcfg = jcfg.replace(n_tasks=3), tcfg.replace(n_tasks=3)
    jp = _params(jcfg, seed=2)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    for task in range(3):
        want = jt.lm_logits(jp, jnp.asarray(hidden), jcfg, task=task)
        got = tt.lm_logits(tp, torch.from_numpy(hidden), tcfg, task=task)
        _close(got, want, atol=1e-5, rtol=1e-5)
    stacked = rng.standard_normal((3, 2, 5, jcfg.d_model)).astype(np.float32)
    _close(tt.lm_logits(tp, torch.from_numpy(stacked), tcfg),
           jt.lm_logits(jp, jnp.asarray(stacked), jcfg), atol=1e-5,
           rtol=1e-5)
    toks = _tokens(jcfg, 2, 9, seed=3)
    _, jc, _ = jt.lm_apply(jp, jnp.asarray(toks[:, :8]), cfg=jcfg,
                           mode="prefill", task=1)
    want, _ = jserve.make_decode_step(jcfg, task=1)(
        jp, jnp.asarray(toks[:, 8:]), jserve.extend_caches(jc, jcfg, 9),
        jnp.asarray(8))
    _, tc, _ = tt.lm_apply(tp, torch.from_numpy(toks[:, :8]), cfg=tcfg,
                           mode="prefill", impl=impl, task=1)
    got, _ = tserve.make_decode_step(tcfg, impl, task=1)(
        tp, torch.from_numpy(toks[:, 8:]), tserve.extend_caches(tc, tcfg, 9),
        8)
    _close(got, want)


def test_bf16_compute_matches_repro():
    """h2o-danube smoke at its own bf16 compute: logits of prefill and two
    decode steps. Tolerance 5e-2 absolute on logits of magnitude ~1: both
    sides round every matmul output, the attention output and the residual
    stream to bf16 (8 mantissa bits, 3.9e-3 relative), at places that
    differ between XLA and PyTorch, over 2 layers."""
    jcfg, tcfg = j_get_smoke("h2o-danube-1.8b"), tconfigs.get_smoke(
        "h2o-danube-1.8b")
    jp = _params(jcfg, seed=4)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    toks = _tokens(jcfg, 2, 18, seed=4)
    full, _, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg)
    scale = float(np.abs(np.asarray(full)).max())
    for impl in IMPLS:
        logits, caches = tserve.make_prefill_step(tcfg, impl)(
            tp, torch.from_numpy(toks[:, :16]))
        _close(logits, np.asarray(full[:, :16]), atol=5e-2 * scale, rtol=0)
        caches = tserve.extend_caches(caches, tcfg, 18)
        for t in (16, 17):
            logits, caches = tserve.make_decode_step(tcfg, impl)(
                tp, torch.from_numpy(toks[:, t:t + 1]), caches, t)
            _close(logits[:, 0], np.asarray(full[:, t]), atol=5e-2 * scale,
                   rtol=0, msg=f"{impl} step {t}")


def test_unported_blocks_raise():
    """The encoder-decoder blocks and the media frontend, refused until
    they were ported, now run: ``enc_attn`` / ``dec_attn`` init and cache
    init (the decoder's cache nested under ``"self"``), and media put
    before the text by ``embed_inputs``. What no version takes still
    raises: an unknown block type, an unknown attention impl."""
    _, tcfg = _cfgs("attn")
    rng = np.random.default_rng(0)
    for bt in ("enc_attn", "dec_attn"):
        p = tt.block_init(rng, tcfg, bt)
        assert {"ln1", "attn", "ln2", "ffn"} <= set(p)
        assert ("xattn" in p and "ln_x" in p) == (bt == "dec_attn")
        c = tt.block_cache_init(tcfg, bt, 1, 4)
        c = c["self"] if bt == "dec_attn" else c
        assert tuple(c["k"].shape) == (1, 4, tcfg.n_kv_heads, tcfg.hd)
    vcfg = tcfg.replace(modality="vision_embed")
    params = tt.lm_init(rng, vcfg)
    x = tt.embed_inputs(params, torch.zeros((1, 2), dtype=torch.long), vcfg,
                        media=torch.zeros(1, 3, 1024))
    assert tuple(x.shape) == (1, 5, tcfg.d_model)
    with pytest.raises(ValueError, match="block type"):
        tt.block_init(rng, tcfg, "conv")
    with pytest.raises(ValueError, match="impl"):
        tattn.sdpa(torch.zeros(1, 2, 2, 16), torch.zeros(1, 2, 2, 16),
                   torch.zeros(1, 2, 2, 16), q_pos=torch.arange(2),
                   k_pos=torch.arange(2), impl="flash")


def test_serve_lm_cli_on_cpu(capsys):
    from repro_torch.launch import serve_lm
    out = serve_lm.main(["--device", "cpu", "--batch", "2",
                         "--prompt-len", "12", "--new", "4"])
    assert out.shape == (2, 4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"impl": "pallas"' in line and '"decode_tok_per_s"' in line
    # on the CPU "pallas" runs the kernels' plain versions: the tokens are
    # the plain "chunked" path's on the CLI's weights and prompt (seed 0)
    cfg = tconfigs.get_smoke("h2o-danube-1.8b")
    params = tt.lm_init(np.random.default_rng(0), cfg)
    prompt = t_lm_data.make_lm_source(1, 2, 12, cfg.vocab)["tokens"]
    plain = tserve.greedy_generate(params, cfg, prompt, 4, impl="chunked",
                                   device="cpu")
    assert torch.equal(plain, out)
