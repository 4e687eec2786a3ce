"""The port's modality frontends and encoder-decoder against ``repro``'s, at
the smoke widths of internvl2-1b (a vision projector's media before the
text) and seamless-m4t-medium (an audio projector, a bidirectional encoder
and decoder blocks that cross-attend its memory).

Both packages start from ``repro``'s parameters (its ``lm_init`` tree with
every bias, norm scale and norm bias drawn, so each leaf matters, carried
into the port with ``interop.to_torch``) and see the same numpy-seeded
tokens and frames. ``repro`` runs its default ``"chunked"`` impl (its
decode through ``sdpa_naive``); the port runs every impl, ``"pallas"``
taking the kernels' plain versions on CPU tensors.

Tolerances. fp32 compute: the projector and the encoder's memory within
1e-5 x max(1, max|ref|) (the same sums in another order); logits within
2e-4 atol / 2e-3 rtol (``tests/test_serve.py``'s tolerance for
``repro``'s own decode), caches within 2e-5; the loss and every gradient
leaf within 1e-5 x max(1, max|ref|). bf16 compute (the configs' own):
both sides round every matmul output and the residual stream to bf16 at
the same points in another order, so logits and memory are held within
5e-2 x max|ref| (``tests/test_torch_lm.py``'s bf16 tolerance), the loss
within 4e-2 x max(1, |ref|) and each gradient leaf to its own size (its
largest error over its largest |ref| and its 2-norm error over its
2-norm within 5e-2), as ``tests/test_torch_lm_train.py`` holds them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.models import frontends as jfront
from repro.models import transformer as jt
from repro.train import checkpoint as j_ckpt
from repro.train import serve as jserve
from repro.train.loop import make_lm_loss as j_make_lm_loss

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.engine import SingleTaskModel, single_grad_fn
from repro_torch.models import frontends as tfront
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import serve as tserve
from repro_torch.train.loop import make_lm_loss

VLM, ENCDEC = "internvl2-1b", "seamless-m4t-medium"
ARCHS = (VLM, ENCDEC)
IMPLS = ("naive", "chunked", "pallas")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL, RTOL = 2e-4, 2e-3
BLOCK_TOL = 1e-5
CACHE_TOL = 2e-5
BF16_TOL = 5e-2
BF16_LOSS_TOL = 4e-2
BF16_GRAD_TOL = 5e-2
B, S, T, M = 2, 12, 3, 20       # batch, text, decode steps, source frames


def _cfgs(arch, dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    return (j_get_smoke(arch).replace(compute_dtype=jd, **kw),
            tconfigs.get_smoke(arch).replace(compute_dtype=td, **kw))


def _params(jcfg, seed=0):
    """repro's tree with every bias, norm scale and norm bias drawn."""
    p = jt.lm_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if any(f"'{k}'" in name for k in ("b", "scale", "bias")):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, p)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _frames(n, B=B, seed=1):
    """Frontend embeddings (B, n, 1024): the stubs' width."""
    return np.random.default_rng(seed).standard_normal(
        (B, n, tfront.VISION_EMBED_DIM)).astype(np.float32)


def _t(tree):
    return interop.to_torch(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


def _scaled(got, want, tol, msg=""):
    """|got - want| <= tol x max(1, max|want|)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (msg, err)


def _logits_close(got, want, dtype, msg=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        return _close(got, want, msg=msg)
    scale = float(np.abs(want).max())
    _close(got, want, atol=BF16_TOL * scale, rtol=0, msg=msg)


# ---------------------------------------------------------------------------
# configs and the projector
# ---------------------------------------------------------------------------

FIELDS = ("name", "family", "citation", "n_layers", "d_model", "n_heads",
          "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias", "act",
          "norm", "rope_theta", "tie_embeddings", "window", "block_pattern",
          "hd", "padded_vocab", "pattern", "n_enc_layers", "enc_memory_len",
          "modality", "n_media_tokens", "naive_tp", "swa_variant_window",
          "remat", "n_experts")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_repro(arch, smoke):
    j = j_get_smoke(arch) if smoke else j_get(arch)
    t = tconfigs.get_smoke(arch) if smoke else tconfigs.get(arch)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.param_dtype == torch.float32
    assert t.compute_dtype == torch.bfloat16
    # a name neither package knows
    for get in (tconfigs.get, j_get):
        with pytest.raises(KeyError, match="unknown arch"):
            get(arch + "-xl")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("modality", ["vision_embed", "audio_embed"])
def test_projector_matches_repro(dtype, modality):
    """layernorm (the frames cast to the compute dtype first), fc1 + bias,
    ReLU, fc2 + bias; the init tree's layout."""
    jcfg, tcfg = _cfgs(VLM, dtype, modality=modality)
    jp = _params(jcfg)["projector"]
    x = 3 * _frames(5)
    want = jfront.projector_apply(jp, jnp.asarray(x), jcfg)
    got = tfront.projector_apply(_t(jp), torch.from_numpy(x), tcfg)
    assert got.dtype == tcfg.compute_dtype and got.shape == (B, 5, 128)
    tol = BLOCK_TOL if dtype == "f32" else BF16_TOL
    _scaled(got.float(), np.asarray(want, np.float32), tol)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    mine = tfront.projector_init(np.random.default_rng(0), tcfg)
    assert interop.tree_map(lambda a: tuple(a.shape), mine) == shapes


def test_every_block_type_is_ported():
    """No block type of ``repro`` is refused; each block's and the whole
    model's parameter tree has ``repro``'s layout, ``projector`` and
    ``enc`` included."""
    assert set(tt.PORTED_BLOCKS) == set(jt.ATTN_TYPES) | set(jt.SSM_TYPES) \
        | {"swa", "dec_attn"}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        want = jax.tree_util.tree_map(
            lambda a: a.shape, jax.eval_shape(
                lambda: jt.lm_init(jax.random.PRNGKey(0), jcfg)))
        mine = tt.lm_init(np.random.default_rng(0), tcfg, device="meta")
        assert interop.tree_map(lambda a: tuple(a.shape), mine) == want
        assert "projector" in mine
        assert ("enc" in mine) == (arch == ENCDEC)


# ---------------------------------------------------------------------------
# the encoder, and the decoder with memory
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _encdec_reference(dtype):
    """repro's encoder memory, the decoder's full forward, prefill logits
    and caches, and decode logits, at the smoke width."""
    jcfg, _ = _cfgs(ENCDEC, dtype)
    jp = _params(jcfg, seed=1)
    src = _frames(M, seed=2)
    toks = _tokens(jcfg, B, S + T, seed=3)
    mem = jt.encode(jp, jnp.asarray(src), jcfg)
    full, _, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg, memory=mem)
    pre, caches = jserve.make_prefill_step(jcfg)(
        jp, jnp.asarray(toks[:, :S]), memory=mem)
    pre_caches = jax.tree_util.tree_map(np.asarray, caches)
    caches = jserve.extend_caches(caches, jcfg, S + T)
    decode = jserve.make_decode_step(jcfg)
    dec = []
    for t in range(S, S + T):
        lg, caches = decode(jp, jnp.asarray(toks[:, t:t + 1]), caches,
                            jnp.asarray(t), memory=mem)
        dec.append(np.asarray(lg[:, 0], np.float32))
    return dict(params=jax.tree_util.tree_map(np.asarray, jp), src=src,
                toks=toks, memory=np.asarray(mem),
                full=np.asarray(full, np.float32),
                prefill=np.asarray(pre, np.float32), caches=pre_caches,
                decode=dec)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_repro(dtype, impl):
    """The projector on the source frames, bidirectional blocks at
    ``arange(S_src)``, the encoder's final norm."""
    ref = _encdec_reference(dtype)
    _, tcfg = _cfgs(ENCDEC, dtype)
    mem = tt.encode(_t(ref["params"]), torch.from_numpy(ref["src"]), tcfg,
                    impl)
    assert mem.dtype == tcfg.compute_dtype and mem.shape == (B, M, 128)
    tol = BLOCK_TOL * 10 if dtype == "f32" else BF16_TOL
    _scaled(mem.float(), np.asarray(ref["memory"], np.float32), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_decoder_with_memory_matches_repro(dtype, impl):
    """``lm_apply(memory=)`` in train, prefill (logits and the nested
    ``{"self": ...}`` caches) and decode, each step from the previous one's
    caches, against ``repro``'s; decode also against the full forward."""
    ref = _encdec_reference(dtype)
    _, tcfg = _cfgs(ENCDEC, dtype)
    tp, toks = _t(ref["params"]), torch.from_numpy(ref["toks"])
    mem = _t(ref["memory"])
    full, _, _ = tt.lm_apply(tp, toks, cfg=tcfg, memory=mem, impl=impl)
    _logits_close(full, ref["full"], dtype, "train")
    pre, caches = tserve.make_prefill_step(tcfg, impl)(tp, toks[:, :S],
                                                       memory=mem)
    _logits_close(pre, ref["prefill"], dtype, "prefill")
    got_c = interop.leaves(interop.tree_map(
        lambda a: a.float(), {"scan": dict(enumerate(caches["scan"]))}))
    want_c = interop.leaves({"scan": dict(enumerate(ref["caches"]["scan"]))})
    assert set(got_c) == set(want_c) and any("self" in k for k in got_c)
    for k, w in want_c.items():
        tol = CACHE_TOL if dtype == "f32" else BF16_TOL
        _scaled(got_c[k], np.asarray(w, np.float32), tol, k)
    caches = tserve.extend_caches(caches, tcfg, S + T)
    decode = tserve.make_decode_step(tcfg, impl)
    for i, t in enumerate(range(S, S + T)):
        lg, caches = decode(tp, toks[:, t:t + 1], caches, t, memory=mem)
        _logits_close(lg[:, 0], ref["decode"][i], dtype, f"decode {t}")
        _logits_close(lg[:, 0], ref["full"][:, t], dtype, f"vs full {t}")


def test_encdec_needs_memory_and_extends_nested_caches():
    """An enc-dec model without memory raises outside decode, as
    ``repro``'s does; ``extend_caches`` pads the decoder's
    ``{"self": {k, v}}`` caches along their sequence axis as ``repro``'s
    does."""
    ref = _encdec_reference("f32")
    jcfg, tcfg = _cfgs(ENCDEC)
    tp = _t(ref["params"])
    with pytest.raises(ValueError, match="memory"):
        tt.lm_apply(tp, torch.zeros((1, 3), dtype=torch.long), cfg=tcfg)
    got = tserve.extend_caches(_t(ref["caches"]), tcfg, S + 7)
    want = jserve.extend_caches(jax.tree_util.tree_map(jnp.asarray,
                                                       ref["caches"]),
                                jcfg, S + 7)
    (sc,) = got["scan"]
    assert tuple(sc["self"]["k"].shape) == (2, B, S + 7, 4, 32)
    gl = interop.leaves({"scan": dict(enumerate(got["scan"]))})
    wl = interop.leaves({"scan": dict(enumerate(want["scan"]))})
    assert set(gl) == set(wl)
    for k, w in wl.items():
        np.testing.assert_array_equal(gl[k].numpy(), np.asarray(w), k)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_greedy_generate_with_memory_matches_repro(impl):
    """``greedy_generate(memory=)``: token for token ``repro``'s at its
    chunked path, fp32 compute."""
    ref = _encdec_reference("f32")
    jcfg, tcfg = _cfgs(ENCDEC)
    want = np.asarray(jserve.greedy_generate(
        jax.tree_util.tree_map(jnp.asarray, ref["params"]), jcfg,
        jnp.asarray(ref["toks"][:, :S]), 6,
        memory=jnp.asarray(ref["memory"])))
    got = tserve.greedy_generate(_t(ref["params"]), tcfg,
                                 ref["toks"][:, :S], 6, impl=impl,
                                 memory=ref["memory"], device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# media before the text
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _media_reference(dtype):
    """repro's full forward over media + text, its prefill with media and
    its decode steps at ``n_media + S_text`` on, through its factories."""
    jcfg, _ = _cfgs(VLM, dtype)
    jp = _params(jcfg, seed=4)
    media = _frames(jcfg.n_media_tokens, seed=5)
    toks = _tokens(jcfg, B, S + T, seed=6)
    full, _, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg,
                             media=jnp.asarray(media))
    pre, caches = jserve.make_prefill_step(jcfg)(
        jp, jnp.asarray(toks[:, :S]), media=jnp.asarray(media))
    n = jcfg.n_media_tokens
    caches = jserve.extend_caches(caches, jcfg, n + S + T)
    decode = jserve.make_decode_step(jcfg)
    dec = []
    for t in range(S, S + T):
        lg, caches = decode(jp, jnp.asarray(toks[:, t:t + 1]), caches,
                            jnp.asarray(n + t))
        dec.append(np.asarray(lg[:, 0], np.float32))
    return dict(params=jax.tree_util.tree_map(np.asarray, jp), media=media,
                toks=toks, full=np.asarray(full, np.float32),
                prefill=np.asarray(pre, np.float32), decode=dec)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_media_prefill_then_decode_matches_repro(dtype, impl):
    """internvl2: the projected media come first, so the prefill runs at
    ``arange(n_media + S_text)`` and the first decode step at
    ``n_media + S_text``; every step within tolerance of ``repro``'s step
    and of the full forward over media + text."""
    ref = _media_reference(dtype)
    _, tcfg = _cfgs(VLM, dtype)
    tp, toks = _t(ref["params"]), torch.from_numpy(ref["toks"])
    media = torch.from_numpy(ref["media"])
    n = tcfg.n_media_tokens
    full, _, _ = tt.lm_apply(tp, toks, cfg=tcfg, media=media, impl=impl)
    assert full.shape[1] == n + S + T
    _logits_close(full, ref["full"], dtype, "train")
    pre, caches = tserve.make_prefill_step(tcfg, impl)(tp, toks[:, :S],
                                                       media=media)
    _logits_close(pre, ref["prefill"], dtype, "prefill")
    assert int(caches["scan"][0]["pos"][0]) == n + S
    caches = tserve.extend_caches(caches, tcfg, n + S + T)
    decode = tserve.make_decode_step(tcfg, impl)
    for i, t in enumerate(range(S, S + T)):
        lg, caches = decode(tp, toks[:, t:t + 1], caches, n + t)
        _logits_close(lg[:, 0], ref["decode"][i], dtype, f"decode {t}")
        _logits_close(lg[:, 0], ref["full"][:, n + t], dtype,
                      f"vs full {t}")


# ---------------------------------------------------------------------------
# the loss and every gradient leaf
# ---------------------------------------------------------------------------

def _close_grads(got, want, dtype):
    wl = interop.leaves(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), want))
    gl = interop.leaves(got)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        g = gl[k].double().numpy()
        assert g.shape == w.shape, k
        if dtype == "f32":
            _scaled(g, w, BLOCK_TOL, k)
            continue
        top, norm = float(np.abs(w).max()), float(np.linalg.norm(w))
        assert top > 0, k
        assert float(np.abs(g - w).max()) <= BF16_GRAD_TOL * top, k
        assert float(np.linalg.norm(g - w)) <= BF16_GRAD_TOL * norm, k


def _loss_batch(arch, cfg):
    toks = _tokens(cfg, B, S + 1, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if arch == VLM:
        batch["media"] = _frames(cfg.n_media_tokens, seed=8)
    else:
        batch["src_embed"] = _frames(M, seed=8)
    return batch


@pytest.mark.parametrize("arch,dtype,remat", [
    (a, d, False) for a in ARCHS for d in DTYPES] + [
    (a, "f32", True) for a in ARCHS])
def test_lm_loss_and_grads_match_repro(arch, dtype, remat):
    """``make_lm_loss``: internvl2 with ``media`` (its logits sliced off
    before the cross-entropy), seamless with ``src_embed`` (encoded inside
    the loss); the loss and every gradient leaf, projector and encoder
    included, through ``single_grad_fn``."""
    jcfg, tcfg = _cfgs(arch, dtype, remat=remat)
    params = _params(jcfg, seed=9)
    batch = _loss_batch(arch, tcfg)
    jl, jg = jax.jit(jax.value_and_grad(j_make_lm_loss(jcfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = SingleTaskModel(init=None, loss_fn=make_lm_loss(tcfg))
    tl, _, tg = single_grad_fn(model)(
        interop.to_torch(jax.tree_util.tree_map(np.asarray, params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _scaled(tl.numpy(), jl, BLOCK_TOL if dtype == "f32" else BF16_LOSS_TOL,
            "loss")
    _close_grads(tg, jg, dtype)
    for key in ("projector/fc1/w", "projector/ln/bias"):
        assert float(tg["projector"][key.split("/")[1]][
            key.split("/")[2]].abs().max()) > 0
    if arch == ENCDEC:
        assert float(tg["enc"]["blocks"]["e0"]["attn"]["wq"]["w"]
                     .abs().max()) > 0
        with pytest.raises(ValueError, match="src_embed"):
            make_lm_loss(tcfg)(interop.to_torch(jax.tree_util.tree_map(
                np.asarray, params)), {k: torch.from_numpy(batch[k])
                                       for k in ("tokens", "labels")})


# ---------------------------------------------------------------------------
# checkpoints, interop, launchers, examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_and_interop_carry_projector_and_encoder(arch,
                                                             tmp_path):
    """A tree with ``projector`` (and ``enc``) written by either package
    restores bit for bit in the other, into a shape-only template; the
    interop round trip is the identity."""
    jcfg, tcfg = _cfgs(arch)
    jp = jt.lm_init(jax.random.PRNGKey(2), jcfg)
    want = interop.leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert any(k.startswith("projector/") for k in want)
    assert any(k.startswith("enc/") for k in want) == (arch == ENCDEC)
    back = interop.leaves(interop.to_numpy(interop.to_torch(
        jax.tree_util.tree_map(np.asarray, jp))))
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], v) for k, v in want.items())
    path = str(tmp_path / "from_repro")
    j_ckpt.save(path, {"params": jp}, metadata={"step": 1})
    template = tt.lm_init(np.random.default_rng(0), tcfg, device="meta")
    got = interop.leaves(t_ckpt.restore(path, {"params": template})
                         ["params"])
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tp = tt.lm_init(np.random.default_rng(1), tcfg)
    path = str(tmp_path / "from_port.npz")
    t_ckpt.save(path, {"params": tp})
    back = j_ckpt.restore(path, {"params": jax.eval_shape(lambda: jp)})
    back = interop.leaves(jax.tree_util.tree_map(np.asarray,
                                                 back["params"]))
    for k, v in interop.leaves(tp).items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_launchers_and_example_take_both_archs(capsys):
    """``launch.serve_lm`` serves internvl2 text-only and seamless against
    zeros of (B, 32, d_model) as memory (``repro``'s serving example's),
    tokens equal to the plain path's; ``launch.train --mode lm`` trains
    internvl2 text-only, and on seamless raises naming ``src_embed``, where
    ``repro``'s launcher fails at ``batch["src_embed"]``; the serving
    example takes seamless."""
    import importlib.util
    from pathlib import Path

    from repro_torch.data.lm_data import make_lm_source
    from repro_torch.launch import serve_lm
    from repro_torch.launch import train as t_launch
    for arch in ARCHS:
        out = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch",
                             "2", "--prompt-len", "8", "--new", "3"])
        cfg = tconfigs.get_smoke(arch)
        params = tt.lm_init(np.random.default_rng(0), cfg)
        prompt = make_lm_source(1, 2, 8, cfg.vocab)["tokens"]
        memory = torch.zeros((2, 32, cfg.d_model), dtype=cfg.compute_dtype) \
            if cfg.n_enc_layers else None
        plain = tserve.greedy_generate(params, cfg, prompt, 3,
                                       impl="chunked", memory=memory,
                                       device="cpu")
        assert torch.equal(out, plain), arch
    loss = t_launch.main(["--mode", "lm", "--device", "cpu", "--arch", VLM,
                          "--steps", "2", "--seq", "16", "--batch", "2"])
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="src_embed"):
        t_launch.main(["--mode", "lm", "--device", "cpu", "--arch", ENCDEC,
                       "--steps", "1", "--seq", "16", "--batch", "2"])
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--arch", ENCDEC, "--batch", "2",
                   "--prompt-len", "8", "--new", "3"])
    assert out.shape == (2, 3)
    capsys.readouterr()
