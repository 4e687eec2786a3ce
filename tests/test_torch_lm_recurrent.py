"""The recurrent configs' serving paths (zamba2-1.2b: Mamba2 and the
shared attention block; xlstm-125m: mLSTM and sLSTM) against ``repro``:
a prompt past zamba2's window, decode from ``lm_cache_init``, bf16
compute, and both launchers. Inputs, references and tolerances:
``torch_lm_serve_common`` (a file apart from ``test_torch_lm.py`` because
``pytest-xdist --dist loadfile`` runs a file on one worker).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as jt
from repro.train import serve as jserve

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import lm_data as t_lm_data
from repro_torch.models import transformer as tt
from repro_torch.train import serve as tserve
from torch_lm_serve_common import (IMPLS, RECURRENT_ARCHS, _cfgs, _close,
                                   _params, _reference, _tokens)


# ---------------------------------------------------------------------------
# the recurrent configs: zamba2-1.2b and xlstm-125m
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _repro_decode_run(case, B, S, T, seed, from_zero=False):
    """repro's jitted teacher-forced forward over S + T tokens and its
    decode of the last T (after an S-token prefill, or from
    ``lm_cache_init`` at token 0 with ``from_zero``), computed once."""
    ref = _reference(case)
    jcfg, _ = _cfgs(case)
    jp = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    toks = _tokens(jcfg, B, S + T, seed=seed)
    full = jax.jit(lambda p, t: jt.lm_apply(p, t, cfg=jcfg)[0])(
        jp, jnp.asarray(toks))
    decode = jax.jit(jserve.make_decode_step(jcfg))
    if from_zero:
        caches, prefill = jt.lm_cache_init(jp, jcfg, B, S + T), None
    else:
        prefill, caches = jax.jit(jserve.make_prefill_step(jcfg))(
            jp, jnp.asarray(toks[:, :S]))
        caches = jserve.extend_caches(caches, jcfg, S + T)
    init = jax.tree_util.tree_map(np.asarray, caches)
    dec = []
    for t in range(S, S + T):
        lg, caches = decode(jp, jnp.asarray(toks[:, t:t + 1]), caches,
                            jnp.asarray(t))
        dec.append(np.asarray(lg[:, 0]))
    greedy = None if from_zero else np.asarray(jserve.greedy_generate(
        jp, jcfg, jnp.asarray(toks[:, :S]), 5))
    return dict(toks=toks, full=np.asarray(full), decode=dec, init=init,
                prefill=None if prefill is None else np.asarray(prefill),
                greedy=greedy)


@pytest.mark.parametrize("impl", IMPLS)
def test_zamba2_prompt_past_the_window_matches_repro(impl):
    """zamba2 smoke (window 32): a 40-token prompt, then 6 decode steps.
    The shared block's prefill cache (40 slots) is past the window, so
    ``extend_caches`` keeps it and decode rolls over it; every attention
    layer is windowed, so decode also equals teacher forcing."""
    ref = _reference("zamba2_smoke")
    _, tcfg = _cfgs("zamba2_smoke")
    tp = interop.to_torch(ref["params"])
    S, T = 40, 6
    want = _repro_decode_run("zamba2_smoke", 2, S, T, 7)
    toks = want["toks"]
    logits, caches = tserve.make_prefill_step(tcfg, impl)(
        tp, torch.from_numpy(toks[:, :S]))
    _close(logits, want["prefill"], msg="prefill")
    _close(logits, want["full"][:, :S], msg="prefill vs full")
    caches = tserve.extend_caches(caches, tcfg, S + T)
    assert caches["scan"][5]["k"].shape == (1, 2, S, 4, 32)
    decode = tserve.make_decode_step(tcfg, impl)
    for i, t in enumerate(range(S, S + T)):
        got, caches = decode(tp, torch.from_numpy(toks[:, t:t + 1]), caches,
                             t)
        _close(got[:, 0], want["decode"][i], msg=f"decode {t}")
        _close(got[:, 0], want["full"][:, t], msg=f"teacher {t}")
    got = tserve.greedy_generate(tp, tcfg, torch.from_numpy(toks[:, :S]), 5,
                                 impl=impl, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want["greedy"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_lm_cache_init_decodes_from_token_zero(arch):
    """Decode from ``lm_cache_init`` (zero states; Mamba2's conv window in
    f32, as ``repro``'s) over 12 tokens against ``repro``'s decode from
    its own ``lm_cache_init`` and its teacher-forced forward."""
    case = {"zamba2-1.2b": "zamba2_smoke", "xlstm-125m": "xlstm_smoke"}[arch]
    ref = _reference(case)
    _, tcfg = _cfgs(case)
    tp = interop.to_torch(ref["params"])
    want = _repro_decode_run(case, 2, 0, 12, 8, from_zero=True)
    toks = want["toks"]
    caches = tt.lm_cache_init(tp, tcfg, 2, 12)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, b), want["init"],
        interop.to_numpy(caches))
    decode = tserve.make_decode_step(tcfg, "chunked")
    for t in range(12):
        got, caches = decode(tp, torch.from_numpy(toks[:, t:t + 1]), caches,
                             t)
        _close(got[:, 0], want["decode"][t], msg=f"decode {t}")
        _close(got[:, 0], want["full"][:, t], msg=f"teacher {t}")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_bf16_compute_matches_repro(arch):
    """The smoke configs at their own bf16 compute: prefill logits and two
    decode steps against ``repro``'s full forward, within 5e-2 x
    max|logit| (``test_bf16_compute_matches_repro``'s tolerance: both
    sides round at the same points, in another order)."""
    jcfg, tcfg = j_get_smoke(arch), tconfigs.get_smoke(arch)
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


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_archs_through_the_launchers(arch, capsys):
    """``launch.serve_lm`` and ``launch.train --mode lm`` take the
    recurrent archs by name at the smoke width on the CPU: tokens equal to
    the plain path's, finite losses."""
    from repro_torch.launch import serve_lm
    from repro_torch.launch import train as t_launch
    toks = serve_lm.main(["--device", "cpu", "--arch", arch])
    assert toks.shape == (4, 16)
    assert f'"arch": "{arch}"' in capsys.readouterr().out
    cfg = tconfigs.get_smoke(arch)
    params = tt.lm_init(np.random.default_rng(0), cfg)
    prompt = t_lm_data.make_lm_source(1, 4, 32, cfg.vocab)["tokens"]
    plain = tserve.greedy_generate(params, cfg, prompt, 16, impl="chunked",
                                   device="cpu")
    assert torch.equal(plain, toks)
    loss = t_launch.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                          "--steps", "4", "--batch", "2", "--seq", "32"])
    assert np.isfinite(loss)
