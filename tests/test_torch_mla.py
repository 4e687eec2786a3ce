"""The port's MLA attention (DeepSeek-V2) against ``repro``'s.

``repro``'s ``mla_init`` tree (norm scales perturbed so they matter) is
carried by ``interop``; inputs are numpy draws from a seed. Prefill runs
under each of the port's impls (``"pallas"`` takes the flash-attention
kernel's plain version on the CPU, at q/k head dim dn + dr with v padded to
it) against ``repro`` at its default ``"chunked"``. Decode is the absorbed
form over the latent cache, against ``repro``'s decode and against teacher
forcing (the prefill output at that position). Tolerance: 1e-5 x max(1,
max|ref|) in f32 compute (the same sums in another order); the caches 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JCfg
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.train import serve as jserve

from repro_torch import interop
from repro_torch.configs.base import ArchConfig as TCfg
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.train import serve as tserve

TOL = 1e-5
BASE = dict(name="mla", n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
            d_ff=64, vocab=97, head_dim=16, kv_lora=24, q_lora=32,
            rope_dims=8, v_head_dim=12, block_pattern=("mla",))
IMPLS = ("naive", "chunked", "pallas")


def _cfgs(**kw):
    kw = dict(BASE, **kw)
    return (JCfg(**kw, compute_dtype=jnp.float32, remat=False),
            TCfg(**kw, compute_dtype=torch.float32, remat=False))


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _params(jcfg, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jattn.mla_init(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):
        s = p[k]["scale"]
        p[k]["scale"] = s + 0.1 * rng.standard_normal(s.shape).astype(
            s.dtype)
    return p


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_prefill_matches_repro(impl):
    jcfg, tcfg = _cfgs()
    p = _params(jcfg)
    x = _x(jcfg, 2, 19)
    pos = np.arange(19)
    jout, jc = jattn.mla_apply(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), cfg=jcfg,
                               positions=jnp.asarray(pos), cache="init")
    tout, tc = tattn.mla_apply(interop.to_torch(p), torch.from_numpy(x),
                               cfg=tcfg, positions=torch.from_numpy(pos),
                               cache="init", impl=impl)
    _close(tout, jout, name="out")
    assert set(tc) == set(jc) == {"ckv", "krope", "pos"}
    _close(tc["ckv"], jc["ckv"], 2e-5, "ckv")
    _close(tc["krope"], jc["krope"], 2e-5, "krope")
    assert tc["pos"].dtype == torch.int32 and int(tc["pos"]) == 19
    train = tattn.mla_apply(interop.to_torch(p), torch.from_numpy(x),
                            cfg=tcfg, positions=torch.from_numpy(pos),
                            impl=impl)
    assert torch.equal(train, tout)


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_absorbed_decode_matches_repro_and_teacher_forcing(impl):
    """Prefill 12 tokens, pad the latent cache to 17, decode 5 steps fed
    the true inputs: each step's output against ``repro``'s decode and
    against the full prefill's output at that position; the cache rows
    are written in place."""
    jcfg, tcfg = _cfgs()
    p = _params(jcfg, seed=1)
    x = _x(jcfg, 2, 17, seed=1)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), interop.to_torch(p)
    full = tattn.mla_apply(tp, torch.from_numpy(x), cfg=tcfg,
                           positions=torch.arange(17), impl=impl)
    _, jc = jattn.mla_apply(jp, jnp.asarray(x[:, :12]), cfg=jcfg,
                            positions=jnp.arange(12), cache="init")
    _, tc = tattn.mla_apply(tp, torch.from_numpy(x[:, :12]), cfg=tcfg,
                            positions=torch.arange(12), cache="init",
                            impl=impl)
    jc = jserve.extend_caches(jc, jcfg, 17)
    tc = tserve.extend_caches(tc, tcfg, 17)
    assert tuple(tc["ckv"].shape) == (2, 17, 24)
    for t in range(12, 17):
        jo, jc = jattn.mla_apply(jp, jnp.asarray(x[:, t:t + 1]), cfg=jcfg,
                                 positions=jnp.array([t]), cache=jc)
        ckv = tc["ckv"]
        to, tc = tattn.mla_apply(tp, torch.from_numpy(x[:, t:t + 1]),
                                 cfg=tcfg, positions=torch.tensor([t]),
                                 cache=tc, impl=impl)
        assert tc["ckv"] is ckv and int(tc["pos"]) == t + 1
        _close(to, jo, name=f"step {t}")
        _close(to[:, 0], full[:, t], name=f"teacher-forced {t}")
        _close(tc["ckv"], jc["ckv"], 2e-5, f"ckv {t}")
        _close(tc["krope"], jc["krope"], 2e-5, f"krope {t}")


def test_mla_cache_init_and_extend_caches_match_repro():
    """``mla_cache_init``'s layout, and ``extend_caches`` on a stacked MLA
    prefill cache: ``ckv``/``krope`` padded along their own sequence axis
    (ndim - 2), whatever the config's window (the window rule is
    ``k``/``v``'s)."""
    for window in (0, 5):
        jcfg, tcfg = _cfgs(window=window)
        jc = jattn.mla_cache_init(jcfg, 3, 11)
        tc = tattn.mla_cache_init(tcfg, 3, 11)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: v.shape for k, v in jc.items()}
        assert tc["ckv"].dtype == torch.float32 and int(tc["pos"]) == 0
        jp = jt.lm_init(jax.random.PRNGKey(2), jcfg)
        toks = np.random.default_rng(2).integers(0, 97, (2, 9))
        _, caches, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg,
                                   mode="prefill")
        caches = jax.tree_util.tree_map(np.asarray, caches)
        for cap in (9, 12, 30):
            want = jserve.extend_caches(
                jax.tree_util.tree_map(jnp.asarray, caches), jcfg, cap)
            got = tserve.extend_caches(interop.to_torch(caches), tcfg, cap)
            assert tuple(got["scan"][0]["ckv"].shape) == (2, 2, cap, 24)
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                want, interop.to_numpy(got))


def test_mla_lm_cache_init_decodes_from_token_zero():
    """``lm_cache_init`` of an MLA LM (stacked latent caches) decoding
    every token from position 0 reproduces teacher forcing."""
    jcfg, tcfg = _cfgs()
    jp = jt.lm_init(jax.random.PRNGKey(3), jcfg)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(0, 97, (2, 10))
    full, _, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg)
    caches = tt.lm_cache_init(tp, tcfg, 2, 10)
    assert tuple(caches["scan"][0]["ckv"].shape) == (2, 2, 10, 24)
    decode = tserve.make_decode_step(tcfg, "pallas")
    for t in range(10):
        lg, caches = decode(tp, torch.from_numpy(toks[:, t:t + 1]), caches,
                            t)
        _close(lg[:, 0], np.asarray(full[:, t]), 2e-4, f"t={t}")
    assert caches["scan"][0]["pos"].tolist() == [10, 10]
