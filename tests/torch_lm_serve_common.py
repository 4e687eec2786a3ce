"""Configurations, parameters, tokens, ``repro``'s reference outputs and
tolerances shared by the port's LM serving tests against ``repro``
(``test_torch_lm.py``, ``test_torch_lm_recurrent.py``).

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
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import ArchConfig as JCfg
from repro.models import transformer as jt
from repro.train import serve as jserve

from repro_torch import configs as tconfigs
from repro_torch.configs.base import ArchConfig as TCfg

ATOL, RTOL = 2e-4, 2e-3
IMPLS = ("naive", "chunked", "pallas")
SMALL = dict(name="t", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=97, head_dim=16)
CASES = {
    "attn": {},
    "swa": {"block_pattern": ("swa",), "window": 8},
    "qkv_bias": {"qkv_bias": True, "n_kv_heads": 4},
    "attn_swa_rem": {"block_pattern": ("attn", "swa"), "window": 8},
    "h2o_smoke": "h2o-danube-1.8b",
    "qwen_smoke": "qwen1.5-0.5b",
    "granite_moe_smoke": "granite-moe-3b-a800m",
    "deepseek_smoke": "deepseek-v2-236b",
    "zamba2_smoke": "zamba2-1.2b",
    "xlstm_smoke": "xlstm-125m",
}
LM_ARCHS = ("h2o-danube-1.8b", "qwen1.5-0.5b", "granite-moe-3b-a800m",
            "deepseek-v2-236b", "zamba2-1.2b", "xlstm-125m")
RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-125m")
# each block type's cache (prefill's and decode's) leaves
CACHE_KEYS = {"attn": {"k", "v", "pos"}, "swa": {"k", "v", "pos"},
              "shared_attn": {"k", "v", "pos"},
              "mla": {"ckv", "krope", "pos"}, "mamba2": {"ssm", "conv"},
              "mlstm": {"C", "n", "m", "conv"},
              "slstm": {"h", "c", "n", "m"}}


def _cfgs(case):
    kw = CASES[case]
    if isinstance(kw, str):
        return (j_get_smoke(kw).replace(compute_dtype=jnp.float32),
                tconfigs.get_smoke(kw).replace(compute_dtype=torch.float32))
    base = dict(SMALL, **kw)
    return (JCfg(**base, remat=False, compute_dtype=jnp.float32),
            TCfg(**base, compute_dtype=torch.float32))


def _params(jcfg, seed=0):
    """repro's tree with random biases (its init zeros them), norm scales
    and the recurrent blocks' zero- or one-initialised leaves (conv bias,
    dt bias, D, the shared block's LoRA ``b`` factors), so every leaf
    matters."""
    p = jt.lm_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "'b'" in name:
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        if "'scale'" in name or re.search(
                r"'(conv_b|dt_bias|D|lora_._b)'", name):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, p)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """repro's outputs for one case, computed once: teacher-forced logits,
    prefill logits and caches, decode logits, greedy tokens."""
    jcfg, _ = _cfgs(case)
    jp = _params(jcfg)
    S, T = 16, 5
    toks = _tokens(jcfg, 2, S + T)
    full, _, _ = jt.lm_apply(jp, jnp.asarray(toks), cfg=jcfg)
    pre, caches, _ = jt.lm_apply(jp, jnp.asarray(toks[:, :S]), cfg=jcfg,
                                 mode="prefill")
    pre_caches = jax.tree_util.tree_map(np.asarray, caches)
    caches = jserve.extend_caches(caches, jcfg, S + T)
    dec = []
    for t in range(T):
        lg, caches, _ = jt.lm_apply(jp, jnp.asarray(toks[:, S + t:S + t + 1]),
                                    cfg=jcfg, mode="decode", caches=caches,
                                    positions=jnp.array([S + t]))
        dec.append(np.asarray(lg[:, 0]))
    greedy = np.asarray(jserve.greedy_generate(jp, jcfg,
                                               jnp.asarray(toks[:, :S]), 6))
    return dict(params=jax.tree_util.tree_map(np.asarray, jp), toks=toks,
                S=S, T=T, full=np.asarray(full), prefill=np.asarray(pre),
                caches=pre_caches, decode=dec, greedy=greedy)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)
