"""Configurations, inputs and tolerances shared by the port's LM training
tests against ``repro`` (``test_torch_lm_train.py``,
``test_torch_lm_grads.py``).

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
import torch

from repro.configs import get_smoke as j_get_smoke

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data.lm_data import make_lm_sources

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
