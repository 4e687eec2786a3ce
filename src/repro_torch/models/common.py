"""Common building blocks: initializers, norms, RoPE, dense, embedding,
activations.

Parameters are plain nested dicts of tensors with ``repro``'s layout —
dense weights are ``(d_in, d_out)`` and ``dense`` computes ``x @ w`` — so a
tree converted from JAX is a copy, never a transpose (``repro_torch.interop``).

Initializers draw from an explicit ``np.random.Generator`` (the port's seed
discipline; JAX's key stream is not reproduced — parity tests convert JAX
parameters instead), or from a seeded ``torch.Generator``, which draws where
it lives: a CUDA generator fills full-width random weights on the card with
no host copy. ``device="meta"`` builds a shape-only tree without drawing,
which is what checkpoint templates use.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

Params = dict  # nested {str: Params | torch.Tensor}


def _leaf(arr_fn, shape, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.as_tensor(arr_fn(), dtype=dtype, device=device)


def normal_init(rng, shape, dtype=torch.float32, stddev=0.02,
                device="cpu") -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        x = torch.randn(shape, generator=rng, device=rng.device)
        return x.mul_(stddev).to(device=device, dtype=dtype)
    return _leaf(lambda: (stddev * rng.standard_normal(shape))
                 .astype(np.float32), shape, dtype, device)


def zeros_init(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _leaf(lambda: np.zeros(shape, np.float32), shape, dtype, device)


def ones_init(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _leaf(lambda: np.ones(shape, np.float32), shape, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            upcast: bool = True) -> torch.Tensor:
    dt = x.dtype
    if upcast:
        x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].to(y.dtype)).to(dt)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, f32 angles)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * inv            # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense layers as param dicts
# ---------------------------------------------------------------------------

def dense_init(rng, d_in: int, d_out: int, dtype=torch.float32,
               bias: bool = False, stddev: float | None = None,
               device="cpu") -> Params:
    std = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(rng, (d_in, d_out), dtype, std, device)}
    if bias:
        p["b"] = zeros_init((d_out,), dtype, device)
    return p


def dense(params: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = params["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding_init(rng, vocab: int, d: int, dtype=torch.float32,
                   device="cpu") -> Params:
    return {"table": normal_init(rng, (vocab, d), dtype, 0.02, device)}


class _Embed(torch.autograd.Function):
    """``table[ids]`` whose backward sums the rows of g into the table by
    id with kernel #1 (``kernels.segment_sum``: f32 sums in token order,
    no atomics; its plain one-hot product on the CPU), the same order on
    every run; with ``plain`` it takes the one-hot product on any device.
    Indexing's own backward accumulates with ``index_put_``, which on CUDA
    adds with float atomics in no fixed order — training would not replay
    bitwise."""

    @staticmethod
    def forward(ctx, table, ids, plain):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.plain = table.shape[0], plain
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        from ..kernels.segment_sum import segment_sum, segment_sum_ref
        (ids,) = ctx.saved_tensors
        fn = segment_sum_ref if ctx.plain else segment_sum
        return fn(g.reshape(-1, g.shape[-1]), ids.reshape(-1),
                  ctx.vocab), None, None


def embed(params: Params, ids: torch.Tensor, compute_dtype=None, *,
          plain: bool = False):
    """``table[ids]`` in ``compute_dtype``; ``plain`` keeps kernel #1 out
    of its backward (the parity oracle's path)."""
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return _Embed.apply(t, ids.long(), plain)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding ``x @ table.T``: the table cast to x's dtype, the
    products summed in f32 (both operands widened exactly to f32, so the
    result is the f32-accumulated product of the x-dtype values)."""
    t = params["table"].to(x.dtype)
    return x.float() @ t.float().T


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACT: dict[str, Callable] = {"gelu": gelu, "silu": F.silu, "relu": F.relu,
                            "tanh": torch.tanh}
