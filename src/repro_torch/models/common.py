"""Common building blocks: initializers, dense, embedding, activations.

Parameters are plain nested dicts of tensors with ``repro``'s layout —
dense weights are ``(d_in, d_out)`` and ``dense`` computes ``x @ w`` — so a
tree converted from JAX is a copy, never a transpose (``repro_torch.interop``).

Initializers draw from an explicit ``np.random.Generator`` (the port's seed
discipline; JAX's key stream is not reproduced — parity tests convert JAX
parameters instead). ``device="meta"`` builds a shape-only tree without
drawing, which is what checkpoint templates use.
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


def normal_init(rng: np.random.Generator, shape, dtype=torch.float32,
                stddev=0.02, device="cpu") -> torch.Tensor:
    return _leaf(lambda: (stddev * rng.standard_normal(shape))
                 .astype(np.float32), shape, dtype, device)


def zeros_init(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _leaf(lambda: np.zeros(shape, np.float32), shape, dtype, device)


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


def embed(params: Params, ids: torch.Tensor, compute_dtype=None):
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[ids.long()]


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACT: dict[str, Callable] = {"gelu": gelu, "silu": F.silu, "relu": F.relu,
                            "tanh": torch.tanh}
