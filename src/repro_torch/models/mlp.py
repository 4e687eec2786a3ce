"""Plain 2+-layer MLP (HydraGNN head style), ``repro.models.mlp`` layout."""
from __future__ import annotations

import torch

from .common import ACT, Params, dense, dense_init


def mlp_init(rng, d_in: int, hidden: int, d_out: int, n_hidden: int,
             dtype=torch.float32, bias: bool = True, device="cpu") -> Params:
    """Plain MLP with n_hidden hidden layers: ``{"fc0": {w, b}, ...}``."""
    dims = [d_in] + [hidden] * n_hidden + [d_out]
    return {f"fc{i}": dense_init(rng, dims[i], dims[i + 1], dtype, bias=bias,
                                 device=device)
            for i in range(len(dims) - 1)}


def mlp_apply(params: Params, x, act="relu", compute_dtype=None):
    n = len(params)
    for i in range(n):
        x = dense(params[f"fc{i}"], x, compute_dtype)
        if i < n - 1:
            x = ACT[act](x)
    return x
