"""Feed-forward blocks: SwiGLU (gated) and the plain 2+-layer MLP (HydraGNN
head style), ``repro.models.mlp`` layout."""
from __future__ import annotations

import math

import torch

from .common import ACT, Params, dense, dense_init


def swiglu_init(rng, d: int, d_ff: int, dtype=torch.float32,
                n_layers: int = 2, device="cpu") -> Params:
    return {
        "w_gate": dense_init(rng, d, d_ff, dtype, device=device),
        "w_up": dense_init(rng, d, d_ff, dtype, device=device),
        "w_down": dense_init(rng, d_ff, d, dtype,
                             stddev=0.02 / math.sqrt(2 * n_layers),
                             device=device),
    }


def swiglu_apply(params: Params, x, act="silu", compute_dtype=None,
                 tp=None, reduce: bool = True):
    """``w_down(act(w_gate x) * w_up x)``. With a ``tp`` that cuts d_ff
    (``tp.ffn``, ``models.common.TensorParallel``) ``w_gate``/``w_up``
    are the rank's columns and ``w_down`` its rows: column-parallel, then
    row-parallel, the partial sums summed over ``model`` — or, with
    ``reduce=False``, returned as this rank's partial sum (a MoE's shared
    experts, summed with the routed experts' partial output once)."""
    split = tp is not None and tp.ffn
    if split:
        x = tp.copy(x)
    g = dense(params["w_gate"], x, compute_dtype)
    u = dense(params["w_up"], x, compute_dtype)
    out = dense(params["w_down"], ACT[act](g) * u, compute_dtype)
    return tp.reduce(out) if split and reduce else out


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
