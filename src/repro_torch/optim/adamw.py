"""AdamW with ``repro``'s exact formula (port of ``repro.optim.adamw``).

``torch.optim.AdamW`` is not the same update: ``repro`` clips by the global
norm first (``max(gnorm, 1e-9)``), calls the schedule with the 1-based
step, computes the bias corrections in float32 and decays every leaf.

The state mirrors the parameter tree (nested dicts of tensors); ``update``
returns new trees and leaves its inputs untouched, as ``repro``'s pure
function does. With ``donate=True`` it writes the new values into the
params' and moments' own storage instead — the counterpart of ``repro``'s
donated step buffers (``ShardingPlan(donate=True)``: XLA reuses them for
the outputs), the same bits — computed a slice of ``DONATE_CHUNK``
elements at a time, so a step holds one copy of the state and a slice's
temporaries, where the pure update holds two copies and each leaf's
f32 temporaries (a full-width MoE layer's expert leaf is 1.26e9
elements). The step counter is a host int, so the schedule and the bias
corrections cost no device synchronisation.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.interop import leaves, tree_map


DONATE_CHUNK = 1 << 26          # elements of a leaf updated at a time


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum()
                          for x in leaves(tree).values()))


def adamw(lr, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          grad_clip=0.0, moment_dtype=torch.float32,
          donate: bool = False) -> Optimizer:
    """lr: float or schedule fn(step) -> float32. ``donate``: update the
    params and moments in place (their inputs are consumed)."""
    sched = lr if callable(lr) else (lambda _: np.float32(lr))

    def init(params):
        return AdamWState(step=0, m=tree_map(lambda p: torch.zeros(
            p.shape, dtype=moment_dtype, device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                         device=p.device), params))

    def update(grads, state, params, norm_fn=global_norm):
        """``norm_fn(grads)``: the global norm clipping divides by (a
        task-parallel plan's spans the ranks)."""
        step = state.step + 1
        if grad_clip > 0:
            gnorm = norm_fn(grads)
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        lr_t = float(sched(step))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def upd(p, g, m, v):
            g32 = g.float()
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = b2 * v.float() + (1 - b2) * g32.square()
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (vhat.sqrt() + eps) + weight_decay * p.float()
            p_new = p.float() - lr_t * delta
            return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        if donate:
            tree_map(lambda p, g, m, v: _in_place(upd, p, g, m, v), params,
                     grads, state.m, state.v)
            return params, AdamWState(step=step, m=state.m, v=state.v)
        flat = tree_map(upd, params, grads, state.m, state.v)
        return _pick(flat, 0), AdamWState(step=step, m=_pick(flat, 1),
                                          v=_pick(flat, 2))

    return Optimizer(init=init, update=update)


def _pick(tree, i):
    """Element i of each (param, m, v) triple at the leaves of ``tree``
    (dicts only: ``tree_map`` would walk into the triples)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def _in_place(upd, p, g, m, v):
    """``upd`` on slices of the flattened leaves, each result copied into
    its slice of p, m and v: elementwise, so the bits of the whole-leaf
    update."""
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("donated AdamW update needs contiguous leaves")
    pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
    for s in range(0, pf.numel(), DONATE_CHUNK):
        sl = slice(s, s + DONATE_CHUNK)
        for dst, new in zip((pf, mf, vf), upd(pf[sl], gf[sl], mf[sl],
                                              vf[sl])):
            dst[sl].copy_(new)
