"""Two-level hierarchical MTL heads (port of ``repro.models.heads``).

Level 1: one branch per data source. Level 2: each branch owns an energy
head (graph-level scalar via masked mean-pool + MLP) and a force head
(node-level 3-vector via MLP). Branches are stacked along a leading task
dim, as in ``repro``, so a converted tree keeps its ``(T, ...)`` leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import Params
from .mlp import mlp_apply, mlp_init


def branch_init(cfg, *, rng: np.random.Generator, device="cpu") -> Params:
    """One per-source branch: {energy, force} MLPs (paper: 3 FC x 889)."""
    hid, hh, hl, dt = (cfg.gnn_hidden, cfg.head_hidden, cfg.head_layers,
                       cfg.param_dtype)
    return {"energy": mlp_init(rng, hid, hh, 1, hl, dt, device=device),
            "force": mlp_init(rng, hid, hh, 3, hl, dt, device=device)}


def stacked_branches_init(cfg, n_tasks: int, *, seed: int = 0,
                          device="cpu") -> Params:
    """``n_tasks`` branches stacked leaf-wise along a leading task dim."""
    rng = np.random.default_rng(seed)
    per = [branch_init(cfg, rng=rng, device=device) for _ in range(n_tasks)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return stack(per)


def branch_apply(bp: Params, node_feats, node_mask, *, cfg):
    """node_feats: (B,A,hid) -> (energy_per_atom: (B,), forces: (B,A,3))."""
    cd = cfg.compute_dtype
    nm = node_mask[..., None].to(cd)
    n = node_mask.sum(-1, keepdim=True).to(torch.float32).clamp(min=1.0)
    pooled = (node_feats * nm).sum(1) / n.to(cd)            # masked mean-pool
    e = mlp_apply(bp["energy"], pooled, "silu", cd)[..., 0]  # (B,)
    f = mlp_apply(bp["force"], node_feats, "silu", cd) * nm  # (B,A,3)
    return e.to(torch.float32), f.to(torch.float32)


def stacked_branches_apply(bp: Params, node_feats, node_mask, *, cfg):
    """Task-major inputs: node_feats (T,B,A,hid), node_mask (T,B,A); bp
    leaves have a leading task dim. Returns (energy (T,B), forces
    (T,B,A,3)) — each task's ``branch_apply`` on its own rows, one batched
    product per layer for all tasks."""
    def per_task(mlp):           # biases broadcast over each task's rows
        return {k: {"w": l["w"], "b": l["b"][:, None]} for k, l in
                mlp.items()}

    cd = cfg.compute_dtype
    T, B, A, H = node_feats.shape
    nm = node_mask[..., None].to(cd)
    n = node_mask.sum(-1, keepdim=True).to(torch.float32).clamp(min=1.0)
    pooled = (node_feats * nm).sum(2) / n.to(cd)            # (T,B,hid)
    e = mlp_apply(per_task(bp["energy"]), pooled, "silu", cd)[..., 0]
    f = mlp_apply(per_task(bp["force"]), node_feats.reshape(T, B * A, H),
                  "silu", cd).reshape(T, B, A, 3) * nm
    return e.to(torch.float32), f.to(torch.float32)
