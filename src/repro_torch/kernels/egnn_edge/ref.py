"""Plain PyTorch version of the fused EGNN edge kernel.

Exactly the unfused message path of ``models.gnn.egnn_apply`` (gather with
the A-1 clamp -> d² -> φ_e via ``mlp_apply`` on the materialized concat ->
masked segment-sum), mirroring ``repro.kernels.egnn_edge.ref``. The CUDA
kernel is held against it on the card; CPU tensors run it."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref
from repro_torch.models.mlp import mlp_apply


def egnn_edge_agg_ref(h, pos, src, dst, edge_mask, phi_e, *,
                      compute_dtype=None):
    """h: (B, A, H); pos: (B, A, 3); src/dst: (B, E); edge_mask: (B, E);
    phi_e: 2-layer MLP params ({"fc0": {w,b}, "fc1": {w,b}}).
    Returns (B, A, H) aggregated messages."""
    cd = compute_dtype or h.dtype
    A = h.shape[1]

    def gather(x, idx):
        return torch.take_along_dim(x, idx[..., None].long(), dim=1)

    sc = src.clamp(max=A - 1)
    dc = dst.clamp(max=A - 1)
    hi, hj = gather(h, sc), gather(h, dc)
    p = pos.to(torch.float32)
    xi, xj = gather(p, sc), gather(p, dc)
    d2 = ((xi - xj) ** 2).sum(-1, keepdim=True).to(cd)
    m = mlp_apply(phi_e, torch.cat([hi.to(cd), hj.to(cd), d2], -1), "silu", cd)
    m = torch.where(edge_mask[..., None], m, torch.zeros((), dtype=m.dtype,
                                                         device=m.device))
    d = torch.where(edge_mask, dst, torch.full_like(dst, A))
    return segment_sum_ref(m, d, A)
