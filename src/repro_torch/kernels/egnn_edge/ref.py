"""Plain PyTorch versions of the fused EGNN edge kernels.

``egnn_edge_agg_ref`` is exactly the unfused message path of
``models.gnn.egnn_apply`` (gather with the A-1 clamp -> d² -> φ_e via
``mlp_apply`` on the materialized concat -> masked segment-sum), mirroring
``repro.kernels.egnn_edge.ref``. ``egnn_edge_bwd_ref`` is its gradient,
written from the node-projection algebra the backward kernel implements
(``csrc/egnn_edge_bwd.cu``). The CUDA kernels are held against these on
the card; CPU tensors run them. Sums over edges are one-hot products, so
they are deterministic on every device."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref
from repro_torch.models.mlp import mlp_apply


def _gather(x, idx):
    return torch.take_along_dim(x, idx[..., None].long(), dim=1)


def egnn_edge_agg_ref(h, pos, src, dst, edge_mask, phi_e, *,
                      compute_dtype=None):
    """h: (B, A, H); pos: (B, A, 3); src/dst: (B, E); edge_mask: (B, E);
    phi_e: 2-layer MLP params ({"fc0": {w,b}, "fc1": {w,b}}).
    Returns (B, A, H) aggregated messages."""
    cd = compute_dtype or h.dtype
    A = h.shape[1]
    sc = src.clamp(max=A - 1)
    dc = dst.clamp(max=A - 1)
    hi, hj = _gather(h, sc), _gather(h, dc)
    p = pos.to(torch.float32)
    xi, xj = _gather(p, sc), _gather(p, dc)
    d2 = ((xi - xj) ** 2).sum(-1, keepdim=True).to(cd)
    m = mlp_apply(phi_e, torch.cat([hi.to(cd), hj.to(cd), d2], -1), "silu", cd)
    m = torch.where(edge_mask[..., None], m, torch.zeros((), dtype=m.dtype,
                                                         device=m.device))
    d = torch.where(edge_mask, dst, torch.full_like(dst, A))
    return segment_sum_ref(m, d, A)


def egnn_edge_bwd_ref(g, h, pos, src, dst, w0i, w0j, w0d, b0, w1):
    """The backward of the fused edge path, in f32, from its inputs.

    Inputs mirror ``repro``'s ``egnn_edge_fused_bwd``: ``g`` (B, A, H) the
    cotangent of the aggregated output; src/dst (B, E) already routed (an
    edge with dst >= A contributes nothing; gathers clamp to A-1); the φ_e
    weights split as in the forward — w0i, w0j (H, H), w0d and b0 (1, H),
    w1 (H, H). Returns ``(dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1)``: dh
    (B, A, H), dpos (B, A, 3), the weight gradients summed over the batch,
    biases as (1, H) rows — all f32."""
    f32 = torch.float32
    B, A, H = h.shape
    hf, gf = h.to(f32), g.to(f32)
    w0i, w0j, w0d, b0, w1 = (w.to(f32) for w in (w0i, w0j, w0d, b0, w1))
    valid = (dst >= 0) & (dst < A)
    vm = valid[..., None].to(f32)
    sc, dc = src.clamp(max=A - 1).long(), dst.clamp(max=A - 1).long()
    nodes = torch.arange(A, device=h.device)
    oh_s = (sc[..., None] == nodes).to(f32) * vm           # (B, E, A)
    oh_d = (dc[..., None] == nodes).to(f32) * vm

    def to_nodes(oh, x):                                   # sum edges -> nodes
        return torch.bmm(oh.transpose(1, 2), x)

    p = pos.to(f32)
    diff = _gather(p, sc) - _gather(p, dc)                 # (B, E, 3)
    d2 = (diff ** 2).sum(-1, keepdim=True)                 # (B, E, 1)
    pi = hf @ w0i + b0
    pj = hf @ w0j
    z = _gather(pi, sc) + _gather(pj, dc) + d2 * w0d       # (B, E, H)
    sig = torch.sigmoid(z)
    s_nodes = to_nodes(oh_d, z * sig)                      # S (B, A, H)
    deg = oh_d.sum(1)                                      # (B, A)

    ds = gf @ w1.T                                         # dS
    dw1 = s_nodes.reshape(-1, H).T @ gf.reshape(-1, H)
    db1 = (deg.reshape(1, -1) @ gf.reshape(-1, H))
    dz = _gather(ds, dc) * (sig * (1 + z * (1 - sig))) * vm
    dpi = to_nodes(oh_s, dz)
    dpj = to_nodes(oh_d, dz)
    dw0d = (dz * d2).sum((0, 1))[None]
    dd2 = (dz * w0d).sum(-1, keepdim=True)
    ddiff = 2 * diff * dd2 * vm
    dpos = to_nodes(oh_s, ddiff) - to_nodes(oh_d, ddiff)
    dh = dpi @ w0i.T + dpj @ w0j.T
    hflat = hf.reshape(-1, H).T
    dw0i = hflat @ dpi.reshape(-1, H)
    dw0j = hflat @ dpj.reshape(-1, H)
    db0 = dpi.sum((0, 1))[None]
    return dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1
