"""EGNN encoder (the paper's HydraGNN backbone: 4-layer EGNN, 866 hidden).

Port of ``repro.models.gnn`` on padded graph batches:

  species:    (B, A)    int32   atomic numbers (0 = pad)
  pos:        (B, A, 3) float   coordinates
  edge_src:   (B, E)    int32   source node index (A = pad sentinel)
  edge_dst:   (B, E)    int32   destination node index
  node_mask:  (B, A)    bool
  edge_mask:  (B, E)    bool

Message aggregation (``segment_sum_impl``), same four names as ``repro``:

  * ``"scatter"`` — ``index_put_(accumulate=True)`` of the masked messages
    (the analogue of the XLA scatter-add);
  * ``"jnp"``     — one-hot membership matmul, the parity oracle
    (``kernels.segment_sum.ref``), also in the species embedding's
    backward, which the other paths sum with kernel #1;
  * ``"pallas"``  — the segment-sum kernel (``kernels.segment_sum``: CUDA
    kernel on the card, its plain version on the CPU);
  * ``"fused"``   — gather -> d² -> φ_e -> masked segment-sum in the fused
    edge kernel (``kernels.egnn_edge``), never materializing the
    (B,E,2H+1) concat or the (B,E,H) messages.

Pad-sentinel contract: gathers clamp to ``A-1``; edges with ``dst >= A`` or
``edge_mask`` False contribute nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import Params, embed, embedding_init
from .mlp import mlp_apply, mlp_init

SEGMENT_SUM_IMPLS = ("scatter", "jnp", "pallas", "fused")


def segment_sum_nodes(messages, dst, n_nodes, *, edge_mask, impl="scatter",
                      block_n=None, block_e=None):
    """messages: (B,E,F), dst: (B,E) -> (B,A,F) summing messages into nodes.

    ``impl``: "scatter" | "jnp" | "pallas" ("fused" is a whole-layer path
    dispatched in ``egnn_apply``). ``block_n``/``block_e`` tile the kernel
    (None = autotune; only "pallas" reads them)."""
    if impl == "pallas":
        from repro_torch.kernels.segment_sum import ops as ss_ops
        return ss_ops.segment_sum(messages, dst, n_nodes, edge_mask=edge_mask,
                                  block_n=block_n, block_e=block_e)
    if impl not in ("scatter", "jnp"):
        raise ValueError(
            f"segment_sum impl '{impl}'; this op takes 'scatter' | 'jnp' | "
            "'pallas' ('fused' is a whole-layer path — select it via "
            "egnn_apply / cfg.segment_sum_impl)")
    keep = edge_mask & (dst >= 0) & (dst < n_nodes)
    if impl == "jnp":
        from repro_torch.kernels.segment_sum.ref import segment_sum_ref
        return segment_sum_ref(messages, torch.where(keep, dst, n_nodes),
                               n_nodes)
    B = messages.shape[0]
    out = torch.zeros((B, n_nodes) + tuple(messages.shape[2:]),
                      dtype=messages.dtype, device=messages.device)
    b_idx = torch.arange(B, device=messages.device)[:, None].expand_as(dst)
    return out.index_put_((b_idx[keep], dst[keep].long()), messages[keep],
                          accumulate=True)


def egnn_init(cfg, *, seed: int = 0, device="cpu") -> Params:
    """EGNN trunk parameters, drawn from ``np.random.default_rng(seed)``
    (``device="meta"`` gives a shape-only tree)."""
    rng = np.random.default_rng(seed)
    hid, dt = cfg.gnn_hidden, cfg.param_dtype
    p: Params = {"embed": embedding_init(rng, cfg.n_species, hid, dt, device)}
    for i in range(cfg.gnn_layers):
        p[f"layer{i}"] = {
            "phi_e": mlp_init(rng, 2 * hid + 1, hid, hid, 1, dt,
                              device=device),
            "phi_h": mlp_init(rng, 2 * hid, hid, hid, 1, dt, device=device),
        }
    return p


def egnn_apply(params: Params, batch: dict, *, cfg, impl=None):
    """-> node features (B, A, hidden). impl selects the aggregation path
    ("scatter" | "jnp" | "pallas" | "fused"); None defers to
    ``cfg.segment_sum_impl``. Runs on the device the tensors live on."""
    if impl is None:
        impl = getattr(cfg, "segment_sum_impl", "scatter") or "scatter"
    if impl not in SEGMENT_SUM_IMPLS:
        raise ValueError(f"segment_sum impl '{impl}'; "
                         f"known: {SEGMENT_SUM_IMPLS}")
    cd = cfg.compute_dtype
    bn = getattr(cfg, "kernel_block_n", 0) or None
    be = getattr(cfg, "kernel_block_e", 0) or None
    bh = getattr(cfg, "kernel_block_h", 0) or None
    species = batch["species"]
    pos = batch["pos"].to(torch.float32)
    src, dst = batch["edge_src"], batch["edge_dst"]
    nm, em = batch["node_mask"], batch["edge_mask"]
    A = species.shape[1]
    nmf = nm[..., None].to(cd)
    h = embed(params["embed"], species, cd, plain=impl == "jnp") * nmf

    def gather(x, idx):
        return torch.take_along_dim(x, idx[..., None].long(), dim=1)

    for i in range(cfg.gnn_layers):
        lp = params[f"layer{i}"]
        if impl == "fused":
            from repro_torch.kernels.egnn_edge import ops as edge_ops
            agg = edge_ops.egnn_edge_agg(h, pos, src, dst, em, lp["phi_e"],
                                         compute_dtype=cd, block_e=be,
                                         block_h=bh)
        else:
            sc, dc = src.clamp(max=A - 1), dst.clamp(max=A - 1)
            hi, hj = gather(h, sc), gather(h, dc)
            xi, xj = gather(pos, sc), gather(pos, dc)
            d2 = ((xi - xj) ** 2).sum(-1, keepdim=True).to(cd)
            m = mlp_apply(lp["phi_e"], torch.cat([hi, hj, d2], -1), "silu",
                          cd)
            agg = segment_sum_nodes(m, dst, A, edge_mask=em, impl=impl,
                                    block_n=bn, block_e=be)
        upd = mlp_apply(lp["phi_h"], torch.cat([h, agg], -1), "silu", cd)
        h = (h + upd) * nmf
    return h
