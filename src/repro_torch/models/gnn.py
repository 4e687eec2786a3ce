"""EGNN encoder (the paper's HydraGNN backbone: 4-layer EGNN, 866 hidden).

Port of ``repro.models.gnn`` on padded graph batches:

  species:    (B, A)    int32   atomic numbers (0 = pad)
  pos:        (B, A, 3) float   coordinates
  edge_src:   (B, E)    int32   source node index (A = pad sentinel)
  edge_dst:   (B, E)    int32   destination node index
  node_mask:  (B, A)    bool
  edge_mask:  (B, E)    bool

Message aggregation (``segment_sum_impl``), same four names as ``repro``:

  * ``"scatter"`` — the analogue of the XLA scatter-add: each node's
    masked messages added in edge order, on the CPU by ``edge_order_sum``
    (a serial scatter-add's values), on the card by the segment-sum kernel
    (#2), where a scatter-add would add with float atomics in no fixed
    order;
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

Training replays bit for bit on the card under every impl: the
aggregation's sums run in edge order (#2 for ``"scatter"`` and
``"pallas"``, whose backward is a gather; the one-hot product for
``"jnp"``), and so does the backward of the node gathers (``gather_nodes``:
#2 over the edge list, the one-hot product under ``"jnp"``, where
``take_along_dim``'s backward is a float-atomic ``scatter_add``). The CPU keeps a serial scatter-add's values and ``take_along_dim``: the
values the parity tests hold to ``repro``.
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
    if impl == "scatter" or (messages.is_cuda and impl == "pallas"):
        return _OrderedSegmentSum.apply(messages, dst, edge_mask, n_nodes,
                                        block_n, block_e)
    if impl == "pallas":
        from repro_torch.kernels.segment_sum import ops as ss_ops
        return ss_ops.segment_sum(messages, dst, n_nodes, edge_mask=edge_mask,
                                  block_n=block_n, block_e=block_e)
    if impl != "jnp":
        raise ValueError(
            f"segment_sum impl '{impl}'; this op takes 'scatter' | 'jnp' | "
            "'pallas' ('fused' is a whole-layer path — select it via "
            "egnn_apply / cfg.segment_sum_impl)")
    keep = edge_mask & (dst >= 0) & (dst < n_nodes)
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    return segment_sum_ref(messages, torch.where(keep, dst, n_nodes),
                           n_nodes)


def edge_order_sum(messages, dst, keep, n_nodes: int):
    """Each node's kept messages summed one at a time in edge order, in the
    messages' dtype, from zero: the values of a serial scatter-add (the
    CPU's ``index_put_(accumulate=True)``), with no scatter-add. The edges
    are sorted stably by destination; pass k adds every node's k-th
    message (one message a node, so each pass is a plain indexed store),
    and the passes run in order: E x F additions in all."""
    B, E = dst.shape
    dev = messages.device
    key = torch.where(keep, dst.long(), torch.full_like(dst, n_nodes).long())
    skey, order = torch.sort(key, dim=1, stable=True)
    nodes = torch.arange(n_nodes + 1, device=dev).expand(B, -1).contiguous()
    start = torch.searchsorted(skey, nodes)                  # (B, n + 1)
    slot = torch.arange(E, device=dev) - torch.take_along_dim(start, skey, 1)
    slot = torch.where(skey < n_nodes, slot, -1)             # dropped edges
    rows = torch.take_along_dim(messages, order[..., None], dim=1)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, E)
    out = messages.new_zeros((B, n_nodes) + tuple(messages.shape[2:]))
    for k in range(int(slot.max()) + 1 if E else 0):
        sel = slot == k
        bk, nk = b_idx[sel], skey[sel]
        out[bk, nk] = out[bk, nk] + rows[sel]
    return out


class _OrderedSegmentSum(torch.autograd.Function):
    """Messages summed into nodes in edge order — the segment-sum kernel
    (#2) on the card, ``edge_order_sum`` elsewhere — with a backward:
    each message's cotangent is its destination node's row, zero where
    the edge is masked or its ``dst`` is out of range — a gather, no
    sum."""

    @staticmethod
    def forward(ctx, messages, dst, edge_mask, n_nodes, block_n, block_e):
        from repro_torch.kernels.segment_sum import ops as ss_ops
        keep = (dst >= 0) & (dst < n_nodes)
        if edge_mask is not None:
            keep = keep & edge_mask
        ctx.save_for_backward(dst, keep)
        if not messages.is_cuda:
            return edge_order_sum(messages, dst, keep, n_nodes)
        return ss_ops.segment_sum(messages, dst, n_nodes, edge_mask=keep,
                                  block_n=block_n, block_e=block_e)

    @staticmethod
    def backward(ctx, g):
        dst, keep = ctx.saved_tensors
        rows = torch.take_along_dim(
            g, dst.clamp(0, g.shape[1] - 1)[..., None].long(), dim=1)
        return (torch.where(keep[..., None], rows, torch.zeros_like(rows)),
                None, None, None, None, None)


class OrderedGather(torch.autograd.Function):
    """``take_along_dim(x, idx[..., None], dim=1)`` on (B, A, F) node rows
    and (B, E) indices, whose backward sums each node's cotangent rows in
    edge order with the segment-sum kernel (#2 on the card; its plain
    version, a one-hot product, on the CPU), or with ``plain`` with the
    one-hot product (``segment_sum_ref``) on every device."""

    @staticmethod
    def forward(ctx, x, idx, plain=False):
        ctx.save_for_backward(idx)
        ctx.n_nodes, ctx.plain = x.shape[1], plain
        return torch.take_along_dim(x, idx[..., None].long(), dim=1)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.segment_sum import ops as ss_ops
        from repro_torch.kernels.segment_sum.ref import segment_sum_ref
        (idx,) = ctx.saved_tensors
        sum_fn = segment_sum_ref if ctx.plain else ss_ops.segment_sum
        return sum_fn(g.contiguous(), idx.to(torch.int32),
                      ctx.n_nodes), None, None


def gather_nodes(x, idx, plain=False):
    """Rows ``x[b, idx[b, e]]`` of (B, A, F) ``x`` -> (B, E, F): on the
    card through ``OrderedGather`` (a backward in edge order; ``plain``:
    the one-hot product, no kernel), elsewhere ``take_along_dim``."""
    if x.is_cuda and x.dtype in (torch.float32, torch.bfloat16):
        return OrderedGather.apply(x, idx, plain)
    return torch.take_along_dim(x, idx[..., None].long(), dim=1)


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

    for i in range(cfg.gnn_layers):
        lp = params[f"layer{i}"]
        if impl == "fused":
            from repro_torch.kernels.egnn_edge import ops as edge_ops
            agg = edge_ops.egnn_edge_agg(h, pos, src, dst, em, lp["phi_e"],
                                         compute_dtype=cd, block_e=be,
                                         block_h=bh)
        else:
            sc, dc = src.clamp(max=A - 1), dst.clamp(max=A - 1)
            plain = impl == "jnp"
            hi, hj = gather_nodes(h, sc, plain), gather_nodes(h, dc, plain)
            xi, xj = (gather_nodes(pos, sc, plain),
                      gather_nodes(pos, dc, plain))
            d2 = ((xi - xj) ** 2).sum(-1, keepdim=True).to(cd)
            m = mlp_apply(lp["phi_e"], torch.cat([hi, hj, d2], -1), "silu",
                          cd)
            agg = segment_sum_nodes(m, dst, A, edge_mask=em, impl=impl,
                                    block_n=bn, block_e=be)
        upd = mlp_apply(lp["phi_h"], torch.cat([h, agg], -1), "silu", cd)
        h = (h + upd) * nmf
    return h
