"""Public entry for the fused EGNN edge kernel (forward).

``egnn_edge_agg`` is the port of ``repro.kernels.egnn_edge.ops.egnn_edge_agg``:
CUDA tensors launch ``csrc/egnn_edge.cu`` (the port of the Pallas
``egnn_edge_fused``; its design note explains the node-projection form),
CPU tensors run the plain version in ``ref.py``. There is no fallback: a
CUDA call the kernel does not take (a dtype other than float32, mixed
devices) raises. The bf16 kernel and the backward come in later work.

Block planning mirrors ``repro``: ``None`` plans ``(block_e, block_h)``
against the shared-memory model in ``budget.py``, explicit overrides are
validated and raise ``SmemBudgetError`` when over budget — on every device,
so a CPU run rejects what the card could not launch.
``egnn_edge_agg.launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .budget import check_blocks, plan_blocks, plan_groups
from .ref import egnn_edge_agg_ref


def _split_phi_e(phi_e, H, cd):
    """fc0 weight (2H+1, H) -> its h_i / h_j / d² row blocks, plus b0, w1,
    b1 (biases as (1, H) rows). On a contiguous float32 fc0 weight in the
    compute dtype these are views: the three blocks stay adjacent rows of
    one buffer, which is how the kernel reads them."""
    w0 = phi_e["fc0"]["w"].to(cd)
    assert w0.shape[0] == 2 * H + 1, \
        f"phi_e fc0 expects (2H+1, H)={2 * H + 1}, got {tuple(w0.shape)}"
    return (w0[:H], w0[H:2 * H], w0[2 * H:],
            phi_e["fc0"]["b"].to(cd)[None, :],
            phi_e["fc1"]["w"].to(cd),
            phi_e["fc1"]["b"].to(cd)[None, :])


def _resolve_blocks(block_e, block_h, A, E, H):
    """Plan-or-validate ``(block_e, block_h)`` against the budget model."""
    if block_e and block_h:
        check_blocks(A, E, H, block_e, block_h)
        return block_e, block_h
    pe, ph = plan_blocks(A, E, H)
    be, bh = block_e or pe, block_h or ph
    if block_e or block_h:          # one side overridden: re-validate the mix
        check_blocks(A, E, H, be, bh)
    return be, bh


def _lib():
    lib = _build.load("egnn_edge")
    fn = lib.egnn_edge_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(h, pos, src, dst, edge_mask, phi_e, cd, block_e, block_h):
    if cd != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"egnn_edge CUDA kernel is float32 only, got h "
                        f"{h.dtype}, compute dtype {cd}")
    dev = h.device
    tensors = [pos, src, dst, edge_mask] + [
        v for layer in phi_e.values() for v in layer.values()]
    if any(t.device != dev for t in tensors):
        raise ValueError("egnn_edge_agg: every input must be on " + str(dev))
    B, A, H = h.shape
    E = src.shape[1]
    if B > 65535:
        raise ValueError(f"egnn_edge grid: B={B} > 65535")
    w0 = phi_e["fc0"]["w"]
    if w0.dtype != torch.float32:
        raise TypeError(f"egnn_edge CUDA kernel takes float32 weights, "
                        f"got {w0.dtype}")
    w0 = w0.contiguous()
    _, _, _, b0, w1, b1 = _split_phi_e(phi_e, H, cd)
    b0, w1, b1 = b0.contiguous(), w1.contiguous(), b1.contiguous()
    h = h.contiguous()
    pos = pos.to(torch.float32).contiguous()
    sentinel = torch.full_like(src, A)
    sr = torch.where(edge_mask, src, sentinel).to(torch.int32).contiguous()
    dr = torch.where(edge_mask, dst, sentinel).to(torch.int32).contiguous()
    out = torch.empty_like(h)
    pi, pj, s = (torch.empty_like(h) for _ in range(3))
    deg = torch.empty((B, A), dtype=torch.float32, device=dev)
    be = min(block_e, max(E, 1))
    lib = _lib()
    code = lib.egnn_edge_fwd_launch(
        h.data_ptr(), pos.data_ptr(), sr.data_ptr(), dr.data_ptr(),
        w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        out.data_ptr(), pi.data_ptr(), pj.data_ptr(), s.data_ptr(),
        deg.data_ptr(), B, A, E, H, be, block_h,
        plan_groups(A, be, block_h), _build.stream_ptr(h))
    _build.check(lib, code, "egnn_edge_fwd_launch")
    egnn_edge_agg.launches += 1
    return out


def egnn_edge_agg(h, pos, src, dst, edge_mask, phi_e, *, compute_dtype=None,
                  block_e=None, block_h=None):
    """Fused EGNN message + aggregation: (B, A, H) node features in,
    (B, A, H) aggregated messages out. Drop-in for the unfused
    gather/φ_e/segment-sum sequence in ``egnn_apply`` (numerics: ``ref.py``).
    ``block_e``/``block_h``: None plans against the shared-memory model;
    over-budget overrides raise ``budget.SmemBudgetError``."""
    B, A, H = h.shape
    block_e, block_h = _resolve_blocks(block_e, block_h, A, src.shape[1], H)
    cd = compute_dtype or h.dtype
    if h.device.type == "cpu":
        return egnn_edge_agg_ref(h, pos, src, dst, edge_mask, phi_e,
                                 compute_dtype=cd)
    return _launch(h, pos, src, dst, edge_mask, phi_e, cd, block_e, block_h)


egnn_edge_agg.launches = 0
