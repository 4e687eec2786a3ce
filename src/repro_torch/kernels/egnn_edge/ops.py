"""Public entry for the fused EGNN edge kernel, forward and backward.

``egnn_edge_agg`` is the port of ``repro.kernels.egnn_edge.ops.egnn_edge_agg``
and, like its ``jax.custom_vjp``, a ``torch.autograd.Function`` on every
device:

  * CUDA tensors: the forward launches ``csrc/egnn_edge.cu`` (the port of
    the Pallas ``egnn_edge_fused``), the backward ``csrc/egnn_edge_bwd.cu``
    (the port of ``egnn_edge_fused_bwd``, wrapper ``egnn_edge_bwd``);
  * CPU tensors: the plain versions in ``ref.py``, ``egnn_edge_agg_ref``
    forward and ``egnn_edge_bwd_ref`` backward.

The compute dtype is float32 or bfloat16 on the card. As in ``repro``
(``_split_phi_e``), h and every φ_e leaf are cast to it, and the output is
in it. A bf16 call launches the bf16 forward (``egnn_edge_fwd_bf16_launch``:
bf16 tensor-core products, f32 scratch) and the backward on the bf16 h, g
and weights as they are (f32 math); each cotangent comes back in its
primal's dtype. There is no fallback: a CUDA call the kernels do not take
(another dtype, float16 included; mixed devices) raises. The forward keeps
only node-major tensors for the backward: its inputs and, on the card, its
scratch Pi, Pj, S (B·A·H f32 each) and deg (B·A), which the backward would
otherwise recompute — never an edge-major (B,E,H) message or (B,E,2H+1)
concat.

Block planning mirrors ``repro``: ``None`` plans ``(block_e, block_h)``
against the shared-memory model in ``budget.py``, each direction on its
own; explicit overrides apply to both directions and are validated against
each direction the call runs, raising ``SmemBudgetError`` when over budget
— on every device, so a CPU run rejects what the card could not launch.
``egnn_edge_agg.launches`` counts the f32 forward's launches and
``egnn_edge_agg.bf16.launches`` the bf16 forward's; ``egnn_edge_bwd``
counts the backward's the same way.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import gemm_plan
from .budget import check_blocks, plan_blocks
from .ref import egnn_edge_agg_ref, egnn_edge_bwd_ref


def _resolve_blocks(block_e, block_h, A, E, H, *, bwd=False):
    """Plan-or-validate ``(block_e, block_h)`` against the budget model of
    one direction."""
    if block_e and block_h:
        check_blocks(A, E, H, block_e, block_h, bwd=bwd)
        return block_e, block_h
    pe, ph = plan_blocks(A, E, H, bwd=bwd)
    be, bh = block_e or pe, block_h or ph
    if block_e or block_h:          # one side overridden: re-validate the mix
        check_blocks(A, E, H, be, bh, bwd=bwd)
    return be, bh


def _lib(name, fn_name, n_ptr, n_int):
    """``lib<name>.so`` with its launcher ``fn_name`` declared (``n_ptr``
    pointers, ``n_int`` ints, the stream)."""
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(what, h, tensors):
    if h.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{what} CUDA kernel computes in float32 or "
                        f"bfloat16, got {h.dtype}")
    dev = h.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every input must be on {dev}")
    if h.shape[0] > 65535:
        raise ValueError(f"{what} grid: B={h.shape[0]} > 65535")


def _launch_fwd(h, pos, sr, dr, w0, b0, w1, b1, cd, block_e, block_h, *,
                splits=None):
    """Kernel #3 (``csrc/egnn_edge.cu``) on routed int32 src/dst, in the
    compute dtype ``cd`` (h and the φ_e leaves cast to it): in f32 three
    launches a call, four when fc1 is split; in bf16 three, unsplit
    (``csrc/gemm_bf16.cuh``). Returns (out, Pi, Pj, S, deg): out
    in ``cd``, the scratch in f32. ``splits``: (proj, fc1) k-ranges in
    place of ``gemm_plan.fwd_splits``' (f32 only; timing only: they change
    the bits)."""
    if cd not in COMPUTE_DTYPES:
        raise TypeError(f"egnn_edge CUDA kernel computes in float32 or "
                        f"bfloat16, got compute dtype {cd}")
    h = h.to(cd).contiguous()
    _check_cuda("egnn_edge", h, (pos, sr, dr, w0, b0, w1, b1))
    w0, b0, w1, b1 = (t.to(cd).contiguous() for t in (w0, b0, w1, b1))
    B, A, H = h.shape
    E = sr.shape[1]
    dev, f32 = h.device, torch.float32
    out = torch.empty_like(h)
    pi, pj, s = (torch.empty((B, A, H), dtype=f32, device=dev)
                 for _ in range(3))
    deg = torch.empty((B, A), dtype=f32, device=dev)
    be = min(block_e, max(E, 1))
    if cd == torch.bfloat16:
        if splits not in (None, (1, 1)):
            raise ValueError(f"the bf16 forward is unsplit, got {splits}")
        lib = _lib("egnn_edge", "egnn_edge_fwd_bf16_launch", 13, 6)
        code = lib.egnn_edge_fwd_bf16_launch(
            h.data_ptr(), pos.data_ptr(), sr.data_ptr(), dr.data_ptr(),
            w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), pi.data_ptr(), pj.data_ptr(), s.data_ptr(),
            deg.data_ptr(), B, A, E, H, be, block_h, _build.stream_ptr(h))
        _build.check(lib, code, "egnn_edge_fwd_bf16_launch")
        _build.count_launch(egnn_edge_agg.bf16)
        return out, pi, pj, s, deg
    proj, fc1 = splits or gemm_plan.fwd_splits(B * A, H)
    part = torch.empty((2, proj, B * A, H), dtype=f32, device=dev) \
        if proj > 1 else None
    out_part = torch.empty((fc1, B * A, H), dtype=f32, device=dev) \
        if fc1 > 1 else None
    lib = _lib("egnn_edge", "egnn_edge_fwd_launch", 15, 8)
    code = lib.egnn_edge_fwd_launch(
        h.data_ptr(), pos.data_ptr(), sr.data_ptr(), dr.data_ptr(),
        w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        out.data_ptr(), pi.data_ptr(), pj.data_ptr(), s.data_ptr(),
        deg.data_ptr(), _ptr(part), _ptr(out_part), B, A, E, H, be,
        block_h, proj, fc1, _build.stream_ptr(h))
    _build.check(lib, code, "egnn_edge_fwd_launch")
    _build.count_launch(egnn_edge_agg)
    return out, pi, pj, s, deg


def egnn_edge_bwd(g, h, pos, src, dst, w0, w1, pi, pj, s, deg, *,
                  block_e, block_h, need_dpos=True):
    """Kernel #4 (``csrc/egnn_edge_bwd.cu``): the backward of the fused edge
    path on the card, three launches (four with dpos). ``g`` is the
    (B, A, H) cotangent of the aggregated output; src/dst (B, E) int32,
    routed (dst >= A: no contribution); w0 the whole fc0 weight (2H+1, H);
    pi, pj, s, deg the forward kernel's f32 scratch. g, h, w0 and w1 are
    all float32 or all bfloat16 (the compute dtype's, read as they are).
    Returns ``(dh, dpos, dw0, db0, dw1, db1)`` in f32 — dpos is None
    unless ``need_dpos``. CUDA tensors only: its plain version is
    ``ref.egnn_edge_bwd_ref``."""
    if g.device.type != "cuda":
        raise ValueError("egnn_edge_bwd launches the CUDA kernel; CPU "
                         "tensors take ref.egnn_edge_bwd_ref")
    _check_cuda("egnn_edge_bwd", h, (g, pos, src, dst, w0, w1, pi, pj, s,
                                     deg))
    if any(t.dtype != h.dtype for t in (g, w0, w1)):
        raise TypeError(f"egnn_edge_bwd: g, h, w0 and w1 share one dtype, "
                        f"got {[t.dtype for t in (g, h, w0, w1)]}")
    bf16 = h.dtype == torch.bfloat16
    B, A, H = h.shape
    E = src.shape[1]
    be = min(block_e, max(E, 1))
    splits = gemm_plan.w1_splits(B * A, H)
    dev, f32 = h.device, torch.float32
    g, h, w0, w1 = (t.contiguous() for t in (g, h, w0, w1))
    dh = torch.empty((B, A, H), dtype=f32, device=dev)
    dpos = torch.empty((B, A, 3), dtype=f32, device=dev) if need_dpos \
        else None
    dw0 = torch.empty((2 * H + 1, H), dtype=f32, device=dev)
    dw1 = torch.empty((H, H), dtype=f32, device=dev)
    db0, db1 = (torch.empty(H, dtype=f32, device=dev) for _ in range(2))
    ds, dpi, dpj = (torch.empty((B, A, H), dtype=f32, device=dev)
                    for _ in range(3))
    dw0d_part = torch.empty((B, H), dtype=f32, device=dev)
    dd2_part = torch.empty((B, -(-H // 32), E), dtype=f32, device=dev) \
        if need_dpos else None
    w1_part = torch.empty((splits, H + 1, H), dtype=f32, device=dev) \
        if splits > 1 else None
    lib = _lib("egnn_edge_bwd", "egnn_edge_bwd_launch", 23, 8)
    code = lib.egnn_edge_bwd_launch(
        g.data_ptr(), h.data_ptr(), pos.data_ptr(), src.data_ptr(),
        dst.data_ptr(), w0.data_ptr(), w1.data_ptr(), pi.data_ptr(),
        pj.data_ptr(), s.data_ptr(), deg.data_ptr(), dh.data_ptr(),
        _ptr(dpos), dw0.data_ptr(), db0.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), ds.data_ptr(), dpi.data_ptr(), dpj.data_ptr(),
        dw0d_part.data_ptr(), _ptr(dd2_part), _ptr(w1_part), B, A, E, H, be,
        block_h, splits, int(bf16), _build.stream_ptr(h))
    _build.check(lib, code, "egnn_edge_bwd_launch")
    _build.count_launch(egnn_edge_bwd.bf16 if bf16 else egnn_edge_bwd)
    return dh, dpos, dw0, db0, dw1, db1


def gemm_blocks_per_sm() -> int:
    """CTAs of the backward's GEMM kernel that one SM of the current card
    holds at once (``gemm_plan.SLOTS`` assumes 1)."""
    lib = _build.load("egnn_edge_bwd")
    out = ctypes.c_int(0)
    _build.check(lib, lib.gemm_tc_blocks_per_sm(ctypes.byref(out)),
                 "gemm_tc_blocks_per_sm")
    return out.value


egnn_edge_bwd.launches = 0
egnn_edge_bwd.bf16 = _build.LaunchCount()


class _EdgeAgg(torch.autograd.Function):
    """Inputs: h, pos, the four φ_e leaves (fc0 w/b, fc1 w/b), src, dst,
    edge_mask, the compute dtype and the two directions' blocks."""

    @staticmethod
    def forward(ctx, h, pos, w0, b0, w1, b1, src, dst, edge_mask, cd,
                fwd_blocks, bwd_blocks):
        A = h.shape[1]
        # masked edges -> sentinel A (excluded from every sum)
        sentinel = torch.full_like(src, A)
        sr = torch.where(edge_mask, src, sentinel)
        dr = torch.where(edge_mask, dst, sentinel)
        ctx.cd, ctx.bwd_blocks = cd, bwd_blocks
        ctx.dtypes = tuple(t.dtype for t in (h, pos, w0, b0, w1, b1))
        if h.device.type == "cpu":
            phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
            ctx.save_for_backward(h, pos, sr, dr, w0, b0, w1)
            return egnn_edge_agg_ref(h, pos, src, dst, edge_mask, phi,
                                     compute_dtype=cd)
        sr = sr.to(torch.int32).contiguous()
        dr = dr.to(torch.int32).contiguous()
        pos32 = pos.to(torch.float32).contiguous()
        hc, w0c, b0c, w1c, b1c = (t.to(cd) for t in (h, w0, b0, w1, b1))
        out, pi, pj, s, deg = _launch_fwd(hc, pos32, sr, dr, w0c, b0c, w1c,
                                          b1c, cd, *fwd_blocks)
        ctx.save_for_backward(hc, pos32, sr, dr, w0c, w1c, pi, pj, s, deg)
        return out

    @staticmethod
    def backward(ctx, g):
        cd = ctx.cd
        need_dpos = ctx.needs_input_grad[1]
        if g.device.type == "cpu":
            h, pos, sr, dr, w0, b0, w1 = ctx.saved_tensors
            H = h.shape[-1]
            w0c = w0.to(cd)
            dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
                g, h.to(cd), pos, sr, dr, w0c[:H], w0c[H:2 * H], w0c[2 * H:],
                b0.to(cd)[None], w1.to(cd))
            dw0 = torch.cat([dw0i, dw0j, dw0d], 0)
            db0, db1 = db0[0], db1[0]
        else:
            h, pos, sr, dr, w0, w1, pi, pj, s, deg = ctx.saved_tensors
            dh, dpos, dw0, db0, dw1, db1 = egnn_edge_bwd(
                g.to(cd), h, pos, sr, dr, w0, w1, pi, pj, s, deg,
                block_e=ctx.bwd_blocks[0], block_h=ctx.bwd_blocks[1],
                need_dpos=need_dpos)
        grads = (dh, dpos if need_dpos else None, dw0, db0, dw1, db1)
        return tuple(None if x is None else x.to(dt)
                     for x, dt in zip(grads, ctx.dtypes)) + (None,) * 6


def egnn_edge_agg(h, pos, src, dst, edge_mask, phi_e, *, compute_dtype=None,
                  block_e=None, block_h=None):
    """Fused EGNN message + aggregation: (B, A, H) node features in,
    (B, A, H) aggregated messages out. Drop-in for the unfused
    gather/φ_e/segment-sum sequence in ``egnn_apply`` (numerics: ``ref.py``),
    differentiable in h, pos and every φ_e leaf through the backward kernel.
    ``block_e``/``block_h``: None plans against the shared-memory model;
    over-budget overrides raise ``budget.SmemBudgetError``."""
    B, A, H = h.shape
    E = src.shape[1]
    fwd_blocks = _resolve_blocks(block_e, block_h, A, E, H)
    f0, f1 = phi_e["fc0"], phi_e["fc1"]
    leaves = (h, pos, f0["w"], f0["b"], f1["w"], f1["b"])
    bwd_blocks = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        bwd_blocks = _resolve_blocks(block_e, block_h, A, E, H, bwd=True)
    if f0["w"].shape[0] != 2 * H + 1:
        raise ValueError(f"phi_e fc0 expects (2H+1, H) = ({2 * H + 1}, {H}),"
                         f" got {tuple(f0['w'].shape)}")
    return _EdgeAgg.apply(*leaves, src, dst, edge_mask,
                          compute_dtype or h.dtype, fwd_blocks, bwd_blocks)


egnn_edge_agg.launches = 0
egnn_edge_agg.bf16 = _build.LaunchCount()
