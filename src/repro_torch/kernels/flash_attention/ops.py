"""Public wrapper for causal / sliding-window GQA flash attention (prefill).

CUDA tensors go to the hand-written kernels of ``csrc/flash_attention.cu``
(the port of ``repro``'s Pallas ``flash_attention_bhsd``: bf16 on the tensor
cores, f32 in FFMA); CPU tensors take the plain version in ``ref.py``. There
is no fallback: a CUDA call the kernels do not take (dtype, head dim,
layout) raises.
``flash_attention.launches`` counts kernel launches (one per CUDA call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 160, 192, 256)   # instantiated
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_rows(name: str, t: torch.Tensor):
    """The kernels read each (position, head) row of D values with 16-byte
    loads: the last axis must be contiguous and every row 16-byte aligned."""
    item = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (st * item) % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name}: rows must be contiguous in D and 16-byte "
                         f"aligned (strides {tuple(t.stride())}, itemsize "
                         f"{item}); pass .contiguous()")


def _launch(q, k, v, q_pos, k_pos, causal, window, scale):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention CUDA kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention CUDA kernel: head dim {D} not "
                         f"in {HEAD_DIMS}")
    if H > 65535 or B > 65535 or -(-Sq // 64) > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}, Sq={Sq} (max "
                         f"65535 each, and 65535 query tiles of 64)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    kp = k_pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(causal), int(window), _DTYPES[q.dtype],
        _build.stream_ptr(q))
    _build.check(lib, code, "flash_attention_launch")
    _build.count_launch(flash_attention)
    return out


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                    scale=None):
    """q: (B,Sq,H,D); k,v: (B,Sk,K,D), H % K == 0; q_pos (Sq,), k_pos (Sk,)
    integer positions -> (B,Sq,H,D) in q's dtype. Keys at ``k_pos <= -1e8``
    are pads; ``window > 0`` keeps ``q_pos - k_pos < window``. The CUDA
    kernels' tiles are fixed (64 keys; 64 query rows for bf16 on the tensor
    cores, 128 for f32; at D = 256 a CTA computes half the output columns)
    and mask the ragged edge themselves, so ``repro``'s
    ``block_q``/``block_k`` knobs have no counterpart."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,H,D) and k, v one (B,Sk,K,D) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % K == 0)")
    if q_pos.shape != (Sq,) or k_pos.shape != (k.shape[1],):
        raise ValueError(f"q_pos must be ({Sq},) and k_pos "
                         f"({k.shape[1]},), got {tuple(q_pos.shape)}, "
                         f"{tuple(k_pos.shape)}")
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, scale=scale)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    return _launch(q, k, v, q_pos, k_pos, causal, window, scale)


flash_attention.launches = 0
