"""Public wrapper for flash-decode: one query token per sequence against a
(B, S, K, D) KV cache, split over S, then an exact combine.

CUDA tensors go to the hand-written kernels ``csrc/flash_decode.cu`` (the
port of ``repro``'s Pallas ``flash_decode_partials`` and its
``combine_partials``); CPU tensors take the plain versions in ``ref.py``
with the same split plan. There is no fallback: a CUDA call the kernel does
not take (dtype, head dim, layout, query heads per kv head) raises. ``flash_decode.launches`` counts calls that launch the kernels (one
per CUDA call: the partials kernel and its combine).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..flash_attention.ops import HEAD_DIMS, check_rows
from .ref import combine_partials, decode_partials_ref

TILE = 128                      # keys per CTA round (4 warps x 32 keys)
GROUPS = (1, 2, 4, 8, 16)       # query heads per kv head, instantiated
SM_COUNT = 132                  # H100 SXM
CTAS_PER_SM = 4                 # the split plan's target occupancy
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plan_splits(B: int, K: int, S: int, n_splits=None,
                block_k=None) -> tuple[int, int]:
    """(n_splits, per_split) for a cache of length S.

    Split boundaries fall on multiples of ``block_k`` (default: the
    kernel's 128-key round, 32 keys for each of its 4 warps): ``per_split = ceil(S / (n_splits·block_k))·
    block_k``, ``repro``'s formula. An explicit ``n_splits`` is kept as
    given, so trailing splits may be empty (their partials weigh 0 in the
    combine). The default plan gives the card's 132 SMs four CTAs each
    across the B·K (batch, kv head) pairs, never more splits than tiles,
    and drops the empty ones."""
    bk = block_k or TILE
    if bk < 1 or (n_splits is not None and n_splits < 1):
        raise ValueError(f"n_splits and block_k must be >= 1, got "
                         f"{n_splits}, {block_k}")
    tiles = max(1, -(-S // bk))
    auto = n_splits is None
    if auto:
        n_splits = min(tiles, max(1, -(-CTAS_PER_SM * SM_COUNT // (B * K))))
    per_split = max(1, -(-S // (n_splits * bk)) * bk)
    if auto:
        n_splits = max(1, -(-S // per_split))
    return n_splits, per_split


def _lib():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, q_pos, k_pos, window, scale, n_splits, per_split):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode CUDA kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode CUDA kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if H // K not in GROUPS:
        raise ValueError(f"flash_decode CUDA kernel: {H // K} query heads "
                         f"per kv head, not in {GROUPS}")
    if K > 65535 or B > 65535 or n_splits > 2 ** 31 - 1:
        raise ValueError(f"grid too large: B={B}, K={K}, n_splits={n_splits}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    if k_pos.stride(-1) != 1:
        raise ValueError("k_pos must be contiguous along its last axis")
    dev = q.device
    m = torch.empty((B, K, H // K, n_splits), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((B, K, H // K, n_splits, D), dtype=torch.float32,
                      device=dev)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    lib = _lib()
    code = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        out.data_ptr(), B, S, H, K, D, n_splits, per_split,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), k_pos.stride(0),
        q_pos.stride(0), float(scale), int(window), _DTYPES[q.dtype],
        _build.stream_ptr(q))
    _build.check(lib, code, "flash_decode_launch")
    flash_decode.launches += 1
    return out


def flash_decode(q, k, v, *, q_pos, k_pos, window=0, scale=None,
                 n_splits=None, block_k=None):
    """q: (B,1,H,D); k,v: (B,S,K,D); q_pos: (B,) or a scalar; k_pos: (B,S)
    or (S,) integer positions -> (B,1,H,D) in q's dtype.

    ``n_splits``/``block_k`` keep ``repro``'s meaning: the cache is cut
    into ``n_splits`` slices whose boundaries fall on multiples of
    ``block_k`` (``plan_splits``); None lets the port plan for the H100
    (four CTAs per SM over the (batch, kv head) pairs, 128-key granule).
    The CUDA kernel gives each (split, kv head, batch) one CTA whose 4 warps
    take 32-key chunks of its slice in turn, whatever ``block_k`` is (a
    slice need not be a multiple of 32: the tail chunk is masked). The CPU path computes
    the same splits' partials with the plain version and combines them the
    same way, so both paths and every call give one result per plan."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,1,H,D) and k, v one (B,S,K,D) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % K:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % K == 0)")
    dev = q.device
    q_pos = torch.as_tensor(q_pos, device=dev).reshape(-1)
    q_pos = q_pos.to(torch.int32).expand(B)
    k_pos = torch.as_tensor(k_pos, device=dev).to(torch.int32)
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    if k_pos.shape[-1] != S or k_pos.shape[0] not in (1, B):
        raise ValueError(f"k_pos must be ({S},) or ({B},{S}), got "
                         f"{tuple(k_pos.shape)}")
    k_pos = k_pos.expand(B, S)
    scale = scale if scale is not None else D ** -0.5
    n_splits, per_split = plan_splits(B, K, S, n_splits, block_k)
    if dev.type == "cpu":
        m, l, acc = decode_partials_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                        n_splits=n_splits,
                                        per_split=per_split, window=window,
                                        scale=scale)
        return combine_partials(m, l, acc).reshape(B, 1, H, D).to(q.dtype)
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    return _launch(q, k, v, q_pos, k_pos, window, scale, n_splits, per_split)


flash_decode.launches = 0
