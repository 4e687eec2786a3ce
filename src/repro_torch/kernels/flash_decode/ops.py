"""Public wrapper for flash-decode: one query token per sequence against a
(B, S, K, D) KV cache, split over S, then an exact combine.

CUDA tensors go to the hand-written kernel ``csrc/flash_decode.cu`` (the
port of ``repro``'s Pallas ``flash_decode_partials`` and its
``combine_partials`` in one launch); CPU tensors take the plain versions
in ``ref.py`` with the same planner's splits (``plan_splits``). There is
no fallback: a CUDA call
the kernel does not take (dtype, head dim, layout, query heads per kv
head, a cluster the card cannot place) raises. ``flash_decode.launches``
counts calls that launch the kernel (one launch per CUDA call).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..flash_attention.ops import check_rows
from .ref import combine_partials, decode_partials_ref

# The (head dim, query heads per kv head) pairs instantiated in the
# kernel: head dims up to 128 at every group (7: internvl2-1b, 14 over 2),
# 160 (stablelm-12b, G=4) and 256 (gemma3-12b, G=2) at the groups of the
# ported configs only (csrc/flash_decode.cu's dispatch)
INSTANCES = frozenset(
    [(d, g) for d in (16, 32, 64, 80, 96, 128)
     for g in (1, 2, 3, 4, 7, 8, 16)]
    + [(d, g) for d in (160, 256) for g in (1, 2, 4, 8)])
MAX_CLUSTER = 16                # CTAs a (batch, kv head)
STAGES = (16, 12, 8, 4, 2)      # ring depths of 32 keys, deepest first; a
                                # ring is a multiple of the kernel's 2, 4 or
                                # 8 consumer warps (a warp waits on a
                                # stage's next use only once its last use
                                # has landed), the launcher refuses others
GRANULE = 8                     # the default plan's split boundaries
MIN_SPLIT = 128                 # the default plan's shortest split
SM_COUNT = 132                  # H100 SXM: the SMs the CPU plans for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How a call is cut: ``n_splits`` partials of ``per_split`` keys;
    ``cluster`` CTAs a (batch, kv head), each taking ``splits_per_cta``
    consecutive splits; a ring of ``stages`` stages of 32 keys a CTA."""
    n_splits: int
    per_split: int
    cluster: int
    splits_per_cta: int
    stages: int


def _no_limit(cluster: int, stages: int, spc: int) -> float:
    return float("inf")


def plan_splits(B: int, K: int, S: int, n_splits=None, block_k=None, *,
                clusters=None, sm_count: int = SM_COUNT) -> Plan:
    """The plan of a call on a (B, S, K, D) cache. ``clusters(cluster,
    stages, spc)`` gives the clusters of ``cluster`` CTAs (a ring of
    ``stages``, ``spc`` splits a CTA) that one wave of the card holds: on
    CUDA the card's own ``cudaOccupancyMaxActiveClusters``; None (the CPU,
    which has no waves) sets no limit. ``sm_count`` is the card's SMs.

    Split boundaries fall on multiples of ``block_k`` (default 8 keys):
    ``per_split = ceil(S / (n_splits·block_k))·block_k``, ``repro``'s
    formula. An explicit ``n_splits`` is kept as given, so trailing splits
    may be empty (their partials weigh 0 in the combine); a cluster of C
    <= 16 CTAs then takes ``ceil(n_splits / C)`` splits a CTA, C and the
    ring chosen for the fewest waves, then the fewest splits a CTA, then
    the deepest ring (which CTA computes a split changes no bit of the
    result). The default plan takes one split a CTA and, among the
    clusters (at most 16 CTAs, splits of at least 128 keys) and rings with
    which all B·K clusters fit in one wave, the one that puts the fewest
    keys on the busiest SM (CTAs spread evenly over the SMs; an SM streams
    at a bounded rate, so that sets the time), then the smallest cluster,
    then the deepest ring; it drops empty splits. Where nothing fits one
    wave, one CTA a (batch, kv head). The splits depend on the occupancy
    only where it rules a cluster out: at the LM decode shapes the CPU
    takes the card's splits (a GPU test holds the two)."""
    bk = block_k or GRANULE
    if bk < 1 or (n_splits is not None and n_splits < 1):
        raise ValueError(f"n_splits and block_k must be >= 1, got "
                         f"{n_splits}, {block_k}")
    fits = clusters or _no_limit
    pairs = B * K
    if n_splits is not None:
        per_split = max(1, -(-S // (n_splits * bk)) * bk)
        options = []         # (waves, splits a CTA, -ring depth)
        for spc in {-(-n_splits // c)
                    for c in range(1, min(MAX_CLUSTER, n_splits) + 1)}:
            for st in STAGES:
                per_wave = fits(-(-n_splits // spc), st, spc)
                if per_wave >= 1:
                    options.append((-(-pairs // per_wave), spc, -st))
        if not options:
            raise ValueError(f"flash_decode: {n_splits} splits need more "
                             f"shared memory than a CTA has")
        _, spc, st = min(options)
        return Plan(n_splits, per_split, -(-n_splits // spc), spc, -st)

    def busiest_sm(choice):
        c, st = choice
        keys = -(-S // (c * bk)) * bk
        return -(-pairs * c // sm_count) * keys, c, -st
    widest = max(1, min(MAX_CLUSTER, S // MIN_SPLIT))
    one_wave = [(c, st) for st in STAGES for c in range(1, widest + 1)
                if fits(c, st, 1) >= pairs]
    if one_wave:
        cluster, stages = min(one_wave, key=busiest_sm)
    else:
        stages = next((st for st in STAGES if fits(1, st, 1) >= 1), None)
        if stages is None:
            raise ValueError("flash_decode: no ring fits a CTA's shared "
                             "memory")
        cluster = 1
    per_split = max(1, -(-S // (cluster * bk)) * bk)
    n = max(1, -(-S // per_split))
    return Plan(n, per_split, n, 1, stages)


def _lib():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.flash_decode_max_active_clusters
        occ.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_active_clusters(device: int, dtype: torch.dtype, G: int, D: int,
                        cluster: int, stages: int, spc: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel's (dtype, G, D)
    instantiation with this cluster, ring and splits a CTA, on CUDA device
    ``device`` (0: it cannot place one such cluster)."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.flash_decode_max_active_clusters(
            _DTYPES[dtype], G, D, cluster, stages, spc, ctypes.byref(n))
    _build.check(lib, code, "flash_decode_max_active_clusters")
    return n.value


def plan_call(q, k, n_splits=None, block_k=None) -> Plan:
    """The plan ``flash_decode`` takes for q (B,1,H,D) and k (B,S,K,D): on
    a CUDA tensor from the kernel's occupancy and the SMs of that card
    (kept per device, dtype and shape: a decode step asks again each
    layer), on the CPU with no occupancy limit."""
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if q.is_cuda and q.dtype in _DTYPES and (D, H // K) in INSTANCES:
        return _card_plan(q.device.index, q.dtype, B, K, S, H // K, D,
                          n_splits, block_k)
    return plan_splits(B, K, S, n_splits, block_k)


@functools.lru_cache(maxsize=4096)
def _card_plan(device: int, dtype: torch.dtype, B: int, K: int, S: int,
               G: int, D: int, n_splits, block_k) -> Plan:
    return plan_splits(
        B, K, S, n_splits, block_k,
        clusters=functools.partial(max_active_clusters, device, dtype, G, D),
        sm_count=torch.cuda.get_device_properties(device)
        .multi_processor_count)


def _launch(q, k, v, q_pos, k_pos, window, scale, plan: Plan):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode CUDA kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if (D, H // K) not in INSTANCES:
        raise ValueError(
            f"flash_decode CUDA kernel: head dim {D} at {H // K} query "
            f"heads per kv head is not instantiated (INSTANCES: "
            f"{sorted(INSTANCES)})")
    if K > 65535 or B > 65535 or plan.n_splits * plan.per_split >= 2 ** 31:
        raise ValueError(f"grid too large: B={B}, K={K}, {plan}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    if k_pos.stride(-1) != 1:
        raise ValueError("k_pos must be contiguous along its last axis")
    if max_active_clusters(q.device.index, q.dtype, H // K, D, plan.cluster,
                           plan.stages, plan.splits_per_cta) < 1:
        raise ValueError(f"flash_decode CUDA kernel: the card cannot place "
                         f"a cluster of {plan}")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    code = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), B, S, H, K, D, plan.n_splits,
        plan.per_split, plan.cluster, plan.stages,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), k_pos.stride(0),
        q_pos.stride(0), float(scale), int(window), _DTYPES[q.dtype],
        _build.stream_ptr(q))
    _build.check(lib, code, "flash_decode_launch")
    _build.count_launch(flash_decode)
    return out


def flash_decode(q, k, v, *, q_pos, k_pos, window=0, scale=None,
                 n_splits=None, block_k=None):
    """q: (B,1,H,D); k,v: (B,S,K,D); q_pos: (B,) or a scalar; k_pos: (B,S)
    or (S,) integer positions -> (B,1,H,D) in q's dtype.

    ``n_splits``/``block_k`` keep ``repro``'s meaning: the cache is cut
    into ``n_splits`` slices whose boundaries fall on multiples of
    ``block_k`` (``plan_splits``); None lets the port plan for the card
    (one wave, up to 16 CTAs a (batch, kv head)). The CUDA kernel gives each
    (batch, kv head) one cluster whose CTAs take consecutive slices, 32 keys
    a stage, and combine the slices' partials in slice order, whatever
    ``block_k`` is. The CPU path computes the same slices' partials with
    the plain version and combines them the same way, so both paths and
    every call give one result per plan."""
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
    plan = plan_call(q, k, n_splits, block_k)
    if dev.type == "cpu":
        m, l, acc = decode_partials_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                        n_splits=plan.n_splits,
                                        per_split=plan.per_split,
                                        window=window, scale=scale)
        return combine_partials(m, l, acc).reshape(B, 1, H, D).to(q.dtype)
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    return _launch(q, k, v, q_pos, k_pos, window, scale, plan)


flash_decode.launches = 0
