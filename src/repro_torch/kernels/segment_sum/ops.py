"""Public wrapper for graph segment-sum (batched or single-graph).

CUDA tensors go to the hand-written kernel ``csrc/segment_sum.cu`` (the
port of ``repro``'s Pallas ``segment_sum_batched`` / ``segment_sum_2d``);
CPU tensors take the plain version in ``ref.py``. There is no fallback: a
CUDA tensor the kernel does not take (dtype, shape) raises.

Masked edges are routed to the ``n_nodes`` sentinel, so they contribute
nothing — the ``>= n_nodes`` pad contract shared with ``repro``.
``segment_sum.launches`` counts the launches of batched (B,E,F) calls
(``segment_sum_batched``'s port) and ``segment_sum.two_d.launches`` those of
(E,F) calls (``segment_sum_2d``'s: the embedding's backward,
``models.common.embed``): one per CUDA call, none for an empty output.

The wrapper has no backward, as ``repro``'s Pallas segment-sum has no
``custom_vjp``: a CUDA call on messages that require grad raises instead of
returning a detached result. The trainable paths wrap it:
``models.gnn``'s ``"scatter"`` / ``"pallas"`` aggregation (an autograd
Function whose backward is a gather) and its node gathers' backward (#2
over the edge list), and ``segment_sum_impl="fused"``
(``kernels.egnn_edge``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..egnn_edge.budget import SMEM_BUDGET, SmemBudgetError
from .ref import segment_sum_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SM_COUNT = 132                  # H100 SXM
MAX_THREADS = 256               # the kernel's __launch_bounds__
MIN_LANES = 64                  # column split stops at 64 lanes a CTA
MIN_CTAS_PER_SM = 3             # node blocks grow while this many remain
MAX_GRID_YZ = 65535             # node blocks, graphs
MAX_BLOCK_E = 2048


class Plan(NamedTuple):
    """One launch's geometry. ``block_n`` nodes and ``block_e`` staged dst
    entries a CTA; each thread loads ``vec`` adjacent columns (8 bytes
    where F and the rows' alignment allow), a CTA covers ``lanes`` such
    vector lanes, and ``chunks`` CTAs span the columns."""
    block_n: int
    block_e: int
    vec: int
    lanes: int
    chunks: int

    @property
    def threads(self) -> int:
        return -(-self.lanes // 32) * 32


def vec_width(F: int, itemsize: int, align: int = 8) -> int:
    """Elements a thread loads at once: 8 bytes' worth, halved until F is
    a multiple of it and ``align`` (the bytes every row start is aligned
    to, through the base pointer) holds a vector."""
    v = 8 // itemsize
    while v > 1 and (F % v or align % (v * itemsize)):
        v //= 2
    return v


def smem_bytes(block_n: int, block_e: int, threads: int = MAX_THREADS, *,
               carry: int = 0) -> int:
    """Dynamic shared memory of one CTA (``ss_smem_words`` in
    ``csrc/segment_sum.cu``): the staged dst window and the per-node edge
    list (int32 each, ``block_e``), per-warp node counts, the list offsets
    and, when E spans several windows, ``carry`` f32 partial sums a thread
    and node (the thread's vector width)."""
    return 4 * (2 * block_e + (threads // 32) * block_n + block_n + 1
                + carry * block_n * threads)


def plan(n_nodes: int, E: int, F: int, *, batch: int = 1, itemsize: int = 4,
         align: int = 8, block_n=None, block_e=None,
         smem_limit: int = SMEM_BUDGET) -> Plan:
    """The launch geometry. Every CTA walks the whole dst window, so a CTA
    is made as wide as the columns allow: the fewest column chunks of at
    most 256 lanes, more (down to 64 lanes) only while the grid would
    leave over half of the H100's 132 SMs idle. ``block_n`` defaults to
    one node a CTA, doubled while at least three CTAs an SM remain (the
    walk is then shared by more nodes); ``block_e`` to the whole edge
    list, up to 2048. None of these changes any sum's order. A list
    longer than that window carries ``vec`` f32 partial sums a thread and
    node between windows; when that carry is what does not fit and the
    whole list does in one window, the default window becomes the whole
    list (no carry: the embedding's backward, 8192 ids into 152064 rows).
    Then, until the CTA fits ``smem_limit``: halve a default window, split
    the columns finer, halve a default node block; an explicit block that
    still does not fit raises ``SmemBudgetError``."""
    n, e = max(n_nodes, 1), max(E, 1)
    vec = vec_width(F, itemsize, align)
    nvec = max(1, F // vec)
    chunks = -(-nvec // MAX_THREADS)
    bn_min = -(-n // MAX_GRID_YZ)

    def grid(bn, ch):
        return ch * -(-n // bn) * batch
    if block_n is None:
        bn = bn_min
        while bn < n and grid(2 * bn, chunks) >= MIN_CTAS_PER_SM * SM_COUNT:
            bn *= 2
    else:
        bn = min(block_n, n)
    be = min(block_e if block_e is not None else MAX_BLOCK_E, e)
    while (2 * grid(bn, chunks) < SM_COUNT
           and -(-nvec // (chunks + 1)) >= MIN_LANES):
        chunks += 1
    lanes = -(-nvec // chunks)

    def need(be):
        threads = -(-lanes // 32) * 32
        return smem_bytes(bn, be, threads, carry=vec if E > be else 0)
    if block_e is None and need(be) > smem_limit >= need(e):
        be = e
    while need(be) > smem_limit:
        if block_e is None and be > 32:
            be //= 2
        elif lanes > 32:
            lanes = max(32, lanes // 2)
        elif block_n is None and bn > bn_min:
            bn //= 2
        else:
            hint = ""
            if block_n is not None or block_e is not None:
                auto = autotune_blocks(n_nodes, E, F, batch=batch,
                                       itemsize=itemsize)
                hint = f"; autotune_blocks suggests {auto}"
            raise SmemBudgetError(
                f"segment_sum blocks (block_n={block_n}, block_e={block_e}) "
                f"need {need(be)} bytes of shared memory at (n_nodes="
                f"{n_nodes}, E={E}, F={F}), over the {smem_limit}-byte "
                f"budget{hint}")
    if -(-n // bn) > MAX_GRID_YZ or batch > MAX_GRID_YZ:
        raise ValueError(f"grid too large: B={batch}, node blocks="
                         f"{-(-n // bn)} (max {MAX_GRID_YZ} each)")
    return Plan(bn, be, vec, lanes, -(-nvec // lanes))


def autotune_blocks(n_nodes: int, E: int, F: int, *, batch: int = 1,
                    itemsize: int = 4,
                    smem_limit: int = SMEM_BUDGET) -> tuple[int, int]:
    """(block_n, block_e) of the default ``plan``."""
    p = plan(n_nodes, E, F, batch=batch, itemsize=itemsize,
             smem_limit=smem_limit)
    return p.block_n, p.block_e


def _launch(messages, dst, n_nodes, p: Plan):
    if messages.dtype not in _DTYPES:
        raise TypeError(f"segment_sum CUDA kernel takes float32/bfloat16 "
                        f"messages, got {messages.dtype}")
    if dst.device != messages.device:
        raise ValueError("messages and dst must be on the same device")
    squeeze = messages.dim() == 2
    m = (messages[None] if squeeze else messages).contiguous()
    d = (dst[None] if squeeze else dst).to(torch.int32).contiguous()
    B, E, F = m.shape
    out = torch.empty((B, n_nodes, F), dtype=m.dtype, device=m.device)
    if out.numel() == 0:                       # no graph, node or column
        return out[0] if squeeze else out
    ptr = m.data_ptr()
    if ptr % (p.vec * m.element_size()):       # a view off its allocation
        p = plan(n_nodes, E, F, batch=B, itemsize=m.element_size(),
                 align=ptr & -ptr, block_n=p.block_n, block_e=p.block_e)
    lib = _lib()
    code = lib.segment_sum_launch(ptr, d.data_ptr(), out.data_ptr(), B, E, F,
                                  n_nodes, p.block_n, p.block_e, p.lanes,
                                  p.chunks, p.vec, _DTYPES[m.dtype],
                                  _build.stream_ptr(m))
    _build.check(lib, code, "segment_sum_launch")
    _build.count_launch(segment_sum.two_d if squeeze else segment_sum)
    return out[0] if squeeze else out


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.segment_sum_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def segment_sum(messages, dst, n_nodes: int, *, edge_mask=None,
                block_n=None, block_e=None):
    """messages: (B,E,F) or (E,F); dst: (B,E) or (E,) -> (B,n_nodes,F) or
    (n_nodes,F). ``block_n``/``block_e`` default to ``plan``'s; explicit
    values (the ``kernel_block_*`` config knobs) override and are checked
    against the shared-memory budget on every device."""
    if messages.dim() not in (2, 3):
        raise ValueError(f"messages must be (E,F) or (B,E,F), got "
                         f"ndim={messages.dim()}")
    if (block_n is not None and block_n < 1) or \
            (block_e is not None and block_e < 1):
        raise ValueError(f"block sizes must be >= 1, got block_n={block_n}, "
                         f"block_e={block_e}")
    E, F = messages.shape[-2], messages.shape[-1]
    batch = messages.shape[0] if messages.dim() == 3 else 1
    p = plan(n_nodes, E, F, batch=batch, itemsize=messages.element_size(),
             block_n=block_n, block_e=block_e)
    if edge_mask is not None:
        dst = torch.where(edge_mask, dst, torch.full_like(dst, n_nodes))
    if messages.device.type == "cpu":
        return segment_sum_ref(messages, dst, n_nodes)
    if torch.is_grad_enabled() and messages.requires_grad:
        raise RuntimeError(
            "the segment_sum CUDA kernel has no backward (nor has repro's "
            "Pallas segment-sum); train with segment_sum_impl=\"fused\" "
            "(the fused edge kernels carry gradients) or \"jnp\"")
    return _launch(messages, dst, n_nodes, p)


segment_sum.launches = 0
segment_sum.two_d = _build.LaunchCount()
