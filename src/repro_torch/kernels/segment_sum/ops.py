"""Public wrapper for graph segment-sum (batched or single-graph).

CUDA tensors go to the hand-written kernel ``csrc/segment_sum.cu`` (the
port of ``repro``'s Pallas ``segment_sum_batched`` / ``segment_sum_2d``);
CPU tensors take the plain version in ``ref.py``. There is no fallback: a
CUDA tensor the kernel does not take (dtype, shape) raises.

Masked edges are routed to the ``n_nodes`` sentinel, so they contribute
nothing — the ``>= n_nodes`` pad contract shared with ``repro``.
``segment_sum.launches`` counts kernel launches (one per CUDA call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..egnn_edge.budget import SMEM_BUDGET, SmemBudgetError
from .ref import segment_sum_ref

COLS = 128                      # column tile == threads per edge group
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


MAX_GROUPS = 8                  # edge groups per CTA (blockDim.y)
SM_COUNT = 132                  # H100 SXM


def smem_bytes(block_n: int, block_e: int, groups: int = 1) -> int:
    """Dynamic shared memory of one CTA: one (block_n x 128) f32 node
    accumulator per edge group plus the staged int32 dst window."""
    return 4 * groups * block_n * COLS + 4 * block_e


def edge_groups(block_n: int, block_e: int, *,
                smem_limit: int = SMEM_BUDGET) -> int:
    """Edge groups per CTA: the most (up to 8) whose partial accumulators
    fit the budget — more loads in flight per SM. The result changes the
    summation order, so it depends on the tiling alone, never on the data."""
    g = MAX_GROUPS
    while g > 1 and smem_bytes(block_n, block_e, g) > smem_limit:
        g //= 2
    return g


def autotune_blocks(n_nodes: int, E: int, F: int, *, batch: int = 1,
                    smem_limit: int = SMEM_BUDGET) -> tuple[int, int]:
    """(block_n, block_e): the dst window up to 2048 edges, and node blocks
    halved from 128 rows until the grid (128-column tiles x node blocks x
    ``batch`` graphs) has a CTA for every one of the H100's 132 SMs, or
    the block reaches 8 rows. Each CTA loads only the messages of its own
    nodes, so more node blocks add CTAs without re-reading messages. Then
    halve the window, then the node block, until one group fits."""
    bn = max(1, min(128, n_nodes))
    be = max(1, min(2048, E))
    col_tiles = -(-F // COLS)
    while bn > 8 and col_tiles * -(-n_nodes // bn) * batch < SM_COUNT:
        bn //= 2
    while smem_bytes(bn, be) > smem_limit and be > 32:
        be //= 2
    while smem_bytes(bn, be) > smem_limit and bn > 1:
        bn //= 2
    return bn, be


def _launch(messages, dst, n_nodes, block_n, block_e):
    if messages.dtype not in _DTYPES:
        raise TypeError(f"segment_sum CUDA kernel takes float32/bfloat16 "
                        f"messages, got {messages.dtype}")
    if dst.device != messages.device:
        raise ValueError("messages and dst must be on the same device")
    squeeze = messages.dim() == 2
    m = (messages[None] if squeeze else messages).contiguous()
    d = (dst[None] if squeeze else dst).to(torch.int32).contiguous()
    B, E, F = m.shape
    if B > 65535 or -(-n_nodes // block_n) > 65535:
        raise ValueError(f"grid too large: B={B}, node blocks="
                         f"{-(-n_nodes // block_n)} (max 65535 each)")
    out = torch.empty((B, n_nodes, F), dtype=m.dtype, device=m.device)
    lib = _lib()
    code = lib.segment_sum_launch(m.data_ptr(), d.data_ptr(), out.data_ptr(),
                                  B, E, F, n_nodes, block_n, block_e,
                                  edge_groups(block_n, block_e),
                                  _DTYPES[m.dtype], _build.stream_ptr(m))
    _build.check(lib, code, "segment_sum_launch")
    segment_sum.launches += 1
    return out[0] if squeeze else out


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.segment_sum_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def segment_sum(messages, dst, n_nodes: int, *, edge_mask=None,
                block_n=None, block_e=None):
    """messages: (B,E,F) or (E,F); dst: (B,E) or (E,) -> (B,n_nodes,F) or
    (n_nodes,F). ``block_n``/``block_e`` default to ``autotune_blocks``;
    explicit values (the ``kernel_block_*`` config knobs) override and are
    checked against the shared-memory budget."""
    if messages.dim() not in (2, 3):
        raise ValueError(f"messages must be (E,F) or (B,E,F), got "
                         f"ndim={messages.dim()}")
    E, F = messages.shape[-2], messages.shape[-1]
    batch = messages.shape[0] if messages.dim() == 3 else 1
    auto_n, auto_e = autotune_blocks(n_nodes, E, F, batch=batch)
    block_n = block_n if block_n is not None else auto_n
    block_e = block_e if block_e is not None else auto_e
    if block_n < 1 or block_e < 1:
        raise ValueError(f"block sizes must be >= 1, got block_n={block_n}, "
                         f"block_e={block_e}")
    block_n, block_e = min(block_n, max(n_nodes, 1)), min(block_e, max(E, 1))
    need = smem_bytes(block_n, block_e)
    if need > SMEM_BUDGET:
        raise SmemBudgetError(
            f"segment_sum blocks (block_n={block_n}, block_e={block_e}) need "
            f"{need} bytes of shared memory, over the {SMEM_BUDGET}-byte "
            f"budget; autotune_blocks suggests {auto_n, auto_e}")
    if edge_mask is not None:
        dst = torch.where(edge_mask, dst, torch.full_like(dst, n_nodes))
    if messages.device.type == "cpu":
        return segment_sum_ref(messages, dst, n_nodes)
    return _launch(messages, dst, n_nodes, block_n, block_e)


segment_sum.launches = 0
