"""Shared-memory budget model for the fused EGNN edge kernel on Hopper.

Replaces ``repro``'s 16 MiB-per-core VMEM model with the Hopper limit: a
block may use at most 227 KB (232,448 bytes) of dynamic shared memory, after
opting in. The GEMM kernels use a fixed 8 KB static tile, so the edge kernel
(``csrc/egnn_edge.cu``, ``egnn_edge_kernel``) is what has to fit:

  * ``acc``     — the (A x block_h) f32 accumulator of one column tile,
    one per edge group;
  * ``deg``     — per-node edge counts, A f32, one per edge group;
  * ``window``  — the staged edge window: block_e x (src, dst int32, d2 f32).

``plan_blocks``/``check_blocks`` budget one group; ``plan_groups`` then adds
edge groups while they fit.

The contract is ``repro``'s: ``plan_blocks`` never returns an over-budget
``(block_e, block_h)``, and ``check_blocks`` raises ``SmemBudgetError`` on an
explicit override that does not fit, instead of letting the launch fail.
``block_h`` is also the thread count of one edge group, so it is a multiple
of 32 up to 512 (the kernel's ``__launch_bounds__``).
"""
from __future__ import annotations

SMEM_PER_BLOCK = 232_448       # H100: max dynamic shared memory per block
SMEM_HEADROOM = 1 << 10        # static shared memory + slack
SMEM_BUDGET = SMEM_PER_BLOCK - SMEM_HEADROOM

_MIN_BLOCK_E = 32
_MIN_BLOCK_H = 32


class SmemBudgetError(ValueError):
    """An explicit block override exceeds the shared-memory budget."""


MAX_GROUPS = 8                 # edge groups per CTA (blockDim.y)
MAX_THREADS = 512              # the edge kernel's __launch_bounds__


def smem_items(A: int, block_e: int, block_h: int, groups: int = 1) -> dict:
    """Itemized dynamic shared memory of one edge-kernel CTA (bytes); each
    of the ``groups`` edge groups keeps its own accumulator and counts."""
    return {"acc": 4 * groups * A * block_h,
            "deg": 4 * groups * A,
            "window": 12 * block_e}


def smem_bytes(A: int, block_e: int, block_h: int, groups: int = 1) -> int:
    return sum(smem_items(A, block_e, block_h, groups).values())


def plan_groups(A: int, block_e: int, block_h: int, *,
                smem_limit: int = SMEM_BUDGET) -> int:
    """Edge groups per CTA for a planned (block_e, block_h): the most (up
    to 8, at most 512 threads) whose partials fit — more edges walked in
    parallel per SM. One group always fits a plan ``check_blocks`` passed.
    The result sets the summation order, so it depends on the tiling
    alone, never on the data."""
    g = MAX_GROUPS
    while g > 1 and (g * block_h > MAX_THREADS or
                     smem_bytes(A, block_e, block_h, g) > smem_limit):
        g //= 2
    return g


def check_blocks(A: int, E: int, H: int, block_e: int, block_h: int, *,
                 smem_limit: int = SMEM_BUDGET) -> None:
    """Raise if an explicit (block_e, block_h) cannot launch: ``ValueError``
    for a malformed tile, ``SmemBudgetError`` when over budget."""
    if block_e < 1:
        raise ValueError(f"block_e must be >= 1, got {block_e}")
    if block_h < 32 or block_h > MAX_THREADS or block_h % 32:
        raise ValueError(f"block_h is the CTA's thread count: a multiple of "
                         f"32 in [32, {MAX_THREADS}], got {block_h}")
    need = smem_bytes(A, min(block_e, max(E, 1)), block_h)
    if need > smem_limit:
        raise SmemBudgetError(
            f"egnn_edge block override (block_e={block_e}, block_h={block_h})"
            f" needs {need} bytes of shared memory at (A={A}, E={E}, H={H}) "
            f"— over the {smem_limit}-byte budget. Shrink the blocks "
            f"(plan_blocks suggests {plan_blocks(A, E, H, smem_limit=smem_limit)}).")


def plan_blocks(A: int, E: int, H: int, *,
                smem_limit: int = SMEM_BUDGET) -> tuple[int, int]:
    """Plan (block_e, block_h): a window of up to 2048 edges and a 64-column
    tile (enough CTAs to cover the SMs at B=8, H=866), halving the window
    first, then the tile, until the CTA fits. Never returns an over-budget
    plan; raises ``SmemBudgetError`` if even (32, 32) does not fit — the A
    nodes' accumulator alone is then too large and needs a node split this
    kernel does not have."""
    be = max(_MIN_BLOCK_E, min(2048, E))
    bh = 64 if H > 32 else _MIN_BLOCK_H
    while smem_bytes(A, be, bh) > smem_limit:
        if be > _MIN_BLOCK_E:
            be = max(_MIN_BLOCK_E, be // 2)
        elif bh > _MIN_BLOCK_H:
            bh //= 2
        else:
            raise SmemBudgetError(
                f"no (block_e, block_h) fits (A={A}, E={E}, H={H}) in "
                f"{smem_limit} bytes — the A x 32 accumulator alone exceeds "
                f"the budget; this shape needs a node-dimension split.")
    return be, bh
