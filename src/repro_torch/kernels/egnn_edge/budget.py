"""Shared-memory budget model for the fused EGNN edge kernel on Hopper.

Replaces ``repro``'s 16 MiB-per-core VMEM model with the Hopper limit: a
block may use at most 227 KB (232,448 bytes) of dynamic shared memory, after
opting in. The GEMMs' tiles are fixed by their launches (``gemm_f32.cuh``'s
8 KB, ``gemm_tc.cuh``'s 98.8 KB), so the edge kernel (``csrc/egnn_edge.cu``,
``egnn_edge_kernel``) is what has to fit:

  * ``acc``     — the (A x block_h) f32 accumulator of one column tile,
    one per edge group;
  * ``deg``     — per-node edge counts, A f32, one per edge group;
  * ``window``  — the staged edge window: block_e x (src, dst int32, d2 f32).

``plan_blocks``/``check_blocks`` budget one group; ``plan_groups`` then adds
edge groups while they fit.

The backward's edge kernel (``csrc/egnn_edge_bwd.cu``) plans on its own
(``bwd=True``). It has no edge groups and no edge window: one CTA of 8
warps per column tile and graph keeps

  * ``lists``   — the graph's E edges compacted by destination and by
    source (8 bytes an edge each), per-warp counts, list offsets and node
    positions (84·A + 8 bytes) and the warps' dw0d shares (1 KB);
  * ``tiles``   — Pi, Pj and dS column tiles, 3 x A x block_h f32, staged
    only when they fit beside the lists (else read from global memory);

and its dpos kernel, one CTA per graph, holds 3·A f32 node sums and a
window of block_e x (three f32 contributions, src, dst) —
``dpos_smem_bytes``. Both kernels must fit, and block_h is at most 256 (a
warp per 32 columns).

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
BWD_THREADS = 256              # the backward edge kernel's block


def smem_items(A: int, block_e: int, block_h: int, groups: int = 1, *,
               bwd: bool = False, E: int | None = None) -> dict:
    """Itemized dynamic shared memory of one edge-kernel CTA (bytes); each
    of the forward's ``groups`` edge groups keeps its own accumulator.
    ``bwd``: the backward's edge kernel, which has no groups and keeps the
    lists of all ``E`` edges of a graph; its column tiles count when they
    fit beside the lists, as the launcher stages them only then."""
    if bwd:
        if E is None:
            raise TypeError("the backward's model needs the graph's E")
        lists = 16 * E + 84 * A + 8 + 4 * BWD_THREADS
        tiles = 12 * A * block_h
        return {"lists": lists,
                "tiles": tiles if lists + tiles <= SMEM_BUDGET else 0}
    return {"acc": 4 * groups * A * block_h,
            "deg": 4 * groups * A,
            "window": 12 * block_e}


def smem_bytes(A: int, block_e: int, block_h: int, groups: int = 1, *,
               bwd: bool = False, E: int | None = None) -> int:
    return sum(smem_items(A, block_e, block_h, groups, bwd=bwd,
                          E=E).values())


def dpos_smem_bytes(A: int, block_e: int) -> int:
    """Dynamic shared memory of the backward's dpos kernel (bytes)."""
    return 12 * A + 20 * block_e


def _fits(A, E, block_e, block_h, bwd, smem_limit) -> bool:
    if smem_bytes(A, block_e, block_h, bwd=bwd, E=E) > smem_limit:
        return False
    return not bwd or dpos_smem_bytes(A, block_e) <= smem_limit


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
                 bwd: bool = False, smem_limit: int = SMEM_BUDGET) -> None:
    """Raise if an explicit (block_e, block_h) cannot launch in the forward
    (or, with ``bwd``, the backward): ``ValueError`` for a malformed tile,
    ``SmemBudgetError`` when over budget."""
    if block_e < 1:
        raise ValueError(f"block_e must be >= 1, got {block_e}")
    top = BWD_THREADS if bwd else MAX_THREADS
    if block_h < 32 or block_h > top or block_h % 32:
        raise ValueError(f"block_h is the CTA's thread count: a multiple of "
                         f"32 in [32, {top}], got {block_h}")
    be = min(block_e, max(E, 1))
    need = smem_bytes(A, be, block_h, bwd=bwd, E=max(E, 1))
    if bwd:
        need = max(need, dpos_smem_bytes(A, be))
    if need > smem_limit:
        try:
            hint = f"plan_blocks suggests " \
                f"{plan_blocks(A, E, H, bwd=bwd, smem_limit=smem_limit)}"
        except SmemBudgetError as e:
            hint = f"no plan fits: {e}"
        raise SmemBudgetError(
            f"egnn_edge {'backward ' if bwd else ''}block override "
            f"(block_e={block_e}, block_h={block_h}) needs {need} bytes of "
            f"shared memory at (A={A}, E={E}, H={H}) — over the "
            f"{smem_limit}-byte budget. Shrink the blocks ({hint}).")


def plan_blocks(A: int, E: int, H: int, *, bwd: bool = False,
                smem_limit: int = SMEM_BUDGET) -> tuple[int, int]:
    """Plan (block_e, block_h): for the forward a window of up to 2048
    edges and a 64-column tile (enough CTAs to cover the SMs at B=8,
    H=866); for the backward a window of up to 512 edges (its dpos
    kernel's) and a 32-column tile (three CTAs an SM at A=64, E=2048).
    Halve the window first, then the tile,
    until the CTA fits. Never returns an over-budget plan; raises
    ``SmemBudgetError`` if even (32, 32) does not fit — the A nodes'
    accumulator (the backward: the graph's edge lists) alone is then too
    large and needs a split this kernel does not have."""
    be = max(_MIN_BLOCK_E, min(512 if bwd else 2048, E))
    bh = 64 if H > 32 and not bwd else _MIN_BLOCK_H
    while not _fits(A, max(E, 1), be, bh, bwd, smem_limit):
        if be > _MIN_BLOCK_E:
            be = max(_MIN_BLOCK_E, be // 2)
        elif bh > _MIN_BLOCK_H:
            bh //= 2
        else:
            what, cut = (("the edge lists", "an edge") if bwd else
                         ("the per-node accumulators", "a node-dimension"))
            raise SmemBudgetError(
                f"no (block_e, block_h) fits (A={A}, E={E}, H={H}) in "
                f"{smem_limit} bytes — {what} alone exceed the budget; this "
                f"shape needs {cut} split.")
    return be, bh
