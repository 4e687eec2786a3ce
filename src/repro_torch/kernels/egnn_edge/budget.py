"""Shared-memory budget model for the fused EGNN edge kernel on Hopper.

Replaces ``repro``'s 16 MiB-per-core VMEM model with the Hopper limit: a
block may use at most 227 KB (232,448 bytes) of dynamic shared memory, after
opting in. The GEMMs' tiles are fixed by their launches (``gemm_tc.cuh``'s
197.6 KB, one CTA an SM), so the edge kernels are what has to fit. Both
are one CTA of 8 warps per (column tile of block_h, graph), a warp per 32
columns, so block_h is a multiple of 32 up to 256.

The forward's edge kernel (``csrc/egnn_edge.cu``, ``egnn_edge_fwd_kernel``)
walks a graph's edges in windows of block_e (one window when the whole
list fits) and keeps

  * ``lists``   — one window's edges compacted by destination, 8 bytes an
    edge (src, d²);
  * ``nodes``   — per-warp counts, list offsets and node positions,
    48·A + 4 bytes;
  * ``tiles``   — the Pi and Pj column tiles, 2 x A x block_h f32, staged
    only when they fit beside the rest (else read from global memory).

The backward's edge kernel (``csrc/egnn_edge_bwd.cu``) plans on its own
(``bwd=True``). It has no edge window: one CTA per column tile and graph
keeps

  * ``lists``   — the graph's E edges compacted by destination and by
    source (8 bytes an edge each), per-warp counts, list offsets and node
    positions (84·A + 8 bytes) and the warps' dw0d shares (1 KB);
  * ``tiles``   — Pi, Pj and dS column tiles, 3 x A x block_h f32, staged
    only when they fit beside the lists (else read from global memory);

and its dpos kernel, one CTA per graph, holds 3·A f32 node sums and a
window of block_e x (three f32 contributions, src, dst) —
``dpos_smem_bytes``. Both kernels must fit.

The contract is ``repro``'s: ``plan_blocks`` never returns an over-budget
``(block_e, block_h)``, and ``check_blocks`` raises ``SmemBudgetError`` on an
explicit override that does not fit, instead of letting the launch fail.
Neither direction's sums depend on the blocks' sizes (but the backward's
dw0d, summed per warp), so a plan is free to pick them for speed.
"""
from __future__ import annotations

SMEM_PER_BLOCK = 232_448       # H100: max dynamic shared memory per block
SMEM_HEADROOM = 1 << 10        # static shared memory + slack
SMEM_BUDGET = SMEM_PER_BLOCK - SMEM_HEADROOM

_MIN_BLOCK_E = 32
_MIN_BLOCK_H = 32


class SmemBudgetError(ValueError):
    """An explicit block override exceeds the shared-memory budget."""


THREADS = 256                  # either edge kernel's block
FWD_BLOCK_H = 32               # the forward's planned column tile


def smem_items(A: int, block_e: int, block_h: int, *, bwd: bool = False,
               E: int | None = None) -> dict:
    """Itemized dynamic shared memory of one edge-kernel CTA (bytes). The
    forward keeps a window of ``block_e`` listed edges; ``bwd``: the
    backward's edge kernel keeps the lists of all ``E`` edges of a graph.
    Either's column tiles count when they fit beside the rest, as the
    launcher stages them only then."""
    if bwd:
        if E is None:
            raise TypeError("the backward's model needs the graph's E")
        lists = 16 * E + 84 * A + 8 + 4 * THREADS
        tiles = 12 * A * block_h
        return {"lists": lists,
                "tiles": tiles if lists + tiles <= SMEM_BUDGET else 0}
    core = {"lists": 8 * block_e, "nodes": 48 * A + 4}
    tiles = 8 * A * block_h
    return {**core,
            "tiles": tiles if sum(core.values()) + tiles <= SMEM_BUDGET
            else 0}


def smem_bytes(A: int, block_e: int, block_h: int, *, bwd: bool = False,
               E: int | None = None) -> int:
    return sum(smem_items(A, block_e, block_h, bwd=bwd, E=E).values())


def dpos_smem_bytes(A: int, block_e: int) -> int:
    """Dynamic shared memory of the backward's dpos kernel (bytes)."""
    return 12 * A + 20 * block_e


def _fits(A, E, block_e, block_h, bwd, smem_limit) -> bool:
    if smem_bytes(A, block_e, block_h, bwd=bwd, E=E) > smem_limit:
        return False
    return not bwd or dpos_smem_bytes(A, block_e) <= smem_limit


def check_blocks(A: int, E: int, H: int, block_e: int, block_h: int, *,
                 bwd: bool = False, smem_limit: int = SMEM_BUDGET) -> None:
    """Raise if an explicit (block_e, block_h) cannot launch in the forward
    (or, with ``bwd``, the backward): ``ValueError`` for a malformed tile,
    ``SmemBudgetError`` when over budget."""
    if block_e < 1:
        raise ValueError(f"block_e must be >= 1, got {block_e}")
    if block_h < 32 or block_h > THREADS or block_h % 32:
        raise ValueError(f"block_h is the CTA's column tile, a warp per 32 "
                         f"columns: a multiple of 32 in [32, {THREADS}], "
                         f"got {block_h}")
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
    """Plan (block_e, block_h): for the forward a window of the graph's
    whole edge list and a ``FWD_BLOCK_H``-column tile, narrowed until its
    tiles are staged; for the backward a window of up to 512 edges (its
    dpos kernel's) and a 32-column tile (three CTAs an SM at A=64,
    E=2048). Halve the window first, then the tile, until the CTA fits.
    Never returns an over-budget plan; raises
    ``SmemBudgetError`` if even (32, 32) does not fit — the A nodes' counts
    (the backward: the graph's edge lists) alone are then too large and
    need a split this kernel does not have."""
    be = max(_MIN_BLOCK_E, min(512, E) if bwd else E)
    bh = FWD_BLOCK_H if H > 32 and not bwd else _MIN_BLOCK_H
    while not _fits(A, max(E, 1), be, bh, bwd, smem_limit):
        if be > _MIN_BLOCK_E:
            be = max(_MIN_BLOCK_E, be // 2)
        elif bh > _MIN_BLOCK_H:
            bh //= 2
        else:
            what, cut = (("the edge lists", "an edge") if bwd else
                         ("the per-node counts", "a node-dimension"))
            raise SmemBudgetError(
                f"no (block_e, block_h) fits (A={A}, E={E}, H={H}) in "
                f"{smem_limit} bytes — {what} alone exceed the budget; this "
                f"shape needs {cut} split.")
    # the forward's tiles are optional: narrow them until they are staged
    while not bwd and bh > _MIN_BLOCK_H and \
            not smem_items(A, be, bh)["tiles"]:
        bh //= 2
    return be, bh
