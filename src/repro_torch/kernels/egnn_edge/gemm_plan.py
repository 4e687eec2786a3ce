"""Tile plans of the EGNN edge path's node-level products
(``csrc/gemm_tc.cuh``), backward (#4) and forward (#3).

Each ``gemm_tc`` launch is one CTA per item: first the reduce items, then
each product's (split, m-tile, n-tile) in product order, the longest
k-ranges first, 128 x 128 outputs an item, k-steps of 32. ``launches``
(backward) and ``fwd_launches`` (forward) mirror that layout, so a test can
check it without the card.

A backward call (``csrc/egnn_edge_bwd.cu``) runs its six products in two
launches around the edge kernel:

  launch 1: dw1 = Sᵀ·g with db1 = degᵀ·g as its extra row (K = B·A,
            ``w1_splits`` k-ranges, partials to scratch), dS = g·w1ᵀ (K = H);
  launch 2: the reduce items that sum dw1's partials in split order, then
            dw0i = hᵀ·dPi with db0 = 1ᵀ·dPi as its extra row, dw0j = hᵀ·dPj
            (K = B·A), dh = dPi·w0iᵀ + dPj·w0jᵀ (two terms of K = H), and
            dw0d = 1ᵀ·(per-graph partials) (K = B).

A forward call (``csrc/egnn_edge.cu``) runs its three products (K = H
each) in two launches around the edge kernel, and a third only when fc1
is split:

  launch 1: Pi = h·w0i (+ b0) and Pj = h·w0j, each in ``proj`` k-ranges
            (partials to scratch, which the edge kernel sums in split
            order);
  launch 2: agg = S·w1 (+ deg ⊗ b1), in ``fc1`` k-ranges;
  launch 3: only when fc1 > 1, the reduce items that sum agg's partials
            in split order (``FWD_REDUCE_ELEMS`` elements an item).

The plan depends on the shapes alone, so it fixes every output's order of
summation. ``SLOTS`` is what an H100 holds at once (132 SMs, one CTA an SM:
its accumulators take ~200 registers a thread; ``chip_smoke.py`` reads the
card's own count). The card hands each SM the next item as its last one
ends, so a launch's time is the busiest SM's load under that greedy order
(``makespan``), an item's load its k-steps plus ``ITEM_KSTEPS`` for its
start and its stores (``launch_cost``; a reduce item one). ``w1_splits``
picks the split count of dw1 that makes launch 1's cost the least;
``fwd_splits`` the forward's two counts: Pi/Pj's for launch 1's cost plus,
when split, the edge kernel's sum of their partials (counted as the reduce
items that would sum them), and fc1's for launch 2's cost plus launch 3's.
Split counts run from 1 to ``MAX_SPLITS``, the forward's each k-range
non-empty. ``ITEM_KSTEPS`` = 6 fits the forward's GEMM time over four
split plans at B=40 and B=8 on an H100 (``chip_smoke.py --sweep``'s
``by_plan``; PERF.md §6), and leaves ``w1_splits``' choices as they were.
"""
from __future__ import annotations

import functools
import heapq

BM = BN = 128                 # outputs an item
BK = 32                       # a k-step
SLOTS = 132                   # CTAs an H100 holds at once
REDUCE_ELEMS = 65536          # partial elements a reduce item sums
FWD_REDUCE_ELEMS = 4096       # ... in the forward's launch 3 (more items)
MAX_SPLITS = 4
ITEM_KSTEPS = 6               # an item's start and stores, in k-steps


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def makespan(ksteps: list, slots: int = SLOTS) -> int:
    """The busiest of ``slots`` SMs' k-steps when each takes the next item
    (``ksteps`` in launch order) as soon as it is free."""
    loads = [0] * slots
    heapq.heapify(loads)
    for k in ksteps:
        heapq.heappush(loads, heapq.heappop(loads) + k)
    return max(loads)


@functools.lru_cache(maxsize=None)
def w1_splits(nodes: int, H: int, slots: int = SLOTS) -> int:
    """k-ranges of dw1 (K = ``nodes``) in launch 1: the count from 1 to
    ``MAX_SPLITS`` whose launch 1 has the least makespan; the fewest on a
    tie. Cached: the
    wrapper asks once a call."""
    return _least(lambda s: launch_cost(
        launches_of(H, s, B=1, nodes=nodes)[0], slots))


def _least(cost, steps: int | None = None) -> int:
    """The split count from 1 to ``MAX_SPLITS`` of least ``cost``, the
    fewest on a tie; given ``steps``, only counts whose every k-range of
    that many k-steps is non-empty."""
    best = None
    for s in range(1, MAX_SPLITS + 1):
        if steps is not None and _ranges(steps, s)[-1][0] >= steps:
            continue
        t = cost(s)
        if best is None or t < best[0]:
            best = (t, s)
    return best[1]


def _ranges(steps: int, splits: int) -> list:
    """The k-step range (first, end) of each split."""
    per = _cdiv(steps, splits)
    return [(min(steps, sp * per), min(steps, (sp + 1) * per))
            for sp in range(splits)]


@functools.lru_cache(maxsize=None)
def fwd_splits(nodes: int, H: int, slots: int = SLOTS) -> tuple:
    """(proj, fc1): the forward's k-ranges of Pi/Pj and of fc1 of least
    ``fwd_cost``, the fewest on a tie. Cached: the wrapper asks once a
    call."""
    steps = _cdiv(H, BK)
    proj = _least(lambda s: fwd_cost(nodes, H, (s, 1), slots)[0], steps)
    fc1 = _least(lambda s: fwd_cost(nodes, H, (1, s), slots)[1], steps)
    return proj, fc1


def fwd_cost(nodes: int, H: int, splits: tuple, slots: int = SLOTS) -> tuple:
    """The modelled cost of a forward's (Pi/Pj, fc1) parts at ``splits``,
    in k-steps: launch 1 plus, when Pi/Pj are split, the edge kernel's sum
    of their 2·nodes·H partial elements as the reduce items that would sum
    them; launch 2 plus launch 3."""
    first, *rest = fwd_launches_of(H, *splits, nodes=nodes)
    proj = launch_cost(first, slots)
    if splits[0] > 1:
        proj += makespan([1] * _cdiv(2 * nodes * H, FWD_REDUCE_ELEMS), slots)
    return proj, sum(launch_cost(x, slots) for x in rest)


def _product(name, rows, cols, K, terms=1, splits=1):
    return {"name": name, "rows": rows, "cols": cols, "K": K,
            "terms": terms, "splits": splits,
            "tiles_m": _cdiv(rows, BM), "tiles_n": _cdiv(cols, BN)}


def launches(B: int, A: int, H: int, splits: int | None = None) -> list:
    """The two GEMM launches of one backward call at (B graphs, A nodes,
    H columns): each ``{"reduce_items": n, "products": [...]}``, products in
    launch order; ``rows`` counts a product's extra row."""
    nodes = B * A
    s = w1_splits(nodes, H) if splits is None else splits
    return launches_of(H, s, B=B, nodes=nodes)


def launches_of(H: int, s: int, *, B: int, nodes: int) -> list:
    """``launches`` with dw1 cut into ``s`` k-ranges."""
    first = [_product("dw1+db1", H + 1, H, nodes, splits=s),
             _product("dS", nodes, H, H)]
    second = [_product("dw0i+db0", H + 1, H, nodes),
              _product("dw0j", H, H, nodes),
              _product("dh", nodes, H, H, terms=2),
              _product("dw0d", 1, H, B)]
    red = _cdiv((H + 1) * H, REDUCE_ELEMS) if s > 1 else 0
    return [{"reduce_items": 0, "products": first},
            {"reduce_items": red, "products": second}]


def fwd_launches(B: int, A: int, H: int, splits: tuple | None = None) -> list:
    """The GEMM launches of one forward call at (B graphs, A nodes, H
    columns), as ``launches``: two, three when fc1 is split."""
    nodes = B * A
    proj, fc1 = fwd_splits(nodes, H) if splits is None else splits
    return fwd_launches_of(H, proj, fc1, nodes=nodes)


def fwd_launches_of(H: int, proj: int, fc1: int, *, nodes: int) -> list:
    """``fwd_launches`` with Pi/Pj in ``proj`` k-ranges, fc1 in ``fc1``."""
    out = [{"reduce_items": 0,
            "products": [_product("Pi", nodes, H, H, splits=proj),
                         _product("Pj", nodes, H, H, splits=proj)]},
           {"reduce_items": 0,
            "products": [_product("agg", nodes, H, H, splits=fc1)]}]
    if fc1 > 1:
        out.append({"reduce_items": _cdiv(nodes * H, FWD_REDUCE_ELEMS),
                    "products": []})
    return out


def items(product: dict) -> list:
    """Every item of a product as (split, m-tile, n-tile, first k-step,
    end k-step), in the kernel's order; k-steps count over the terms."""
    steps = product["terms"] * _cdiv(product["K"], BK)
    out = []
    for sp, (k0, k1) in enumerate(_ranges(steps, product["splits"])):
        for tm in range(product["tiles_m"]):
            for tn in range(product["tiles_n"]):
                out.append((sp, tm, tn, k0, k1))
    return out


def launch_items(launch: dict) -> int:
    return launch["reduce_items"] + sum(len(items(p))
                                        for p in launch["products"])


def launch_cost(launch: dict, slots: int = SLOTS) -> int:
    """A launch's makespan with each product item costing its k-steps plus
    ``ITEM_KSTEPS``, a reduce item one."""
    return makespan([1] * launch["reduce_items"] + [
        k1 - k0 + ITEM_KSTEPS for p in launch["products"]
        for *_, k0, k1 in items(p)], slots)


def launch_ksteps(launch: dict) -> list:
    """Each item's k-steps in launch order (a reduce item counts one)."""
    return [1] * launch["reduce_items"] + [
        k1 - k0 for p in launch["products"] for *_, k0, k1 in items(p)]
