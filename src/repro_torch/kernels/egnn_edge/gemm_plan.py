"""Tile plan of the backward's node-level products (``csrc/gemm_tc.cuh``).

A backward call (``csrc/egnn_edge_bwd.cu``) runs its six products in two
``gemm_tc`` launches around the edge kernel. Each launch is one CTA per
item: first the reduce items, then each product's (split, m-tile, n-tile)
in product order, the longest k-ranges first, 128 x 128 outputs an item,
k-steps of 32. ``launches`` mirrors that layout, so a test can check it
without the card:

  launch 1: dw1 = Sᵀ·g with db1 = degᵀ·g as its extra row (K = B·A,
            ``w1_splits`` k-ranges, partials to scratch), dS = g·w1ᵀ (K = H);
  launch 2: the reduce items that sum dw1's partials in split order, then
            dw0i = hᵀ·dPi with db0 = 1ᵀ·dPi as its extra row, dw0j = hᵀ·dPj
            (K = B·A), dh = dPi·w0iᵀ + dPj·w0jᵀ (two terms of K = H), and
            dw0d = 1ᵀ·(per-graph partials) (K = B).

The plan depends on the shapes alone, so it fixes every output's order of
summation. ``SLOTS`` is what an H100 holds at once (132 SMs, one CTA an SM:
its accumulators take ~200 registers a thread; ``chip_smoke.py`` reads the
card's own count). The card hands each SM the next item as its last one
ends, so a launch's time is the busiest SM's k-steps under that greedy
order (``makespan``); ``w1_splits`` picks the split count of dw1 that
makes launch 1's the least.
"""
from __future__ import annotations

import functools
import heapq

BM = BN = 128                 # outputs an item
BK = 32                       # a k-step
SLOTS = 132                   # CTAs an H100 holds at once
REDUCE_ELEMS = 65536          # partial elements a reduce item sums


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
    """k-ranges of dw1 (K = ``nodes``) in launch 1: the count from 1 to 4
    whose launch 1 has the least makespan; the fewest on a tie. Cached: the
    wrapper asks once a call."""
    best = None
    for s in range(1, 5):
        first = launches_of(H, s, B=1, nodes=nodes)[0]
        t = makespan(launch_ksteps(first), slots)
        if best is None or t < best[0]:
            best = (t, s)
    return best[1]


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


def items(product: dict) -> list:
    """Every item of a product as (split, m-tile, n-tile, first k-step,
    end k-step), in the kernel's order; k-steps count over the terms."""
    steps = product["terms"] * _cdiv(product["K"], BK)
    per = _cdiv(steps, product["splits"])
    out = []
    for sp in range(product["splits"]):
        k0 = min(steps, sp * per)
        k1 = min(steps, k0 + per)
        for tm in range(product["tiles_m"]):
            for tn in range(product["tiles_n"]):
                out.append((sp, tm, tn, k0, k1))
    return out


def launch_items(launch: dict) -> int:
    return launch["reduce_items"] + sum(len(items(p))
                                        for p in launch["products"])


def launch_ksteps(launch: dict) -> list:
    """Each item's k-steps in launch order (a reduce item counts one)."""
    return [1] * launch["reduce_items"] + [
        k1 - k0 for p in launch["products"] for *_, k0, k1 in items(p)]
