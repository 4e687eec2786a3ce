"""The fused EGNN edge forward (#3) of the port: its order of summation
emulated against ``repro``'s, and the plan of its products.

The CUDA forward (``csrc/egnn_edge.cu``) runs Pi = h·w0i + b0, Pj = h·w0j
and agg = S·w1 + deg ⊗ b1 on the tensor cores as 3xTF32 products (the
arithmetic of ``csrc/gemm_tc.cuh``, emulated by ``_tc_matmul`` of
tests/test_torch_edge_bwd.py), each cut into the plan's k-ranges and summed
in split order, and sums S per node in edge order. ``_emulate_fwd`` does
the same in plain torch; it is held against ``repro``'s Pallas
``egnn_edge_fused`` (interpret mode on the CPU, as tests/test_hotpath.py
runs it) and against a float64 forward. The kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py,
``chip_smoke.py``).

Tolerances: against ``repro``'s f32 kernel 1e-5 x max(1, max|ref|) (fp32
sums in another order: node projections against per-edge products);
against float64 1e-5 of the largest entry, the fp32 contract of
tests/test_torch_edge_bwd.py (``CONTRACT``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic_atoms import generate_all, to_batch_dict
from repro.kernels.egnn_edge.kernel import egnn_edge_fused

from repro_torch.kernels.egnn_edge import gemm_plan
from repro_torch.kernels.egnn_edge.ref import egnn_edge_agg_ref
from test_torch_edge_bwd import CONTRACT, _tc_matmul

TOL = 1e-5
B, A, E = 4, 10, 40
H = 96                     # 3 k-steps of 32: products split up to 3 ways


def _case(seed):
    """tests/test_torch_edge_bwd.py's kind of inputs (ragged E, masked
    edges, sentinel dst == A edges the mask still marks valid) at H = 96:
    routed src/dst and the φ_e weights, float32 numpy."""
    data = generate_all(B, max_atoms=A, max_edges=E, seed=seed,
                        sources=["ani1x"])
    batch = to_batch_dict(data["ani1x"], np.arange(B))
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, A, H)).astype(np.float32) \
        * np.asarray(batch["node_mask"])[..., None]
    w0 = (rng.standard_normal((2 * H + 1, H)) / np.sqrt(2 * H + 1)) \
        .astype(np.float32)
    b0, b1 = (0.1 * rng.standard_normal((2, H))).astype(np.float32)
    w1 = (rng.standard_normal((H, H)) / np.sqrt(H)).astype(np.float32)
    src = np.asarray(batch["edge_src"]).copy()
    dst = np.asarray(batch["edge_dst"]).copy()
    em = np.asarray(batch["edge_mask"]).copy()
    em[:, ::7] = False                                   # masked edges
    dst[:, -3:], src[:, -3:], em[:, -3:] = A, 2, True     # sentinel edges
    sr, dr = np.where(em, src, A), np.where(em, dst, A)
    return h, np.array(batch["pos"]), sr, dr, w0, b0, w1, b1


def _emulate_fwd(h, pos, src, dst, w0, b0, w1, b1, splits):
    """The CUDA forward's arithmetic: launch 1 (Pi, Pj as 3xTF32 products
    in ``splits[0]`` k-ranges summed in split order, then + b0); the edge
    kernel (d² from the clamped endpoints, z = Pi[src] + Pj[dst] + d²·w0d,
    silu, S summed per destination in edge order, deg the list length);
    launch 2 (+3) (agg = S·w1 in ``splits[1]`` k-ranges summed in order,
    then deg·b1 added with one rounding, the kernel's fma)."""
    B, A, H = h.shape
    nodes = B * A
    proj, fc1 = splits
    hf = h.reshape(nodes, H)
    pi = (_tc_matmul(hf, w0[:H], splits=proj) + b0).reshape(B, A, H)
    pj = _tc_matmul(hf, w0[H:2 * H], splits=proj).reshape(B, A, H)
    S = torch.zeros(B, A, H)
    deg = torch.zeros(B, A)
    for b in range(B):
        for e in range(src.shape[1]):
            d = int(dst[b, e])
            if not 0 <= d < A:
                continue
            s = min(int(src[b, e]), A - 1)
            diff = pos[b, s] - pos[b, d]
            d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
            z = pi[b, s] + pj[b, d] + d2 * w0[2 * H]
            S[b, d] += z * (1 / (1 + torch.exp(-z)))
            deg[b, d] += 1
    acc = _tc_matmul(S.reshape(nodes, H), w1, splits=fc1)
    out = (acc.double() + deg.reshape(nodes, 1).double() * b1.double())
    return out.float().reshape(B, A, H)


def _repro(h, pos, sr, dr, w0, b0, w1, b1):
    return np.asarray(egnn_edge_fused(
        jnp.asarray(h), jnp.asarray(pos), jnp.asarray(sr), jnp.asarray(dr),
        jnp.asarray(w0[:H]), jnp.asarray(w0[H:2 * H]),
        jnp.asarray(w0[2 * H:]), jnp.asarray(b0[None]), jnp.asarray(w1),
        jnp.asarray(b1[None]), block_e=16, block_h=32, interpret=True))


def _float64(h, pos, sr, dr, w0, b0, w1, b1):
    """The plain forward (``egnn_edge_agg_ref``) in float64."""
    t = [torch.from_numpy(x).double() for x in (h, pos, w0, b0, w1, b1)]
    phi = {"fc0": {"w": t[2], "b": t[3]}, "fc1": {"w": t[4], "b": t[5]}}
    src, dst = torch.from_numpy(sr), torch.from_numpy(dr)
    return egnn_edge_agg_ref(t[0], t[1], src, dst, dst < A, phi).numpy()


@pytest.mark.parametrize("seed,splits", [(0, (1, 1)), (1, (3, 2)),
                                         (2, (2, 3))])
def test_kernel_order_emulation_matches_repro_kernel(seed, splits):
    """The emulated #3 (3xTF32 products in the plan's k-ranges, S in edge
    order) against repro's egnn_edge_fused in interpret mode at TOL, and
    within the fp32 contract of a float64 forward."""
    case = _case(seed)
    got = _emulate_fwd(*(torch.from_numpy(x) for x in case), splits).numpy()
    want = _repro(*case)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))
    exact = _float64(*case)
    scale = float(np.abs(exact).max())
    assert float(np.abs(got - exact).max()) <= CONTRACT * scale
    # repro's own f32 kernel is held to the same contract
    assert float(np.abs(want - exact).max()) <= CONTRACT * scale


def test_emulated_splits_move_bits_not_values():
    """Another split count is another order of summation: the outputs'
    bits may move, their values stay within the contract of one another."""
    case = [torch.from_numpy(x) for x in _case(3)]
    one = _emulate_fwd(*case, (1, 1))
    three = _emulate_fwd(*case, (3, 3))
    scale = float(one.abs().max())
    assert float((one - three).abs().max()) <= CONTRACT * scale


# ---------------------------------------------------------------------------
# the forward's GEMM plan (kernels/egnn_edge/gemm_plan.py)
# ---------------------------------------------------------------------------

def _check_covers_once(launch):
    for p in launch["products"]:
        assert (p["tiles_m"] - 1) * gemm_plan.BM < p["rows"] <= \
            p["tiles_m"] * gemm_plan.BM
        assert (p["tiles_n"] - 1) * gemm_plan.BN < p["cols"] <= \
            p["tiles_n"] * gemm_plan.BN
        steps = p["terms"] * -(-p["K"] // gemm_plan.BK)
        ranges = {}
        for sp, tm, tn, k0, k1 in gemm_plan.items(p):
            assert k1 > k0, "every k-range of a forward product is non-empty"
            ranges.setdefault((tm, tn), []).append((sp, k0, k1))
        assert len(ranges) == p["tiles_m"] * p["tiles_n"]
        for parts in ranges.values():
            assert [s for s, _, _ in parts] == list(range(p["splits"]))
            edges = [k for _, k0, k1 in parts for k in (k0, k1)]
            assert edges[0] == 0 and edges[-1] == steps
            assert edges[1::2][:-1] == edges[2::2]     # contiguous
    assert gemm_plan.launch_items(launch) == len(
        gemm_plan.launch_ksteps(launch))


@pytest.mark.parametrize("B,A,H", [(40, 64, 866), (8, 64, 866),
                                   (8, 16, 866), (3, 40, 96), (1, 8, 24)])
def test_fwd_gemm_plan_covers_every_output_once(B, A, H):
    plan = gemm_plan.fwd_launches(B, A, H)
    proj, fc1 = gemm_plan.fwd_splits(B * A, H)
    assert len(plan) == (3 if fc1 > 1 else 2)       # at most 4 kernels a call
    assert [p["splits"] for p in plan[0]["products"]] == [proj, proj]
    assert plan[1]["products"][0]["splits"] == fc1
    for launch in plan:
        _check_covers_once(launch)
    if fc1 > 1:          # launch 3 sums every element of agg once
        assert plan[2]["products"] == [] and plan[2]["reduce_items"] == \
            -(-B * A * H // gemm_plan.FWD_REDUCE_ELEMS)


def test_fwd_gemm_plan_depends_on_shapes_alone():
    """The split counts fix the order of every sum: they are a function of
    (B·A, H) — equal for equal node counts, the same when planned again —
    and never more than MAX_SPLITS."""
    first = gemm_plan.fwd_launches(8, 64, 866)
    gemm_plan.fwd_splits.cache_clear()
    assert gemm_plan.fwd_launches(8, 64, 866) == first
    assert gemm_plan.fwd_splits(8 * 64, 866) == gemm_plan.fwd_splits(
        16 * 32, 866)
    for nodes in (64, 128, 512, 2560, 10 ** 4):
        assert all(1 <= s <= gemm_plan.MAX_SPLITS
                   for s in gemm_plan.fwd_splits(nodes, 866))


@pytest.mark.parametrize("A", [16, 24, 32, 40, 48, 56, 64])
def test_fwd_gemm_plan_beats_unsplit_at_serve_buckets(A):
    """B=8 (the serving batch) at each bucket of atoms, M = 8·A = 128..512:
    the plan's modelled cost beats one k-range a product, which fills at
    most 2·7·ceil(M/128) of the 132 SMs — in each part and in all."""
    nodes = 8 * A
    planned = gemm_plan.fwd_cost(nodes, 866, gemm_plan.fwd_splits(nodes, 866))
    unsplit = gemm_plan.fwd_cost(nodes, 866, (1, 1))
    assert all(p < u for p, u in zip(planned, unsplit))
    # and by the k-steps alone, the model without its item cost
    span = [sum(gemm_plan.makespan(gemm_plan.launch_ksteps(x)) for x in
                gemm_plan.fwd_launches(8, A, 866, splits=sp))
            for sp in (gemm_plan.fwd_splits(nodes, 866), (1, 1))]
    assert span[0] < span[1]


@pytest.mark.parametrize("B,A", [(40, 64), (8, 64), (8, 16), (1, 64)])
def test_fwd_gemm_plan_is_the_least_cost(B, A):
    """The two split counts are chosen part by part; no pair of counts in
    1..MAX_SPLITS with non-empty k-ranges costs less in all."""
    nodes = B * A
    best = sum(gemm_plan.fwd_cost(nodes, 866, gemm_plan.fwd_splits(nodes,
                                                                   866)))
    for p in range(1, gemm_plan.MAX_SPLITS + 1):
        for f in range(1, gemm_plan.MAX_SPLITS + 1):
            assert best <= sum(gemm_plan.fwd_cost(nodes, 866, (p, f)))


def test_item_cost_keeps_the_backward_plan():
    """The item cost the forward's plan was fitted with leaves #4's dw1
    split where it was: 2 k-ranges at the training shape, 1 at B=8."""
    assert gemm_plan.w1_splits(40 * 64, 866) == 2
    assert gemm_plan.w1_splits(8 * 64, 866) == 1
