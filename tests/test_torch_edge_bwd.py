"""The fused EGNN edge backward of the port against ``repro``'s.

The same numpy-seeded inputs (ragged E, masked edges, sentinel dst == A
edges that the mask still marks valid) go through ``repro``'s Pallas
``egnn_edge_fused_bwd`` and ``jax.grad`` of its ``egnn_edge_agg`` (in
interpret mode on the CPU, as tests/test_hotpath.py runs them) and through
the port's ``egnn_edge_bwd_ref`` and ``torch.autograd`` of its
``egnn_edge_agg`` (on CPU tensors, the plain versions behind the autograd
Function). The CUDA kernel itself is held against ``egnn_edge_bwd_ref`` on
the card (tests/test_torch_cuda.py, ``chip_smoke.py``).

Tolerance: 1e-5 x max(1, max|ref|) per output — fp32 sums over edges and
nodes in another order (the node-projection algebra against the TPU
kernel's per-edge chain rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic_atoms import generate_all, to_batch_dict
from repro.kernels.egnn_edge import ops as j_edge_ops
from repro.kernels.egnn_edge.kernel import egnn_edge_fused_bwd

from repro_torch import interop
from repro_torch.kernels.egnn_edge import budget, gemm_plan
from repro_torch.kernels.egnn_edge import ops as edge_ops
from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
from repro_torch.kernels.segment_sum import ops as ss_ops
from repro_torch.models import common

TOL = 1e-5
B, A, E, H = 4, 10, 40, 24


def _inputs(seed):
    data = generate_all(B, max_atoms=A, max_edges=E, seed=seed,
                        sources=["ani1x"])
    batch = to_batch_dict(data["ani1x"], np.arange(B))
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, A, H)).astype(np.float32) \
        * np.asarray(batch["node_mask"])[..., None]
    g = rng.standard_normal((B, A, H)).astype(np.float32)
    phi = {"fc0": {"w": (rng.standard_normal((2 * H + 1, H))
                         / np.sqrt(2 * H + 1)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(H)).astype(np.float32)},
           "fc1": {"w": (rng.standard_normal((H, H))
                         / np.sqrt(H)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(H)).astype(np.float32)}}
    src = np.asarray(batch["edge_src"]).copy()
    dst = np.asarray(batch["edge_dst"]).copy()
    em = np.asarray(batch["edge_mask"]).copy()
    em[:, ::7] = False                                   # masked edges
    dst[:, -3:], src[:, -3:], em[:, -3:] = A, 2, True     # sentinel edges
    return h, np.array(batch["pos"]), src, dst, em, phi, g


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.mark.parametrize("seed,block_e", [(0, 16), (1, 40)])
def test_bwd_ref_matches_repro_kernel(seed, block_e):
    h, pos, src, dst, em, phi, g = _inputs(seed)
    sr, dr = np.where(em, src, A), np.where(em, dst, A)
    w0 = phi["fc0"]["w"]
    split = (w0[:H], w0[H:2 * H], w0[2 * H:], phi["fc0"]["b"][None],
             phi["fc1"]["w"])
    want = egnn_edge_fused_bwd(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(pos), jnp.asarray(sr),
        jnp.asarray(dr), *map(jnp.asarray, split), block_e=block_e,
        block_h=16, interpret=True)
    got = egnn_edge_bwd_ref(*(torch.from_numpy(x) for x in
                              (g, h, pos, sr, dr) + split))
    names = ("dh", "dpos", "dw0i", "dw0j", "dw0d", "db0", "dw1", "db1")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a.numpy(), b, name)


def test_autograd_matches_jax_grad():
    """torch.autograd through the port's egnn_edge_agg (the autograd
    Function: plain forward and plain backward on the CPU, fc0 split into
    w0i/w0j/w0d, grads reassembled in the param dtypes) against jax.grad
    through repro's custom_vjp."""
    h, pos, src, dst, em, phi, g = _inputs(2)

    def j_loss(h_, pos_, phi_):
        out = j_edge_ops.egnn_edge_agg(h_, pos_, jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(em),
                                       phi_, block_e=16, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    jphi = jax.tree_util.tree_map(jnp.asarray, phi)
    jh, jpos, jdphi = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(pos), jphi)

    th = torch.from_numpy(h).requires_grad_(True)
    tpos = torch.from_numpy(pos).requires_grad_(True)
    tphi = interop.tree_map(lambda x: x.requires_grad_(True),
                            interop.to_torch(phi))
    out = edge_ops.egnn_edge_agg(th, tpos, torch.from_numpy(src),
                                 torch.from_numpy(dst), torch.from_numpy(em),
                                 tphi)
    (out * torch.from_numpy(g)).sum().backward()
    _close(th.grad.numpy(), jh, "h")
    _close(tpos.grad.numpy(), jpos, "pos")
    for path, leaf in interop.leaves(tphi).items():
        assert leaf.grad.dtype == leaf.dtype, path
        _close(leaf.grad.numpy(), interop.leaves(jdphi)[path], path)


def test_backward_blocks_planned_and_checked_per_direction():
    for A_, E_, H_ in ((8, 40, 24), (64, 2048, 866), (512, 8192, 866)):
        be, bh = budget.plan_blocks(A_, E_, H_, bwd=True)
        budget.check_blocks(A_, E_, H_, be, bh, bwd=True)
        assert budget.smem_bytes(A_, min(be, E_), bh, bwd=True, E=E_) <= \
            budget.SMEM_BUDGET
        assert budget.dpos_smem_bytes(A_, min(be, E_)) <= budget.SMEM_BUDGET
    # the backward keeps the lists of a graph's edges: an override that
    # fits the forward can be over the backward's budget — it raises when a
    # gradient is needed, and only then
    A_, E_, H_, be, bh = 8, 16000, 866, 256, 64
    budget.check_blocks(A_, E_, H_, be, bh)
    with pytest.raises(budget.SmemBudgetError, match="backward"):
        budget.check_blocks(A_, E_, H_, be, bh, bwd=True)
    h = torch.zeros(1, A_, H_)
    phi = {"fc0": {"w": torch.zeros(2 * H_ + 1, H_), "b": torch.zeros(H_)},
           "fc1": {"w": torch.zeros(H_, H_), "b": torch.zeros(H_)}}
    idx = torch.zeros(1, E_, dtype=torch.int64)
    em = torch.ones(1, E_, dtype=torch.bool)
    args = (torch.zeros(1, A_, 3), idx, idx, em, phi)
    edge_ops.egnn_edge_agg(h, *args, block_e=be, block_h=bh)
    with pytest.raises(budget.SmemBudgetError, match="backward"):
        edge_ops.egnn_edge_agg(h.requires_grad_(True), *args, block_e=be,
                               block_h=bh)


def test_segment_sum_kernel_path_refuses_grad():
    """The CUDA path refuses messages that need a gradient before it
    launches anything — shown here on the meta device, which takes the
    kernel path without a card."""
    msg = torch.zeros((1, 8, 4), device="meta", requires_grad=True)
    dst = torch.zeros((1, 8), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match='segment_sum_impl="fused"'):
        ss_ops.segment_sum(msg, dst, 2)
    # the CPU plain path is unchanged and differentiable
    cpu = torch.ones((1, 8, 4), requires_grad=True)
    ss_ops.segment_sum(cpu, torch.zeros((1, 8), dtype=torch.int64),
                       2).sum().backward()
    assert torch.equal(cpu.grad, torch.ones_like(cpu))


def test_embed_backward_is_a_one_hot_product():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (5, 7)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((5, 7, 9)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    out = common.embed({"table": t}, ids)
    assert torch.equal(out, table[ids.long()])           # forward bitwise
    out.backward(g)
    want = torch.zeros_like(table).index_add_(0, ids.reshape(-1).long(),
                                              g.reshape(-1, 9))
    torch.testing.assert_close(t.grad, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# #4's GEMMs (csrc/gemm_tc.cuh): 3xTF32 on the tensor cores keeps the fp32
# contract; one TF32 product does not
# ---------------------------------------------------------------------------

# The fp32 contract of a product at the model's scale: within 1e-5 of its
# largest entry against float64 — a plain fp32 product of up to 2560 terms
# lands near 5e-7, #4's BWD_TOL (chip_smoke.py) is 1e-4.
CONTRACT = 1e-5


def _rna_tf32(x):
    """cvt.rna.tf32.f32 by integer ops: round the fp32 bit pattern to 10
    mantissa bits, to nearest, ties away from zero (on the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _tc_matmul(a, b, *, splits=1, three=True):
    """The arithmetic of gemm_tc.cuh on a (M, K) @ (K, N) fp32 product:
    k-steps of 32 (gemm_plan.BK), each of 4 MMAs of k = 8 running lo·hi,
    hi·lo, hi·hi (or, ``three=False``, hi·hi alone) into an accumulator that
    is added into an f32 sum every 2 k-steps; ``splits`` k-ranges summed in
    order. An MMA's 8 products are exact in float64 and rounded once into
    the f32 accumulator; the tensor cores' own rounding (truncating) inside
    an MMA is not modelled."""
    M, K = a.shape
    N = b.shape[1]
    ah, al = _split(a)
    bh, bl = _split(b)
    steps = -(-K // gemm_plan.BK)
    per = -(-steps // splits)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if three else [(ah, bh)]
    total = torch.zeros(M, N)
    for sp in range(splits):
        s0, s1 = min(steps, sp * per), min(steps, (sp + 1) * per)
        part = torch.zeros(M, N)
        d = torch.zeros(M, N)
        for st in range(s0, s1):
            for k0 in range(st * gemm_plan.BK, min(K, (st + 1) * gemm_plan.BK),
                            8):
                k = slice(k0, min(K, k0 + 8))
                for x, y in pairs:
                    d = (d.double() + x[:, k].double() @ y[k].double()).float()
            if (st - s0 + 1) % 2 == 0 or st + 1 == s1:
                part, d = part + d, torch.zeros(M, N)
        total = total + part
    return total


def _contract_share(K, *, three, splits=1):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 64)) / np.sqrt(K))
                         .astype(np.float32))
    ref = a.double() @ b.double()
    got = _tc_matmul(a, b, splits=splits, three=three)
    return float((got.double() - ref).abs().max() / ref.abs().max()) / CONTRACT


def test_rna_rounding_is_cvt_rna():
    one = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                        -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11],
                       dtype=torch.float32)
    assert _rna_tf32(one).tolist() == [1.0 + 2.0 ** -10, 1.0,
                                       -(1.0 + 2.0 ** -10),
                                       1.0 + 2 * 2.0 ** -10]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("K,splits", [(866, 1), (1732, 1), (2560, 1),
                                      (2560, 2)])
def test_3xtf32_product_keeps_fp32_contract(K, splits):
    """K: dS (H), dh (two terms of H), the weight gradients (B·A at the
    training shape, dw1 in 2 k-ranges there)."""
    assert _contract_share(K, three=True, splits=splits) <= 0.2


@pytest.mark.parametrize("K", [866, 1732, 2560])
def test_one_tf32_product_breaks_fp32_contract(K):
    """hi·hi alone keeps ~2^-11 of each product: some 30x the contract,
    which is why the kernel runs three MMAs a k-step."""
    assert _contract_share(K, three=False) > 10.0


# ---------------------------------------------------------------------------
# the GEMM plan (kernels/egnn_edge/gemm_plan.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [40, 8, 3, 1])
def test_gemm_plan_covers_every_output_once(B):
    for launch in gemm_plan.launches(B, 64, 866):
        for p in launch["products"]:
            assert (p["tiles_m"] - 1) * gemm_plan.BM < p["rows"] <= \
                p["tiles_m"] * gemm_plan.BM
            assert (p["tiles_n"] - 1) * gemm_plan.BN < p["cols"] <= \
                p["tiles_n"] * gemm_plan.BN
            steps = p["terms"] * -(-p["K"] // gemm_plan.BK)
            ranges = {}
            for sp, tm, tn, k0, k1 in gemm_plan.items(p):
                ranges.setdefault((tm, tn), []).append((sp, k0, k1))
            assert len(ranges) == p["tiles_m"] * p["tiles_n"]
            for parts in ranges.values():
                assert [s for s, _, _ in parts] == list(range(p["splits"]))
                edges = [k for _, k0, k1 in parts for k in (k0, k1)]
                assert edges[0] == 0 and edges[-1] == steps
                assert edges[1::2][:-1] == edges[2::2]     # contiguous
        assert gemm_plan.launch_items(launch) == len(
            gemm_plan.launch_ksteps(launch))


def test_gemm_plan_balances_the_training_shape():
    """B=40 (5 sources x 8 graphs): dw1 in 2 k-ranges evens launch 1 out;
    the busiest SM of either launch is within 15% of the mean."""
    assert gemm_plan.w1_splits(40 * 64, 866) == 2
    spans = {s: gemm_plan.makespan(gemm_plan.launch_ksteps(
        gemm_plan.launches(40, 64, 866, splits=s)[0])) for s in (1, 2, 3, 4)}
    assert spans[2] == min(spans.values())
    for launch in gemm_plan.launches(40, 64, 866):
        ks = gemm_plan.launch_ksteps(launch)
        assert gemm_plan.makespan(ks) <= 1.15 * sum(ks) / gemm_plan.SLOTS


# ---------------------------------------------------------------------------
# #4's order of summation, emulated, against repro's Pallas backward
# ---------------------------------------------------------------------------

def _emulate_bwd(g, h, pos, src, dst, w0i, w0j, w0d, b0, w1):
    """The CUDA backward's arithmetic in plain torch: the forward's Pi, Pj,
    S, deg; launch 1 (dw1 with db1 as its extra row, in the plan's
    k-ranges; dS); the edge kernel (per node, dPj over its destination
    list and dPi over its source list in edge order, dz recomputed for the
    source walk, dw0d per lane over its warp's nodes then over the warps
    (block_h = 32: warp q owns nodes q, q + 8, ...), dd² per 32 columns);
    the dpos kernel (edges in order); launch 2 (dw0i with db0, dw0j, dh in
    two terms, dw0d over the graphs)."""
    B, A, H = h.shape
    nodes = B * A
    pi = h @ w0i + b0
    pj = h @ w0j
    valid = (dst >= 0) & (dst < A)
    sc = src.clamp(max=A - 1)
    z_all = pi.gather(1, sc[..., None].expand(-1, -1, H)) + \
        pj.gather(1, dst.clamp(max=A - 1)[..., None].expand(-1, -1, H))
    diff = pos.gather(1, sc[..., None].expand(-1, -1, 3)) - \
        pos.gather(1, dst.clamp(max=A - 1)[..., None].expand(-1, -1, 3))
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + \
        diff[..., 2] * diff[..., 2]
    z_all = z_all + d2[..., None] * w0d
    s_e = z_all * torch.sigmoid(z_all) * valid[..., None]
    S = torch.zeros(B, A, H)
    deg = torch.zeros(B, A)
    for b in range(B):
        for e in range(src.shape[1]):
            if valid[b, e]:
                S[b, dst[b, e]] += s_e[b, e]
                deg[b, dst[b, e]] += 1
    gf = g.reshape(nodes, H)
    splits = gemm_plan.w1_splits(nodes, H)
    w1x = _tc_matmul(torch.cat([S.reshape(nodes, H), deg.reshape(nodes, 1)],
                               1).T, gf, splits=splits)
    dw1, db1 = w1x[:H], w1x[H:]
    ds = _tc_matmul(gf, w1.T).reshape(B, A, H)

    def dz_of(pi_v, pj_v, ds_v, d2_v):
        z = pi_v + pj_v + d2_v * w0d[0]
        sig = 1 / (1 + torch.exp(-z))
        return ds_v * (sig * (1 + z * (1 - sig)))

    dpi, dpj = torch.zeros(B, A, H), torch.zeros(B, A, H)
    part = torch.zeros(B, H)
    dd2 = torch.zeros(B, src.shape[1])
    for b in range(B):
        edges = [e for e in range(src.shape[1]) if valid[b, e]]
        gw = torch.zeros(8, H)
        for a in range(A):
            for e in (e for e in edges if dst[b, e] == a):
                dz = dz_of(pi[b, sc[b, e]], pj[b, a], ds[b, a], d2[b, e])
                dpj[b, a] += dz
                gw[a % 8] += dz * d2[b, e]
                dd2[b, e] = sum(float((dz * w0d[0])[c:c + 32].sum())
                                for c in range(0, H, 32))
            for e in (e for e in edges if sc[b, e] == a):
                dpi[b, a] += dz_of(pi[b, a], pj[b, dst[b, e]],
                                   ds[b, dst[b, e]], d2[b, e])
        part[b] = gw.sum(0)
    dpos = torch.zeros(B, A, 3)
    for b in range(B):
        for e in range(src.shape[1]):
            if valid[b, e]:
                con = 2 * diff[b, e] * dd2[b, e]
                dpos[b, sc[b, e]] += con
                dpos[b, dst[b, e]] -= con
    hf = h.reshape(nodes, H)
    w0ix = _tc_matmul(torch.cat([hf, torch.ones(nodes, 1)], 1).T,
                      dpi.reshape(nodes, H))
    dw0i, db0 = w0ix[:H], w0ix[H:]
    dw0j = _tc_matmul(hf.T, dpj.reshape(nodes, H))
    dh = _tc_matmul(torch.cat([dpi.reshape(nodes, H),
                               dpj.reshape(nodes, H)], 1),
                    torch.cat([w0i.T, w0j.T], 0)).reshape(B, A, H)
    dw0d = _tc_matmul(torch.ones(1, B), part)
    return dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_emulation_matches_repro_kernel(seed):
    """The emulated #4 (3xTF32 products, edge-order sums) against repro's
    egnn_edge_fused_bwd in interpret mode, per output, at TOL."""
    h, pos, src, dst, em, phi, g = _inputs(seed)
    sr, dr = np.where(em, src, A), np.where(em, dst, A)
    w0 = phi["fc0"]["w"]
    split = (w0[:H], w0[H:2 * H], w0[2 * H:], phi["fc0"]["b"][None],
             phi["fc1"]["w"])
    want = egnn_edge_fused_bwd(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(pos), jnp.asarray(sr),
        jnp.asarray(dr), *map(jnp.asarray, split), block_e=16, block_h=16,
        interpret=True)
    got = _emulate_bwd(*(torch.from_numpy(x) for x in
                         (g, h, pos, sr, dr) + split))
    names = ("dh", "dpos", "dw0i", "dw0j", "dw0d", "db0", "dw1", "db1")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a.numpy(), b, name)
