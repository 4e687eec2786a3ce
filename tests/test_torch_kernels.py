"""Parity of the port's kernel modules with ``repro``'s Pallas kernels.

The same numpy-seeded inputs go through ``repro``'s Pallas kernels (in
interpret mode on the CPU, as tests/test_hotpath.py runs them) and through
the port's wrappers, which on CPU tensors run their plain PyTorch versions.
The CUDA kernels themselves are held against those plain versions on the
card (``chip_smoke.py`` and tests/test_torch_cuda.py).

Tolerances: 1e-5, what tests/test_hotpath.py holds the JAX impls to
against each other (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.data.synthetic_atoms import generate_all, to_batch_dict
from repro.kernels.egnn_edge import ops as j_edge_ops
from repro.kernels.segment_sum.kernel import (segment_sum_2d,
                                              segment_sum_batched)
from repro.kernels.segment_sum.ref import segment_sum_ref as j_ss_ref
from repro.models import gnn as j_gnn

from repro_torch import interop
from repro_torch.kernels.egnn_edge import budget
from repro_torch.kernels.egnn_edge import ops as edge_ops
from repro_torch.kernels.segment_sum import ops as ss_ops

TOL = 1e-5


def _ss_case(B, E, A, F, seed=0, mask_p=0.7):
    """Ragged-E segment-sum inputs with masked edges and sentinel
    (dst == A) edges."""
    rng = np.random.default_rng(seed)
    msg = rng.standard_normal((B, E, F)).astype(np.float32)
    dst = rng.integers(0, A + 1, (B, E)).astype(np.int32)   # A = sentinel
    em = (rng.random((B, E)) < mask_p) & (dst < A)
    return msg, dst, em


@pytest.mark.parametrize("B,E,A,F,bn,be", [
    (2, 64, 16, 8, 8, 16),
    (3, 300, 33, 48, 16, 64),     # ragged E and A vs blocks
    (1, 128, 128, 128, 128, 128),
    (2, 7, 3, 5, 8, 8),           # blocks larger than the problem
])
def test_segment_sum_matches_repro(B, E, A, F, bn, be):
    msg, dst, em = _ss_case(B, E, A, F)
    routed = np.where(em, dst, A).astype(np.int32)
    got = ss_ops.segment_sum(torch.from_numpy(msg), torch.from_numpy(dst), A,
                             edge_mask=torch.from_numpy(em), block_n=bn,
                             block_e=be).numpy()
    batched = np.asarray(segment_sum_batched(
        jnp.asarray(msg), jnp.asarray(routed), A, block_n=bn, block_e=be,
        interpret=True))
    np.testing.assert_allclose(got, batched, atol=TOL, rtol=TOL)
    for b in range(min(B, 2)):
        two_d = np.asarray(segment_sum_2d(jnp.asarray(msg[b]),
                                          jnp.asarray(routed[b]), A,
                                          block_n=bn, block_e=be,
                                          interpret=True))
        ref = np.asarray(j_ss_ref(jnp.asarray(msg[b]), jnp.asarray(routed[b]),
                                  A))
        # the port's 2-D entry (B=1 of the same kernel) per graph
        got_2d = ss_ops.segment_sum(torch.from_numpy(msg[b]),
                                    torch.from_numpy(routed[b]), A).numpy()
        np.testing.assert_allclose(got[b], two_d, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[b], ref, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got_2d, ref, atol=TOL, rtol=TOL)


def test_segment_sum_drops_every_masked_and_sentinel_edge():
    msg, dst, em = _ss_case(2, 50, 9, 6, seed=2, mask_p=0.5)
    out = ss_ops.segment_sum(torch.from_numpy(msg), torch.from_numpy(dst), 9,
                             edge_mask=torch.from_numpy(em)).numpy()
    expect = np.where(em[..., None], msg, 0.0).sum(1)
    np.testing.assert_allclose(out.sum(1), expect, atol=TOL, rtol=TOL)


def test_segment_sum_rejects_bad_rank_and_blocks():
    msg, dst, em = (torch.from_numpy(x) for x in _ss_case(2, 16, 4, 4))
    with pytest.raises(ValueError, match="ndim"):
        ss_ops.segment_sum(msg[:, :, :, None], dst, 4, edge_mask=em)
    with pytest.raises(ValueError, match="block"):
        ss_ops.segment_sum(msg, dst, 4, block_n=0)
    # a dst window of 40,000 edges stages 320 KB (dst and the edge list)
    with pytest.raises(budget.SmemBudgetError):
        ss_ops.segment_sum(torch.zeros(1, 40_000, 8),
                           torch.zeros(1, 40_000, dtype=torch.int32), 16,
                           block_e=40_000)
    # 4096 nodes a CTA carry 4096 x 32 lanes x 2 f32 partials across windows
    with pytest.raises(budget.SmemBudgetError):
        ss_ops.segment_sum(torch.zeros(1, 64, 8), torch.zeros(1, 64,
                                                              dtype=torch.int32),
                           4096, block_n=4096, block_e=32)


def _plan_smem(p, E):
    return ss_ops.smem_bytes(p.block_n, p.block_e, p.threads,
                             carry=p.vec if E > p.block_e else 0)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B", [1, 8])
def test_segment_sum_autotune_fits_budget(B, itemsize):
    for A in (1, 16, 64, 128, 500, 4096, 200_000):
        for E in (1, 64, 2048, 100_000):
            for F in (1, 7, 866, 4096):
                p = ss_ops.plan(A, E, F, batch=B, itemsize=itemsize)
                assert ss_ops.autotune_blocks(
                    A, E, F, batch=B, itemsize=itemsize) == (p.block_n,
                                                             p.block_e)
                assert _plan_smem(p, E) <= budget.SMEM_BUDGET
                assert 1 <= p.block_n <= max(A, 1)
                assert 1 <= p.block_e <= min(max(E, 1), ss_ops.MAX_BLOCK_E)
                # grid limits: node blocks and graphs, threads a CTA
                assert -(-A // p.block_n) <= ss_ops.MAX_GRID_YZ
                assert 32 <= p.threads <= ss_ops.MAX_THREADS
                # the chunks cover every column once, each row aligned
                assert F % p.vec == 0 and p.vec * itemsize <= 8
                assert (p.chunks - 1) * p.lanes < F // p.vec <= \
                    p.chunks * p.lanes


def test_segment_sum_plan_fills_the_card_at_the_main_shapes():
    one = ss_ops.plan(64, 2048, 866, batch=1)
    # one node and half of the columns a CTA: 128 CTAs of 224 threads
    assert one == ss_ops.Plan(block_n=1, block_e=2048, vec=2, lanes=217,
                              chunks=2)
    assert one.threads == 224
    # B=8: two nodes a CTA share the dst walk, ~4 CTAs an SM remain
    batched = ss_ops.plan(64, 2048, 866, batch=8)
    assert batched == ss_ops.Plan(block_n=2, block_e=2048, vec=2, lanes=217,
                                  chunks=2)
    assert ss_ops.plan(64, 2048, 866, batch=64).block_n == 16
    for B, A, F in ((1, 3, 5), (1, 64, 866), (8, 64, 866), (2, 40, 96),
                    (1, 8, 866)):
        p = ss_ops.plan(A, 1000, F, batch=B)
        grid = p.chunks * -(-A // p.block_n) * B
        # at least half the SMs busy, unless the columns run out of lanes
        assert 2 * grid >= ss_ops.SM_COUNT or p.lanes < 2 * ss_ops.MIN_LANES
        assert p.block_n == 1 or grid >= ss_ops.MIN_CTAS_PER_SM * \
            ss_ops.SM_COUNT


def test_segment_sum_plan_takes_the_whole_list_when_the_carry_overflows():
    """The embedding's backward (qwen1.5-0.5b: 8 x 1024 token ids into a
    152064-row table, d=1024, bf16): a 2048-id window would carry 4 f32
    partial sums a thread and node, 1.5 MB at 384 nodes and 256 lanes, so
    the plan takes all 8192 ids in one window and carries nothing, where
    shrinking the window to fit the carry would leave 32 ids and 32
    lanes: 3,168 one-warp CTAs walking 256 windows each."""
    V, E, F = 152064, 8192, 1024
    p = ss_ops.plan(V, E, F, itemsize=2)
    assert p == ss_ops.Plan(block_n=384, block_e=E, vec=4, lanes=256,
                            chunks=1)
    assert _plan_smem(p, E) == ss_ops.smem_bytes(384, E, 256) <= \
        budget.SMEM_BUDGET
    assert -(-V // p.block_n) == 396           # 3 CTAs an SM
    # in f32 too; an explicit window is kept (and carries)
    assert ss_ops.plan(V, E, F).block_e == E
    q = ss_ops.plan(V, E, F, itemsize=2, block_e=2048)
    assert q.block_e == 2048 and _plan_smem(q, E) <= budget.SMEM_BUDGET
    # a list too long for one window keeps the old order of shrinking
    assert ss_ops.plan(V, 100_000, F, itemsize=2).block_e < 2048
    # graph shapes are untouched: their lists fit the 2048-id window
    assert ss_ops.plan(64, 2560, 866).block_e == 2048


@pytest.mark.parametrize("F,itemsize,align,vec", [
    (866, 4, 8, 2), (867, 4, 8, 1), (866, 4, 4, 1), (866, 2, 8, 2),
    (868, 2, 8, 4), (868, 2, 4, 2), (867, 2, 8, 1), (8, 8, 8, 1)])
def test_segment_sum_vector_width(F, itemsize, align, vec):
    assert ss_ops.vec_width(F, itemsize, align) == vec
    p = ss_ops.plan(64, 2048, F, itemsize=itemsize, align=align)
    assert p.vec == vec


def test_segment_sum_plan_keeps_explicit_blocks_or_refuses():
    p = ss_ops.plan(64, 5000, 866, block_e=1024)
    assert (p.block_n, p.block_e) == (1, 1024)
    # a window smaller than E carries partial sums: 8 bytes a lane and node
    assert _plan_smem(p, 5000) == ss_ops.smem_bytes(1, 1024, p.threads,
                                                    carry=2)
    assert _plan_smem(p, 5000) - ss_ops.smem_bytes(1, 1024, p.threads) == \
        8 * p.threads
    p = ss_ops.plan(128, 2048, 866, block_n=128)
    assert p.block_n == 128 and _plan_smem(p, 2048) <= budget.SMEM_BUDGET
    # blocks past the problem are clipped to it
    assert ss_ops.plan(3, 7, 5, block_n=8, block_e=8)[:2] == (3, 7)
    # the column split narrows to fit a large explicit node block
    wide = ss_ops.plan(512, 100_000, 866, block_n=512, block_e=2048)
    assert wide.lanes < 217 and _plan_smem(wide, 100_000) <= \
        budget.SMEM_BUDGET
    with pytest.raises(ValueError, match="grid too large"):
        ss_ops.plan(70_000, 64, 8, block_n=1)


# ---------------------------------------------------------------------------
# fused edge kernel
# ---------------------------------------------------------------------------

def _edge_inputs(seed=0):
    cfg = JArchConfig(name="g", family="gnn", gnn_hidden=24, gnn_layers=2,
                      n_species=64, head_hidden=12, head_layers=2,
                      max_atoms=10, max_edges=40, remat=False,
                      compute_dtype=jnp.float32)
    data = generate_all(4, max_atoms=10, max_edges=40, seed=seed,
                        sources=["ani1x"])
    batch = to_batch_dict(data["ani1x"], np.arange(4))
    rng = np.random.default_rng(seed)
    H = cfg.gnn_hidden
    h = rng.standard_normal((4, 10, H)).astype(np.float32) \
        * np.asarray(batch["node_mask"])[..., None]
    phi_e = {"fc0": {"w": (rng.standard_normal((2 * H + 1, H))
                           / np.sqrt(2 * H + 1)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(H)).astype(np.float32)},
             "fc1": {"w": (rng.standard_normal((H, H))
                           / np.sqrt(H)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(H)).astype(np.float32)}}
    # a few extra sentinel edges (dst == A) that the mask still marks valid:
    # the sentinel alone must drop them
    src = np.asarray(batch["edge_src"]).copy()
    dst = np.asarray(batch["edge_dst"]).copy()
    em = np.asarray(batch["edge_mask"]).copy()
    dst[:, -3:], src[:, -3:], em[:, -3:] = 10, 2, True
    return h, np.array(batch["pos"]), src, dst, em, phi_e


@pytest.mark.parametrize("block_e", [16, 40, 64])
def test_egnn_edge_agg_matches_repro_fused(block_e):
    h, pos, src, dst, em, phi_e = _edge_inputs()
    want = np.asarray(j_edge_ops.egnn_edge_agg(
        jnp.asarray(h), jnp.asarray(pos), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(em), {k: {n: jnp.asarray(a) for n, a in v.items()}
                          for k, v in phi_e.items()},
        block_e=block_e, interpret=True))
    got = edge_ops.egnn_edge_agg(
        torch.from_numpy(h), torch.from_numpy(pos), torch.from_numpy(src),
        torch.from_numpy(dst), torch.from_numpy(em),
        interop.to_torch(phi_e), block_e=block_e).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_egnn_edge_plain_matches_repro_model_path():
    """The plain version is the unfused model message path of repro."""
    h, pos, src, dst, em, phi_e = _edge_inputs(seed=1)
    A = h.shape[1]

    def gather(x, idx):
        return jnp.take_along_axis(x, idx[..., None], axis=1)

    sc, dc = np.minimum(src, A - 1), np.minimum(dst, A - 1)
    xi, xj = gather(jnp.asarray(pos), sc), gather(jnp.asarray(pos), dc)
    d2 = jnp.sum((xi - xj) ** 2, -1, keepdims=True)
    cat = jnp.concatenate([gather(jnp.asarray(h), sc),
                           gather(jnp.asarray(h), dc), d2], -1)
    from repro.models.mlp import mlp_apply
    m = mlp_apply({k: {n: jnp.asarray(a) for n, a in v.items()}
                   for k, v in phi_e.items()}, cat, "silu", jnp.float32)
    want = np.asarray(j_gnn.segment_sum_nodes(m, jnp.asarray(dst), A,
                                              edge_mask=jnp.asarray(em),
                                              impl="scatter"))
    got = edge_ops.egnn_edge_agg(
        torch.from_numpy(h), torch.from_numpy(pos), torch.from_numpy(src),
        torch.from_numpy(dst), torch.from_numpy(em),
        interop.to_torch(phi_e)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# shared-memory planner: same contract as repro's VMEM planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [24, 256, 512, 866])
def test_plan_blocks_never_over_budget(H):
    """Every planned forward fits, launches (check_blocks passes) and stages
    its Pi/Pj tiles wherever a 32-column tile would let them; one window
    holds the graph's whole edge list wherever it fits."""
    for A in (8, 16, 64, 128, 512, 1024):
        for E in (1, 40, 256, 2048, 8192):
            be, bh = budget.plan_blocks(A, E, H)
            be_e = min(be, E)
            items = budget.smem_items(A, be_e, bh)
            assert budget.smem_bytes(A, be_e, bh) <= budget.SMEM_BUDGET
            assert bh % 32 == 0 and 32 <= bh <= budget.THREADS and be >= 1
            budget.check_blocks(A, E, H, be, bh)      # planned => valid
            assert items["lists"] == 8 * be_e
            assert items["nodes"] == 48 * A + 4
            if budget.smem_items(A, be_e, 32)["tiles"]:
                assert items["tiles"] == 8 * A * bh
            if 8 * E + 48 * A + 4 <= budget.SMEM_BUDGET:
                assert be >= E                        # one window


def test_over_budget_overrides_raise():
    # a window of 65536 listed edges (512 KB) cannot launch
    with pytest.raises(budget.SmemBudgetError):
        budget.check_blocks(1024, 65536, 866, 65536, 64)
    budget.check_blocks(1024, 65536, 866, 2048, 64)   # windows of 2048 can
    # 8192 nodes' counts alone exceed the budget: no override launches
    with pytest.raises(budget.SmemBudgetError):
        edge_ops.egnn_edge_agg(torch.zeros(1, 8192, 8),
                               torch.zeros(1, 8192, 3),
                               torch.zeros(1, 64, dtype=torch.int32),
                               torch.zeros(1, 64, dtype=torch.int32),
                               torch.ones(1, 64, dtype=torch.bool),
                               {}, block_e=64, block_h=32)
    with pytest.raises(budget.SmemBudgetError, match="node-dimension"):
        budget.plan_blocks(8192, 2048, 866)
    with pytest.raises(ValueError, match="multiple of 32"):
        budget.check_blocks(64, 2048, 866, 64, 48)
    with pytest.raises(ValueError, match="multiple of 32"):
        budget.check_blocks(64, 2048, 866, 64, 1024)
    with pytest.raises(ValueError, match="multiple of 32"):
        budget.check_blocks(64, 2048, 866, 64, 512)   # 8 warps: 256 columns
    items = budget.smem_items(64, 2048, 64)
    assert items == {"lists": 8 * 2048, "nodes": 48 * 64 + 4,
                     "tiles": 8 * 64 * 64}
    # tiles that do not fit beside the window are not staged (not counted)
    assert budget.smem_items(1024, 2048, 64)["tiles"] == 0
