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
    with pytest.raises(budget.SmemBudgetError):
        ss_ops.segment_sum(torch.zeros(1, 64, 8), torch.zeros(1, 64,
                                                              dtype=torch.int32),
                           1024, block_n=1024, block_e=64)


def test_segment_sum_autotune_fits_budget():
    for A in (1, 16, 64, 128, 500, 4096):
        for E in (1, 64, 2048, 100_000):
            bn, be = ss_ops.autotune_blocks(A, E, 866)
            g = ss_ops.edge_groups(bn, be)
            assert 1 <= g <= 8
            assert ss_ops.smem_bytes(bn, be, g) <= budget.SMEM_BUDGET
            assert 1 <= bn <= max(A, 1) and 1 <= be <= max(E, 1)


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
    for A in (8, 16, 64, 128, 512, 1024):
        for E in (1, 40, 256, 2048, 8192):
            be, bh = budget.plan_blocks(A, E, H)
            assert budget.smem_bytes(A, min(be, E), bh) <= budget.SMEM_BUDGET
            assert bh % 32 == 0 and be >= 1
            budget.check_blocks(A, E, H, be, bh)      # planned => valid
            g = budget.plan_groups(A, min(be, E), bh)
            assert 1 <= g <= 8 and g * bh <= budget.MAX_THREADS
            assert budget.smem_bytes(A, min(be, E), bh, g) <= \
                budget.SMEM_BUDGET


def test_over_budget_overrides_raise():
    with pytest.raises(budget.SmemBudgetError):
        budget.check_blocks(1024, 2048, 866, 2048, 512)
    with pytest.raises(budget.SmemBudgetError):
        edge_ops.egnn_edge_agg(torch.zeros(1, 1024, 866),
                               torch.zeros(1, 1024, 3),
                               torch.zeros(1, 64, dtype=torch.int32),
                               torch.zeros(1, 64, dtype=torch.int32),
                               torch.ones(1, 64, dtype=torch.bool),
                               {}, block_e=64, block_h=512)
    with pytest.raises(budget.SmemBudgetError, match="node-dimension"):
        budget.plan_blocks(4096, 2048, 866)
    with pytest.raises(ValueError, match="multiple of 32"):
        budget.check_blocks(64, 2048, 866, 64, 48)
    with pytest.raises(ValueError, match="multiple of 32"):
        budget.check_blocks(64, 2048, 866, 64, 1024)
    items = budget.smem_items(64, 2048, 64)
    assert items["acc"] == 4 * 64 * 64 and items["window"] == 12 * 2048
