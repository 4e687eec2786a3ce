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
from repro_torch.kernels.egnn_edge import budget
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
        g = budget.plan_groups(A_, min(be, E_), bh, bwd=True)
        assert budget.smem_bytes(A_, min(be, E_), bh, g, bwd=True) <= \
            budget.SMEM_BUDGET
        assert budget.dpos_smem_bytes(A_, min(be, E_)) <= budget.SMEM_BUDGET
    # the backward keeps two per-node partials: an override that fits the
    # forward can be over the backward's budget — it raises when a gradient
    # is needed, and only then
    A_, E_, H_, be, bh = 500, 256, 866, 256, 64
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
