"""The port's bf16 GNN path against ``repro``'s, on the CPU.

``repro`` runs hydragnn-gfm's trunk in a compute dtype: its fused edge op
(``egnn_edge_agg(compute_dtype=bf16)``) runs the φ_e products in bf16 and
sums the messages in f32, its backward recomputes z in bf16 and runs the
chain rule in f32. The port takes the same compute dtype (on the card
through the bf16 variants of #3 and #4, ``csrc/gemm_bf16.cuh``; here
through the plain versions) and is held to ``repro`` on the same inputs,
made with numpy:

  * the edge op, output and every cotangent (h, pos, φ_e), against
    ``repro``'s Pallas kernel in interpret mode at B=2, E=100, A=16, H=96
    with ragged blocks; cotangents in their primals' dtypes;
  * ``egnn_apply`` at ``smoke()`` in bf16, every impl, against ``repro``'s
    ``"fused"``;
  * one ``multitask_grad_fn`` step in bf16: loss, per-task loss and every
    gradient leaf;
  * ``ServeSession`` at a 16-wide model in bf16: energies and forces, and
    batched rows bitwise equal to ``predict_one``.

Tolerance: 4e-2 x max(1, max|ref|), ``repro``'s own for bf16
(tests/test_egnn_paper_shape.py): both sides round to bf16, at other
points (``repro`` rounds z and silu(z) per edge, the port's plain path too
but with its own gathers and sums). Measured on the CPU: the edge op's
output 4.6e-3 and cotangents up to 2.0e-3 scaled; the trunk up to 1.1e-2;
a step's leaves up to 4.9e-4, its loss 2.5e-6 and per-task losses
1.5e-5; serving 7.9e-4 (energy) and 1.4e-2 (forces). Each cotangent and
gradient leaf is also held to its own size, |port - repro| / |repro| in
2-norms: the edge op's within 4e-2 (measured up to 1.8e-3), a step's
within 0.1 (measured up to 4.5e-2 on a leaf of entries below 2.4e-3,
where ``repro``'s own bf16 step differs from its f32 step by 3.9e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hydragnn_gfm as j_gfm
from repro.configs.base import ArchConfig as JArchConfig
from repro.core.mtl import make_gfm_mtl as j_make_gfm_mtl
from repro.data import synthetic_atoms as j_atoms
from repro.data.bucketing import BucketSpec as JBucketSpec
from repro.data.loader import GroupBatcher as JGroupBatcher
from repro.engine import multitask_grad_fn as j_grad_fn
from repro.kernels.egnn_edge import ops as j_edge_ops
from repro.models import gnn as j_gnn
from repro.serve import ServeSession as JServeSession

from repro_torch import interop
from repro_torch.configs import hydragnn_gfm as t_gfm
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mtl import make_gfm_mtl
from repro_torch.data import synthetic_atoms as t_atoms
from repro_torch.data.bucketing import BucketSpec
from repro_torch.engine import multitask_grad_fn
from repro_torch.kernels.egnn_edge import ops as edge_ops
from repro_torch.models import gnn
from repro_torch.serve import ServeSession

TOL = 4e-2
T = 3


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


def _edge_case(B=2, E=100, A=16, H=96, seed=0):
    """tests/test_egnn_paper_shape.py's kind of inputs, from numpy: masked
    and sentinel (dst == A) edges, a cotangent probe."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, A, H)).astype(np.float32)
    pos = (2.0 * rng.standard_normal((B, A, 3))).astype(np.float32)
    src = rng.integers(0, A, (B, E)).astype(np.int32)
    dst = rng.integers(0, A + 1, (B, E)).astype(np.int32)
    em = (rng.random((B, E)) < 0.85) & (dst < A)
    phi = {"fc0": {"w": (rng.standard_normal((2 * H + 1, H))
                         / np.sqrt(2 * H + 1)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(H)).astype(np.float32)},
           "fc1": {"w": (rng.standard_normal((H, H))
                         / np.sqrt(H)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(H)).astype(np.float32)}}
    gw = rng.standard_normal((B, A, H)).astype(np.float32)
    return h, pos, src, dst, em, phi, gw


NAMES = ("h", "pos", "fc0.w", "fc0.b", "fc1.w", "fc1.b")


@functools.cache
def _edge_run(h_dtype, pos_grad=True):
    """The bf16 edge op's output and cotangents in the port and in
    ``repro``'s Pallas kernel (interpret mode), ragged blocks (repro:
    block_e=48, block_h=40; the port: block_e=48, block_h=32, a warp's
    columns), h in ``h_dtype``; with ``pos_grad`` False pos is no leaf.
    Returns (out, want, [(name, primal dtype, cotangent, repro's)])."""
    h, pos, src, dst, em, phi, gw = _edge_case()
    jh = jnp.asarray(h).astype(getattr(jnp, h_dtype))
    jphi = jax.tree_util.tree_map(jnp.asarray, phi)

    def jloss(hh, pp, ww):
        o = j_edge_ops.egnn_edge_agg(hh, pp, jnp.asarray(src),
                                     jnp.asarray(dst), jnp.asarray(em), ww,
                                     compute_dtype=jnp.bfloat16, block_e=48,
                                     block_h=40, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * gw), o

    (_, want), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if pos_grad else (0, 2), has_aux=True)(
            jh, jnp.asarray(pos), jphi)
    th = torch.from_numpy(h).to(getattr(torch, h_dtype)).requires_grad_()
    tpos = torch.from_numpy(pos).requires_grad_(pos_grad)
    tphi = {k: {n: torch.from_numpy(a).requires_grad_() for n, a in v.items()}
            for k, v in phi.items()}
    out = edge_ops.egnn_edge_agg(th, tpos, torch.from_numpy(src),
                                 torch.from_numpy(dst), torch.from_numpy(em),
                                 tphi, compute_dtype=torch.bfloat16,
                                 block_e=48, block_h=32)
    leaves = [th, tpos] + [tphi[k][n] for k in ("fc0", "fc1")
                           for n in ("w", "b")]
    jleaves = [jg[0], jg[1] if pos_grad else None] + [
        jg[-1][k][n] for k in ("fc0", "fc1") for n in ("w", "b")]
    names = list(NAMES)
    if not pos_grad:
        del leaves[1], jleaves[1], names[1]
    got = torch.autograd.grad((out.float() * torch.from_numpy(gw)).sum(),
                              leaves)
    return out.detach(), np.asarray(want, np.float32), [
        (n, t.dtype, g, np.asarray(j, np.float32))
        for n, t, g, j in zip(names, leaves, got, jleaves)]


def _rel_norm(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("h_dtype", ["bfloat16", "float32"])
def test_edge_agg_bf16_matches_repro_kernel(h_dtype):
    """Forward and every cotangent of the bf16 edge op against ``repro``'s
    Pallas kernel (interpret mode) with ragged blocks. Measured: output
    4.6e-3 scaled, cotangents up to 2.0e-3."""
    out, want, grads = _edge_run(h_dtype)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), want, "forward")
    for name, dtype, g, j in grads:
        assert g.dtype == dtype, name             # the primal's dtype
        _close(g.float().numpy(), j, name)


@pytest.mark.parametrize("h_dtype", ["bfloat16", "float32"])
def test_edge_agg_bf16_cotangents_within_own_size(h_dtype):
    """Each cotangent of the bf16 edge op held to its own size,
    |port - repro| / |repro| (2-norms) within ``TOL``, which the
    max(1, ·) scale does not do for a cotangent of small entries
    (fc1.b's, pos's). Measured: up to 1.8e-3 (h), fc1.b 0."""
    _, _, grads = _edge_run(h_dtype)
    for name, _, g, j in grads:
        rel = _rel_norm(g.float().numpy(), j)
        assert rel <= TOL, f"{name}: {rel} > {TOL}"


@pytest.mark.parametrize("h_dtype", ["bfloat16", "float32"])
def test_edge_agg_bf16_without_pos_gradient(h_dtype):
    """pos no leaf (the backward computes no dpos): the cotangents of h
    and φ_e as with it, in their primals' dtypes, each against ``repro``'s
    scaled and to its own size."""
    _, _, grads = _edge_run(h_dtype, pos_grad=False)
    _, _, with_pos = _edge_run(h_dtype)
    assert [n for n, *_ in grads] == [n for n in NAMES if n != "pos"]
    for (name, dtype, g, j), (_, _, g_pos, _) in zip(
            grads, [x for x in with_pos if x[0] != "pos"]):
        assert g.dtype == dtype, name
        _close(g.float().numpy(), j, name)
        assert _rel_norm(g.float().numpy(), j) <= TOL, name
        assert torch.equal(g, g_pos), name        # dpos changes no other


@pytest.fixture(scope="module")
def smoke_bf16():
    jcfg = j_gfm.smoke().replace(compute_dtype=jnp.bfloat16)
    params = j_make_gfm_mtl(jcfg, T).init(jax.random.PRNGKey(0))
    data = j_atoms.generate_all(4, max_atoms=jcfg.max_atoms,
                                max_edges=jcfg.max_edges, seed=0,
                                sources=["ani1x"])
    jb = j_atoms.to_batch_dict(data["ani1x"], np.arange(4))
    keys = ("species", "pos", "edge_src", "edge_dst", "node_mask",
            "edge_mask")
    jb = {k: jb[k] for k in keys}
    tb = {k: torch.from_numpy(np.array(jb[k])) for k in keys}
    want = np.asarray(j_gnn.egnn_apply(params["shared"], jb, cfg=jcfg,
                                       impl="fused"), np.float32)
    return params, tb, want


@pytest.mark.parametrize("impl", gnn.SEGMENT_SUM_IMPLS)
def test_egnn_apply_bf16_matches_repro_fused(smoke_bf16, impl):
    """The trunk at ``smoke()`` in bf16 compute, every impl, against
    ``repro``'s fused trunk (measured ≤ 1.1e-2 scaled; ``repro``'s own
    bf16 against its f32 differs by 9.3e-3)."""
    params, tb, want = smoke_bf16
    cfg = t_gfm.smoke().replace(compute_dtype=torch.bfloat16)
    got = gnn.egnn_apply(interop.to_torch(params)["shared"], tb, cfg=cfg,
                         impl=impl)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, impl)


@pytest.fixture(scope="module")
def sources():
    cfg = j_gfm.smoke()
    return j_atoms.source_dicts(j_atoms.generate_all(
        12, max_atoms=cfg.max_atoms, max_edges=cfg.max_edges, seed=0))[:T]


STEP_NORM_TOL = 0.1


@pytest.fixture(scope="module")
def steps_bf16(sources):
    """One ``multitask_grad_fn`` step in bf16 compute (fp32 params) in
    ``repro`` (its Pallas kernels in interpret mode) and, per impl, in the
    port, on the same params and batch."""
    jcfg = j_gfm.smoke().replace(segment_sum_impl="fused",
                                 compute_dtype=jnp.bfloat16)
    jmodel = j_make_gfm_mtl(jcfg, T)
    params = jmodel.init(jax.random.PRNGKey(1))
    batch = JGroupBatcher(sources, 4, seed=2).next_batch()
    jl, jm, jg = jax.jit(j_grad_fn(jmodel, T))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    want = (jl, jm, interop.leaves(jax.tree_util.tree_map(np.asarray, jg)))
    got = {}
    for impl in ("fused", "jnp"):
        tcfg = t_gfm.smoke().replace(segment_sum_impl=impl,
                                     compute_dtype=torch.bfloat16)
        tl, tm, tg = multitask_grad_fn(make_gfm_mtl(tcfg, T), T)(
            interop.to_torch(params),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        got[impl] = (tl, tm, interop.leaves(tg))
    return got, want


@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_one_step_bf16_matches_repro(steps_bf16, impl):
    """One ``multitask_grad_fn`` step in bf16 compute (fp32 params): loss,
    per-task loss and every gradient leaf against ``repro``'s step with
    its Pallas kernels in interpret mode (measured: leaves ≤ 4.9e-4
    scaled, the loss 2.5e-6)."""
    (tl, tm, got), (jl, jm, want) = steps_bf16[0][impl], steps_bf16[1]
    _close(tl.numpy(), jl, "loss")
    _close(tm["per_task_loss"].numpy(), jm["per_task_loss"],
           "per_task_loss")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k   # params stay fp32
        _close(got[k].numpy(), v, k)


@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_one_step_bf16_leaves_within_own_size(steps_bf16, impl):
    """Each gradient leaf of the bf16 step held to its own size,
    |port - repro| / |repro| (2-norms) within ``STEP_NORM_TOL``: most
    leaves' entries are far below 1, where the max(1, ·) scale holds
    nothing. Measured: up to 4.5e-2 (heads/force/fc0/w, entries up to
    2.4e-3), where ``repro``'s own bf16 step differs from its f32 step by
    3.9e-2; a zero or wrong leaf reads ~1."""
    (_, _, got), (_, _, want) = steps_bf16[0][impl], steps_bf16[1]
    for k, v in want.items():
        rel = _rel_norm(got[k].numpy(), v)
        assert rel <= STEP_NORM_TOL, f"{k}: {rel} > {STEP_NORM_TOL}"


JCFG = JArchConfig(name="serve-bf16", family="gnn", gnn_hidden=16,
                   gnn_layers=2, n_species=64, head_hidden=8, head_layers=2,
                   remat=False, compute_dtype=jnp.bfloat16,
                   segment_sum_impl="fused")
CFG = ArchConfig(name="serve-bf16", gnn_hidden=16, gnn_layers=2,
                 n_species=64, head_hidden=8, head_layers=2,
                 compute_dtype=torch.bfloat16, segment_sum_impl="fused")


@pytest.fixture(scope="module")
def served():
    sources = t_atoms.source_dicts(t_atoms.generate_mixture(
        40, max_atoms=16, max_edges=64))
    params = j_make_gfm_mtl(JCFG, len(sources)).init(jax.random.PRNGKey(0))
    jobs = [(t, {k: sources[t][k][i] for k in (
        "species", "pos", "edge_src", "edge_dst", "node_mask", "edge_mask")})
        for t in range(len(sources)) for i in range(2)]
    return params, jobs


def test_serving_bf16_matches_repro(served):
    """``ServeSession`` in bf16 compute against ``repro``'s: energies and
    forces (measured 7.9e-4 and 1.4e-2 scaled)."""
    params, jobs = served
    with JServeSession(params, JCFG, spec=JBucketSpec((8, 16), (32, 64)),
                       max_batch=4, max_wait_ms=2.0) as ref, \
            ServeSession(params, CFG, spec=BucketSpec((8, 16), (32, 64)),
                         max_batch=4, max_wait_ms=2.0, device="cpu") as srv:
        want = [f.result(timeout=120) for f in
                [ref.submit(sm, head=t) for t, sm in jobs]]
        got = [f.result(timeout=120) for f in
               [srv.submit(sm, head=t) for t, sm in jobs]]
    for (t, _), g, w in zip(jobs, got, want):
        _close(g["energy"], w["energy"], f"energy head {t}")
        assert g["forces"].shape == w["forces"].shape
        _close(g["forces"], w["forces"], f"forces head {t}")


def test_serving_bf16_rows_bitwise_equal_predict_one(served):
    params, jobs = served
    with ServeSession(params, CFG, spec=BucketSpec((8, 16), (32, 64)),
                      max_batch=4, max_wait_ms=2.0, device="cpu") as srv:
        futs = [(t, sm, srv.submit(sm, head=t)) for t, sm in jobs]
        for t, sm, fut in futs:
            got = fut.result(timeout=60)
            one = srv.predict_one(sm, head=t)
            assert got["energy"] == one["energy"], (t, got, one)
            np.testing.assert_array_equal(got["forces"], one["forces"])


def test_cuda_checks_take_float32_and_bfloat16_only():
    """float16 is no compute dtype of the card's kernels: the CUDA checks
    refuse it (tests/test_torch_cuda.py holds the launch); the dtype set
    they accept is float32 and bfloat16."""
    assert edge_ops.COMPUTE_DTYPES == (torch.float32, torch.bfloat16)
    h = torch.zeros(1, 2, 4, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        edge_ops._check_cuda("egnn_edge", h, ())
