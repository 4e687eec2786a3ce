"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device. This file imports neither ``jax`` nor ``repro``,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 x max(1, |ref|) for segment-sum (f32 sums in another
order); 1e-4 x max(1, |ref|) for the fused edge kernel (node projections
group the 2H+1- and H-term contractions differently), 4e-2 x max(1, |ref|)
in bf16 compute (``repro``'s own bf16 tolerance: the kernel and the plain
version round to bf16 at other points); its bf16 backward is bitwise
equal to its f32 one on the upcast values; 1e-4 x max|ref| per
output for its backward (the same regrouping, and weight gradients summed
over up to B·A nodes in another order). Attention kernels (#5 flash
attention, #6 flash decode): 2e-5 x max(1, |ref|) in f32 (online softmax
summed in another order); in bf16, per element, that plus 2^-7 |ref|: both
sides compute in f32 from the same bf16 inputs and round once to bf16,
which moves a value by at most 1 ulp, at most 2^-7 of it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.egnn_edge import egnn_edge_agg, egnn_edge_agg_ref
from repro_torch.kernels.egnn_edge import ops as edge_ops
from repro_torch.kernels.egnn_edge.ops import egnn_edge_bwd
from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import (Plan, combine_partials,
                                              decode_partials_ref,
                                              decode_ref, flash_decode,
                                              plan_call, plan_splits)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
from repro_torch.models import transformer
from repro_torch.models.mlp import mlp_init
from repro_torch.train.serve import greedy_generate

PAD = -(10 ** 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _edges(rng, B, E, A, dev):
    src = torch.from_numpy(rng.integers(0, A, (B, E))).to(dev)
    dst = torch.from_numpy(rng.integers(0, A + 1, (B, E))).to(dev)  # A: pad
    em = torch.from_numpy(rng.random((B, E)) < 0.8).to(dev) & (dst < A)
    return src, dst, em


def _trace(call, short, iters=4):
    """The CUDA events (``count`` > 0) of a ``torch.profiler`` trace of
    ``iters`` calls. The profiler on the card drops an event now and then
    and never adds one: while ``short(events)`` says a count is under its
    expected value the trace is taken again, three traces at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and ev.count]
        if not short(events):
            break
    return events


def _kernel_counts(events):
    return {ev.key.split("(")[0].split("<")[0].split()[-1]: ev.count
            for ev in events}


def _traced_counts(call, want):
    """Kernel counts by name over 4 calls, traced again while one of
    ``want``'s is under its value (``_trace``)."""
    return _kernel_counts(_trace(call, lambda evs: any(
        _kernel_counts(evs).get(k, 0) < n for k, n in want.items())))


def _close(got, ref, tol):
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,A,F", [(3, 300, 33, 200), (1, 64, 8, 130),
                                     (8, 2048, 64, 866)])
def test_segment_sum_kernel_matches_plain(cuda, B, E, A, F):
    rng = np.random.default_rng(0)
    msg = torch.from_numpy(rng.standard_normal((B, E, F), np.float32)).to(cuda)
    _, dst, em = _edges(rng, B, E, A, cuda)
    before = segment_sum.launches
    got = segment_sum(msg, dst, A, edge_mask=em)
    assert segment_sum.launches == before + 1
    ref = segment_sum_ref(msg, torch.where(em, dst, A), A)
    _close(got, ref, 1e-5)
    # deterministic: the same call gives the same bits
    assert torch.equal(got, segment_sum(msg, dst, A, edge_mask=em))
    got_bf16 = segment_sum(msg.bfloat16(), dst, A, edge_mask=em)
    assert got_bf16.dtype == torch.bfloat16
    _close(got_bf16.float(), segment_sum_ref(msg.bfloat16(), torch.where(
        em, dst, A), A).float(), 1e-2)


def _ss_inputs(rng, B, E, A, F, dev, dtype=torch.float32):
    msg = torch.from_numpy(rng.standard_normal((B, E, F), np.float32))
    _, dst, em = _edges(rng, B, E, A, dev)
    return msg.to(dev).to(dtype), dst, em


def _ss_check(got, msg, dst, A, tol):
    ref = segment_sum_ref(msg, dst, A)
    assert got.dtype == msg.dtype and got.shape == ref.shape
    _close(got.float(), ref.float(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("F", [866, 868, 867, 5])
def test_segment_sum_kernel_windows_and_scalar_path(cuda, F, dtype, tol):
    """E over several dst windows (partial sums carried), and an odd F
    (the scalar-load instantiation), against the plain version; the
    result does not depend on the window or the node block."""
    rng = np.random.default_rng(3)
    msg, dst, em = _ss_inputs(rng, 2, 5000, 64, F, cuda, dtype)
    routed = torch.where(em, dst, 64)
    got = segment_sum(msg, dst, 64, edge_mask=em, block_e=1024)
    _ss_check(got, msg, routed, 64, tol)
    for bn, be in ((None, None), (4, 1024), (64, 333), (7, 5000)):
        assert torch.equal(got, segment_sum(msg, routed, 64, block_n=bn,
                                            block_e=be)), (bn, be)


@pytest.mark.gpu
def test_segment_sum_kernel_masked_negative_and_out_of_range_dst(cuda):
    rng = np.random.default_rng(4)
    msg, dst, em = _ss_inputs(rng, 3, 700, 20, 64, cuda)
    # every edge masked: zeros, one launch
    before = segment_sum.launches
    out = segment_sum(msg, dst, 20, edge_mask=torch.zeros_like(em))
    assert segment_sum.launches == before + 1
    assert torch.equal(out, torch.zeros_like(out))
    # negative and past-the-end dst contribute nothing
    wild = dst.clone()
    wild[:, ::3] = -1
    wild[:, 1::7] = -(2 ** 31)
    wild[:, 2::5] = 2 ** 31 - 1
    _ss_check(segment_sum(msg, wild, 20), msg, wild, 20, 1e-5)
    for bn in (1, 3, 20):
        assert torch.equal(segment_sum(msg, wild, 20, block_n=bn),
                           segment_sum(msg, wild, 20))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_rows_independent_of_the_batch(cuda, dtype):
    """Row b of a batched call is bitwise equal to a call on graph b alone
    (3-D with B=1 and 2-D): a sum's order is the edge order alone."""
    rng = np.random.default_rng(5)
    msg, dst, em = _ss_inputs(rng, 8, 2048, 64, 866, cuda, dtype)
    got = segment_sum(msg, dst, 64, edge_mask=em)
    for b in range(8):
        one = segment_sum(msg[b:b + 1], dst[b:b + 1], 64,
                          edge_mask=em[b:b + 1])
        two_d = segment_sum(msg[b], dst[b], 64, edge_mask=em[b])
        assert torch.equal(got[b], one[0]) and torch.equal(got[b], two_d), b


@pytest.mark.gpu
def test_segment_sum_kernel_one_launch_per_call(cuda):
    rng = np.random.default_rng(6)
    for B, E, A, F, kw in ((1, 2048, 64, 866, {}), (8, 2048, 64, 866, {}),
                           (2, 5000, 64, 866, {"block_e": 1024}),
                           (2, 300, 33, 7, {"block_n": 5})):
        msg, dst, em = _ss_inputs(rng, B, E, A, F, cuda)
        before = segment_sum.launches
        segment_sum(msg, dst, A, edge_mask=em, **kw)
        assert segment_sum.launches == before + 1, (B, E, A, F, kw)
    # no edges: zeros from one launch; no node: an empty result, no launch
    before = segment_sum.launches
    none = segment_sum(msg[:, :0], dst[:, :0], A)
    assert segment_sum.launches == before + 1
    assert none.shape == (2, A, F) and torch.equal(none,
                                                   torch.zeros_like(none))
    assert segment_sum(msg, dst, 0).shape == (2, 0, F)
    assert segment_sum.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_embed_backward_runs_on_segment_sum_2d(cuda, dtype, tol):
    """The embedding's backward (``models.common.embed``) on the card: one
    (E, F) launch of the segment-sum kernel (counted on ``two_d``, not on
    the batched count), against the plain version, the same bits twice;
    with E past the 2048-id window the plan takes the whole list in one
    window, bitwise equal to a carried 2048-id window."""
    from repro_torch.models import common
    rng = np.random.default_rng(7)
    V, d, shape = 3000, 256, (4, 1024)
    ids = torch.from_numpy((np.minimum(rng.zipf(1.2, shape), V) - 1)
                           .astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal(shape + (d,), np.float32)) \
        .to(cuda).to(dtype)
    grads = []
    for _ in range(2):
        t = torch.zeros((V, d), device=cuda, dtype=dtype,
                        requires_grad=True)
        two_d, batched = segment_sum.two_d.launches, segment_sum.launches
        common.embed({"table": t}, ids).backward(g)
        assert segment_sum.two_d.launches == two_d + 1
        assert segment_sum.launches == batched
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
    ref = segment_sum_ref(g.reshape(-1, d), ids.reshape(-1).long(), V)
    _close(grads[0].float(), ref.float(), tol)
    # the plain path ("jnp" trunk) launches nothing: the one-hot product
    t = torch.zeros((V, d), device=cuda, dtype=dtype, requires_grad=True)
    two_d = segment_sum.two_d.launches
    common.embed({"table": t}, ids, plain=True).backward(g)
    assert segment_sum.two_d.launches == two_d
    assert torch.equal(t.grad, ref)
    flat = ids.reshape(-1)
    assert torch.equal(segment_sum(g.reshape(-1, d), flat, V),
                       segment_sum(g.reshape(-1, d), flat, V, block_e=2048))


def _fwd_case(cuda, B, A, E, H, seed=1):
    rng = np.random.default_rng(seed)
    phi = mlp_init(rng, 2 * H + 1, H, H, 1, device=cuda)
    phi["fc0"]["b"] = torch.from_numpy(
        0.1 * rng.standard_normal(H, np.float32)).to(cuda)
    phi["fc1"]["b"] = torch.from_numpy(
        0.1 * rng.standard_normal(H, np.float32)).to(cuda)
    h = torch.from_numpy(rng.standard_normal((B, A, H), np.float32)).to(cuda)
    pos = torch.from_numpy(rng.standard_normal((B, A, 3), np.float32)).to(cuda)
    src, dst, em = _edges(rng, B, E, A, cuda)
    return h, pos, src, dst, em, phi


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(2, 10, 40, 24), (3, 40, 1000, 96),
                                     (8, 64, 2048, 866),
                                     (40, 64, 2048, 866),
                                     (8, 16, 512, 866)])   # a serve bucket
def test_egnn_edge_kernel_matches_plain(cuda, B, A, E, H):
    h, pos, src, dst, em, phi = _fwd_case(cuda, B, A, E, H)
    before = egnn_edge_agg.launches
    got = egnn_edge_agg(h, pos, src, dst, em, phi)
    assert egnn_edge_agg.launches == before + 1
    before_f32 = before
    _close(got, egnn_edge_agg_ref(h, pos, src, dst, em, phi), 1e-4)
    assert torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi))
    # bf16 is a compute dtype of the kernels, float16 is none
    before = egnn_edge_agg.bf16.launches
    assert egnn_edge_agg(h.bfloat16(), pos, src, dst, em, phi).dtype == \
        torch.bfloat16
    assert egnn_edge_agg.bf16.launches == before + 1
    assert egnn_edge_agg.launches == before_f32 + 2
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        egnn_edge_agg(h.half(), pos, src, dst, em, phi)


# bf16 #3 against its plain version in bf16, x max(1, |ref|): repro's own
# bf16 tolerance (both round to bf16, at other points: the kernel's z is
# f32, the plain version's bf16 per edge)
EDGE_BF16_TOL = 4e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(2, 10, 40, 24), (3, 40, 1000, 96),
                                     (8, 64, 2048, 866),
                                     (40, 64, 2048, 866),
                                     (8, 16, 512, 866)])   # a serve bucket
def test_egnn_edge_bf16_kernel_matches_plain(cuda, B, A, E, H):
    """#3 in bf16 compute (h bf16, the φ_e leaves f32 cast by the op)
    launches the bf16 forward alone, is within EDGE_BF16_TOL of
    ``egnn_edge_agg_ref`` at bf16 and gives the same bits twice; its
    scratch is f32."""
    h, pos, src, dst, em, phi = _fwd_case(cuda, B, A, E, H)
    h = h.bfloat16()
    f32, bf16 = egnn_edge_agg.launches, egnn_edge_agg.bf16.launches
    got = egnn_edge_agg(h, pos, src, dst, em, phi,
                        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert (egnn_edge_agg.launches, egnn_edge_agg.bf16.launches) == \
        (f32, bf16 + 1)
    ref = egnn_edge_agg_ref(h, pos, src, dst, em, phi,
                            compute_dtype=torch.bfloat16)
    _close(got.float(), ref.float(), EDGE_BF16_TOL)
    assert torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi,
                                          compute_dtype=torch.bfloat16))
    sr = torch.where(em, src, A).to(torch.int32)
    dr = torch.where(em, dst, A).to(torch.int32)
    w = (phi["fc0"]["w"], phi["fc0"]["b"], phi["fc1"]["w"], phi["fc1"]["b"])
    _, pi, pj, s, deg = edge_ops._launch_fwd(
        h, pos, sr, dr, *w, torch.bfloat16,
        *edge_ops._resolve_blocks(None, None, A, E, H))
    assert all(t.dtype == torch.float32 for t in (pi, pj, s, deg))
    with pytest.raises(ValueError, match="unsplit"):
        edge_ops._launch_fwd(h, pos, sr, dr, *w, torch.bfloat16,
                             *edge_ops._resolve_blocks(None, None, A, E, H),
                             splits=(2, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,blocks", [
    (8, 64, 2048, ((2048, 32), (2048, 128), (2048, 256), (300, 64),
                   (64, 32))),
    # a graph whose list crowds out a 256-column tile: unstaged tiles, and
    # windows of 2000 edges beside staged ones
    (2, 64, 16000, ((16000, 256), (2000, 256), (16000, 32)))])
def test_egnn_edge_kernel_bits_independent_of_blocks(cuda, B, A, E, blocks):
    """#3 sums S per node in edge order alone, so no output bit moves with
    block_h (the column tile, staged or not) or block_e (windows of the
    edge list, S and deg carried through global memory)."""
    from repro_torch.kernels.egnn_edge import budget
    H = 866
    h, pos, src, dst, em, phi = _fwd_case(cuda, B, A, E, H)
    base = egnn_edge_agg(h, pos, src, dst, em, phi)
    _close(base, egnn_edge_agg_ref(h, pos, src, dst, em, phi), 1e-4)
    staged = set()
    for be, bh in blocks:
        staged.add(bool(budget.smem_items(A, min(be, E), bh)["tiles"]))
        got = egnn_edge_agg(h, pos, src, dst, em, phi, block_e=be,
                            block_h=bh)
        assert torch.equal(base, got), (be, bh)
    if E > 2048:
        assert staged == {True, False}


@pytest.mark.gpu
def test_egnn_edge_kernel_rows_independent_of_the_batch(cuda):
    """A graph's rows are the same bits wherever it sits in a batch of one
    shape (the products' plan depends on B·A and H, not on the rows)."""
    h, pos, src, dst, em, phi = _fwd_case(cuda, 8, 64, 2048, 866)
    out = egnn_edge_agg(h, pos, src, dst, em, phi)
    roll = [torch.roll(x, 3, 0) for x in (h, pos, src, dst, em)]
    assert torch.equal(torch.roll(out, 3, 0), egnn_edge_agg(*roll, phi))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [40, 8])
def test_egnn_edge_kernels_a_call(cuda, B):
    """#3 is at most four kernel launches a call (GEMMs, edge kernel, GEMM
    and, when fc1 is split, its reduce), counted by torch.profiler on the
    card over 4 calls (traced again, three times at most, while a count
    is short: ``_trace``); every kernel is one of its own (no FFMA GEMM,
    no plain version)."""
    from repro_torch.kernels.egnn_edge import gemm_plan
    A, E, H = 64, 2048, 866
    h, pos, src, dst, em, phi = _fwd_case(cuda, B, A, E, H)
    sr = torch.where(em, src, A).to(torch.int32)
    dr = torch.where(em, dst, A).to(torch.int32)
    w = (phi["fc0"]["w"], phi["fc0"]["b"], phi["fc1"]["w"], phi["fc1"]["b"])
    blocks = edge_ops._resolve_blocks(None, None, A, E, H)

    def call():
        return edge_ops._launch_fwd(h, pos, sr, dr, *w, torch.float32,
                                    *blocks)
    call()
    torch.cuda.synchronize()
    gemms = len(gemm_plan.fwd_launches(B, A, H))
    assert gemms + 1 <= 4
    want = {"gemm_tc_kernel": 4 * gemms, "egnn_edge_fwd_kernel": 4}
    counts = _traced_counts(call, want)
    assert set(counts) == set(want), counts
    assert all(counts[k] <= n for k, n in want.items())


def _bwd_case(cuda, B, A, E, H, seed=2):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape).astype(np.float32)).to(cuda)

    w0, b0 = t(2 * H + 1, H, scale=(2 * H + 1) ** -0.5), t(H, scale=0.1)
    w1, b1 = t(H, H, scale=H ** -0.5), t(H, scale=0.1)
    h, pos, g = t(B, A, H), t(B, A, 3, scale=2.0), t(B, A, H)
    leaves = [h, pos, w0, b0, w1, b1]
    for x in leaves:
        x.requires_grad_(True)
    src, dst, em = _edges(rng, B, E, A, cuda)
    src[:, -3:], dst[:, -3:], em[:, -3:] = 1, A, True   # sentinel, unmasked
    return leaves, (src, dst, em), g


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(2, 10, 40, 24), (3, 40, 1000, 96),
                                     (8, 64, 2048, 866),
                                     (40, 64, 2048, 866)])
def test_egnn_edge_bwd_kernel_matches_plain(cuda, B, A, E, H):
    leaves, (src, dst, em), g = _bwd_case(cuda, B, A, E, H)
    h, pos, w0, b0, w1, b1 = leaves
    phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
    out = egnn_edge_agg(h, pos, src, dst, em, phi)
    before = egnn_edge_bwd.launches
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    assert egnn_edge_bwd.launches == before + 1
    sr = torch.where(em, src, A)
    dr = torch.where(em, dst, A)
    dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
        g, h.detach(), pos.detach(), sr, dr, w0[:H].detach(),
        w0[H:2 * H].detach(), w0[2 * H:].detach(), b0.detach()[None],
        w1.detach())
    want = [dh, dpos, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
    for name, a, b in zip(("h", "pos", "w0", "b0", "w1", "b1"), got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)
    # deterministic: the same backward gives the same bits
    again = torch.autograd.grad(out, leaves, g, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # pos needing no gradient skips dpos and leaves the rest bitwise as is
    out = egnn_edge_agg(h, pos.detach(), src, dst, em, phi)
    no_pos = torch.autograd.grad(out, [h, w0, b0, w1, b1], g,
                                 retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(no_pos, got[:1] + got[2:]))
    again = torch.autograd.grad(out, [h, w0, b0, w1, b1], g)
    assert all(torch.equal(a, b) for a, b in zip(no_pos, again))


@pytest.mark.gpu
@pytest.mark.parametrize("B,need_dpos", [(40, False), (8, True)])
def test_egnn_edge_bwd_kernels_a_call(cuda, B, need_dpos):
    """#4 is at most three kernel launches a call without dpos (GEMMs, edge
    kernel, GEMMs) and four with, counted by torch.profiler on the card
    over 4 calls (traced again, three times at most, while a count is
    short: ``_trace``); every kernel is one of its own."""
    A, E, H = 64, 2048, 866
    leaves, (src, dst, em), g = _bwd_case(cuda, B, A, E, H)
    h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
    sr = torch.where(em, src, A).to(torch.int32)
    dr = torch.where(em, dst, A).to(torch.int32)
    _, pi, pj, s, deg = edge_ops._launch_fwd(
        h, pos, sr, dr, w0, b0, w1, b1, torch.float32,
        *edge_ops._resolve_blocks(None, None, A, E, H))
    be, bh = edge_ops._resolve_blocks(None, None, A, E, H, bwd=True)

    def call():
        return egnn_edge_bwd(g, h, pos, sr, dr, w0, w1, pi, pj, s, deg,
                             block_e=be, block_h=bh, need_dpos=need_dpos)
    call()
    torch.cuda.synchronize()
    want = {"gemm_tc_kernel": 8, "egnn_edge_bwd_kernel": 4}
    if need_dpos:
        want["egnn_edge_dpos_kernel"] = 4
    counts = _traced_counts(call, want)
    assert set(counts) == set(want)
    assert all(counts[k] <= n for k, n in want.items())


@pytest.mark.gpu
def test_egnn_edge_bwd_bits_independent_of_blocks(cuda):
    """#4 sums dPi and dPj in edge order alone, so no output moves with
    block_e, and only dw0d (per-warp shares) with block_h."""
    A, E, H = 64, 2048, 866
    leaves, (src, dst, em), g = _bwd_case(cuda, 8, A, E, H)
    h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
    sr = torch.where(em, src, A).to(torch.int32)
    dr = torch.where(em, dst, A).to(torch.int32)
    _, pi, pj, s, deg = edge_ops._launch_fwd(
        h, pos, sr, dr, w0, b0, w1, b1, torch.float32,
        *edge_ops._resolve_blocks(None, None, A, E, H))

    def call(be, bh):
        return egnn_edge_bwd(g, h, pos, sr, dr, w0, w1, pi, pj, s, deg,
                             block_e=be, block_h=bh)
    base = call(512, 32)
    for be in (128, 2048):
        assert all(torch.equal(a, b) for a, b in zip(base, call(be, 32)))
    wide = call(512, 64)
    for i in (0, 1, 3, 4, 5):                     # dh, dpos, db0, dw1, db1
        assert torch.equal(base[i], wide[i])
    assert torch.equal(base[2][:2 * H], wide[2][:2 * H])
    _close(wide[2][2 * H:], base[2][2 * H:], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H,need_dpos", [(40, 64, 2048, 866, False),
                                               (8, 64, 2048, 866, True),
                                               (3, 40, 1000, 96, True)])
def test_egnn_edge_bwd_bf16_bitwise_equals_f32_on_upcast(cuda, B, A, E, H,
                                                         need_dpos):
    """#4 on bf16 g, h and weights (read as they are, converted where they
    are staged) gives the bits of #4's f32 launch on their f32 copies: the
    f32 math is the same, and a bf16 value is exact in f32 and TF32. Each
    launch counts on its own counter."""
    leaves, (src, dst, em), g = _bwd_case(cuda, B, A, E, H)
    h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
    hb, gb, w0b, b0b, w1b, b1b = (x.bfloat16() for x in (h, g, w0, b0, w1,
                                                         b1))
    sr = torch.where(em, src, A).to(torch.int32)
    dr = torch.where(em, dst, A).to(torch.int32)
    _, pi, pj, s, deg = edge_ops._launch_fwd(
        hb, pos, sr, dr, w0b, b0b, w1b, b1b, torch.bfloat16,
        *edge_ops._resolve_blocks(None, None, A, E, H))
    be, bh = edge_ops._resolve_blocks(None, None, A, E, H, bwd=True)
    f32, bf16 = egnn_edge_bwd.launches, egnn_edge_bwd.bf16.launches
    got = egnn_edge_bwd(gb, hb, pos, sr, dr, w0b, w1b, pi, pj, s, deg,
                        block_e=be, block_h=bh, need_dpos=need_dpos)
    assert (egnn_edge_bwd.launches, egnn_edge_bwd.bf16.launches) == \
        (f32, bf16 + 1)
    want = egnn_edge_bwd(gb.float(), hb.float(), pos, sr, dr, w0b.float(),
                         w1b.float(), pi, pj, s, deg, block_e=be, block_h=bh,
                         need_dpos=need_dpos)
    assert egnn_edge_bwd.launches == f32 + 1
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(TypeError, match="one dtype"):
        egnn_edge_bwd(gb.float(), hb, pos, sr, dr, w0b, w1b, pi, pj, s, deg,
                      block_e=be, block_h=bh)


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(3, 40, 1000, 96), (40, 64, 2048, 866)])
def test_egnn_edge_bwd_bf16_through_autograd_matches_plain(cuda, B, A, E, H):
    """#4 in bf16 compute through ``egnn_edge_agg``'s autograd Function, as
    the trunk calls it (a bf16 h leaf, f32 φ_e leaves, a bf16 cotangent):
    one bf16 backward launch, each cotangent in its primal's dtype and
    within 1e-4 x max|ref| of the plain version on the same bf16 values,
    dh also within the half ulp of its rounding to bf16."""
    leaves, (src, dst, em), g = _bwd_case(cuda, B, A, E, H)
    h = leaves[0].detach().bfloat16().requires_grad_(True)
    pos, w0, b0, w1, b1 = leaves[1:]
    phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
    out = egnn_edge_agg(h, pos, src, dst, em, phi,
                        compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    wrt = [h, pos, w0, b0, w1, b1]
    f32, bf16 = egnn_edge_bwd.launches, egnn_edge_bwd.bf16.launches
    got = torch.autograd.grad(out, wrt, g.bfloat16())
    assert (egnn_edge_bwd.launches, egnn_edge_bwd.bf16.launches) == \
        (f32, bf16 + 1)
    assert [x.dtype for x in got] == [x.dtype for x in wrt]
    w0b, b0b, w1b = (x.detach().bfloat16() for x in (w0, b0, w1))
    dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
        g.bfloat16(), h.detach(), pos.detach(), torch.where(em, src, A),
        torch.where(em, dst, A), w0b[:H], w0b[H:2 * H], w0b[2 * H:],
        b0b[None], w1b)
    want = [dh, dpos, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
    for name, a, b in zip(("h", "pos", "w0", "b0", "w1", "b1"), got, want):
        b = b.float()
        lim = 1e-4 * float(b.abs().max())
        if name == "h":
            lim = lim * (1 + 2.0 ** -8) + 2.0 ** -8 * b.abs()
        assert bool(((a.float() - b).abs() <= lim).all()), name


@pytest.mark.gpu
def test_egnn_edge_bwd_gemm_plan_fits_the_card(cuda):
    """The GEMM plan's model of the card holds: it keeps gemm_plan.SLOTS
    CTAs of the tensor-core GEMM resident at once."""
    from repro_torch.kernels.egnn_edge import gemm_plan
    slots = (edge_ops.gemm_blocks_per_sm()
             * torch.cuda.get_device_properties(0).multi_processor_count)
    assert slots >= gemm_plan.SLOTS


@pytest.mark.gpu
def test_segment_sum_kernel_refuses_grad(cuda):
    msg = torch.ones((1, 8, 4), device=cuda, requires_grad=True)
    dst = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="fused"):
        segment_sum(msg, dst, 2)
    with torch.no_grad():
        assert segment_sum(msg, dst, 2).shape == (1, 2, 4)


def _attn_close(got, ref):
    """Per element: |got - ref| <= 2e-5 x max(1, max|ref|), plus 2^-7 |ref|
    in bf16 (one rounding to bf16 moves a value by at most 1 ulp, and 1 ulp
    is at most 2^-7 of it)."""
    ref = ref.float()
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.abs()
    return bool(((got.float() - ref).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,window,rolled", [
    (2, 100, 100, 8, 2, 32, 0, False),      # GQA, ragged vs 64-tiles
    (1, 130, 130, 4, 4, 80, 37, True),      # rotated positions + pads
    (2, 64, 200, 32, 8, 80, 4096, False),   # Sq < Sk, the model's GQA
    (1, 1, 70, 6, 3, 128, 0, False),        # one query row
    # the bf16 tensor-core kernel's edges: every head dim, G = 1, 2, 4, 8,
    # lengths 1, 63, 65, 129 against the 64-row query and 64-key tiles
    (3, 1, 1, 4, 4, 16, 0, False),          # one query, one key, G = 1
    (2, 63, 63, 8, 4, 64, 0, False),        # G = 2
    (1, 65, 65, 8, 2, 96, 0, False),        # G = 4
    (1, 129, 129, 16, 2, 80, 0, False),     # G = 8
    (2, 65, 129, 8, 8, 16, 7, False),       # short window: skips both sides
    (1, 129, 63, 8, 1, 128, 0, False),      # Sq > Sk: rows see no key
    (1, 300, 300, 8, 2, 80, 40, True),      # rolled pads + window: rows with
                                            # dead first tiles (p = 1), then
                                            # skipped tiles
    # D = 192 (MLA prefill: q/k of nope 128 + rope 64, v padded to it) and
    # G = 3 (granite-moe: 24 query heads over 8 kv heads)
    (1, 130, 130, 8, 8, 192, 0, False),     # MHA at D = 192, ragged
    (2, 65, 129, 4, 2, 192, 7, True),       # D = 192, window, pads, G = 2
    (1, 129, 63, 4, 4, 192, 0, False),      # D = 192, rows see no key
    (2, 100, 100, 24, 8, 64, 0, False),     # G = 3
    (1, 300, 300, 6, 2, 80, 40, True),      # G = 3, rolled pads + window
    # zamba2-1.2b's shared attention: MHA (G = 1) at D = 64, windowed
    (2, 200, 200, 32, 32, 64, 4096, False),  # window inactive
    (1, 300, 300, 32, 32, 64, 128, True),    # window live, rolled pads
    # internvl2-1b: G = 7 (14 query heads over 2 kv heads) at D = 64
    (2, 100, 100, 14, 2, 64, 0, False),      # G = 7, ragged
    (1, 130, 130, 7, 1, 64, 40, True),       # G = 7, rolled pads + window
    # stablelm-12b: D = 160 at G = 4; gemma3-12b: D = 256 at G = 2, where
    # each CTA computes half the output columns
    (2, 100, 100, 32, 8, 160, 0, False),     # stablelm's heads, ragged
    (1, 300, 300, 8, 2, 160, 40, True),      # D = 160, rolled pads + window
    (1, 129, 63, 8, 2, 160, 0, False),       # D = 160, rows see no key
    (2, 130, 130, 16, 8, 256, 0, False),     # gemma3's heads, ragged
    (1, 300, 300, 4, 2, 256, 40, True),      # D = 256, rolled pads + window
    (2, 65, 129, 4, 4, 256, 7, False),       # D = 256, G = 1, short window
    (1, 129, 63, 8, 1, 256, 0, False),       # D = 256, G = 8, no key seen
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, K,
                                              D, window, rolled):
    rng = np.random.default_rng(Sq + Sk)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda, dt)
    q, k, v = t(B, Sq, H, D), t(B, Sk, K, D), t(B, Sk, K, D)
    kp = np.arange(Sk)
    if rolled:
        kp = (kp - Sk // 3) % Sk
        kp[::9] = PAD
    kp = torch.from_numpy(kp.astype(np.int32)).to(cuda)
    qp = torch.arange(Sk - Sq, Sk, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_pos=qp, k_pos=kp, window=window)
    assert flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == (B, Sq, H, D)
    ref = flash_attention_ref(q, k, v, qp, kp, window=window)
    assert _attn_close(got, ref)
    assert torch.equal(got, flash_attention(q, k, v, q_pos=qp, k_pos=kp,
                                            window=window))
    nc = flash_attention(q, k, v, q_pos=qp, k_pos=kp, causal=False)
    ref = flash_attention_ref(q, k, v, qp, kp, causal=False)
    assert _attn_close(nc, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,pos", [
    (2, 300, 300, 16, 16, "arange"),    # seamless's encoder: bidirectional
    (2, 130, 300, 16, 16, "zeros"),     # its cross-attention in prefill
    (2, 1, 300, 16, 16, "zeros"),       # ... at decode: one query row
    (2, 130, 257, 8, 4, "distinct"),    # distinct positions, pads
])
def test_flash_attention_kernel_cross_and_bidirectional(cuda, dtype, B, Sq,
                                                        Sk, H, K, pos):
    """#5 at D = 64 without a causal mask, where every tile is live: the
    encoder's shape, cross-attention with every position 0 (nothing
    masked), and, since equal positions would hide a wrong position test,
    distinct unordered positions with pads (every 7th key), there also
    causal."""
    rng = np.random.default_rng(Sq * Sk)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda, dt)
    q, k, v = t(B, Sq, H, 64), t(B, Sk, K, 64), t(B, Sk, K, 64)
    if pos == "arange":
        qp, kp = np.arange(Sq), np.arange(Sk)
    elif pos == "zeros":
        qp, kp = np.zeros(Sq), np.zeros(Sk)
    else:
        qp, kp = rng.integers(0, 1000, Sq), rng.integers(0, 1000, Sk)
        kp[::7] = PAD
    qp, kp = (torch.from_numpy(x.astype(np.int32)).to(cuda)
              for x in (qp, kp))
    for causal in (False, True) if pos == "distinct" else (False,):
        got = flash_attention(q, k, v, q_pos=qp, k_pos=kp, causal=causal)
        ref = flash_attention_ref(q, k, v, qp, kp, causal=causal)
        assert _attn_close(got, ref), causal
        assert torch.equal(got, flash_attention(q, k, v, q_pos=qp, k_pos=kp,
                                                causal=causal))


@pytest.mark.gpu
def test_flash_attention_kernel_refuses(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    pos = torch.arange(8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q, q_pos=pos, k_pos=pos)
    q = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, q, q, q_pos=pos, k_pos=pos)
    # rows are read by strides: a column slice is taken as it is, a
    # strided last axis is refused
    wide = torch.randn(1, 8, 2, 64, device=cuda)
    q = wide[..., :32]
    ref = flash_attention_ref(q, q, q, pos, pos)
    got = flash_attention(q, q, q, q_pos=pos, k_pos=pos)
    assert _attn_close(got, ref)
    q = wide[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q, q_pos=pos, k_pos=pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,n_splits,block_k", [
    (3, 1000, 32, 8, 80, None, None),       # the port's plan
    (3, 1000, 32, 8, 80, 8, 512),           # repro's defaults
    (2, 640, 8, 2, 64, 12, 64),             # trailing empty splits
    (1, 77, 16, 1, 32, 3, 16),              # MQA, G = 16, ragged
    (2, 1000, 32, 8, 80, 17, None),         # 2 splits a CTA, 9 CTAs
    (2, 1000, 32, 8, 80, 33, None),         # 3 splits a CTA, 11 CTAs
    (2, 700, 16, 1, 128, None, None),       # the largest instantiation
    (1, 700, 16, 1, 128, 40, 8),            # ... with 3 splits a CTA
    # G = 3 (granite-moe's 24 query heads over 8 kv heads)
    (8, 1056, 24, 8, 64, None, None),       # granite's decode shape
    (2, 1000, 6, 2, 80, 17, None),          # 2 splits a CTA
    (1, 77, 3, 1, 128, 3, 16),              # one kv head, ragged
    (2, 640, 3, 1, 16, 12, 64),             # trailing empty splits
    # zamba2-1.2b's shared attention: MHA (G = 1) at D = 64
    (8, 1056, 32, 32, 64, None, None),      # decode run (a)'s cache
    (1, 4200, 32, 32, 64, None, None),      # run (b)'s rolling cache
    # G = 7 (internvl2-1b's 14 query heads over 2 kv heads)
    (8, 1056, 14, 2, 64, None, None),       # internvl2's decode shape
    (2, 1000, 14, 2, 64, 17, None),         # 2 splits a CTA
    (1, 77, 7, 1, 128, 3, 16),              # one kv head, D = 128, ragged
    # stablelm-12b (D = 160, G = 4) and gemma3-12b (D = 256, G = 2) at
    # their decode shapes, then the other groups of those head dims (in
    # f32 at D = 256: two consumer warps, a ring of two stages)
    (8, 1056, 32, 8, 160, None, None),      # stablelm's decode shape
    (8, 1056, 16, 8, 256, None, None),      # gemma3's decode shape
    (2, 1000, 8, 2, 160, 17, None),         # D = 160, 2 splits a CTA
    (1, 77, 8, 8, 160, 3, 16),              # D = 160, G = 1, ragged
    (1, 300, 16, 2, 160, None, None),       # D = 160, G = 8
    (2, 640, 4, 2, 256, 12, 64),            # D = 256, trailing empty splits
    (1, 300, 4, 4, 256, None, None),        # D = 256, G = 1
    (1, 77, 8, 2, 256, 3, 16),              # D = 256, G = 4, ragged
    (1, 300, 8, 1, 256, None, None),        # D = 256, G = 8
])
def test_flash_decode_kernel_matches_plain(cuda, dtype, B, S, H, K, D,
                                           n_splits, block_k):
    rng = np.random.default_rng(S)
    dt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda, dt)
    q, k, v = t(B, 1, H, D), t(B, S, K, D), t(B, S, K, D)
    filled = rng.integers(S // 2, S + 1, B)
    kp = np.where(np.arange(S)[None] < filled[:, None], np.arange(S)[None],
                  PAD)
    kp[:, 64:128] = PAD                      # no valid key in rows 64-127
    kp = torch.from_numpy(kp.astype(np.int32)).to(cuda)
    qp = torch.from_numpy((filled - 1).astype(np.int32)).to(cuda)
    before = flash_decode.launches
    got = flash_decode(q, k, v, q_pos=qp, k_pos=kp, n_splits=n_splits,
                       block_k=block_k)
    assert flash_decode.launches == before + 1
    assert got.dtype == dt and got.shape == (B, 1, H, D)
    plan = plan_call(q, k, n_splits, block_k)
    if n_splits is not None:
        assert plan.n_splits == n_splits
    m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp,
                                    n_splits=plan.n_splits,
                                    per_split=plan.per_split)
    plain = combine_partials(m, l, acc).reshape(B, 1, H, D).to(dt)
    assert _attn_close(got, plain)
    ref = decode_ref(q, k, v, q_pos=qp, k_pos=kp)
    assert _attn_close(got, ref)
    again = flash_decode(q, k, v, q_pos=qp, k_pos=kp, n_splits=n_splits,
                         block_k=block_k)
    assert torch.equal(got, again)


def _decode_run_b(cuda):
    """LM decode run (b)'s shape: B=1, a rolling cache of 4200 slots at
    position 4210, the window (4096) folded into k_pos; bf16."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for shape in ((1, 1, 32, 80), (1, 4200, 8, 80),
                             (1, 4200, 8, 80)))
    j = torch.arange(4200, device=cuda)
    slot_pos = 4210 - torch.remainder(4210 - j, 4200)
    kp = torch.where(slot_pos > 4210 - 4096, slot_pos, PAD).to(torch.int32)
    qp = torch.full((1,), 4210, device=cuda, dtype=torch.int32)
    return q, k, v, qp, kp[None]


@pytest.mark.gpu
def test_flash_decode_kernel_decode_b_rolling(cuda):
    q, k, v, qp, kp = _decode_run_b(cuda)
    got = flash_decode(q, k, v, q_pos=qp, k_pos=kp)
    plan = plan_call(q, k)
    assert plan.cluster == plan.n_splits <= 16
    m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp,
                                    n_splits=plan.n_splits,
                                    per_split=plan.per_split)
    assert _attn_close(got, combine_partials(m, l, acc).reshape(
        1, 1, 32, 80).bfloat16())
    assert _attn_close(got, decode_ref(q, k, v, q_pos=qp, k_pos=kp))
    for _ in range(3):                       # replays give the same bits
        assert torch.equal(got, flash_decode(q, k, v, q_pos=qp, k_pos=kp))


@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [None, 1, 17, 33])
def test_flash_decode_kernel_one_launch_a_call(cuda, n_splits):
    """One kernel on the device a call, counted from a profiler trace
    (traced again, three times at most, while the count is short:
    ``_trace``)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for shape in ((8, 1, 32, 80), (8, 1056, 8, 80),
                             (8, 1056, 8, 80)))
    kp = torch.arange(1056, device=cuda, dtype=torch.int32)[None]
    qp = torch.full((8,), 1055, device=cuda, dtype=torch.int32)
    def call():
        flash_decode(q, k, v, q_pos=qp, k_pos=kp, n_splits=n_splits)
    call()
    torch.cuda.synchronize()
    kernels = _trace(call, lambda evs: sum(ev.count for ev in evs) < 4)
    assert [ev.key.split("<")[0].split()[-1] for ev in kernels] == [
        "flash_decode_kernel"]
    assert kernels[0].count == 4


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 1056), (1, 4200)])
def test_flash_decode_plan_matches_the_card(cuda, B, S):
    """At the LM decode shapes (runs (a) and (b)) the plan taken from the
    card's own occupancy (cudaOccupancyMaxActiveClusters) fits one wave
    on the card, and the CPU path (no occupancy limit) takes its splits and
    cluster; the card's counts are those of clusters that share the SMs
    (c CTAs a cluster take c CTA slots) and of a CTA that fits one SM."""
    q = torch.zeros(B, 1, 32, 80, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(B, S, 8, 80, device=cuda, dtype=torch.bfloat16)
    plan = plan_call(q, k)
    assert plan[:4] == plan_splits(B, 8, S)[:4]
    dev = q.device.index
    assert fd_ops.max_active_clusters(
        dev, torch.bfloat16, 4, 80, plan.cluster, plan.stages,
        plan.splits_per_cta) >= B * 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for st in fd_ops.STAGES:
        one = fd_ops.max_active_clusters(dev, torch.bfloat16, 4, 80, 1, st,
                                         1)
        assert one % sms == 0 and (one > 0) == (st % 8 == 0)
        for c in range(2, fd_ops.MAX_CLUSTER + 1):
            assert fd_ops.max_active_clusters(
                dev, torch.bfloat16, 4, 80, c, st, 1) * c <= one


@pytest.mark.gpu
def test_flash_decode_kernel_refuses(cuda):
    """What the kernel does not take raises: a cluster the card cannot
    place (the largest instantiation with an 8-stage ring: 270 KB of
    shared memory), G = 5, head dim 192 (prefill's only), head dims 160
    and 256 at a group they are not instantiated at, a misaligned row,
    float16."""
    q = torch.zeros(1, 1, 16, 128, device=cuda)
    k = torch.zeros(1, 64, 1, 128, device=cuda)
    pos = torch.zeros(1, device=cuda, dtype=torch.int32)
    kp = torch.zeros(1, 64, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot place"):
        fd_ops._launch(q, k, k, pos, kp, 0, 1.0, Plan(1, 64, 1, 1, 8))
    with pytest.raises(ValueError, match="query heads"):
        flash_decode(q[:, :, :5], k, k, q_pos=pos, k_pos=kp)
    q192 = torch.zeros(1, 1, 2, 192, device=cuda)
    k192 = torch.zeros(1, 64, 1, 192, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q192, k192, k192, q_pos=pos, k_pos=kp)
    # head dims 160 and 256 exist at G = 1, 2, 4, 8 only
    for D, G in ((160, 3), (256, 16), (256, 7)):
        qw = torch.zeros(1, 1, G, D, device=cuda, dtype=torch.bfloat16)
        kw = torch.zeros(1, 64, 1, D, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="not instantiated"):
            flash_decode(qw, kw, kw, q_pos=pos, k_pos=kp)
    wide = torch.zeros(1, 64, 1, 136, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        flash_decode(q, wide[..., 2:130], wide[..., 2:130], q_pos=pos,
                     k_pos=kp)
    with pytest.raises(TypeError, match="float32"):
        flash_decode(q.half(), k.half(), k.half(), q_pos=pos, k_pos=kp)


@pytest.mark.gpu
def test_flash_decode_kernel_rolling_window(cuda):
    """A rolling cache of 96 slots at position 200, the window (50) passed
    as an argument and folded into k_pos: both equal the plain version."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64), np.float32)).to(
        cuda)
    k, v = (torch.from_numpy(rng.standard_normal((2, 96, 2, 64),
                                                 np.float32)).to(cuda)
            for _ in range(2))
    j = np.arange(96)
    slot_pos = 200 - (200 - j) % 96
    folded = np.where(slot_pos > 150, slot_pos, PAD).astype(np.int32)
    ref = decode_ref(q, k, v, q_pos=torch.tensor([200, 200], device=cuda),
                     k_pos=torch.from_numpy(folded).to(cuda).expand(2, 96))
    for kp, w in ((folded, 0), (slot_pos.astype(np.int32), 50)):
        got = flash_decode(q, k, v, q_pos=200,
                           k_pos=torch.from_numpy(kp).to(cuda), window=w)
        assert _attn_close(got, ref)


@pytest.mark.gpu
def test_lm_greedy_generate_through_the_kernels(cuda):
    """h2o-danube smoke (2 layers, fp32 compute) on the card: the kernel
    path gives the plain path's tokens, one #5 launch per layer for the
    prefill and one #6 launch per layer and decode step."""
    cfg = get_smoke("h2o-danube-1.8b").replace(compute_dtype=torch.float32,
                                                window=16)
    params = transformer.lm_init(np.random.default_rng(0), cfg, device=cuda)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 40)).astype(np.int32))
    fa0, fd0 = flash_attention.launches, flash_decode.launches
    got = greedy_generate(params, cfg, prompt, 6, impl="pallas")
    assert flash_attention.launches - fa0 == cfg.n_layers
    assert flash_decode.launches - fd0 == cfg.n_layers * 5
    want = greedy_generate(params, cfg, prompt, 6, impl="chunked")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the multi-source pre-training path: bucket shapes and placed batches
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E", [(40, 32, 128), (40, 16, 64),
                                   (40, 24, 128), (40, 32, 64)])
def test_egnn_edge_kernels_match_plain_at_bucket_shapes(cuda, B, A, E):
    """#3 and #4 at the bucketed training shapes (5 sources x 8 graphs, or
    one mixed row of 40, trimmed to A <= 32, E <= 128): each output of the
    forward and each gradient of the backward against the plain versions,
    and bits over two calls of each."""
    H = 866
    h, pos, src, dst, em, phi = _fwd_case(cuda, B, A, E, H)
    got = egnn_edge_agg(h, pos, src, dst, em, phi)
    _close(got, egnn_edge_agg_ref(h, pos, src, dst, em, phi), 1e-4)
    assert torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi))
    leaves, (src, dst, em), g = _bwd_case(cuda, B, A, E, H)
    h, pos, w0, b0, w1, b1 = leaves
    out = egnn_edge_agg(h, pos.detach(), src, dst, em,
                        {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}})
    wrt = [h, w0, b0, w1, b1]
    got = torch.autograd.grad(out, wrt, g, retain_graph=True)
    again = torch.autograd.grad(out, wrt, g, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    sr, dr = torch.where(em, src, A), torch.where(em, dst, A)
    d = [x.detach() for x in leaves]
    dh, _, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
        g, d[0], d[1], sr, dr, d[2][:H], d[2][H:2 * H], d[2][2 * H:],
        d[3][None], d[4])
    want = [dh, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
    for name, a, b in zip(("h", "w0", "b0", "w1", "b1"), got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)


def _bucketed_sources():
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(16, max_atoms=64, max_edges=2048,
                                     seed=0))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["gfm-mtl", "gfm-baseline"])
def test_bucketed_training_grads_match_plain_on_the_card(cuda, model):
    """One bucketed batch at full width (MTL-All: 5 x 8 graphs; Baseline-All:
    one mixed row of 40) through the fused kernels against the plain path
    (``"jnp"``), per leaf within 1e-4 of its largest entry, and the fused
    gradients bitwise equal over two calls."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.data.bucketing import BucketingBatcher, BucketSpec
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.data.mixing import MixingBatcher
    from repro_torch.engine import build_model, multitask_grad_fn
    sources = _bucketed_sources()
    spec = BucketSpec.from_sources(sources, n_atom_buckets=3,
                                   n_edge_buckets=3)
    inner = GroupBatcher(sources, 8, seed=0) if model == "gfm-mtl" else \
        MixingBatcher(sources, 40, seed=0, task_major=True)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
             for k, v in BucketingBatcher(inner, spec).next_batch().items()}
    T = batch["pos"].shape[0]
    assert batch["pos"].shape[1] * T == 40 and batch["pos"].shape[2] <= 32
    grads = {}
    for impl in ("fused", "jnp", "fused"):
        m = build_model(model, CONFIG.replace(segment_sum_impl=impl),
                        n_tasks=T)
        params = m.init(0, cuda)
        loss, _, g = multitask_grad_fn(m, m.n_tasks)(params, batch)
        grads.setdefault(impl, []).append((float(loss), interop.leaves(g)))
    (lf, gf), (lf2, gf2) = grads["fused"]
    lj, gj = grads["jnp"][0]
    assert lf == lf2 and all(torch.equal(gf[k], gf2[k]) for k in gf)
    assert abs(lf - lj) <= 1e-4 * abs(lj)
    for k, ref in gj.items():
        assert float((gf[k] - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max()), k


@pytest.mark.gpu
def test_bucketing_batcher_over_the_cards_placed_batches(cuda, tmp_path):
    """A ``BucketingBatcher`` over a ``PrefetchingBatcher`` trims batches
    already on the card: the same values as the numpy trim, on the card,
    contiguous, with the same ``shapes_seen``."""
    from repro_torch.data.bucketing import BucketingBatcher, BucketSpec
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.data.store import (PrefetchingBatcher, ShardedSource,
                                        write_store)
    sources = _bucketed_sources()[:2]
    for i, s in enumerate(sources):
        write_store(str(tmp_path / f"s{i}"), s, shard_size=8)
    spec = BucketSpec.from_sources(sources, n_atom_buckets=3,
                                   n_edge_buckets=3)
    ref = BucketingBatcher(GroupBatcher(sources, 2, seed=3), spec)
    with PrefetchingBatcher([ShardedSource(str(tmp_path / f"s{i}"))
                             for i in range(2)], 2, seed=3,
                            device=cuda) as pb:
        placed = BucketingBatcher(pb, spec)
        for _ in range(10):
            got, want = placed.next_batch(), ref.next_batch()
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].device.type == "cuda" and \
                    got[k].is_contiguous()
                assert torch.equal(got[k].cpu(), torch.from_numpy(
                    np.ascontiguousarray(v))), k
    assert placed.shapes_seen == ref.shapes_seen
    assert len(placed.shapes_seen) > 1


FIRST_LAUNCHES = r"""
import sys
import threading
import torch
from repro_torch.kernels.egnn_edge import egnn_edge_agg
from repro_torch.models.mlp import mlp_init
import numpy as np

cd = getattr(torch, sys.argv[1])          # the compute dtype
count = egnn_edge_agg if cd == torch.float32 else egnn_edge_agg.bf16
dev = torch.device("cuda")
B, A, E, H = 4, 64, 2048, 866
g = torch.Generator(device=dev).manual_seed(0)
h = torch.randn((B, A, H), generator=g, device=dev)
pos = torch.randn((B, A, 3), generator=g, device=dev)
src = torch.randint(0, A, (B, E), generator=g, device=dev)
dst = torch.randint(0, A, (B, E), generator=g, device=dev)
em = torch.rand((B, E), generator=g, device=dev) < 0.8
phi = mlp_init(np.random.default_rng(0), 2 * H + 1, H, H, 1, device=dev)
torch.cuda.synchronize()
n = 8
barrier = threading.Barrier(n)
outs, errors = [None] * n, []

def run(i):
    try:
        stream = torch.cuda.Stream(device=dev)
        barrier.wait()
        with torch.inference_mode(), torch.cuda.stream(stream):
            outs[i] = egnn_edge_agg(h, pos, src, dst, em, phi,
                                    compute_dtype=cd)
        stream.synchronize()
    except Exception as e:
        errors.append(repr(e))

count.launches = 0
threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
assert not errors, errors
assert count.launches == n, count.launches
with torch.inference_mode():
    want = egnn_edge_agg(h, pos, src, dst, em, phi, compute_dtype=cd)
torch.cuda.synchronize()
assert all(torch.equal(o, want) for o in outs)
print("ok")
"""


@pytest.mark.gpu
def test_edge_forward_first_launches_from_8_threads(cuda):
    """#3's first launches in a fresh process come from 8 threads at once,
    each on its own stream (as replica workers warm up together): every
    launch runs, is counted, and gives the bits one launch alone gives."""
    _first_launches("float32")


@pytest.mark.gpu
def test_edge_forward_bf16_first_launches_from_8_threads(cuda):
    """The same for the bf16 forward (its own GEMM kernel's first
    shared-memory opt-in under ``allow_smem_once``), counted on
    ``egnn_edge_agg.bf16``."""
    _first_launches("bfloat16")


def _first_launches(dtype):
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", FIRST_LAUNCHES, dtype],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.gpu
def test_replicas_and_sharded_rows_on_one_card(cuda):
    """Replicas on four streams of one card, and rows split over two: each
    row bitwise equal to its session's predict_one, launches 4 x batches
    (x chunks when sharded) of #3."""
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.data.synthetic_atoms import generate_mixture, source_dicts
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serve import ReplicaServeSession, ServeSession
    cfg = get_smoke("hydragnn-gfm").replace(segment_sum_impl="fused",
                                            gnn_layers=4,
                                            compute_dtype=torch.float32)
    sources = source_dicts(generate_mixture(40, max_atoms=16, max_edges=64))
    spec = BucketSpec((8, 16), (32, 64))
    params = gfm_mtl_init(cfg, len(sources), seed=0)
    jobs = [(t, {k: v[i % v.shape[0]] for k, v in sources[t].items()})
            for t in range(len(sources)) for i in range(4)]
    with ServeSession(params, cfg, spec=spec, max_batch=4) as one:
        refs = [one.predict_one(sm, head=t) for t, sm in jobs]
    with ReplicaServeSession(
            params, cfg, spec=spec, max_batch=4, max_wait_ms=2.0,
            meshes=make_replica_meshes(4, devices=["cuda"] * 4)) as rep:
        rep.warmup()
        egnn_edge_agg.launches = 0
        outs = [f.result(timeout=120) for f in
                [rep.submit(sm, head=t) for t, sm in jobs]]
        batches = rep.stats()["counters"]["batches"]
        assert egnn_edge_agg.launches == cfg.gnn_layers * batches
        streams = [s.worker_streams for s in rep.replicas]
        assert all(len(w) == 1 for w in streams)
        assert len(set().union(*streams)) == 4
    for o, r in zip(outs, refs):
        assert o["energy"] == r["energy"]
        assert np.array_equal(o["forces"], r["forces"])
    mesh = make_replica_meshes(1, devices_per_replica=2,
                               devices=["cuda"] * 2)[0]
    with ServeSession(params, cfg, spec=spec, max_batch=4, mesh=mesh,
                      max_wait_ms=2.0) as sh:
        sh.warmup()
        egnn_edge_agg.launches = 0
        outs = [f.result(timeout=120) for f in
                [sh.submit(sm, head=t) for t, sm in jobs]]
        batches = sh.stats()["counters"]["batches"]
        assert egnn_edge_agg.launches == 2 * cfg.gnn_layers * batches
        for (t, sm), o, r in zip(jobs, outs, refs):
            own = sh.predict_one(sm, head=t)
            assert o["energy"] == own["energy"]
            assert np.array_equal(o["forces"], own["forces"])
            _close(torch.from_numpy(o["forces"]),
                   torch.from_numpy(r["forces"]), 1e-4)


def _moe_mla_cfg(**kw):
    """A small MLA + MoE LM whose q/k head dim (48 + 16) the kernels take."""
    from repro_torch.configs.base import ArchConfig
    base = dict(name="mla-moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=64, vocab=97, head_dim=48, kv_lora=24,
                q_lora=32, rope_dims=16, v_head_dim=32, n_experts=4,
                top_k=2, n_shared_experts=1, d_ff_expert=32,
                block_pattern=("mla",), compute_dtype=torch.float32,
                remat=False)
    base.update(kw)
    return ArchConfig(**base)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_on_card_matches_cpu_and_replays(cuda, cf):
    """``moe_apply`` on the card: output and aux within 1e-5 of the CPU's
    (f32 compute, the same routing; capacity 0.5 drops tokens), and its
    forward and every gradient bitwise equal over two runs (the dispatch
    and the combine's backward write rows by indexed copies, no float
    atomics)."""
    from repro_torch.models.moe import moe_apply, moe_init
    cfg = _moe_mla_cfg(capacity_factor=cf, n_experts=8, top_k=3,
                       d_model=96)
    rng = np.random.default_rng(0)
    p = moe_init(rng, cfg)
    x = torch.from_numpy(rng.standard_normal((4, 64, 96), np.float32))
    y_cpu, aux_cpu = moe_apply(p, x, cfg=cfg, group_size=32)
    from repro_torch import interop
    pc = interop.leaves(p)
    runs = []
    for _ in range(2):
        leaves = {k: v.to(cuda).requires_grad_(True) for k, v in pc.items()}
        params = interop.unflatten(p, leaves)
        xc = x.to(cuda).requires_grad_(True)
        y, aux = moe_apply(params, xc, cfg=cfg, group_size=32)
        grads = torch.autograd.grad((y.square().sum() + aux),
                                    [xc, *leaves.values()])
        runs.append((y.detach(), aux.detach(), grads))
    _close(runs[0][0].cpu(), y_cpu, 1e-5)
    assert abs(float(runs[0][1]) - float(aux_cpu)) <= 1e-5
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


@pytest.mark.gpu
def test_mla_moe_lm_on_card(cuda):
    """An MLA + MoE LM on the card: the kernel path's prefill (#5 at q/k
    head dim 64) within 1e-4 of the plain path's, the absorbed decode's
    logits within 2e-4 atol / 2e-3 rtol of teacher forcing (capacity
    ample: no token drops in either grouping), and greedy generation twice
    bitwise equal."""
    from repro_torch.train.serve import extend_caches, make_decode_step
    cfg = _moe_mla_cfg(capacity_factor=4.0)
    params = transformer.lm_init(np.random.default_rng(1), cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24))).to(cuda)
    full, _, _ = transformer.lm_apply(params, toks, cfg=cfg, impl="pallas")
    plain, _, _ = transformer.lm_apply(params, toks, cfg=cfg,
                                       impl="chunked")
    _close(full, plain, 1e-4)
    _, caches, _ = transformer.lm_apply(params, toks[:, :20], cfg=cfg,
                                        mode="prefill", impl="pallas")
    caches = extend_caches(caches, cfg, 24)
    decode = make_decode_step(cfg, "pallas")
    for t in range(20, 24):
        lg, caches = decode(params, toks[:, t:t + 1], caches, t)
        assert torch.allclose(lg[:, 0], full[:, t], atol=2e-4, rtol=2e-3)
    a = greedy_generate(params, cfg, toks[:, :20], 6, impl="pallas",
                        device=cuda)
    b = greedy_generate(params, cfg, toks[:, :20], 6, impl="pallas",
                        device=cuda)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the frontends and the encoder-decoder: internvl2-1b, seamless-m4t-medium
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_encdec_and_media_lm_on_card(cuda):
    """The smoke configs in f32 compute on the card. seamless: the encoder
    through #5 (bidirectional) within 1e-4 of the plain path's memory;
    ``greedy_generate(memory=)`` on the kernel path equal to the plain
    path's and the CPU's tokens, with #5 twice a layer a prefill (self,
    cross) and once a layer a decode step (cross, one query), #6 once a
    layer a decode step. internvl2: prefill with media, then decode at
    ``n_media + S`` on, the kernel path's logits within 2e-4 atol / 2e-3
    rtol of the full forward's."""
    from repro_torch import interop
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    cfg = get_smoke("seamless-m4t-medium").replace(
        compute_dtype=torch.float32)
    L = cfg.n_layers
    params = transformer.lm_init(np.random.default_rng(0), cfg)
    cparams = interop.to_torch(params, cuda)
    src = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 40, 1024), np.float32))
    mem = transformer.encode(cparams, src.to(cuda), cfg, impl="pallas")
    plain = transformer.encode(cparams, src.to(cuda), cfg)
    _close(mem, plain, 1e-4)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 24)).astype(np.int32))
    fa0, fd0 = flash_attention.launches, flash_decode.launches
    got = greedy_generate(cparams, cfg, prompt, 6, impl="pallas",
                          memory=mem, device=cuda)
    assert flash_attention.launches - fa0 == 2 * L + 5 * L
    assert flash_decode.launches - fd0 == 5 * L
    assert torch.equal(got, greedy_generate(cparams, cfg, prompt, 6,
                                            impl="chunked", memory=mem,
                                            device=cuda))
    assert torch.equal(got.cpu(), greedy_generate(
        params, cfg, prompt, 6, impl="chunked", memory=mem.cpu(),
        device="cpu"))

    cfg = get_smoke("internvl2-1b").replace(compute_dtype=torch.float32)
    n = cfg.n_media_tokens
    params = transformer.lm_init(np.random.default_rng(3), cfg, cuda)
    media = torch.randn(2, n, 1024, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 24))).to(cuda)
    full, _, _ = transformer.lm_apply(params, toks, cfg=cfg, media=media,
                                      impl="pallas")
    _, caches = make_prefill_step(cfg, "pallas")(params, toks[:, :20],
                                                 media=media)
    caches = extend_caches(caches, cfg, n + 24)
    decode = make_decode_step(cfg, "pallas")
    for t in range(20, 24):
        lg, caches = decode(params, toks[:, t:t + 1], caches, n + t)
        assert torch.allclose(lg[:, 0], full[:, n + t], atol=2e-4,
                              rtol=2e-3)


# ---------------------------------------------------------------------------
# the recurrent blocks: zamba2-1.2b (Mamba2 + shared attention), xlstm-125m
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_recurrent_lm_on_card(cuda, arch):
    """The smoke config in f32 compute on the card: the kernel path's
    greedy tokens are the plain path's and the CPU's, one #5 launch per
    shared-attention layer for the prefill and one #6 launch per such
    layer and decode step (none for xlstm: it has no attention), its
    teacher-forced logits within 2e-4 atol / 2e-3 rtol of the CPU's (the
    same arithmetic on another device), two runs bitwise; a prompt past
    zamba2's window (32) decodes through the rolling cache."""
    from repro_torch import interop
    cfg = get_smoke(arch).replace(compute_dtype=torch.float32)
    n_attn = sum(bt == "shared_attn" for bt in cfg.pattern)
    params = transformer.lm_init(np.random.default_rng(0), cfg)
    cparams = interop.to_torch(params, cuda)
    for S in (24, 40):
        prompt = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab, (3, S)).astype(np.int32))
        fa0, fd0 = flash_attention.launches, flash_decode.launches
        got = greedy_generate(cparams, cfg, prompt, 6, impl="pallas",
                              device=cuda)
        assert flash_attention.launches - fa0 == n_attn
        assert flash_decode.launches - fd0 == n_attn * 5
        assert torch.equal(got, greedy_generate(cparams, cfg, prompt, 6,
                                                impl="pallas", device=cuda))
        assert torch.equal(got, greedy_generate(cparams, cfg, prompt, 6,
                                                impl="chunked", device=cuda))
        assert torch.equal(got.cpu(), greedy_generate(
            params, cfg, prompt, 6, impl="chunked", device="cpu"))
        full, _, _ = transformer.lm_apply(cparams, prompt.to(cuda), cfg=cfg,
                                          impl="pallas")
        ref, _, _ = transformer.lm_apply(params, prompt, cfg=cfg)
        assert torch.allclose(full.cpu(), ref, atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_recurrent_lm_training_on_card(cuda, arch):
    """``lm`` training of the smoke config (bf16 compute, remat) on the
    card through ``Session``: finite losses, #1 launched once a step for
    the embedding's backward, two 3-step runs bitwise equal."""
    from repro_torch import interop
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.engine import Session, SessionConfig
    cfg = get_smoke(arch).replace(remat=True)
    source = make_lm_sources(1, 16, 64, cfg.vocab)[0]
    ends, losses = [], []
    for _ in range(2):
        scfg = SessionConfig(model="lm", arch=cfg, steps=3,
                             batch_per_task=4, lr=3e-4, log_every=1,
                             seed=0, verbose=False)
        n0 = segment_sum.two_d.launches
        with Session.from_config(scfg, sources=source, device=cuda) as s:
            res = s.run()
        assert segment_sum.two_d.launches - n0 == 3
        losses.append([r["loss"] for r in res.logger.history])
        ends.append(interop.leaves(res.params))
    assert all(np.isfinite(losses[0])) and losses[0] == losses[1]
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-12b", "stablelm-12b"])
def test_dense12b_lm_on_card(cuda, arch):
    """The smoke config at its arch's own head dim and group (gemma3 256 at
    G=2, stablelm 160 at G=4) in f32 compute on the card: one #5 launch a
    layer a prefill and one #6 launch a layer a decode step; the kernel
    path's greedy tokens are the plain path's and the CPU's, two runs
    bitwise; a prompt past gemma3's window (32) keeps every cache at its
    length; the full forward within 2e-4 atol / 2e-3 rtol of the CPU's."""
    from repro_torch import interop
    real = {"gemma3-12b": dict(head_dim=256, n_heads=4, n_kv_heads=2),
            "stablelm-12b": dict(head_dim=160, n_heads=8, n_kv_heads=2)}
    cfg = get_smoke(arch).replace(compute_dtype=torch.float32, **real[arch])
    L = cfg.n_layers
    params = transformer.lm_init(np.random.default_rng(0), cfg)
    cparams = interop.to_torch(params, cuda)
    for S in (24, 40):
        prompt = torch.from_numpy(np.random.default_rng(S).integers(
            0, cfg.vocab, (3, S)).astype(np.int32))
        fa0, fd0 = flash_attention.launches, flash_decode.launches
        got = greedy_generate(cparams, cfg, prompt, 6, impl="pallas",
                              device=cuda)
        assert flash_attention.launches - fa0 == L
        assert flash_decode.launches - fd0 == L * 5
        assert torch.equal(got, greedy_generate(cparams, cfg, prompt, 6,
                                                impl="pallas", device=cuda))
        assert torch.equal(got, greedy_generate(cparams, cfg, prompt, 6,
                                                impl="chunked", device=cuda))
        assert torch.equal(got.cpu(), greedy_generate(
            params, cfg, prompt, 6, impl="chunked", device="cpu"))
        full, _, _ = transformer.lm_apply(cparams, prompt.to(cuda), cfg=cfg,
                                          impl="pallas")
        ref, _, _ = transformer.lm_apply(params, prompt, cfg=cfg)
        assert torch.allclose(full.cpu(), ref, atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_donated_session_on_card_is_bitwise_the_pure_one(cuda):
    """``lm`` training of gemma3's smoke config (bf16 compute, remat)
    through ``Session`` on the card, ``donate=True`` (the default) against
    ``donate=False``: #1 once a step, the same losses and the same final
    params bit for bit, the donated params in their first storage."""
    from repro_torch import interop
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.engine import Session, SessionConfig
    cfg = get_smoke("gemma3-12b").replace(remat=True)
    source = make_lm_sources(1, 16, 64, cfg.vocab)[0]
    ends, losses = [], []
    for donate in (True, False):
        scfg = SessionConfig(model="lm", arch=cfg, steps=3,
                             batch_per_task=4, lr=3e-4, log_every=1,
                             seed=0, verbose=False, donate=donate)
        n0 = segment_sum.two_d.launches
        with Session.from_config(scfg, sources=source, device=cuda) as s:
            first = dict(interop.leaves(s.state.params))
            res = s.run()
        assert segment_sum.two_d.launches - n0 == 3
        after = interop.leaves(res.params)
        assert all((after[k] is v) == donate for k, v in first.items())
        losses.append([r["loss"] for r in res.logger.history])
        ends.append(after)
    assert all(np.isfinite(losses[0])) and losses[0] == losses[1]
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
