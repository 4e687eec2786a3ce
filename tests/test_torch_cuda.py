"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device. This file imports neither ``jax`` nor ``repro``,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 x max(1, |ref|) for segment-sum (f32 sums in another
order); 1e-4 x max(1, |ref|) for the fused edge kernel (node projections
group the 2H+1- and H-term contractions differently); 1e-4 x max|ref| per
output for its backward (the same regrouping, and weight gradients summed
over up to B·A nodes in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.egnn_edge import egnn_edge_agg, egnn_edge_agg_ref
from repro_torch.kernels.egnn_edge.ops import egnn_edge_bwd
from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
from repro_torch.models.mlp import mlp_init


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


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(2, 10, 40, 24), (3, 40, 1000, 96)])
def test_egnn_edge_kernel_matches_plain(cuda, B, A, E, H):
    rng = np.random.default_rng(1)
    phi = mlp_init(rng, 2 * H + 1, H, H, 1, device=cuda)
    phi["fc0"]["b"] = torch.from_numpy(
        0.1 * rng.standard_normal(H, np.float32)).to(cuda)
    phi["fc1"]["b"] = torch.from_numpy(
        0.1 * rng.standard_normal(H, np.float32)).to(cuda)
    h = torch.from_numpy(rng.standard_normal((B, A, H), np.float32)).to(cuda)
    pos = torch.from_numpy(rng.standard_normal((B, A, 3), np.float32)).to(cuda)
    src, dst, em = _edges(rng, B, E, A, cuda)
    before = egnn_edge_agg.launches
    got = egnn_edge_agg(h, pos, src, dst, em, phi)
    assert egnn_edge_agg.launches == before + 1
    _close(got, egnn_edge_agg_ref(h, pos, src, dst, em, phi), 1e-4)
    assert torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi))
    with pytest.raises(TypeError, match="float32"):
        egnn_edge_agg(h.bfloat16(), pos, src, dst, em, phi)


@pytest.mark.gpu
@pytest.mark.parametrize("B,A,E,H", [(2, 10, 40, 24), (3, 40, 1000, 96),
                                     (8, 64, 2048, 866)])
def test_egnn_edge_bwd_kernel_matches_plain(cuda, B, A, E, H):
    rng = np.random.default_rng(2)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape).astype(np.float32)).to(cuda)

    w0, b0 = t(2 * H + 1, H, scale=(2 * H + 1) ** -0.5), t(H, scale=0.1)
    w1, b1 = t(H, H, scale=H ** -0.5), t(H, scale=0.1)
    h, pos, g = t(B, A, H), t(B, A, 3, scale=2.0), t(B, A, H)
    leaves = [h, pos, w0, b0, w1, b1]
    for x in leaves:
        x.requires_grad_(True)
    phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
    src, dst, em = _edges(rng, B, E, A, cuda)
    src[:, -3:], dst[:, -3:], em[:, -3:] = 1, A, True   # sentinel, unmasked
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
    no_pos = torch.autograd.grad(out, [h, w0, b0, w1, b1], g)
    assert all(torch.equal(a, b) for a, b in zip(no_pos, got[:1] + got[2:]))


@pytest.mark.gpu
def test_segment_sum_kernel_refuses_grad(cuda):
    msg = torch.ones((1, 8, 4), device=cuda, requires_grad=True)
    dst = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="fused"):
        segment_sum(msg, dst, 2)
    with torch.no_grad():
        assert segment_sum(msg, dst, 2).shape == (1, 2, 4)
