"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device. This file imports neither ``jax`` nor ``repro``,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 x max(1, |ref|) for segment-sum (f32 sums in another
order); 1e-4 x max(1, |ref|) for the fused edge kernel (node projections
group the 2H+1- and H-term contractions differently).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.egnn_edge import egnn_edge_agg, egnn_edge_agg_ref
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
