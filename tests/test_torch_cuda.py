"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device. This file imports neither ``jax`` nor ``repro``,
so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 x max(1, |ref|) for segment-sum (f32 sums in another
order); 1e-4 x max(1, |ref|) for the fused edge kernel (node projections
group the 2H+1- and H-term contractions differently); 1e-4 x max|ref| per
output for its backward (the same regrouping, and weight gradients summed
over up to B·A nodes in another order). Attention kernels (#5 flash
attention, #6 flash decode): 2e-5 x max(1, |ref|) in f32 (online softmax
summed in another order); in bf16, per element, that plus 2^-7 |ref|: both
sides compute in f32 from the same bf16 inputs and round once to bf16,
which moves a value by at most 1 ulp, at most 2^-7 of it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.egnn_edge import egnn_edge_agg, egnn_edge_agg_ref
from repro_torch.kernels.egnn_edge.ops import egnn_edge_bwd
from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_decode import (combine_partials,
                                              decode_partials_ref,
                                              decode_ref, flash_decode,
                                              plan_splits)
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
    n, per = plan_splits(B, K, S, n_splits, block_k)
    m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp, n_splits=n,
                                    per_split=per)
    plain = combine_partials(m, l, acc).reshape(B, 1, H, D).to(dt)
    assert _attn_close(got, plain)
    ref = decode_ref(q, k, v, q_pos=qp, k_pos=kp)
    assert _attn_close(got, ref)
    again = flash_decode(q, k, v, q_pos=qp, k_pos=kp, n_splits=n_splits,
                         block_k=block_k)
    assert torch.equal(got, again)


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
