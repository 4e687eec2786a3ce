"""The plain versions of the port's attention kernels (#5 flash attention,
#6 flash decode) against ``repro``'s, on the CPU.

#5: the port's ``flash_attention`` on CPU tensors (its plain version) against
``repro``'s Pallas ``flash_attention_bhsd`` in interpret mode (a few tiny
shapes: interpret mode is slow) and against ``repro``'s ``attention_ref``.
#6: the port's split partials and combine against ``repro``'s
``decode_ref`` and ``combine_partials`` (``repro``'s Pallas decode kernel
does not run on this JAX, so it is not the oracle). The CUDA kernels are
held against these plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).

#5's bf16 precision contract: a plain-torch emulation of the CUDA kernel's
bf16 arithmetic (64-key tiles, the sentinel and the skip rule, P·V as bf16
hi + lo against bf16 v) holds the f32 tolerance of the plain version, and
the same emulation with one bf16 p does not.

Tolerances: 2e-5 in f32 (``repro``'s own kernel-vs-oracle tolerance, sums
in another order); bf16 3e-2, ``repro``'s bf16 flash tolerance (outputs
rounded to 8 mantissa bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.flash_decode.kernel import combine_partials as j_combine
from repro.kernels.flash_decode.ref import decode_ref as j_decode_ref

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import NEG_INF, keep_mask
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import (combine_partials,
                                              decode_partials_ref,
                                              decode_ref, flash_decode,
                                              plan_splits)
from repro_torch.kernels.flash_decode.ref import PAD_LIMIT

TOL = 2e-5
PAD = -(10 ** 9)


def _qkv(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32))


def _rolled(S, shift):
    """A rolling cache's key positions: slot j holds position j + shift
    (mod S), so the stream is not monotone."""
    return ((np.arange(S) - shift) % S).astype(np.int32)


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _port_fa(q, k, v, qp, kp, **kw):
    return flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_pos=torch.from_numpy(qp),
                           k_pos=torch.from_numpy(kp), **kw).numpy()


# ---------------------------------------------------------------------------
# #5 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,K,D,window,rolled", [
    (1, 40, 4, 2, 16, 0, False),      # GQA, ragged S vs 32-blocks
    (2, 70, 4, 1, 32, 13, False),     # MQA, window, ragged
    (1, 64, 2, 2, 32, 32, True),      # rolling positions + window
])
def test_flash_attention_plain_matches_repro_pallas(B, S, H, K, D, window,
                                                    rolled):
    q, k, v = _qkv(B, S, S, H, K, D)
    qp = np.arange(S, dtype=np.int32)
    kp = _rolled(S, S // 2) if rolled else qp
    got = _port_fa(q, k, v, qp, kp, causal=True, window=window)
    want = flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v),
                                jnp.asarray(qp), jnp.asarray(kp),
                                causal=True, window=window, block_q=32,
                                block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5, 37])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (1, 64, 64, 4, 4, 16),            # MHA, tile-aligned
    (2, 100, 100, 8, 2, 32),          # GQA G=4, ragged
    (1, 33, 97, 6, 3, 80),            # Sq != Sk, hd 80
    (2, 1, 65, 4, 1, 64),             # one query row, MQA
])
def test_flash_attention_plain_matches_attention_ref(B, Sq, Sk, H, K, D,
                                                     causal, window):
    q, k, v = _qkv(B, Sq, Sk, H, K, D, seed=Sq + Sk)
    kp = np.arange(Sk, dtype=np.int32)
    qp = (Sk - Sq + np.arange(Sq)).astype(np.int32)   # queries at the end
    got = _port_fa(q, k, v, qp, kp, causal=causal, window=window)
    want = attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), jnp.asarray(qp),
                         jnp.asarray(kp), causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shift", [0, 17, 50])
def test_flash_attention_rolled_and_padded_keys(shift):
    """Rotated key positions with pad keys (k_pos = -1e9) among them, and
    an explicit scale."""
    B, S, H, K, D = 2, 72, 4, 2, 32
    q, k, v = _qkv(B, S, S, H, K, D, seed=shift)
    kp = _rolled(S, shift)
    kp[::7] = PAD
    qp = np.arange(S, dtype=np.int32) + 5
    got = _port_fa(q, k, v, qp, kp, causal=True, window=40, scale=0.3)
    want = attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), jnp.asarray(qp),
                         jnp.asarray(kp), causal=True, window=40, scale=0.3)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               atol=TOL, rtol=TOL)


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 96, 96, 4, 2, 80, seed=3)
    pos = np.arange(96, dtype=np.int32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, q_pos=torch.from_numpy(pos),
                          k_pos=torch.from_numpy(pos), window=24)
    assert got.dtype == torch.bfloat16
    want = attention_ref(*(_bhsd(x.float().numpy()).astype(jnp.bfloat16)
                           for x in (tq, tk, tv)), jnp.asarray(pos),
                         jnp.asarray(pos), window=24)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want, np.float32).transpose(0, 2, 1, 3), atol=3e-2,
        rtol=3e-2)


def test_flash_attention_wrapper_checks_shapes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q, k, k, q_pos=pos, k_pos=pos)
    with pytest.raises(ValueError, match="q_pos"):
        flash_attention(q, q, q, q_pos=pos[:4], k_pos=pos)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q, q[:, :4], q_pos=pos, k_pos=pos)
    before = flash_attention.launches
    flash_attention(q, q, q, q_pos=pos, k_pos=pos)
    assert flash_attention.launches == before     # CPU: no kernel launch


# ---------------------------------------------------------------------------
# #5's bf16 precision contract: why P·V splits p into two bf16 halves
# ---------------------------------------------------------------------------

def _emulate_bf16_kernel(q, k, v, qp, kp, *, causal, window, split):
    """The arithmetic of the CUDA kernel's bf16 path in plain torch, f32 out
    (before the one rounding to bf16): CTAs of 64 query rows walk 64-key
    tiles; scores in f32 from bf16 q/k, scaled after the sum; the finite
    sentinel; a tile with no kept pair skipped once every row of the CTA has
    a finite max; online softmax; P·V of bf16 v against p as bf16 hi + lo
    (``split``) or one bf16 p, accumulated in f32. Where the kernel
    differs it changes no conclusion: it sums each product in another
    order, takes 2^x of log2(e)-scaled scores on the SFU (a few ulp from
    exp), and decides a skip one tile ahead (a dead tile it computes adds
    exact zeros)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, scale = H // K, D ** -0.5
    keep = keep_mask(qp.long(), kp.long(), causal=causal, window=window)
    qg = q.reshape(B, Sq, K, G, D).float()
    kf, vf = k.float(), v.float()
    out = torch.empty(B, Sq, K, G, D)
    for r0 in range(0, Sq, 64):
        rows = slice(r0, min(Sq, r0 + 64))
        m = torch.full((B, K, G, rows.stop - r0), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(*m.shape, D)
        for c0 in range(0, Sk, 64):
            keys = slice(c0, min(Sk, c0 + 64))
            kt = keep[rows, keys]
            if not bool(kt.any()) and bool((m > 0.5 * NEG_INF).all()):
                continue
            s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, rows],
                             kf[:, keys]) * scale
            s = torch.where(kt, s, torch.full_like(s, NEG_INF))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            l = l * corr + p.sum(-1)
            hi = p.bfloat16().float()
            pv = torch.einsum("bkgqs,bskd->bkgqd", hi, vf[:, keys])
            if split:
                lo = (p - hi).bfloat16().float()
                pv = pv + torch.einsum("bkgqs,bskd->bkgqd", lo, vf[:, keys])
            acc = acc * corr[..., None] + pv
            m = mx
        out[:, rows] = (acc / l.clamp_min(1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D)


_CONTRACT_CASES = {   # B, S, H, K, D, window, rolled
    "causal_gqa": (2, 200, 8, 2, 32, 0, False),
    "rolled_pads_window": (1, 300, 4, 2, 80, 128, True),
}


def _contract_share(case, split):
    """Worst element's share of the f32 tolerance, 2e-5 x max(1, |ref|),
    of the emulated kernel against the plain version on bf16-valued
    inputs."""
    B, S, H, K, D, window, rolled = _CONTRACT_CASES[case]
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(B, S, S, H, K, D, seed=S))
    kp = np.arange(S, dtype=np.int32)
    if rolled:
        kp = _rolled(S, S // 3)
        kp[::11] = PAD
    qp, kp = torch.arange(S, dtype=torch.int32), torch.from_numpy(kp)
    got = _emulate_bf16_kernel(q, k, v, qp, kp, causal=True, window=window,
                               split=split)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                              causal=True, window=window)
    tol = TOL * max(1.0, float(ref.abs().max()))
    return float((got - ref).abs().max()) / tol


@pytest.mark.parametrize("case", sorted(_CONTRACT_CASES))
def test_flash_attention_bf16_split_pv_keeps_f32_contract(case):
    assert _contract_share(case, split=True) <= 1.0


@pytest.mark.parametrize("case", sorted(_CONTRACT_CASES))
def test_flash_attention_bf16_single_p_breaks_f32_contract(case):
    """One bf16 p (FlashAttention-2's P·V) is off by up to 2^-9 of each p:
    far past the f32 tolerance, which is why the kernel splits p."""
    assert _contract_share(case, split=False) > 10.0


# ---------------------------------------------------------------------------
# #6 flash decode
# ---------------------------------------------------------------------------

def _decode_case(B, S, H, K, D, *, rolled_pos=None, window=0, seed=0):
    """One query per sequence at position q_pos; a cache whose slots hold
    positions k_pos (a rolling layout when rolled_pos is given; slots past
    the filled length are pads)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    if rolled_pos is None:
        filled = rng.integers(S // 2, S + 1, B)
        kp = np.where(np.arange(S)[None] < filled[:, None],
                      np.arange(S)[None], PAD).astype(np.int32)
        qp = (filled - 1).astype(np.int32)
    else:
        j = np.arange(S)
        slot_pos = rolled_pos - (rolled_pos - j) % S
        valid = slot_pos > rolled_pos - window if window else slot_pos >= 0
        kp = np.broadcast_to(np.where(valid, slot_pos, PAD),
                             (B, S)).astype(np.int32)
        qp = np.full(B, rolled_pos, np.int32)
    return q, k, v, qp, kp


def _port_partials(q, k, v, qp, kp, n_splits, per_split, window=0):
    return decode_partials_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               q_pos=torch.from_numpy(qp),
                               k_pos=torch.from_numpy(kp), n_splits=n_splits,
                               per_split=per_split, window=window)


@pytest.mark.parametrize("n_splits", [1, 3, 8, None])
@pytest.mark.parametrize("B,S,H,K,D", [
    (2, 100, 4, 2, 16), (1, 256, 8, 8, 32), (3, 77, 6, 1, 80)])
def test_flash_decode_splits_match_decode_ref(B, S, H, K, D, n_splits):
    q, k, v, qp, kp = _decode_case(B, S, H, K, D, seed=S)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), q_pos=torch.from_numpy(qp),
                       k_pos=torch.from_numpy(kp), n_splits=n_splits,
                       block_k=16).numpy()
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("pos", [50, 64, 130])
def test_flash_decode_rolling_cache(window, pos):
    """A rolling cache of 64 slots at absolute position ``pos`` (the slot
    of ``pos`` was just written); the window folded into k_pos validity,
    as the decode path does, and also passed as ``window``."""
    q, k, v, qp, kp = _decode_case(2, 64, 4, 2, 32, rolled_pos=pos,
                                   window=window, seed=pos)
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp))
    for w in (0, window):
        got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_pos=int(qp[0]),
                           k_pos=torch.from_numpy(kp[0]), window=w,
                           n_splits=4, block_k=8).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_flash_decode_empty_and_dead_splits():
    """Trailing splits past the cache end (empty) and splits whose keys are
    all pads or in the future (dead: m stays -1e30) weigh 0 in the exact
    combine; repro's combine_partials agrees on the same partials."""
    B, S, H, K, D = 2, 40, 4, 2, 16
    q, k, v, qp, kp = _decode_case(B, S, H, K, D, seed=9)
    kp[:, 8:16] = PAD                        # split 1 (8 keys): all pads
    kp[:, 24:32] = 10 ** 6                   # split 3: all in the future
    n_splits, per_split = 8, 8               # splits 5-7: past the end
    m, l, acc = _port_partials(q, k, v, qp, kp, n_splits, per_split)
    assert torch.all(m[..., 5:] == -1e30) and torch.all(l[..., 5:] == 0)
    assert torch.all(m[..., [1, 3]] == -1e30)
    assert torch.all(l[..., [1, 3]] == per_split)   # p = exp(0) = 1 each
    got = combine_partials(m, l, acc).reshape(B, 1, H, D).numpy()
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    j_out = j_combine(jnp.asarray(m.numpy()), jnp.asarray(l.numpy()),
                      jnp.asarray(acc.numpy()))
    np.testing.assert_allclose(combine_partials(m, l, acc).numpy(),
                               np.asarray(j_out), atol=TOL, rtol=TOL)


def test_flash_decode_port_oracle_is_repro_s():
    q, k, v, qp, kp = _decode_case(2, 50, 8, 2, 16, seed=4)
    for window in (0, 9):
        got = decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), q_pos=torch.from_numpy(qp),
                         k_pos=torch.from_numpy(kp), window=window)
        want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp),
                            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_flash_decode_bf16():
    q, k, v, qp, kp = _decode_case(2, 130, 8, 2, 80, seed=5)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_decode(tq, tk, tv, q_pos=torch.from_numpy(qp),
                       k_pos=torch.from_numpy(kp))
    assert got.dtype == torch.bfloat16
    want = j_decode_ref(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                          for x in (tq, tk, tv)), q_pos=jnp.asarray(qp),
                        k_pos=jnp.asarray(kp))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("B,K,S,n_splits,block_k", [
    (8, 8, 1056, None, None), (1, 8, 4200, None, None), (1, 1, 10, None, None),
    (4, 2, 300, 8, 64), (2, 2, 100, 3, 512), (1, 1, 1, 5, None)])
def test_plan_splits_covers_the_cache(B, K, S, n_splits, block_k):
    plan = plan_splits(B, K, S, n_splits, block_k)
    n, per = plan.n_splits, plan.per_split
    assert n * per >= S and per % (block_k or fd_ops.GRANULE) == 0
    if n_splits is None:
        assert (n - 1) * per < S                     # no empty split
        # one split a CTA, one cluster of at most 16 a (batch, kv head)
        assert plan.cluster == n <= fd_ops.MAX_CLUSTER
        assert plan.splits_per_cta == 1
    else:
        assert n == n_splits


# The card's cudaOccupancyMaxActiveClusters for the LM's instantiation
# (bf16, G=4, D=80, one split a CTA), clusters of 1..16 CTAs by ring
# depth: chip_smoke.py --sweep on an H100 80GB HBM3 (the attn_sweep line's
# max_active_clusters). Rings of 12 and 4 are not multiples of its 8
# consumer warps.
_H100_LM_CLUSTERS = {
    16: (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7),
    8: (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
}
_OCCUPANCY = {   # assumed clusters(cluster, stages, spc) a wave holds
    "h100_lm": lambda c, st, spc: _H100_LM_CLUSTERS.get(st, [0] * 16)[c - 1],
    "one_cta_an_sm": lambda c, st, spc: 132 // c,
    "only_shallow_rings": lambda c, st, spc: 32 // c if st == 4 else 0,
    "seven_clusters_a_wave": lambda c, st, spc: 7 if st >= 8 else 0,
    "none": None,
}


@pytest.mark.parametrize("occupancy", sorted(_OCCUPANCY))
@pytest.mark.parametrize("B,K,S,n_splits", [
    (8, 8, 1056, None), (1, 8, 4200, None), (64, 8, 1056, None),
    (1, 1, 100_000, None), (2, 1, 77, None), (3, 8, 1000, 8),
    (2, 2, 640, 12), (8, 8, 1056, 17), (8, 8, 1056, 33), (1, 1, 700, 40)])
def test_plan_splits_invariants(occupancy, B, K, S, n_splits):
    """Cluster of 1..16 CTAs (the grid is (C, K, B), so C divides it); the
    cluster's CTAs hold the splits, every CTA at least one and at most
    ``splits_per_cta``; the card can place the cluster; the default plan
    fits one wave at the assumed occupancy (or, where no plan does, takes
    one CTA a (batch, kv head)) with one split a CTA and the fewest keys on
    the busiest SM among the plans that do; an explicit ``n_splits`` is
    kept as given, with the cluster and ring of the fewest waves, then of
    the fewest splits a CTA."""
    fits = _OCCUPANCY[occupancy]
    plan = plan_splits(B, K, S, n_splits, clusters=fits)
    fits = fits or (lambda c, st, spc: float("inf"))
    C, spc = plan.cluster, plan.splits_per_cta
    assert 1 <= C <= fd_ops.MAX_CLUSTER
    assert (C - 1) * spc < plan.n_splits <= C * spc
    assert plan.stages in fd_ops.STAGES and fits(C, plan.stages, spc) >= 1
    assert plan.n_splits * plan.per_split >= S
    if n_splits is None:
        assert spc == 1 and (plan.n_splits - 1) * plan.per_split < S
        assert B * K <= fits(C, plan.stages, 1) or C == 1
        assert plan.per_split >= min(S, fd_ops.MIN_SPLIT)

        def busiest(c):
            return -(-B * K * c // fd_ops.SM_COUNT) * (
                -(-S // (c * fd_ops.GRANULE)) * fd_ops.GRANULE)
        if B * K <= fits(C, plan.stages, 1):
            assert all(busiest(C) <= busiest(c)
                       for c in range(1, min(16, S // fd_ops.MIN_SPLIT) + 1)
                       if any(B * K <= fits(c, st, 1)
                              for st in fd_ops.STAGES))
    else:
        assert plan.n_splits == n_splits and C == -(-n_splits // spc)
        # the fewest waves over every cluster of up to 16 CTAs and ring,
        # then the fewest splits a CTA, then the deepest ring
        best = min((-(-B * K // fits(-(-n_splits // k), st, k)), k, -st)
                   for c in range(1, min(16, n_splits) + 1)
                   for k in [-(-n_splits // c)] for st in fd_ops.STAGES
                   if fits(-(-n_splits // k), st, k) >= 1)
        assert best == (-(-B * K // fits(C, plan.stages, spc)), spc,
                        -plan.stages)


def test_plan_splits_lm_decode_shapes():
    """The LM decode runs (bf16, G=4, D=80) at the H100's occupancy: (a)
    B=8, 1056 slots -> 2 CTAs of 528 keys a (batch, kv head), 128 CTAs,
    one an SM (4 of 264 would put two on most SMs: as many keys on the
    busiest, and twice the splits), a 16-stage ring (8 consumer warps, 2
    stages each); (b) B=1, 4200 slots -> 16 CTAs of 264 keys, an 8-stage
    ring (eight clusters of 16 CTAs of 16 stages would not fit one wave);
    one wave each. With no occupancy limit (the CPU) the splits and the
    cluster are the same."""
    card = dict(clusters=_OCCUPANCY["h100_lm"])
    assert plan_splits(8, 8, 1056, **card) == fd_ops.Plan(2, 528, 2, 1, 16)
    assert plan_splits(1, 8, 4200, **card) == fd_ops.Plan(16, 264, 16, 1, 8)
    assert plan_splits(8, 8, 1056)[:4] == (2, 528, 2, 1)
    assert plan_splits(1, 8, 4200)[:4] == (16, 264, 16, 1)


# ---------------------------------------------------------------------------
# #6's reduction order: a plain-torch emulation of the CUDA kernel
# ---------------------------------------------------------------------------

def _emulate_decode_kernel(q, k, v, qp, kp, plan, warps, window=0):
    """The CUDA kernel's arithmetic in plain torch, f32 from the inputs'
    values, with ``warps`` consumer warps (``fd_warps``: 8, or 4 for the
    instantiations whose 8-warp CTA does not fit its shared memory): CTA r
    of a (batch, kv head)'s cluster takes splits [r·spc, (r+1)·spc) one
    after another; a split's keys go in stages of 32, stage c to warp c
    mod ``warps``, each warp an online softmax over its stages (masked keys
    at the sentinel; keys past the split get p = 0 against the rows the
    kernel loads there: the next split's, zeros past the cache end); at
    the split's end the warps merge in warp order (max, then weighted
    sums); the combine takes the splits in order (max, then weighted sums).
    Returns the partials (m, l, acc) and the output (B,1,H,D), f32. Where
    the kernel differs it changes no conclusion: it sums a stage's 32
    scores and the warps' shuffles in another order."""
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G, scale = H // K, D ** -0.5
    qg = q[:, 0].float().reshape(B, K, G, D)
    kf, vf = k.float(), v.float()
    n, per, spc = plan.n_splits, plan.per_split, plan.splits_per_cta
    m = torch.full((B, K, G, n), NEG_INF)
    l = torch.zeros(B, K, G, n)
    acc = torch.zeros(B, K, G, n, D)
    for r in range(plan.cluster):
        for s in range(r * spc, min(n, (r + 1) * spc)):
            lo, hi = s * per, min(S, (s + 1) * per)
            states = [[torch.full((B, K, G), NEG_INF), torch.zeros(B, K, G),
                       torch.zeros(B, K, G, D)] for _ in range(warps)]
            for c in range(max(0, -(-(hi - lo) // 32))):
                state = states[c % warps]
                keys = lo + 32 * c + torch.arange(32)
                inside = keys < hi
                kk = keys.clamp(max=S - 1)
                kpc = kp[:, kk]
                dpos = qp[:, None] - kpc
                keep = inside & (kpc > PAD_LIMIT) & (dpos >= 0)
                if window > 0:
                    keep = keep & (dpos < window)
                sc = torch.einsum("bkgd,bskd->bkgs", qg, kf[:, kk]) * scale
                sc = torch.where(keep[:, None, None], sc,
                                 torch.full_like(sc, NEG_INF))
                mx = torch.maximum(state[0], sc.amax(-1))
                p = torch.where(inside, torch.exp(sc - mx[..., None]),
                                torch.zeros_like(sc))
                corr = torch.exp(state[0] - mx)
                rows = torch.where((keys < S)[None, :, None, None], vf[:, kk],
                                   torch.zeros_like(vf[:, kk]))
                state[1] = state[1] * corr + p.sum(-1)
                state[2] = state[2] * corr[..., None] + torch.einsum(
                    "bkgs,bskd->bkgd", p, rows)
                state[0] = mx
            m_cta = torch.stack([w[0] for w in states]).amax(0)
            for w_m, w_l, w_a in states:         # warp order
                wt = torch.exp(w_m - m_cta)
                l[..., s] += w_l * wt
                acc[..., s, :] += w_a * wt[..., None]
            m[..., s] = m_cta
    m_max = m.amax(-1)
    l_tot = torch.zeros(B, K, G)
    a_tot = torch.zeros(B, K, G, D)
    for s in range(n):                           # split order
        w = torch.exp(m[..., s] - m_max)
        l_tot += l[..., s] * w
        a_tot += acc[..., s, :] * w[..., None]
    out = a_tot / l_tot.clamp_min(1e-30)[..., None]
    return (m, l, acc), out.reshape(B, 1, H, D)


_EMU_CASES = {   # B, S, H, K, D, n_splits, block_k, window
    "default_plan": (2, 300, 8, 2, 32, None, None, 0),
    "empty_splits": (2, 100, 4, 2, 16, 8, 16, 0),
    "dead_splits_and_cta": (3, 160, 8, 2, 16, 20, 8, 0),
    "several_splits_a_cta": (1, 1000, 8, 2, 32, 33, None, 40),
    # the LM's instantiation (G=4, D=80), splits of 17 stages: each of 8
    # warps takes two or three
    "lm_instantiation": (1, 1056, 32, 8, 80, 2, None, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_EMU_CASES))
def test_flash_decode_kernel_order_matches_repro(case, dtype):
    """The kernel's reduction order (emulated, with 8 and with 4 consumer
    warps) holds repro's decode_ref, and repro's combine_partials on its
    partials gives its output, at TOL: with empty splits (past the cache),
    dead splits (pads only, future keys only), a CTA whose two splits are
    both dead, a row with no valid key at all (every split dead: the mean
    of v, as softmax gives), several splits a CTA, the LM's instantiation,
    in f32 and from bf16 values."""
    B, S, H, K, D, n_splits, block_k, window = _EMU_CASES[case]
    q, k, v, qp, kp = _decode_case(B, S, H, K, D, seed=S)
    if case == "dead_splits_and_cta":
        kp[:, 32:48] = PAD                   # CTA 2: splits 4, 5 pads only
        kp[:, 64:72] = 10 ** 6               # split 8: future keys only
        kp[2] = PAD                          # row 2: no valid key
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    plan = plan_splits(B, K, S, n_splits, block_k)
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp),
                        window=window)
    for warps in (8, 4):
        (m, l, acc), got = _emulate_decode_kernel(
            *(torch.from_numpy(x) for x in (q, k, v, qp, kp)), plan, warps,
            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
        j_out = j_combine(jnp.asarray(m.numpy()), jnp.asarray(l.numpy()),
                          jnp.asarray(acc.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(j_out).reshape(
            got.shape), atol=TOL, rtol=TOL)
    live = plan.n_splits * plan.per_split
    if case == "empty_splits":
        assert live - plan.per_split >= S     # the last split is empty
        assert torch.all(m[..., -1] == NEG_INF) and torch.all(l[..., -1] == 0)
        assert torch.all(acc[..., -1, :] == 0)
    if case == "dead_splits_and_cta":
        assert plan.cluster == 10 and plan.splits_per_cta == 2
        assert torch.all(m[..., [4, 5, 8]] == NEG_INF)
        assert torch.all(l[:2, ..., [4, 5, 8]] == 8)   # p = exp(0) = 1 each
    if case == "several_splits_a_cta":
        assert plan.splits_per_cta == 3
    if case == "lm_instantiation":
        assert plan.per_split == 528 and plan.splits_per_cta == 1


def test_flash_decode_wrapper_checks_shapes():
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 10, 2, 16)
    with pytest.raises(ValueError, match="k_pos"):
        flash_decode(q, k, k, q_pos=3, k_pos=torch.arange(9))
    with pytest.raises(ValueError, match=r"\(B,1,H,D\)"):
        flash_decode(q[:, [0, 0]], k, k, q_pos=3, k_pos=torch.arange(10))
    with pytest.raises(ValueError, match=">= 1"):
        flash_decode(q, k, k, q_pos=3, k_pos=torch.arange(10), n_splits=0)
