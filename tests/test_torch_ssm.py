"""The port's recurrent blocks (``repro_torch.models.ssm``) against
``repro.models.ssm``: Mamba2 (chunked SSD), mLSTM (chunkwise and the step
scan) and sLSTM.

Both packages start from ``repro``'s parameters (its ``*_init`` tree with
every zero-initialised bias and the norm scales perturbed, so each leaf
matters), carried into the port with ``interop.to_torch``, and see the
same numpy-seeded inputs.

Tolerances. f32 compute: outputs, states and gradients within 2e-5 x
max(1, max|ref|) — the same sums in another order (``repro``'s einsums
contract in XLA's order, the port's products in its own) over chunks of
at most 16 and widths of at most 256. The naive float64 recurrence holds
SSD to 2e-4, as ``tests/test_ssm.py`` holds ``repro``'s. A prefill then
one step against the full sequence: 1e-4 absolute / 1e-3 relative,
``tests/test_ssm.py``'s. bf16 compute: both packages round the
projections, the conv and the gates' inputs to bf16 at the same points
but XLA may keep a fused elementwise chain in f32 where PyTorch rounds
each op; one flipped rounding moves a value by 2^-8 of itself and the
recurrences carry it on, so outputs and states are held to 1e-2 x
max(1, max|ref|) (the worst reading at these widths: 2.0e-3, mLSTM's
output and stabiliser).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JCfg
from repro.models import ssm as jssm

from repro_torch import interop
from repro_torch.configs.base import ArchConfig as TCfg
from repro_torch.models import ssm as tssm

F32_TOL = 2e-5
BF16_TOL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
TINY = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
            d_ff=0, vocab=64, ssm_state=8, ssm_heads=4, ssm_chunk=8)
# the smoke widths of zamba2-1.2b (Mamba2) and xlstm-125m (mLSTM, sLSTM)
SMOKE = {"mamba2": dict(TINY, d_model=128, ssm_state=16, ssm_heads=4,
                        ssm_chunk=16, n_layers=8),
         "mlstm": dict(TINY, d_model=128, ssm_chunk=256, n_layers=2),
         "slstm": dict(TINY, d_model=128, n_layers=2)}
BLOCKS = ("mamba2", "mlstm", "mlstm_scan", "slstm")
J = {"mamba2": (jssm.mamba2_init, jssm.mamba2_apply, jssm.mamba2_step,
                jssm.mamba2_state_init),
     "mlstm": (jssm.mlstm_init, jssm.mlstm_apply, jssm.mlstm_step,
               jssm.mlstm_state_init),
     "slstm": (jssm.slstm_init, jssm.slstm_apply, jssm.slstm_step,
               jssm.slstm_state_init)}
T = {"mamba2": (tssm.mamba2_apply, tssm.mamba2_step,
                tssm.mamba2_state_init),
     "mlstm": (tssm.mlstm_apply, tssm.mlstm_step, tssm.mlstm_state_init),
     "slstm": (tssm.slstm_apply, tssm.slstm_step, tssm.slstm_state_init)}


def _cfgs(block, dtype="f32", width="tiny", **kw):
    jd, td, _ = DTYPES[dtype]
    base = dict(TINY if width == "tiny" else SMOKE[block.split("_")[0]],
                **kw)
    if block == "mlstm_scan":
        base["mlstm_chunked"] = False
    return (JCfg(**base, remat=False, compute_dtype=jd),
            TCfg(**base, compute_dtype=td))


def _params(block, jcfg, seed=0):
    """repro's block tree with its zero biases, conv bias, dt bias, D and
    norm scales perturbed."""
    p = J[block.split("_")[0]][0](jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if any(s in name for s in ("'b'", "conv_b", "dt_bias", "'D'",
                                   "'scale'")):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(perturb, p)


def _x(cfg, B, S, seed=0):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _close(got, want, tol, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64) \
        if not isinstance(want, np.ndarray) else want.astype(np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (name, err)


def _close_state(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        _close(got[k], want[k], tol, k)


def _run_j(block, jp, x, jcfg, **kw):
    if block == "mlstm_scan":
        kw["use_chunked"] = False
    return J[block.split("_")[0]][1](jp, jnp.asarray(x, jcfg.compute_dtype),
                                     cfg=jcfg, **kw)


def _run_t(block, tp, x, tcfg, **kw):
    return T[block.split("_")[0]][0](
        tp, torch.from_numpy(x).to(tcfg.compute_dtype), cfg=tcfg, **kw)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _naive_ssd(xh, dtv, A, Bm, Cm):
    """The sequential recurrence in float64."""
    B_, S, H, P = xh.shape
    h = np.zeros((B_, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        h = h * np.exp(dtv[:, t] * A)[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dtv[:, t], xh[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (48, 16), (37, 16),
                                     (5, 16)])
def test_ssd_chunked_matches_repro_and_naive(S, chunk):
    """``tests/test_ssm.py``'s cases, plus S % chunk != 0 (the dt=0 pad)
    and one chunk shorter than the chunk size."""
    rng = np.random.default_rng(S)
    B_, H, P, N = 2, 3, 8, 5
    xh = rng.standard_normal((B_, S, H, P)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((B_, S, H)))).astype(
        np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B_, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B_, S, N))).astype(np.float32)
    y, hT = tssm.ssd_chunked(*map(torch.from_numpy, (xh, dtv, A, Bm, Cm)),
                             chunk)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (xh, dtv, A, Bm, Cm)),
                              chunk)
    assert y.dtype == hT.dtype == torch.float32
    _close(y, jy, F32_TOL, "y")
    _close(hT, jh, F32_TOL, "state")
    ny, nh = _naive_ssd(*(a.astype(np.float64) for a in
                          (xh, dtv, A, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), ny, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(hT.numpy(), nh, atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# full-sequence apply, final states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", ["tiny", "smoke"])
@pytest.mark.parametrize("block", BLOCKS)
def test_apply_and_state_match_repro(block, width, dtype):
    """Outputs and the final states (``return_state``) on a ragged length
    (21: not a whole number of chunks at the tiny width)."""
    jcfg, tcfg = _cfgs(block, dtype, width)
    jp = _params(block, jcfg)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    x = _x(jcfg, 2, 21)
    tol = DTYPES[dtype][2]
    jy, jst = _run_j(block, jp, x, jcfg, return_state=True)
    ty, tst = _run_t(block, tp, x, tcfg, return_state=True,
                     **({"use_chunked": False} if block == "mlstm_scan"
                        else {}))
    assert ty.dtype == tcfg.compute_dtype
    _close(ty, jy, tol, "y")
    _close_state(tst, jst, tol)
    _close(_run_t(block, tp, x, tcfg), jy, tol, "y without state")


def test_mlstm_chunked_equals_scan_path():
    """``cfg.mlstm_chunked`` picks the path; the scan is the oracle."""
    jcfg, tcfg = _cfgs("mlstm", "f32")
    tp = interop.to_torch(jax.tree_util.tree_map(
        np.asarray, _params("mlstm", jcfg, seed=3)))
    x = torch.from_numpy(_x(jcfg, 2, 20, seed=3))
    y_c, s_c = tssm.mlstm_apply(tp, x, cfg=tcfg, return_state=True)
    y_s, s_s = tssm.mlstm_apply(tp, x, cfg=tcfg.replace(mlstm_chunked=False),
                                return_state=True)
    _close(y_c, y_s.numpy(), F32_TOL, "y")
    for k in ("C", "n", "m"):
        _close(s_c[k], s_s[k].numpy(), F32_TOL, k)


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("start", ["prefill", "state_init"])
@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_step_matches_repro(block, start, dtype):
    """Three decode steps from a prefill state or from ``*_state_init``,
    against ``repro``'s steps: outputs and states, in each state leaf's
    dtype. Mamba2's zero state holds its conv window in f32 (a bf16 step
    then runs its conv and output in f32), the prefill tail is the bf16
    projection: both promote as ``repro``'s do."""
    jcfg, tcfg = _cfgs(block, dtype)
    jp = _params(block, jcfg, seed=1)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    x = _x(jcfg, 2, 12, seed=1)
    tol = DTYPES[dtype][2]
    if start == "prefill":
        _, jst = _run_j(block, jp, x[:, :9], jcfg, return_state=True)
        _, tst = _run_t(block, tp, x[:, :9], tcfg, return_state=True)
    else:
        jst = J[block][3](jcfg, 2)
        tst = T[block][2](tcfg, 2)
        _close_state(tst, jst, 0.0)
    for t in range(9, 12):
        jy, jst = J[block][2](jp, jnp.asarray(x[:, t:t + 1],
                                              jcfg.compute_dtype), jst,
                              cfg=jcfg)
        ty, tst = T[block][1](tp, torch.from_numpy(x[:, t:t + 1]).to(
            tcfg.compute_dtype), tst, cfg=tcfg)
        assert ty.dtype == tcfg.compute_dtype
        _close(ty, jy, tol, f"y {t}")
        _close_state(tst, jst, tol)
    if block == "mamba2":
        want = torch.float32 if start == "state_init" else \
            tcfg.compute_dtype
        assert tst["conv"].dtype == want


@pytest.mark.parametrize("S", [2, 16])
@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_prefill_then_step_equals_full_sequence(block, S):
    """Prefill S tokens then decode 1 == the full apply on S+1 tokens
    (S=2 is shorter than the conv window: its tail is zero-padded)."""
    jcfg, tcfg = _cfgs(block)
    tp = interop.to_torch(jax.tree_util.tree_map(
        np.asarray, _params(block, jcfg, seed=2)))
    x = torch.from_numpy(_x(jcfg, 2, S + 1, seed=2))
    y_full = T[block][0](tp, x, cfg=tcfg)
    _, state = T[block][0](tp, x[:, :S], cfg=tcfg, return_state=True)
    y_step, _ = T[block][1](tp, x[:, S:], state, cfg=tcfg)
    np.testing.assert_allclose(y_step[:, 0].numpy(), y_full[:, S].numpy(),
                               atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _grads(block, jp, tp, x, jcfg, tcfg, w):
    """Every parameter's gradient and the input's of sum(y * w), in
    ``repro`` (``jax.grad``) and in the port (autograd)."""
    def jloss(p, x):
        return jnp.sum(_run_j(block, p, x, jcfg).astype(jnp.float32) * w)
    jg = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {k: v.requires_grad_(True)
              for k, v in interop.leaves(tp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = T[block.split("_")[0]][0](
        interop.unflatten(tp, leaves), xt, cfg=tcfg,
        **({"use_chunked": False} if block == "mlstm_scan" else {}))
    (y.float() * torch.from_numpy(w)).sum().backward()
    want = interop.leaves(jax.tree_util.tree_map(np.asarray, jg[0]))
    assert set(want) == set(leaves)
    return xt.grad, jg[1], {k: v.grad for k, v in leaves.items()}, want


@pytest.mark.parametrize("block", BLOCKS)
def test_grads_match_jax_grad(block):
    jcfg, tcfg = _cfgs(block)
    jp = _params(block, jcfg, seed=4)
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    x = _x(jcfg, 2, 19, seed=4)
    w = np.random.default_rng(4).standard_normal(
        (2, 19, jcfg.d_model)).astype(np.float32)
    dx, jdx, got, want = _grads(block, jp, tp, x, jcfg, tcfg, w)
    _close(dx, jdx, F32_TOL, "dx")
    for k in want:
        _close(got[k], want[k], F32_TOL, k)


@pytest.mark.parametrize("block", ["mlstm", "mlstm_scan"])
def test_mlstm_large_gates_stay_finite_and_match(block):
    """Input and forget gates pushed to +-25 and their weights scaled up:
    above the chunk's diagonal ``b_i - b_j`` is large and positive, so an
    exp before the mask would give inf and a NaN gradient. Every gradient
    is finite and ``jax.grad``'s."""
    jcfg, tcfg = _cfgs(block)
    jp = _params(block, jcfg, seed=5)
    jp["wi"] = {"w": 10 * jp["wi"]["w"], "b": jp["wi"]["b"] + 25.0}
    jp["wf"] = {"w": 10 * jp["wf"]["w"], "b": jp["wf"]["b"] - 25.0}
    tp = interop.to_torch(jax.tree_util.tree_map(np.asarray, jp))
    x = _x(jcfg, 2, 21, seed=5)
    w = np.random.default_rng(5).standard_normal(
        (2, 21, jcfg.d_model)).astype(np.float32)
    dx, jdx, got, want = _grads(block, jp, tp, x, jcfg, tcfg, w)
    assert torch.isfinite(dx).all()
    assert all(torch.isfinite(g).all() for g in got.values())
    _close(dx, jdx, F32_TOL, "dx")
    for k in want:
        _close(got[k], want[k], F32_TOL, k)


def test_state_init_and_init_layouts_match_repro():
    """``*_init`` (numpy and torch generators) and ``*_state_init``: the
    same leaves, shapes and dtypes as ``repro``'s."""
    for block in ("mamba2", "mlstm", "slstm"):
        jcfg, tcfg = _cfgs(block, "bf16", "smoke")
        want = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            J[block][0](jax.random.PRNGKey(0), jcfg))
        init = getattr(tssm, f"{block}_init")
        for rng in (np.random.default_rng(0),
                    torch.Generator().manual_seed(0)):
            got = interop.tree_map(
                lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                init(rng, tcfg))
            assert got == want, block
        jst = J[block][3](jcfg, 3)
        tst = T[block][2](tcfg, 3)
        _close_state(tst, jst, 0.0)
