"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM),
``repro``'s layout and arithmetic.

Mamba2 runs the chunked SSD formulation: within a chunk a masked (Q, Q)
product, across chunks one carried state. ``repro``'s four-operand
``einsum`` calls (which XLA contracts in an order of its own choosing) are
written here as explicit products, in an order that never forms a tensor
larger than the (B, chunks, H, Q, Q) decay matrix; the sums are the same
in another order. ``lax.scan`` over chunks or steps becomes a Python loop.

Each block exposes:
  *_init(rng, cfg, device)          parameter tree
  *_apply(params, x, cfg)           full sequence (train/prefill) -> y, or
                                    (y, state) with ``return_state``
  *_step(params, x1, state, cfg)    one-token decode -> (y1, state)
  *_state_init(cfg, batch, ...)     the zero decode state

Dtypes follow ``repro``'s promotion: a bf16 tensor meeting an f32 one
gives f32. So a Mamba2 decode step from ``mamba2_state_init`` (an f32 conv
state) runs its conv and output in f32, one from prefill (the bf16 conv
tail) in bf16, as in ``repro``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Params, dense, dense_init, gelu, normal_init, rmsnorm

NEG = -1e30                       # the empty stabiliser m, as in ``repro``


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _max1(x):
    """``jnp.maximum(x, 1.0)``: at a tie the gradient is split in half, as
    ``torch.maximum``'s is (``clamp_min`` would pass it whole)."""
    return torch.maximum(x, x.new_ones(()))


def _conv_step(conv, w, b):
    """``einsum("bkc,kc->bc", conv, w) + b`` with ``repro``'s promotion."""
    conv, w, b = _promote(conv, w, b)
    return torch.einsum("bkc,kc->bc", conv, w) + b


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def _mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    P = d_inner // H
    N = cfg.ssm_state
    return d_inner, H, P, N


def mamba2_init(rng, cfg, device="cpu") -> Params:
    d = cfg.d_model
    d_inner, H, P, N = _mamba_dims(cfg)
    dt = cfg.param_dtype
    conv_ch = d_inner + 2 * N
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    if torch.device(device).type == "meta":
        a_log = torch.empty(H, device="meta")
    return {
        "w_in": dense_init(rng, d, 2 * d_inner + 2 * N + H, dt,
                           device=device),
        "conv_w": normal_init(rng, (cfg.conv_kernel, conv_ch), dt, 0.1,
                              device),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": a_log.to(device=device, dtype=dt),
        "D": torch.ones(H, dtype=dt, device=device),
        "dt_bias": torch.zeros(H, dtype=dt, device=device),
        "norm": {"scale": torch.ones(d_inner, dtype=dt, device=device)},
        "w_out": dense_init(rng, d_inner, d, dt,
                            stddev=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)),
                            device=device),
    }


def _causal_conv(x, w, b):
    """x: (B,S,C) depthwise causal conv, kernel K (``repro``'s sum of K
    shifted products, in x's dtype)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<m<=i} x[m], -inf
    above the diagonal (masked before any exp)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    d = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~keep, -math.inf)


def ssd_chunked(xh, dtv, A, Bm, Cm, chunk: int):
    """Chunked SSD. xh:(B,S,H,P) dtv:(B,S,H) A:(H,) Bm,Cm:(B,S,N).
    Returns (y:(B,S,H,P) in xh's dtype, final_state:(B,H,P,N) f32)."""
    B_, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    if nc * Q != S:
        # pad with dt=0 steps: decay exp(0)=1 and contribution dt*x=0, so
        # the recurrence (and final state) are exactly preserved
        pad = nc * Q - S
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    f32 = torch.float32
    xc = xh.reshape(B_, nc, Q, H, P).to(f32)
    dtc = dtv.reshape(B_, nc, Q, H).to(f32)
    Bc = Bm.reshape(B_, nc, Q, N).to(f32)
    Cc = Cm.reshape(B_, nc, Q, N).to(f32)
    dA = dtc * A.to(f32)                                 # (B,nc,Q,H)
    dAh = dA.transpose(2, 3)                             # (B,nc,H,Q)
    dA_cs = torch.cumsum(dAh, -1)                        # (B,nc,H,Q)
    xd = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)    # (B,nc,H,Q,P)

    # intra-chunk: y_diag[i] = sum_j (C_i . B_j) L_ij xd_j
    L = torch.exp(_segsum(dAh))                          # (B,nc,H,Q,Q)
    cb = Cc @ Bc.transpose(-1, -2)                       # (B,nc,Q,Q)
    y_diag = (L * cb[:, :, None]) @ xd                   # (B,nc,H,Q,P)
    del L

    # per-chunk input -> state: sum_j decay_j xd_j (outer) B_j
    decay = torch.exp(dA_cs[..., -1:] - dA_cs)           # (B,nc,H,Q)
    states = (xd * decay[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]                                 # (B,nc,H,P,N)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])              # (B,nc,H)
    h = torch.zeros((B_, H, P, N), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, 1)                          # (B,nc,H,P,N)
    y_off = (Cc[:, :, None] @ prev.transpose(-1, -2)) \
        * torch.exp(dA_cs)[..., None]                    # (B,nc,H,Q,P)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(B_, nc * Q, H, P)
    return y[:, :S].to(xh.dtype), h


def mamba2_apply(params: Params, x, *, cfg, return_state=False):
    B, S, d = x.shape
    d_inner, H, P, N = _mamba_dims(cfg)
    cd = cfg.compute_dtype
    zxbcdt = dense(params["w_in"], x, cd)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: 2 * d_inner + 2 * N]
    dtv = zxbcdt[..., 2 * d_inner + 2 * N:]
    xBC = F.silu(_causal_conv(xBC, params["conv_w"].to(cd),
                              params["conv_b"].to(cd)))
    xh = xBC[..., :d_inner].reshape(B, S, H, P)
    Bm = xBC[..., d_inner: d_inner + N]
    Cm = xBC[..., d_inner + N:]
    dtv = F.softplus(dtv.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, hT = ssd_chunked(xh, dtv, A, Bm, Cm, cfg.ssm_chunk)
    y = y + params["D"].to(cd)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(params["norm"], y) * F.silu(z)
    out = dense(params["w_out"], y, cd)
    if return_state:
        return out, {"ssm": hT, "conv": _conv_tail(zxbcdt, cfg)}
    return out


def _conv_tail(zxbcdt, cfg):
    """Last (K-1) pre-conv xBC inputs, for decode cache continuity."""
    d_inner, H, P, N = _mamba_dims(cfg)
    K = cfg.conv_kernel
    tail = zxbcdt[:, -(K - 1):, d_inner: 2 * d_inner + 2 * N]
    pad = (K - 1) - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return tail


def mamba2_state_init(cfg, batch: int, dtype=torch.float32,
                      device="cpu") -> Params:
    d_inner, H, P, N = _mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                                 d_inner + 2 * N), dtype=dtype,
                                device=device)}


def mamba2_step(params: Params, x1, state, *, cfg):
    """x1: (B,1,d) single-token decode."""
    B = x1.shape[0]
    d_inner, H, P, N = _mamba_dims(cfg)
    cd = cfg.compute_dtype
    zxbcdt = dense(params["w_in"], x1, cd)
    z = zxbcdt[..., :d_inner]
    xBC_raw = zxbcdt[:, 0, d_inner: 2 * d_inner + 2 * N]
    dtv = zxbcdt[:, 0, 2 * d_inner + 2 * N:]
    conv = torch.cat(_promote(state["conv"], xBC_raw[:, None]), dim=1)
    xBC = F.silu(_conv_step(conv, params["conv_w"].to(cd),
                            params["conv_b"].to(cd)))
    xh = xBC[:, :d_inner].reshape(B, H, P)
    Bm = xBC[:, d_inner: d_inner + N].float()
    Cm = xBC[:, d_inner + N:].float()
    dtv = F.softplus(dtv.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dtv * A)                              # (B,H)
    h = state["ssm"] * dA[..., None, None] + (
        dtv[..., None] * xh.float())[..., None] * Bm[:, None, None, :]
    y = (h @ Cm[:, None, :, None])[..., 0].to(cd)        # (B,H,P)
    y = y + params["D"].to(cd)[None, :, None] * xh
    y = y.reshape(B, 1, d_inner)
    y = rmsnorm(params["norm"], y) * F.silu(z)
    out = dense(params["w_out"], y, cd)
    return out, {"ssm": h, "conv": conv[:, 1:]}


# ===========================================================================
# xLSTM — mLSTM (matrix memory) and sLSTM (scalar memory)
# ===========================================================================

def _mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def mlstm_init(rng, cfg, device="cpu") -> Params:
    d = cfg.d_model
    d_inner, H, dk = _mlstm_dims(cfg)
    dt = cfg.param_dtype
    return {
        "w_up": dense_init(rng, d, 2 * d_inner, dt, device=device),
        "conv_w": normal_init(rng, (4, d_inner), dt, 0.1, device),
        "conv_b": torch.zeros(d_inner, dtype=dt, device=device),
        "wq": dense_init(rng, d_inner, d_inner, dt, device=device),
        "wk": dense_init(rng, d_inner, d_inner, dt, device=device),
        "wv": dense_init(rng, d_inner, d_inner, dt, device=device),
        "wi": dense_init(rng, d_inner, H, dt, bias=True, device=device),
        "wf": dense_init(rng, d_inner, H, dt, bias=True, device=device),
        "norm": {"scale": torch.ones(d_inner, dtype=dt, device=device)},
        "w_down": dense_init(rng, d_inner, d, dt,
                             stddev=0.02 / math.sqrt(2 * max(cfg.n_layers,
                                                             1)),
                             device=device),
    }


def _mlstm_cell(q, k, v, ig, fg, state):
    """One step. q,k,v: (B,H,dk|dv); ig,fg: (B,H) raw gates.
    state = (C:(B,H,dv,dk), n:(B,H,dk), m:(B,H))."""
    C, n, m = state
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(ig - m_new)
    C = C * fp[..., None, None] + ip[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = n * fp[..., None] + ip[..., None] * k
    num = (C @ q[..., None])[..., 0]
    den = _max1(torch.abs((n[..., None, :] @ q[..., None])[..., 0, 0]))
    return num / den[..., None], (C, n, m_new)


def mlstm_chunkwise(q, k, v, ig, fg, chunk: int, state=None):
    """Chunkwise-parallel mLSTM, algebraically exact against the step
    cell: intra-chunk work as masked (L, L) products, one stabilised state
    carried a chunk. q,k,v: (B,S,H,dk) f32; ig,fg: (B,S,H) raw gates.
    Returns (y, (C, n, m))."""
    B, S, H, dk = q.shape
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        # pad with fg -> +inf (f=1, no decay) and ig -> -inf (no input):
        # the recurrence and final state pass through unchanged
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
        fg = F.pad(fg, (0, 0, 0, pad), value=40.0)

    def cks(x):  # (B,S,H,...) -> (B,nc,H,L,...)
        x = x.reshape((B, nc, L) + x.shape[2:])
        return x.transpose(2, 3)

    qc, kc, vc, igc, fgc = (cks(t) for t in (q, k, v, ig, fg))
    if state is None:
        C = torch.zeros((B, H, dk, dk), dtype=q.dtype, device=q.device)
        n = torch.zeros((B, H, dk), dtype=q.dtype, device=q.device)
        m = torch.full((B, H), NEG, dtype=q.dtype, device=q.device)
    else:
        C, n, m = state
    keep = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    ys = []
    for c in range(nc):
        qi, ki, vi = qc[:, c], kc[:, c], vc[:, c]        # (B,H,L,dk)
        logf = F.logsigmoid(fgc[:, c])                   # (B,H,L)
        b = torch.cumsum(logf, -1)                       # local decay
        g = igc[:, c] - b
        gmax = torch.cummax(g, -1).values
        m_i = b + torch.maximum(m[..., None], gmax)      # (B,H,L)
        # D_ij = exp(b_i + g_j - m_i), j <= i. Masked BEFORE the exp: for
        # j > i the argument can be large and positive, and exp -> inf
        # would poison the backward even under a later where (inf * 0)
        arg = b[..., :, None] + g[..., None, :] - m_i[..., :, None]
        D = torch.exp(arg.masked_fill(~keep, -math.inf))
        w = D * (qi @ ki.transpose(-1, -2))              # (B,H,L,L)
        inter = torch.exp(m[..., None] + b - m_i)        # (B,H,L)
        num = w @ vi + inter[..., None] * (qi @ C.transpose(-1, -2))
        den = w.sum(-1) + inter * (qi @ n[..., None])[..., 0]
        ys.append(num / _max1(torch.abs(den))[..., None])
        # end-of-chunk state
        bL = b[..., -1]                                  # (B,H)
        m_new = bL + torch.maximum(m, gmax[..., -1])
        sc = torch.exp(bL[..., None] + g - m_new[..., None])   # (B,H,L)
        carry = torch.exp(m + bL - m_new)
        C = carry[..., None, None] * C + \
            (vi * sc[..., None]).transpose(-1, -2) @ ki
        n = carry[..., None] * n + (sc[..., None, :] @ ki)[..., 0, :]
        m = m_new
    y = torch.stack(ys, 1).transpose(2, 3).reshape(B, nc * L, H, dk)
    return y[:, :S], (C, n, m)


def mlstm_apply(params: Params, x, *, cfg, return_state=False,
                use_chunked=None):
    if use_chunked is None:
        use_chunked = cfg.mlstm_chunked
    B, S, d = x.shape
    d_inner, H, dk = _mlstm_dims(cfg)
    cd = cfg.compute_dtype
    up = dense(params["w_up"], x, cd)
    xin, z = up[..., :d_inner], up[..., d_inner:]
    xc = F.silu(_causal_conv(xin, params["conv_w"].to(cd),
                             params["conv_b"].to(cd)))
    q = dense(params["wq"], xc, cd).reshape(B, S, H, dk)
    k = dense(params["wk"], xc, cd).reshape(B, S, H, dk) / math.sqrt(dk)
    v = dense(params["wv"], xin, cd).reshape(B, S, H, dk)
    ig = dense(params["wi"], xc, cd).float()
    fg = dense(params["wf"], xc, cd).float()
    if use_chunked:
        yq, (C, n, m) = mlstm_chunkwise(q.float(), k.float(), v.float(),
                                        ig, fg, cfg.ssm_chunk or 64)
        y = yq.reshape(B, S, d_inner).to(cd)
    else:
        st = (torch.zeros((B, H, dk, dk), device=x.device),
              torch.zeros((B, H, dk), device=x.device),
              torch.full((B, H), NEG, device=x.device))
        ys = []
        for t in range(S):
            yt, st = _mlstm_cell(q[:, t].float(), k[:, t].float(),
                                 v[:, t].float(), ig[:, t], fg[:, t], st)
            ys.append(yt)
        y = torch.stack(ys, 1).reshape(B, S, d_inner).to(cd)
        C, n, m = st
    y = rmsnorm(params["norm"], y) * F.silu(z)
    out = dense(params["w_down"], y, cd)
    if return_state:
        tail = xin[:, -3:]
        if tail.shape[1] < 3:
            tail = F.pad(tail, (0, 0, 3 - tail.shape[1], 0))
        return out, {"C": C, "n": n, "m": m, "conv": tail}
    return out


def mlstm_state_init(cfg, batch: int, dtype=None, device="cpu") -> Params:
    d_inner, H, dk = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, H, dk, dk), device=device),
            "n": torch.zeros((batch, H, dk), device=device),
            "m": torch.full((batch, H), NEG, device=device),
            "conv": torch.zeros((batch, 3, d_inner),
                                dtype=dtype or cfg.compute_dtype,
                                device=device)}


def mlstm_step(params: Params, x1, state, *, cfg):
    B = x1.shape[0]
    d_inner, H, dk = _mlstm_dims(cfg)
    cd = cfg.compute_dtype
    up = dense(params["w_up"], x1, cd)
    xin, z = up[:, 0, :d_inner], up[:, 0, d_inner:]
    conv = torch.cat(_promote(state["conv"], xin[:, None]), dim=1)
    xc = F.silu(_conv_step(conv, params["conv_w"].to(cd),
                           params["conv_b"].to(cd)))
    q = dense(params["wq"], xc, cd).reshape(B, H, dk)
    k = dense(params["wk"], xc, cd).reshape(B, H, dk) / math.sqrt(dk)
    v = dense(params["wv"], xin, cd).reshape(B, H, dk)
    ig = dense(params["wi"], xc, cd).float()
    fg = dense(params["wf"], xc, cd).float()
    y, (C, n, m) = _mlstm_cell(q.float(), k.float(), v.float(), ig, fg,
                               (state["C"], state["n"], state["m"]))
    y = y.reshape(B, 1, d_inner).to(cd)
    y = rmsnorm(params["norm"], y) * F.silu(z[:, None])
    out = dense(params["w_down"], y, cd)
    return out, {"C": C, "n": n, "m": m, "conv": conv[:, 1:]}


def slstm_init(rng, cfg, device="cpu") -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dt = cfg.param_dtype
    ff = 2 * d  # xLSTM sLSTM post-FFN (``repro``'s proj factor)
    return {
        "w_gates": dense_init(rng, d, 4 * d, dt, bias=True, device=device),
        "r_gates": normal_init(rng, (H, dh, 4 * dh), dt, 1 / math.sqrt(dh),
                               device),
        "norm": {"scale": torch.ones(d, dtype=dt, device=device)},
        "w_ff_up": dense_init(rng, d, ff, dt, device=device),
        "w_ff_down": dense_init(rng, ff, d, dt,
                                stddev=0.02 / math.sqrt(
                                    2 * max(cfg.n_layers, 1)),
                                device=device),
    }


def _slstm_cell(gx, h_prev, state, r, H, dh):
    """gx: (B,4d) input gate pre-acts; h_prev: (B,d); state=(c,n,m) each
    (B,d)."""
    c, n, m = state
    B = gx.shape[0]
    gr = (h_prev.reshape(B, H, 1, dh) @ r)[:, :, 0].reshape(B, 4 * H * dh)
    g = (gx + gr).reshape(B, 4, H * dh)
    ig, fg, zg, og = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    ip = torch.exp(ig - m_new)
    fp = torch.exp(logf + m - m_new)
    c = fp * c + ip * torch.tanh(zg)
    n = fp * n + ip
    h = torch.sigmoid(og) * c / _max1(n)
    return h, (c, n, m_new)


def _slstm_ffn(params, h, cd):
    y = rmsnorm(params["norm"], h)
    return dense(params["w_ff_down"], gelu(dense(params["w_ff_up"], y, cd)),
                 cd)


def slstm_apply(params: Params, x, *, cfg, return_state=False):
    """A sequential scan: one step a token (``repro``'s ``lax.scan``)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    cd = cfg.compute_dtype
    gx = dense(params["w_gates"], x, cd).float()
    r = params["r_gates"].float()
    h = torch.zeros((B, d), device=x.device)
    st = (torch.zeros((B, d), device=x.device),
          torch.zeros((B, d), device=x.device),
          torch.full((B, d), NEG, device=x.device))
    hs = []
    for t in range(S):
        h, st = _slstm_cell(gx[:, t], h, st, r, H, dh)
        hs.append(h)
    out = _slstm_ffn(params, torch.stack(hs, 1).to(cd), cd)
    if return_state:
        return out, {"h": h, "c": st[0], "n": st[1], "m": st[2]}
    return out


def slstm_state_init(cfg, batch: int, dtype=None, device="cpu") -> Params:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), device=device),
            "c": torch.zeros((batch, d), device=device),
            "n": torch.zeros((batch, d), device=device),
            "m": torch.full((batch, d), NEG, device=device)}


def slstm_step(params: Params, x1, state, *, cfg):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    cd = cfg.compute_dtype
    gx = dense(params["w_gates"], x1, cd).float()[:, 0]
    r = params["r_gates"].float()
    h, (c, n, m) = _slstm_cell(gx, state["h"],
                               (state["c"], state["n"], state["m"]), r, H,
                               dh)
    out = _slstm_ffn(params, h[:, None].to(cd), cd)
    return out, {"h": h, "c": c, "n": n, "m": m}
