"""Attention: GQA/MHA (+QKV bias), sliding-window, and DeepSeek-V2 MLA,
``repro``'s layout.

Three compute paths, ``repro``'s names:
  * ``impl="chunked"`` — blocked online-softmax attention in plain PyTorch
    (``repro``'s default): memory O(q_chunk · k_chunk), never O(S²);
  * ``impl="pallas"`` — the hand-written kernels: prefill through
    ``kernels.flash_attention``, decode through ``kernels.flash_decode``
    (CUDA on the card; their plain versions for CPU tensors);
  * ``impl="naive"`` — the full score matrix; the oracle.

Cache layout: ``{"k","v": (B, C, K, hd), "pos": 0-d int32}`` where C is the
full length or the rolling window. Keys are stored post-RoPE at their
absolute positions, so a rolling cache stays valid. A decode step writes
its slot into ``k``/``v`` in place (``index_copy_``), so a token moves one
row per layer rather than copying the cache; the values are ``repro``'s.
Cache layout (MLA): ``{"ckv": (B, C, r), "krope": (B, C, dr), "pos"}``,
written in place the same way.

Tensor-parallel GQA (``gqa_apply(tp=)``, ``models.common.TensorParallel``
with ``tp.heads``): a rank computes its q heads (``wq``'s local columns)
and the kv heads they read — its block of ``wk``/``wv`` when ``model``
divides the kv heads, else the columns of the replicated ones that its
heads' groups need —, RoPE and attention (#5 / #6 under ``"pallas"``) on
them, and ``wo``'s rows as a partial sum that is summed over ``model``
(Megatron's f at the input, g after ``wo``). Its decode cache holds those
kv heads (``local_kv_heads``). ``local_qkv`` / ``local_out`` are those
projections, which the encoder's bidirectional attention and the
decoder's cross-attention (k and v of the encoder's memory) share.

Tensor-parallel MLA (``mla_apply(tp=)`` with ``tp.mla``): the latents —
``q_norm(wq_a x)``, ``kv_norm`` of ``wkv_a``'s first ``kv_lora`` columns
and the RoPE'd shared key — are replicated compute; ``wq_b``, ``wk_b``
and ``wv_b`` give the rank's H/m heads from them (Megatron's f on each
latent where it enters that compute), attention (#5 at q/k head dim dn +
dr under ``"pallas"``) or the absorbed decode runs on those heads, and
``wo``'s rows give a partial sum summed over ``model``. The latent cache
is whole on every ``model`` rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.flash_decode import ops as fd_ops
from .common import (Params, apply_rope, dense, dense_init, ones_init,
                     rmsnorm)

NEG_INF = -1e30
PAD_POS = -(10 ** 9)            # position of a pad or invalid slot


def _mask(q_pos, k_pos, causal: bool, window: int):
    """q_pos: (..., Sq), k_pos: (..., Sk) -> bool (..., Sq, Sk); True=keep.
    Padded/invalid positions use large-negative sentinels; guard them
    explicitly (a -1e9 k_pos would otherwise pass the causal test)."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = (k_pos > -(10 ** 8))[..., None, :] & (q_pos > -(10 ** 8))[..., :, None]
    if causal:
        m = m & (d >= 0)
    if window > 0:
        m = m & (d < window)
    return m


# ---------------------------------------------------------------------------
# Scaled dot-product attention (grouped-query, no kv repeat)
# ---------------------------------------------------------------------------

def sdpa_naive(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale=None):
    """q: (B,Sq,H,hd) k,v: (B,Sk,K,hd). Oracle path."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    m = _mask(q_pos, k_pos, causal, window)  # (Sq,Sk) or (B,Sq,Sk)
    while m.dim() < s.dim():
        m = m[..., None, :, :]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def sdpa_chunked(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale=None,
                 q_chunk=512, k_chunk=1024):
    """Blocked online-softmax attention in plain PyTorch; ``repro``'s
    ``lax.map``/``lax.scan`` over blocks become Python loops."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    pad_q, pad_k = nq * qc - Sq, nk * kc - Sk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=PAD_POS)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k), value=PAD_POS)
    qb = q.reshape(B, nq, qc, K, G, hd).float()
    kb = k.reshape(B, nk, kc, K, hd).float()
    vb = v.reshape(B, nk, kc, K, hd).float()
    qpb, kpb = q_pos.reshape(nq, qc), k_pos.reshape(nk, kc)
    outs = []
    for iq in range(nq):
        qi = qb[:, iq]
        m = torch.full((B, K, G, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, qc), device=q.device)
        acc = torch.zeros((B, K, G, qc, hd), device=q.device)
        for ik in range(nk):
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kb[:, ik]) * scale
            msk = _mask(qpb[iq], kpb[ik], causal, window)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_cur = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp(s - m_cur[..., None])
            corr = torch.exp(m - m_cur)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                       p, vb[:, ik])
            m = m_cur
        o = acc / l.clamp_min(1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))        # (B,qc,K,G,hd)
    out = torch.stack(outs, dim=1).reshape(B, nq * qc, H, hd)
    return out[:, :Sq].to(q.dtype)


def sdpa(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale=None,
         impl="chunked", **kw):
    if impl == "naive":
        return sdpa_naive(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                          window=window, scale=scale)
    if impl == "pallas":
        return fa_ops.flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                      causal=causal, window=window,
                                      scale=scale)
    if impl != "chunked":
        raise ValueError(f"unknown attention impl {impl!r}: naive | chunked "
                         f"| pallas")
    return sdpa_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                        window=window, scale=scale,
                        q_chunk=kw.get("q_chunk", 512),
                        k_chunk=kw.get("k_chunk", 1024))


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(rng, cfg, device="cpu") -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    return {
        "wq": dense_init(rng, d, H * hd, dt, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(rng, d, K * hd, dt, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(rng, d, K * hd, dt, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(rng, H * hd, d, dt,
                         stddev=0.02 / math.sqrt(2 * cfg.n_layers or 2),
                         device=device),
    }


def local_kv_heads(cfg, tp=None):
    """-> (q heads [h0, h1), kv heads [k0, k1), ``owner``) of this rank
    under ``tp`` (every head without it, or when the q heads are whole).
    ``owner`` is None when each kv head of the range serves an equal run
    of the local q heads, in order (plain GQA on the local heads); else
    the index in [k0, k1) of each local q head's kv head, and the kv heads
    are repeated to one a q head."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    if tp is None or not tp.heads:
        return (0, H), (0, K), None
    hl = H // tp.size
    h0 = tp.index * hl
    if tp.kv:
        kl = K // tp.size
        return (h0, h0 + hl), (tp.index * kl, (tp.index + 1) * kl), None
    G = H // K
    k0, k1 = h0 // G, (h0 + hl - 1) // G + 1
    owner = [h // G - k0 for h in range(h0, h0 + hl)]
    run = hl // (k1 - k0)
    if hl % (k1 - k0) == 0 and owner == [i // run for i in range(hl)]:
        owner = None
    return (h0, h0 + hl), (k0, k1), owner


def _kv_columns(p: Params, k0: int, k1: int, hd: int, tp) -> Params:
    """The columns of replicated ``wk``/``wv`` (and bias) for kv heads
    [k0, k1); their gradient is summed over ``model`` (each rank's heads
    read some of them)."""
    out = {"w": tp.copy(p["w"])[:, k0 * hd:k1 * hd]}
    if "b" in p:
        out["b"] = tp.copy(p["b"])[k0 * hd:k1 * hd]
    return out


def local_qkv(params: Params, x, cfg, tp=None, kv_x=None):
    """q of ``x`` (B, S, d) and k, v of ``kv_x`` (B, M, d; ``x`` when None:
    self-attention, a cross-attention's memory otherwise) on the heads
    this rank computes under ``tp`` (every head without it): (B, S, H_l,
    hd) and (B, M, K_l, hd), the kv heads repeated to one a q head where
    ``local_kv_heads`` gives an ``owner``. Megatron's f on each input
    that enters the split products."""
    B, S, _ = x.shape
    hd, cd = cfg.hd, cfg.compute_dtype
    (h0, h1), (k0, k1), owner = local_kv_heads(cfg, tp)
    if tp is not None and tp.heads:
        x = tp.copy(x)
        kv_x = None if kv_x is None else tp.copy(kv_x)
        if not tp.kv:
            params = dict(params, wk=_kv_columns(params["wk"], k0, k1, hd, tp),
                          wv=_kv_columns(params["wv"], k0, k1, hd, tp))
    kv_x = x if kv_x is None else kv_x
    M = kv_x.shape[1]
    q = dense(params["wq"], x, cd).reshape(B, S, h1 - h0, hd)
    k = dense(params["wk"], kv_x, cd).reshape(B, M, k1 - k0, hd)
    v = dense(params["wv"], kv_x, cd).reshape(B, M, k1 - k0, hd)
    if owner is not None:
        k, v = k[:, :, owner], v[:, :, owner]
    return q, k, v


def local_out(params: Params, o, cfg, tp=None):
    """``wo`` over the local heads' output (B, S, H_l, hd): the rank's
    rows of ``wo`` give a partial sum, summed over ``model`` (Megatron's
    g) — whole on every rank."""
    B, S = o.shape[:2]
    out = dense(params["wo"], o.reshape(B, S, -1), cfg.compute_dtype)
    return tp.reduce(out) if tp is not None and tp.heads else out


def gqa_apply(params: Params, x, *, cfg, positions, window=0, cache=None,
              impl="chunked", tp=None):
    """x: (B,S,d). cache None => train/prefill (returns a new cache if
    requested via cache == "init"); else a decode step (S == 1) that writes
    its slot of ``cache["k"]``/``cache["v"]`` in place and returns
    (out, new_cache). ``tp``: tensor-parallel over the local heads (see
    the module docstring); the output is whole on every rank."""
    B, S, d = x.shape
    q, k, v = local_qkv(params, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None or (isinstance(cache, str) and cache == "init"):
        o = sdpa(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                 window=window, impl=impl)
        out = local_out(params, o, cfg, tp)
        if cache == "init":
            pos = torch.tensor(S, dtype=torch.int32, device=x.device)
            return out, {"k": k, "v": v, "pos": pos}
        return out

    # ---- decode: S == 1, rolling or full cache --------------------------
    C = cache["k"].shape[1]
    pos = cache["pos"]  # absolute position of the new token
    slot = torch.remainder(pos, C).reshape(1).long()
    ck = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    # absolute position held by each slot j after the write:
    j = torch.arange(C, device=x.device)
    slot_pos = pos - torch.remainder(pos - j, C)  # <= pos, same residue as j
    valid = slot_pos >= 0
    if window > 0:
        valid = valid & (slot_pos > pos - window)
    k_pos = torch.where(valid, slot_pos, torch.full_like(slot_pos, PAD_POS))
    if impl == "pallas":
        # window already folded into k_pos validity
        o = fd_ops.flash_decode(q, ck, cv, q_pos=pos,
                                k_pos=k_pos[None].expand(B, C))
    else:
        o = sdpa_naive(q, ck, cv, q_pos=positions, k_pos=k_pos, causal=True,
                       window=0)
    return local_out(params, o, cfg, tp), {"k": ck, "v": cv, "pos": pos + 1}


def gqa_cache_init(cfg, batch: int, cache_len: int, dtype=None,
                   device="cpu") -> Params:
    dt = dtype or cfg.compute_dtype
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, cache_len, K, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, cache_len, K, hd), dtype=dt,
                             device=device),
            "pos": torch.tensor(0, dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV, absorbed decode
# ---------------------------------------------------------------------------

def mla_init(rng, cfg, device="cpu") -> Params:
    d, H = cfg.d_model, cfg.n_heads
    r, rq = cfg.kv_lora, cfg.q_lora
    dn, dr, dv = cfg.hd, cfg.rope_dims, cfg.v_head_dim
    dt = cfg.param_dtype
    return {
        "wq_a": dense_init(rng, d, rq, dt, device=device),
        "q_norm": {"scale": ones_init((rq,), dt, device)},
        "wq_b": dense_init(rng, rq, H * (dn + dr), dt, device=device),
        "wkv_a": dense_init(rng, d, r + dr, dt, device=device),
        "kv_norm": {"scale": ones_init((r,), dt, device)},
        "wk_b": dense_init(rng, r, H * dn, dt, device=device),
        "wv_b": dense_init(rng, r, H * dv, dt, device=device),
        "wo": dense_init(rng, H * dv, d, dt,
                         stddev=0.02 / math.sqrt(2 * cfg.n_layers),
                         device=device),
    }


def _mla_heads(cfg, tp) -> int:
    """The MLA heads this rank computes (all of them without ``tp.mla``)."""
    return cfg.n_heads // tp.size if tp is not None and tp.mla \
        else cfg.n_heads


def _mla_project_q(params, x, cfg, positions, tp=None):
    B, S, _ = x.shape
    H, dn, dr = _mla_heads(cfg, tp), cfg.hd, cfg.rope_dims
    cd = cfg.compute_dtype
    qa = rmsnorm(params["q_norm"], dense(params["wq_a"], x, cd))
    if tp is not None and tp.mla:
        qa = tp.copy(qa)
    qb = dense(params["wq_b"], qa, cd).reshape(B, S, H, dn + dr)
    q_nope, q_rope = qb[..., :dn], qb[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_apply(params: Params, x, *, cfg, positions, cache=None,
              impl="chunked", tp=None):
    """x: (B,S,d). Train/prefill: the latent is up-projected to per-head
    k/v and attention runs over q/k of head dim dn + dr with v zero-padded
    to it (``repro``'s semantics: the shared ``sdpa`` at scale 1/√(dn+dr),
    then the padding sliced off). Decode (S == 1, cache given): the
    absorbed form over the latent cache in f32 scores; the token's
    ``ckv``/``krope`` rows are written in place at ``pos`` (no rolling).
    ``tp``: tensor-parallel over the rank's heads (the module docstring);
    the output is whole on every rank."""
    B, S, d = x.shape
    split = tp is not None and tp.mla
    H, r = _mla_heads(cfg, tp), cfg.kv_lora
    dn, dr, dv = cfg.hd, cfg.rope_dims, cfg.v_head_dim
    cd = cfg.compute_dtype
    q_nope, q_rope = _mla_project_q(params, x, cfg, positions, tp)

    kv = dense(params["wkv_a"], x, cd)
    ckv, k_rope = kv[..., :r], kv[..., r:]
    ckv = rmsnorm(params["kv_norm"], ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is None or (isinstance(cache, str) and cache == "init"):
        lat, kr = (tp.copy(ckv), tp.copy(k_rope)) if split else (ckv, k_rope)
        k_nope = dense(params["wk_b"], lat, cd).reshape(B, S, H, dn)
        vv = dense(params["wv_b"], lat, cd).reshape(B, S, H, dv)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], -1)
        o = sdpa(q, k, F.pad(vv, (0, dn + dr - dv)), q_pos=positions,
                 k_pos=positions, causal=True, impl=impl, scale=scale)
        out = dense(params["wo"], o[..., :dv].reshape(B, S, H * dv), cd)
        if split:
            out = tp.reduce(out)
        if cache == "init":
            pos = torch.tensor(S, dtype=torch.int32, device=x.device)
            return out, {"ckv": ckv, "krope": k_rope, "pos": pos}
        return out

    # ---- absorbed decode (S == 1): score/value in latent space ----------
    C = cache["ckv"].shape[1]
    pos = cache["pos"]
    at = pos.reshape(1).long()
    cc = cache["ckv"].index_copy_(1, at, ckv.to(cache["ckv"].dtype))
    cr = cache["krope"].index_copy_(1, at, k_rope.to(cache["krope"].dtype))
    # absorb W_uk into q: q_lat[b,h,r'] = sum_dn q_nope[b,h,dn] Wk_b[r',h,dn]
    # (the rank's heads: wk_b's and wv_b's local columns)
    wkb = params["wk_b"]["w"].reshape(r, H, dn).to(cd)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wkb)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cc.float())
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                        cr.float())) * scale
    k_pos = torch.arange(C, device=x.device)
    s = torch.where((k_pos <= pos)[None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, cc.float())          # (B,H,r)
    wvb = params["wv_b"]["w"].reshape(r, H, dv).to(cd)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(cd), wvb)
    out = dense(params["wo"], o.reshape(B, 1, H * dv), cd)
    if split:
        out = tp.reduce(out)
    return out, {"ckv": cc, "krope": cr, "pos": pos + 1}


def mla_cache_init(cfg, batch: int, cache_len: int, dtype=None,
                   device="cpu") -> Params:
    dt = dtype or cfg.compute_dtype
    return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, cache_len, cfg.rope_dims), dtype=dt,
                                 device=device),
            "pos": torch.tensor(0, dtype=torch.int32, device=device)}
