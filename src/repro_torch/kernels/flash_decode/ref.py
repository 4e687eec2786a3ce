"""Plain PyTorch flash-decode: the CUDA kernel's reference and CPU path.

``decode_partials_ref`` computes what each split of the kernel computes —
the online-softmax partials (m, l, acc) of one query token against its
slice of the cache — and ``combine_partials`` (a port of ``repro``'s)
merges them exactly. ``decode_ref`` is the full-softmax oracle (a port of
``repro``'s ``decode_ref``). Everything in f32; masked scores take the
finite ``NEG_INF``, so a split whose keys are all masked keeps m = NEG_INF
and gets weight 0 in the combine."""
from __future__ import annotations

import torch

NEG_INF = -1e30
PAD_LIMIT = -(10 ** 8)          # k_pos at or below this is a pad key


def _scores(q, k, q_pos, k_pos, window, scale):
    """q (B,1,H,D), k (B,S,K,D), q_pos (B,), k_pos (B,S) -> masked f32
    scores (B,K,G,S)."""
    B, _, H, D = q.shape
    K = k.shape[2]
    qg = q[:, 0].reshape(B, K, H // K, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    dpos = q_pos[:, None] - k_pos
    keep = (k_pos > PAD_LIMIT) & (dpos >= 0)
    if window > 0:
        keep = keep & (dpos < window)
    return torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))


def decode_ref(q, k, v, *, q_pos, k_pos, window=0, scale=None):
    """q: (B,1,H,D); k,v: (B,S,K,D); q_pos (B,); k_pos (B,S) -> (B,1,H,D)."""
    B, _, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    p = torch.softmax(_scores(q, k, q_pos, k_pos, window, scale), dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_partials_ref(q, k, v, *, q_pos, k_pos, n_splits: int,
                        per_split: int, window=0, scale=None):
    """Split s covers cache rows [s·per_split, (s+1)·per_split) ∩ [0, S).
    Returns m, l (B,K,G,n_splits) and acc (B,K,G,n_splits,D), f32; a split
    past the cache end has m = NEG_INF, l = 0, acc = 0."""
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    s_all = _scores(q, k, q_pos, k_pos, window, scale)
    dev = q.device
    m = torch.full((B, K, G, n_splits), NEG_INF, device=dev)
    l = torch.zeros((B, K, G, n_splits), device=dev)
    acc = torch.zeros((B, K, G, n_splits, D), device=dev)
    for i in range(n_splits):
        lo, hi = i * per_split, min(S, (i + 1) * per_split)
        if lo >= hi:
            continue
        s = s_all[..., lo:hi]
        m_i = s.max(dim=-1).values
        p = torch.exp(s - m_i[..., None])
        m[..., i] = m_i
        l[..., i] = p.sum(-1)
        acc[..., i, :] = torch.einsum("bkgs,bskd->bkgd", p,
                                      v[:, lo:hi].float())
    return m, l, acc


def combine_partials(m, l, acc):
    """Exact combine of per-split online-softmax partials -> (B,K,G,D)."""
    m_max = m.max(dim=-1, keepdim=True).values
    w = torch.exp(m - m_max)
    l_tot = (l * w).sum(-1)
    acc_tot = (acc * w[..., None]).sum(-2)
    return acc_tot / l_tot.clamp_min(1e-30)[..., None]
