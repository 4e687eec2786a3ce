"""Plain PyTorch flash attention: the CUDA kernel's reference and CPU path.

A full-softmax port of ``repro``'s ``attention_ref``, in the port's
(B, S, H, D) layout with GQA by grouping query heads (no kv repeat). Scores,
softmax and P·V in f32; the output in q's dtype. Masking is the kernel's:
keys at ``k_pos <= -1e8`` are pads, causal keeps ``q_pos - k_pos >= 0`` and
a window keeps ``q_pos - k_pos < window``; a masked score is the finite
``NEG_INF``, so a query that sees no key averages every key, as the
kernel's online softmax does."""
from __future__ import annotations

import torch

NEG_INF = -1e30
PAD_LIMIT = -(10 ** 8)          # k_pos at or below this is a pad key


def keep_mask(q_pos, k_pos, *, causal: bool, window: int):
    """(Sq,) and (Sk,) integer positions -> bool (Sq, Sk), True = keep."""
    dpos = q_pos[:, None] - k_pos[None, :]
    keep = (k_pos > PAD_LIMIT)[None, :].expand_as(dpos)
    if causal:
        keep = keep & (dpos >= 0)
    if window > 0:
        keep = keep & (dpos < window)
    return keep


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                        scale=None):
    """q: (B,Sq,H,D); k,v: (B,Sk,K,D), H % K == 0 -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    keep = keep_mask(q_pos.long(), k_pos.long(), causal=causal,
                     window=window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
