"""Plain PyTorch segment-sum: the CUDA kernel's reference and CPU path.

A one-hot membership matmul (the same formulation as ``repro``'s ``"jnp"``
impl), f32 accumulation, output in the message dtype. Deterministic on
every device; ``index_add_``/``scatter_add_`` are deliberately not used."""
from __future__ import annotations

import torch


def segment_sum_ref(messages: torch.Tensor, dst: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """messages (E,F) or (B,E,F); dst (E,) or (B,E) — any ``dst`` outside
    ``[0, n_nodes)`` contributes nothing. Returns (n_nodes,F) or
    (B,n_nodes,F)."""
    squeeze = messages.dim() == 2
    m = messages[None] if squeeze else messages
    d = dst[None] if squeeze else dst
    nodes = torch.arange(n_nodes, device=m.device)
    onehot = (d[..., None] == nodes).to(torch.float32)          # (B,E,A)
    out = torch.bmm(onehot.transpose(1, 2), m.to(torch.float32))
    out = out.to(messages.dtype)
    return out[0] if squeeze else out
