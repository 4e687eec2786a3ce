"""``ArchConfig`` with torch dtypes.

``repro.configs.base`` imports jax for its dtypes, so the port keeps its own
dataclass holding only the fields its ported paths read: the EGNN trunk and
the MTL heads, and the decoder-only LM trunk (GQA ``attn``/``swa`` blocks).
Field names and defaults match the reference; MoE, MLA, SSM and
encoder-decoder fields come with their slices."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = ""
    family: str = "gnn"
    citation: str = ""
    # LM trunk --------------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # attention pattern: 0 = full attention; >0 = sliding window. The unit
    # is repeated to n_layers; the port's blocks are "attn" and "swa".
    window: int = 0
    block_pattern: tuple = ("attn",)
    # multi-task: one branch (GNN) or one LM head (LM) per data source -----
    n_tasks: int = 1
    # GNN (hydragnn-gfm) ----------------------------------------------------
    gnn_hidden: int = 0
    gnn_layers: int = 0
    head_hidden: int = 0           # MTL head FC width (paper: 889)
    head_layers: int = 3
    max_atoms: int = 0
    max_edges: int = 0
    n_species: int = 0
    # message-aggregation path ("scatter" | "jnp" | "pallas" | "fused"),
    # see repro_torch.models.gnn
    segment_sum_impl: str = "scatter"
    # kernel tile overrides (0 = plan from the problem shape):
    kernel_block_n: int = 0        # segment_sum node-tile rows
    kernel_block_e: int = 0        # edge window staged in shared memory
    kernel_block_h: int = 0        # egnn_edge column tile, 32 columns a warp
    # precision -------------------------------------------------------------
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        if self.vocab == 0:
            return 0
        return -(-self.vocab // 256) * 256

    @property
    def pattern(self) -> tuple:
        """Full per-layer pattern of length n_layers."""
        unit = self.block_pattern
        reps = -(-self.n_layers // len(unit))
        return (unit * reps)[: self.n_layers]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
