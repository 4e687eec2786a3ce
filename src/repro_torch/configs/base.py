"""``ArchConfig`` with torch dtypes.

``repro.configs.base`` imports jax for its dtypes, so the port keeps its own
dataclass holding only the fields its ported paths read: the EGNN trunk and
the MTL heads, and the decoder-only LM trunk (GQA ``attn``/``swa``,
DeepSeek-V2 ``mla``, the recurrent ``mamba2``/``mlstm``/``slstm`` blocks
and zamba's ``shared_attn``, the MoE feed-forward, per-block
rematerialisation in training), plus the sharding and memory fields
(``fsdp`` and ``naive_tp``, which ``configs.sharding`` reads;
``train_accum``, ``moment_dtype``, ``swa_variant_window``,
``long_context_ok`` and ``supports_decode``, which ``launch.dryrun`` and
``configs.specs`` read). Field names and defaults match
the reference; so do the encoder-decoder (``enc_attn``/``dec_attn``) and
modality-frontend fields (``n_enc_layers``, ``enc_memory_len``,
``modality``, ``n_media_tokens``)."""
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
    # is repeated to n_layers; the port's blocks are "attn", "swa", "mla",
    # "mamba2", "mlstm", "slstm", "shared_attn" (zamba-style
    # shared-weight attention with per-application LoRA), "enc_attn"
    # (bidirectional) and "dec_attn" (self + cross, enc-dec only).
    window: int = 0
    block_pattern: tuple = ("attn",)
    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0           # per-expert hidden size
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2) ------------------------------------------------------
    kv_lora: int = 0               # latent rank for compressed KV (0 => GQA)
    q_lora: int = 0
    rope_dims: int = 0             # per-head rotary sub-dim
    v_head_dim: int = 0
    # SSM -------------------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    mlstm_chunked: bool = True     # chunkwise-parallel mLSTM (the scan is
                                   # the oracle)
    # encoder-decoder ---------------------------------------------------------
    n_enc_layers: int = 0          # >0 => encoder-decoder (seamless)
    enc_memory_len: int = 4096     # stub encoder-memory length for serving
    # modality frontends (stubs) ----------------------------------------------
    modality: str = "text"         # text | vision_embed | audio_embed
    n_media_tokens: int = 0        # prepended embedding tokens for vlm/audio
    # sharding and serving (``configs.sharding``, ``launch.dryrun``) --------
    naive_tp: bool = False         # head-fractional TP (the reference's
                                   # pre-head-aligned rule)
    moment_dtype: Any = torch.float32
    fsdp: bool = False             # ZeRO-3-style param sharding over "data"
    train_accum: int = 1           # gradient-accumulation microbatches
    supports_decode: bool = True
    long_context_ok: bool = False  # native sub-quadratic path for long_500k
    swa_variant_window: int = 0    # >0: the SWA serve variant for long_500k
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
    # training: recompute each LM block's activations in the backward
    # (``repro``'s per-block ``jax.checkpoint``; torch.utils.checkpoint)
    remat: bool = True

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
