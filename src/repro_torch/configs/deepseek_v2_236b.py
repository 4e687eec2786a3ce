"""deepseek-v2-236b [moe] — 60L d=5120 128H, MLA (kv_lora=512, q_lora=1536,
rope 64 + nope 128 per head, v_head 128), MoE 160 routed top-6 + 2 shared
experts, d_ff_expert=1536, vocab=102400. [arXiv:2405.04434]

bf16 params. The reference's deviations from the published model are
kept: MoE in every layer (the real model's first layer is dense), plain
softmax top-k routing, no YaRN rope scaling, a tied table."""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", citation="arXiv:2405.04434",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab=102400,
    head_dim=128,              # nope sub-dim per head
    kv_lora=512, q_lora=1536, rope_dims=64, v_head_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    block_pattern=("mla",),
    param_dtype=torch.bfloat16,
    moment_dtype=torch.bfloat16,
    fsdp=True,
    train_accum=64,
    long_context_ok=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, kv_lora=32, q_lora=48, rope_dims=16,
                          v_head_dim=32, n_experts=4, top_k=2,
                          n_shared_experts=1, d_ff_expert=64, d_ff=256,
                          vocab=512, param_dtype=torch.float32, fsdp=False,
                          remat=False)
