"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base
family, 3b-a800m scaling]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    n_experts=40, top_k=8, d_ff_expert=512,
    block_pattern=("attn",),
    fsdp=True,
    train_accum=2,
    naive_tp=True,
    swa_variant_window=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, n_experts=4, top_k=2, d_ff_expert=64,
                          d_ff=64, vocab=512, fsdp=False, remat=False)
