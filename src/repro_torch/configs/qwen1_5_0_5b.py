"""qwen1.5-0.5b [dense] — 24L d=1024 16H (kv=16, MHA) d_ff=2816 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense", citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, head_dim=64, qkv_bias=True,
    block_pattern=("attn",),
    swa_variant_window=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab=512, remat=False)
