"""stablelm-12b [dense] — 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b family, 12b scaling]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    citation="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, head_dim=160,
    block_pattern=("attn",),
    fsdp=True,
    train_accum=4,
    swa_variant_window=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512, fsdp=False,
                          remat=False)
