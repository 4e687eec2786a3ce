"""internvl2-1b [vlm] — 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655;
InternViT vision encoder is a STUB (input_specs provides patch embeddings),
we own the projector + Qwen2-0.5B-style language backbone. [arXiv:2404.16821]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", citation="arXiv:2404.16821",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, head_dim=64, qkv_bias=True,
    block_pattern=("attn",),
    modality="vision_embed", n_media_tokens=256,
    naive_tp=True,  # 14 heads % 16 != 0 (the reference's sharding note)
    swa_variant_window=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512, n_media_tokens=8,
                          remat=False)
