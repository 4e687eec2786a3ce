"""gemma3-12b [dense] — 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144;
5:1 local:global attention (local window 1024), 128k context.
[hf:google/gemma-3-1b-pt family, 12b scaling]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", citation="hf:google/gemma-3-1b-pt",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256,
    block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"), window=1024,
    rope_theta=1_000_000.0,
    fsdp=True,
    train_accum=4,
    long_context_ok=True,      # 5/6 layers windowed; global layers O(S) decode
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512, window=32,
                          fsdp=False, remat=False)
