"""zamba2-1.2b [hybrid] — 38L d=2048, Mamba2 backbone (ssm_state=64) with a
SHARED attention block (32H, MHA) applied every 6th layer through
per-application LoRA adapters (rank 64). [arXiv:2411.15242]

The shared block's serve cache is windowed (4096) so long_500k decodes with
bounded attention state (deviation from full-context shared attn; noted)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", citation="arXiv:2411.15242",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, head_dim=64,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
    window=4096,
    ssm_state=64, ssm_heads=64, ssm_expand=2, ssm_chunk=256,
    long_context_ok=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=8, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab=512, window=32,
                          ssm_state=16, ssm_heads=4, ssm_chunk=16,
                          remat=False)
