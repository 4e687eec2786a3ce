"""xlstm-125m [ssm] — 12L d=768 4H, alternating mLSTM (matrix memory) and
sLSTM (scalar memory) blocks, d_ff=0 (blocks own their projections),
vocab=50304. [arXiv:2405.04517]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", citation="arXiv:2405.04517",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=192,
    block_pattern=("mlstm", "slstm"),
    long_context_ok=True,      # O(1) recurrent state
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, vocab=512, remat=False)
