"""h2o-danube-1.8b [dense] — 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000;
llama+mistral mix with sliding-window attention (window 4096).
[arXiv:2401.16818]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense", citation="arXiv:2401.16818",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab=32000, head_dim=80,
    block_pattern=("swa",), window=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=512, window=32,
                          remat=False)
