"""seamless-m4t-medium [audio] — encoder-decoder, 12L enc + 12L dec, d=1024
16H (kv=16) d_ff=4096 vocab=256206. The conformer speech frontend is a STUB:
input_specs supplies w2v-BERT-style frame embeddings; we own the projector,
the transformer encoder and the decoder. [arXiv:2308.11596]

long_500k is skipped for this arch (enc-dec speech translation never
decodes 500k tokens)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", citation="arXiv:2308.11596",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, norm="layernorm",
    block_pattern=("dec_attn",),
    n_enc_layers=12, enc_memory_len=4096,
    modality="audio_embed",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                          n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
                          enc_memory_len=32, remat=False)
