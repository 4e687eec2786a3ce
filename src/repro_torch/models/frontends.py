"""Modality frontends (port of ``repro.models.frontends``): stubs.

The ViT / conv-codec themselves are out of scope: the inputs are
precomputed patch / frame embeddings. What the model owns is the learned
projector that maps those embeddings into the LM's d_model space (the
VLM / audio "adapter"): layernorm, fc1 with a bias, ReLU, fc2 with a bias.
"""
from __future__ import annotations

import torch

from .common import Params, dense, dense_init, layernorm, ones_init, zeros_init

# embedding widths the stubs emit (typical ViT-L / w2v-BERT frame widths)
VISION_EMBED_DIM = 1024
AUDIO_EMBED_DIM = 1024


def projector_init(rng, cfg, device="cpu") -> Params:
    d_in = VISION_EMBED_DIM if cfg.modality == "vision_embed" \
        else AUDIO_EMBED_DIM
    dt = cfg.param_dtype
    return {
        "ln": {"scale": ones_init((d_in,), dt, device),
               "bias": zeros_init((d_in,), dt, device)},
        "fc1": dense_init(rng, d_in, cfg.d_model, dt, bias=True,
                          device=device),
        "fc2": dense_init(rng, cfg.d_model, cfg.d_model, dt, bias=True,
                          device=device),
    }


def projector_apply(params: Params, media_embed, cfg):
    """media_embed: (B, n_media, d_in) -> (B, n_media, d_model), in the
    compute dtype (the input is cast to it before the layernorm). ReLU is
    ``repro``'s ``maximum(x, 0)``: at an exact 0 the gradient splits."""
    cd = cfg.compute_dtype
    x = layernorm(params["ln"], media_embed.to(cd))
    x = dense(params["fc1"], x, cd)
    x = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return dense(params["fc2"], x, cd)
