"""Model registry (port of ``repro.engine.registry``, GFM models only):

  * ``gfm-mtl``      — GFM-MTL-All: shared EGNN + per-source branches
  * ``gfm-baseline`` — GFM-Baseline-All: shared EGNN + ONE branch

The LM models (``lm``, ``lm-mtl``) come with the LM slice.
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def build_model(name: str, cfg, **kw):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, **kw)


@register_model("gfm-mtl")
def _gfm_mtl(cfg, *, n_tasks=None, **kw):
    from repro_torch.core.mtl import make_gfm_mtl
    return make_gfm_mtl(cfg, n_tasks or cfg.n_tasks, **kw)


@register_model("gfm-baseline")
def _gfm_baseline(cfg, *, n_tasks=None, **kw):
    """ONE branch regardless of how many sources feed it."""
    from repro_torch.core.mtl import make_gfm_mtl
    return make_gfm_mtl(cfg, 1, **kw)
