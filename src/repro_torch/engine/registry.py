"""Model registry (port of ``repro.engine.registry``): build any trainable
model by name.

Registered builders (``build(arch_cfg, *, n_tasks=None, **kw)``):

  * ``gfm-mtl``      — GFM-MTL-All: shared EGNN + per-source branches
  * ``gfm-baseline`` — GFM-Baseline-All: shared EGNN + ONE branch
  * ``lm-mtl``       — shared transformer trunk + per-source LM heads
  * ``lm``           — standard single-task LM (``SingleTaskModel``)
"""
from __future__ import annotations

from typing import Callable

from .step import SingleTaskModel

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


def available_models() -> tuple:
    return tuple(sorted(_REGISTRY))


@register_model("gfm-mtl")
def _gfm_mtl(cfg, *, n_tasks=None, **kw):
    from repro_torch.core.mtl import make_gfm_mtl
    return make_gfm_mtl(cfg, n_tasks or cfg.n_tasks, **kw)


@register_model("gfm-baseline")
def _gfm_baseline(cfg, *, n_tasks=None, **kw):
    """ONE branch regardless of how many sources feed it."""
    from repro_torch.core.mtl import make_gfm_mtl
    return make_gfm_mtl(cfg, 1, **kw)


@register_model("lm-mtl")
def _lm_mtl(cfg, *, n_tasks=None, impl="chunked"):
    from repro_torch.core.mtl import make_lm_multitask
    if n_tasks not in (None, cfg.n_tasks):
        raise ValueError(f"lm-mtl head count is cfg.n_tasks={cfg.n_tasks}, "
                         f"got {n_tasks} sources")
    return make_lm_multitask(cfg, impl)


@register_model("lm")
def _lm(cfg, *, n_tasks=None, impl="chunked"):
    from repro_torch.models.transformer import init_generator, lm_init
    from repro_torch.train.loop import make_lm_loss
    return SingleTaskModel(
        init=lambda seed=0, device="cpu": lm_init(
            init_generator(seed, device), cfg, device),
        loss_fn=make_lm_loss(cfg, impl), name=f"lm-{cfg.name}")

