"""Config registry of the ported architectures: ``get(name)`` /
``get_smoke(name)`` / ``ARCHS``, every arch ``repro`` knows, in its
registry's order; ``ASSIGNED``, the LM archs the dry run sweeps; ``SHAPES``,
the input shapes of the dry run. An unknown name raises ``KeyError``."""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "internvl2-1b": "internvl2_1b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma3-12b": "gemma3_12b",
    "zamba2-1.2b": "zamba2_1_2b",
    "stablelm-12b": "stablelm_12b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-125m": "xlstm_125m",
    "hydragnn-gfm": "hydragnn_gfm",
}
ARCHS = tuple(_MODULES)
ASSIGNED = tuple(a for a in ARCHS if a != "hydragnn-gfm")


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _mod(name).smoke()


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "ArchConfig", "ShapeConfig",
           "get", "get_smoke"]
