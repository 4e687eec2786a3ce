"""The GNN side of ``ArchConfig`` with torch dtypes.

``repro.configs.base`` imports jax for its dtypes, so the port keeps its own
dataclass holding only the fields the EGNN trunk and the MTL heads read.
Field names and defaults match the reference."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = ""
    family: str = "gnn"
    citation: str = ""
    # multi-task: one branch per data source --------------------------------
    n_tasks: int = 1
    # GNN (hydragnn-gfm) ----------------------------------------------------
    gnn_hidden: int = 0
    gnn_layers: int = 0
    head_hidden: int = 0           # MTL head FC width (paper: 889)
    head_layers: int = 3
    max_atoms: int = 0
    max_edges: int = 0
    n_species: int = 0
    # message-aggregation path ("scatter" | "jnp" | "pallas" | "fused"),
    # see repro_torch.models.gnn
    segment_sum_impl: str = "scatter"
    # kernel tile overrides (0 = plan from the problem shape):
    kernel_block_n: int = 0        # segment_sum node-tile rows
    kernel_block_e: int = 0        # edge window staged in shared memory
    kernel_block_h: int = 0        # egnn_edge column tile (threads per CTA)
    # precision -------------------------------------------------------------
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
