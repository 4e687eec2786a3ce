"""The GFM-MTL parameter tree (the init half of ``repro.core.mtl``).

Level 1: one branch per data source; level 2: each branch = {energy head,
force head}. The loss and the training step come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import gnn, heads


def gfm_mtl_init(cfg, n_tasks: int, *, seed: int = 0, device="cpu",
                 uncertainty: bool = False) -> dict:
    """``{"shared": egnn params, "heads": stacked branch params}``, the
    layout of ``repro``'s ``make_gfm_mtl(cfg, n_tasks).init``. The trunk and
    the heads draw from two numpy streams derived from ``seed``;
    ``device="meta"`` gives a shape-only template."""
    hp = heads.stacked_branches_init(cfg, n_tasks, seed=seed + 1,
                                     device=device)
    if uncertainty:
        hp["log_sigma2"] = torch.zeros((n_tasks, 2), dtype=torch.float32,
                                       device=device)
    return {"shared": gnn.egnn_init(cfg, seed=seed, device=device),
            "heads": hp}
