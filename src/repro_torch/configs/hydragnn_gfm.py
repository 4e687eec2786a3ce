"""hydragnn-gfm — the paper's own architecture (§5): 4-layer EGNN encoder,
866 hidden units per message-passing layer; one branch per dataset (5), each
branch = {energy head, force head} of 3 FC layers x 889 units.
[this paper; HydraGNN v3.0, doi:10.11578/dc.20240131.1]"""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hydragnn-gfm", family="gnn", citation="this paper / HydraGNN v3.0",
    gnn_hidden=866, gnn_layers=4, head_hidden=889, head_layers=3,
    n_tasks=5, n_species=64, max_atoms=64, max_edges=2048,
    compute_dtype=torch.float32,   # paper trains fp32; GNN heads are small
)


def smoke() -> ArchConfig:
    return CONFIG.replace(gnn_hidden=64, gnn_layers=2, head_hidden=32,
                          head_layers=2, max_atoms=16, max_edges=64,
                          n_tasks=3, remat=False)
