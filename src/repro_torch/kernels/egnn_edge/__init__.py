from .budget import SmemBudgetError, check_blocks, plan_blocks
from .ops import egnn_edge_agg
from .ref import egnn_edge_agg_ref

__all__ = ["SmemBudgetError", "check_blocks", "egnn_edge_agg",
           "egnn_edge_agg_ref", "plan_blocks"]
