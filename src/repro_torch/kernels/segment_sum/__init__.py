from .ops import autotune_blocks, segment_sum
from .ref import segment_sum_ref

__all__ = ["autotune_blocks", "segment_sum", "segment_sum_ref"]
