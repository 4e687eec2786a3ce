from .ops import flash_decode, plan_splits
from .ref import combine_partials, decode_partials_ref, decode_ref

__all__ = ["combine_partials", "decode_partials_ref", "decode_ref",
           "flash_decode", "plan_splits"]
