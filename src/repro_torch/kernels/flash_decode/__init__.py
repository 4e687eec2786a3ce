from .ops import Plan, flash_decode, plan_call, plan_splits
from .ref import combine_partials, decode_partials_ref, decode_ref

__all__ = ["Plan", "combine_partials", "decode_partials_ref", "decode_ref",
           "flash_decode", "plan_call", "plan_splits"]
