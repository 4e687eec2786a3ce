from .adamw import AdamWState, Optimizer, adamw, global_norm
from .schedules import warmup_cosine

__all__ = ["AdamWState", "Optimizer", "adamw", "global_norm",
           "warmup_cosine"]
