"""Property-prediction serving (port of ``repro.serve``, single device)."""
from .batching import AdaptivePolicy, AssembledBatch, SizeBinnedBatcher, assemble
from .engine import ServeSession
from .metrics import Reservoir, ServeMetrics
from .queue import (DeadlineExceededError, Request, RequestQueue,
                    ServeClosedError)

__all__ = ["AdaptivePolicy", "AssembledBatch", "DeadlineExceededError",
           "Request", "RequestQueue", "Reservoir", "ServeClosedError",
           "ServeMetrics", "ServeSession", "SizeBinnedBatcher", "assemble"]
