"""Property-prediction serving (port of ``repro.serve``): one session on
one device, its rows split over a serving mesh (``ServeSession(mesh=)``),
or replicas behind a least-loaded router (``ReplicaServeSession``)."""
from .batching import AdaptivePolicy, AssembledBatch, SizeBinnedBatcher, assemble
from .engine import ServeSession
from .metrics import Reservoir, ServeMetrics
from .queue import (DeadlineExceededError, Request, RequestQueue,
                    ServeClosedError)
from .scaleout import ReplicaScheduler, ReplicaServeSession

__all__ = ["AdaptivePolicy", "AssembledBatch", "DeadlineExceededError",
           "ReplicaScheduler", "ReplicaServeSession", "Request",
           "RequestQueue", "Reservoir", "ServeClosedError", "ServeMetrics",
           "ServeSession", "SizeBinnedBatcher", "assemble"]
