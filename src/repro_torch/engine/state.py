"""Unified training state and step output (port of ``repro.engine.state``).

Every train step has ONE signature:

    step(state: TrainState, batch) -> (TrainState, StepOutput)

``TrainState`` bundles params, optimizer state and a step counter;
``StepOutput`` carries the scalar loss plus a dict of auxiliary metrics
(e.g. ``per_task_loss``). The step counter is a host int (``repro`` keeps a
device scalar for its jitted step; PyTorch runs eagerly). ``repro``'s
``rng`` and ``guard`` fields come with the slices that use them.
"""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params, optimizer) -> "TrainState":
        """Initialise from params + an ``Optimizer`` (repro_torch.optim)."""
        return cls(params=params, opt_state=optimizer.init(params), step=0)


class StepOutput(NamedTuple):
    loss: Any                  # () tensor
    metrics: dict              # auxiliary metric tensors (may be empty)
