"""Unified training state and step output (port of ``repro.engine.state``).

Every train step has ONE signature:

    step(state: TrainState, batch) -> (TrainState, StepOutput)

``TrainState`` bundles params, optimizer state, a step counter, a PRNG key
and the guard's scalars; ``StepOutput`` carries the scalar loss plus a dict
of auxiliary metrics (e.g. ``per_task_loss``). The step counter is a host
int (``repro`` keeps a device scalar for its jitted step; PyTorch runs
eagerly).

``rng`` is carried, never used: the port's GNN training draws nothing at
step time. It holds the two uint32 words of ``repro``'s key for the same
seed (``prng_key``), so a full-state checkpoint has the leaf ``repro``
expects and restores in either package. ``guard`` is a ``GuardState`` of
host scalars in guarded sessions (``repro_torch.resilience``), None
otherwise.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


def prng_key(seed: int) -> np.ndarray:
    """The (2,) uint32 words of ``repro``'s ``PRNGKey(seed)`` for a
    non-negative seed: threefry's (high, low) words of the seed, which JAX
    without x64 first cuts to its low 32 bits."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"prng_key takes a non-negative seed, got {seed}")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


class GuardState(NamedTuple):
    """The guard's scalars (``repro``'s ``GuardState``), threaded through
    ``TrainState.guard`` so they ride every checkpoint and rollback with
    the params. Host numpy scalars: the guarded step reads its loss and
    gradient norm once a step to decide, and updates these on the host in
    float32 / int32, as ``repro`` does on the device."""
    ema: np.float32      # EMA of ACCEPTED losses
    good: np.int32       # accepted steps seen (arms the spike check)
    trips: np.int32      # consecutive tripped steps

    @classmethod
    def init(cls) -> "GuardState":
        return cls(ema=np.float32(0), good=np.int32(0), trips=np.int32(0))


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    rng: Any = None            # repro's key words, carried (see above)
    guard: Any = None          # GuardState in guarded sessions

    @classmethod
    def create(cls, params, optimizer, rng=None, guard=None) -> "TrainState":
        """Initialise from params + an ``Optimizer`` (repro_torch.optim)."""
        return cls(params=params, opt_state=optimizer.init(params), step=0,
                   rng=rng, guard=guard)


class StepOutput(NamedTuple):
    loss: Any                  # () tensor
    metrics: dict              # auxiliary metric tensors (may be empty)
