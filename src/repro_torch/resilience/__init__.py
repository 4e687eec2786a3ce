"""repro_torch.resilience — fault-tolerant pre-training (port of
``repro.resilience``).

Guarded stepping (loss-spike/NaN rollback), preemption-safe full-state
checkpointing, retried IO, and a deterministic fault-injection harness.
Wire it into a run with ``SessionConfig(resilience=ResilienceConfig(...))``.
"""
from .faults import (
    KINDS,
    Fault,
    FaultSchedule,
    InjectedFault,
    ProducerKilled,
    corrupt_batch,
    poison_nan,
    scale_floats,
)
from .guard import (
    GuardConfig,
    GuardState,
    StepGuard,
    make_guarded_step,
    make_guarded_train_step,
    zero_task_slices,
)
from .policy import (
    CheckpointManager,
    CheckpointPolicy,
    CheckpointWriteError,
    PreemptionHandler,
)
from .retry import RetryError, with_retry
from .runner import ResilienceConfig, run_resilient

__all__ = [
    "KINDS",
    "Fault",
    "FaultSchedule",
    "InjectedFault",
    "ProducerKilled",
    "corrupt_batch",
    "poison_nan",
    "scale_floats",
    "GuardConfig",
    "GuardState",
    "StepGuard",
    "make_guarded_step",
    "make_guarded_train_step",
    "zero_task_slices",
    "CheckpointManager",
    "CheckpointPolicy",
    "CheckpointWriteError",
    "PreemptionHandler",
    "RetryError",
    "with_retry",
    "ResilienceConfig",
    "run_resilient",
]
