"""The multi-task model bundle (the single-device part of
``repro.core.taskpar``; the task-parallel plans come with a later slice)."""
from __future__ import annotations

from typing import Callable, NamedTuple


class MultiTaskModel(NamedTuple):
    """init(seed, device) -> {"shared": ..., "heads": stacked-leading-task-
    dim}. loss_fn(shared, heads, batch) -> (per_task_loss (n_tasks,),
    metrics) over a task-major batch. n_tasks: number of heads/branches."""
    init: Callable
    loss_fn: Callable
    name: str = "mtl"
    n_tasks: int = 0
