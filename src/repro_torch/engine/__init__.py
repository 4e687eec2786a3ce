"""repro_torch.engine — the training-session API (port of
``repro.engine``):

    from repro_torch.engine import Session, SessionConfig
    result = Session.from_config(
        SessionConfig(model="gfm-mtl", arch=cfg, steps=300),
        sources=sources).run()

Lower-level pieces: ``TrainState`` / ``StepOutput`` / ``TrainStep`` (the
step protocol ``step(state, batch) -> (state, StepOutput)``), ``make_step``
/ ``multitask_grad_fn`` / ``with_grad_accum`` (step assembly) and the model
registry. ``ArchConfig.segment_sum_impl="fused"`` trains through the fused
EGNN edge kernels (forward and backward) on the card. Multi-task
parallelism on ``torch.distributed``: ``ShardingPlan`` (flat ``"pjit"`` /
``"shard_map"`` meshes, hierarchical ``"hier"`` placements),
``make_grad_fn``, ``HierStepSpec`` and ``HierCompiledStep``.
"""
from .hier import HierCompiledStep  # noqa: F401
from .plan import BACKENDS, ShardingPlan  # noqa: F401
from .registry import build_model, register_model  # noqa: F401
from .session import Session, SessionConfig, SessionResult  # noqa: F401
from .state import GuardState, StepOutput, TrainState  # noqa: F401
from .step import (HierStepSpec, TrainStep, make_grad_fn,  # noqa: F401
                   make_guarded_step, make_guarded_train_step, make_step,
                   make_train_step,
                   multitask_grad_fn, normalized_task_weights,
                   with_grad_accum)
