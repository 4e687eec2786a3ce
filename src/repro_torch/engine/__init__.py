"""repro_torch.engine — the training-session API (port of
``repro.engine``):

    from repro_torch.engine import Session, SessionConfig
    result = Session.from_config(
        SessionConfig(model="gfm-mtl", arch=cfg, steps=300),
        sources=sources).run()

Lower-level pieces: ``TrainState`` / ``StepOutput`` / ``TrainStep`` (the
step protocol ``step(state, batch) -> (state, StepOutput)``), ``make_step``
/ ``make_grad_fn`` / ``with_grad_accum`` (step assembly, for a
``MultiTaskModel`` or a ``SingleTaskModel`` — the LM, downstream
fine-tuning) and the model registry (``available_models()``). ``ArchConfig.segment_sum_impl="fused"`` trains through the fused
EGNN edge kernels (forward and backward) on the card. Multi-task
parallelism on ``torch.distributed``: ``ShardingPlan`` (flat ``"pjit"`` /
``"shard_map"`` meshes, hierarchical ``"hier"`` placements),
``make_grad_fn``, ``HierStepSpec`` and ``HierCompiledStep``.
"""
from .hier import HierCompiledStep  # noqa: F401
from .plan import BACKENDS, ShardingPlan  # noqa: F401
from .registry import (available_models, build_model,  # noqa: F401
                       register_model)
from .session import Session, SessionConfig, SessionResult  # noqa: F401
from .state import GuardState, StepOutput, TrainState  # noqa: F401
from .step import (HierStepSpec, SingleTaskModel, TrainStep,  # noqa: F401
                   make_grad_fn, make_guarded_step, make_guarded_train_step,
                   make_step, make_train_step, multitask_grad_fn,
                   normalized_task_weights, single_grad_fn, with_grad_accum)
