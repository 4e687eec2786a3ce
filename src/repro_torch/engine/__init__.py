"""repro_torch.engine — the training-session API, one device (port of
``repro.engine``):

    from repro_torch.engine import Session, SessionConfig
    result = Session.from_config(
        SessionConfig(model="gfm-mtl", arch=cfg, steps=300),
        sources=sources).run()

Lower-level pieces: ``TrainState`` / ``StepOutput`` / ``TrainStep`` (the
step protocol ``step(state, batch) -> (state, StepOutput)``), ``make_step``
/ ``multitask_grad_fn`` / ``with_grad_accum`` (step assembly) and the model
registry. ``ArchConfig.segment_sum_impl="fused"`` trains through the fused
EGNN edge kernels (forward and backward) on the card.
"""
from .registry import build_model, register_model  # noqa: F401
from .session import Session, SessionConfig, SessionResult  # noqa: F401
from .state import GuardState, StepOutput, TrainState  # noqa: F401
from .step import (TrainStep, make_guarded_step,  # noqa: F401
                   make_guarded_train_step, make_step, make_train_step,
                   multitask_grad_fn, normalized_task_weights,
                   with_grad_accum)
