"""Unified train-step construction (port of ``repro.engine.step``):

    grad_fn = make_grad_fn(model, plan)          # either model flavour
    grad_fn = with_grad_accum(grad_fn, accum, axis)
    step    = make_train_step(grad_fn, optimizer)

Models come in two flavours: ``MultiTaskModel`` (``core.taskpar``: params
``{"shared", "heads"}``, per-task losses over a task-major batch — the
paper's technique) and ``SingleTaskModel`` (flat params, a scalar loss over
a flat batch — the LM path and downstream fine-tuning).

``make_step`` composes the pipeline in one call; ``make_guarded_step`` /
``make_guarded_train_step`` build the guarded step of
``repro_torch.resilience`` (``repro.resilience.guard``'s two functions).
A ``grad_fn`` has the
signature ``grad_fn(params, batch) -> (loss, metrics, grads)``; a step has
``step(state, batch) -> (state, StepOutput)``. PyTorch runs eagerly, so
there is nothing to compile.

A task-parallel plan (``engine.plan.ShardingPlan`` with a mesh or a
placement) makes ``make_grad_fn`` the two-scope distributed grad
(``core.taskpar.mtp_value_and_grad_dist``) over the rank's params and batch
slice; a hierarchical plan gets a ``HierStepSpec``, built into a step by
``plan.compile``.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.taskpar import (MultiTaskModel,
                                      mtp_value_and_grad_dist)
from repro_torch.interop import leaves as tree_leaves
from repro_torch.interop import tree_map, unflatten
from repro_torch.optim.adamw import global_norm

from .plan import ShardingPlan
from .state import GuardState, StepOutput, TrainState

# step(state, batch) -> (state, StepOutput)
TrainStep = Callable[[TrainState, Any], tuple[TrainState, StepOutput]]


class SingleTaskModel(NamedTuple):
    """init(seed, device) -> params; loss_fn(params, batch) -> scalar
    loss. ``init`` takes a seed (or a generator) and a device, as
    ``MultiTaskModel``'s does."""
    init: Callable
    loss_fn: Callable
    name: str = "single"


class HierStepSpec(NamedTuple):
    """The ``make_step`` product for hierarchical plans (backend="hier"):
    not a callable — a rank's group step depends on the plan's
    ``HeadPlacement``, so it is built by ``plan.compile()``
    (``engine.hier.HierCompiledStep``) from these ingredients."""
    model: Any
    optimizer: Any
    accum: int = 1
    task_weights: Any = None


def normalized_task_weights(n_tasks: int, task_weights=None,
                            device="cpu") -> torch.Tensor:
    tw = torch.ones(n_tasks, dtype=torch.float32) if task_weights is None \
        else torch.as_tensor(task_weights, dtype=torch.float32)
    return (tw / tw.sum()).to(device)


def _requires_grad(params):
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tree_leaves(params).items()}
    return leaves, unflatten(params, leaves)


def single_grad_fn(model: SingleTaskModel) -> Callable:
    """grad_fn of a ``SingleTaskModel``: the loss and every parameter's
    gradient, no metrics."""
    def grad_fn(params, batch):
        leaves, p = _requires_grad(params)
        with torch.enable_grad():
            loss = model.loss_fn(p, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {}, unflatten(params, dict(zip(leaves, grads)))
    return grad_fn


def multitask_grad_fn(model: MultiTaskModel, n_tasks: int,
                      task_weights=None) -> Callable:
    on_device = {}                  # the weights, copied once per device

    def grad_fn(params, batch):
        leaves, p = _requires_grad(params)
        with torch.enable_grad():
            per_task, metrics = model.loss_fn(p["shared"], p["heads"], batch)
            dev = per_task.device
            if dev not in on_device:
                on_device[dev] = normalized_task_weights(n_tasks,
                                                         task_weights, dev)
            tw = on_device[dev]
            # zero-weight (quarantined) tasks are excluded by select, not by
            # multiplication: 0 * non-finite is still non-finite
            loss = torch.where(tw > 0, per_task * tw,
                               torch.zeros((), device=per_task.device)).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = unflatten(params, dict(zip(leaves, grads)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), dict(metrics, per_task_loss=per_task.detach()), \
            grads

    return grad_fn


def with_grad_accum(grad_fn: Callable, accum: int, axis: int = 1
                    ) -> Callable:
    """Microbatch a grad_fn: split the batch into ``accum`` slices along
    ``axis`` (1 for task-major ``(T, B, ...)`` batches, 0 for flat ones;
    ``repro``'s default is 0, the port keeps 1, which its multi-task
    callers rely on) and average losses, metrics and grads over the
    slices, in slice order. A leaf with no batch dim (ndim <= axis, e.g.
    per-task weights) goes whole to every slice."""
    if accum <= 1:
        return grad_fn

    def split(x):
        if x.dim() <= axis:
            return [x] * accum
        b = x.shape[axis]
        if b % accum:
            raise ValueError(f"batch dim {b} not divisible by accum={accum}")
        return torch.chunk(x, accum, dim=axis)

    def accum_fn(params, batch):
        parts = {k: split(v) for k, v in batch.items()}
        loss, grads, metrics = None, None, []
        for i in range(accum):
            l, m, g = grad_fn(params, {k: v[i] for k, v in parts.items()})
            if loss is None:
                loss, grads = l, g
            else:
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            metrics.append(m)
        metrics = {k: torch.stack([m[k] for m in metrics]).mean(0)
                   for k in metrics[0]}
        grads = tree_map(lambda g: g / accum, grads)
        return loss / accum, metrics, grads

    return accum_fn


def make_train_step(grad_fn: Callable, optimizer,
                    norm_fn=global_norm) -> TrainStep:
    """Wrap a grad_fn + optimizer into the unified TrainStep signature.
    ``norm_fn``: the global gradient norm (``ShardingPlan.norm_fn`` on a
    task-parallel plan)."""
    def step(state: TrainState, batch):
        loss, metrics, grads = grad_fn(state.params, batch)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params, norm_fn)
        new_state = state._replace(params=new_params, opt_state=new_opt,
                                   step=state.step + 1)
        return new_state, StepOutput(loss=loss, metrics=metrics)
    return step


def _fma32(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once (a fused multiply-add). ``repro``'s
    compiled guard step computes its EMA so on the CPU: XLA rounds
    ``decay * ema``, then contracts ``rest * loss`` and the add into one
    FMA. The exact value is a rational; the nearest float32 wins, ties to
    even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    if not np.isfinite(r):
        return r
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                     int(x.view(np.int32)) & 1))


def make_guarded_train_step(grad_fn: Callable, optimizer, gcfg,
                            norm_fn=global_norm) -> TrainStep:
    """A grad_fn + optimizer into a guarded TrainStep (``repro``'s
    ``make_guarded_train_step``). ``gcfg`` is a
    ``repro_torch.resilience.GuardConfig``; the state must carry a
    ``GuardState``.

    A step is accepted when the loss and the gradients' global norm are
    finite and, once ``warmup_steps`` accepted steps have seeded the EMA,
    ``loss <= spike_factor * |EMA| + spike_slack``. The update runs first
    (it leaves its inputs untouched); then the loss and the norm come to
    the host in one read, and the step keeps the new trees or the old ones
    by reference — no select pass over the parameters. A tripped step
    returns params, moments AND the step counter unchanged (so the
    schedule's step stays where it was); tripped losses never enter the
    EMA. The guard's scalars follow ``repro``'s float32 / int32
    arithmetic on the host. ``norm_fn`` as in ``make_train_step``."""
    spike = np.float32(gcfg.spike_factor)
    slack = np.float32(gcfg.spike_slack)
    decay = np.float32(gcfg.ema_decay)
    rest = np.float32(1.0 - gcfg.ema_decay)

    def step(state: TrainState, batch):
        g = state.guard
        loss, metrics, grads = grad_fn(state.params, batch)
        gnorm = norm_fn(grads)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params, norm_fn)
        # the step's one host read: the loss and the global norm together
        # (one non-finite gradient makes the norm non-finite)
        lv, gv = torch.stack([loss.float(), gnorm.float()]).cpu().numpy()
        warm = int(g.good) >= gcfg.warmup_steps
        threshold = spike * np.abs(g.ema) + slack if warm \
            else np.float32(np.inf)
        ok = bool(np.isfinite(lv) and np.isfinite(gv) and lv <= threshold)
        if ok:
            ema = _fma32(rest, lv, decay * g.ema) if int(g.good) > 0 else lv
            guard = GuardState(ema=np.float32(ema),
                               good=np.int32(g.good + 1), trips=np.int32(0))
            new_state = state._replace(params=new_params, opt_state=new_opt,
                                       step=state.step + 1, guard=guard)
        else:
            guard = GuardState(ema=g.ema, good=g.good,
                               trips=np.int32(g.trips + 1))
            new_state = state._replace(guard=guard)
        host = lambda x: torch.tensor(np.float32(x))  # noqa: E731
        metrics = dict(metrics, guard_ok=host(ok),
                       guard_trips=host(guard.trips), guard_gnorm=gnorm,
                       guard_threshold=host(threshold))
        return new_state, StepOutput(loss=loss, metrics=metrics)

    return step


def make_grad_fn(model, plan=None, *, task_weights=None) -> Callable:
    """Backend-aware grad_fn. ``plan``: a ``ShardingPlan`` or None (one
    device). On a flat task-parallel plan it is the two-scope distributed
    grad over the rank's params and batch slice: ``"pjit"`` normalises each
    task's loss over its whole batch, ``"shard_map"`` over each rank's rows
    (uniform task weights only)."""
    if plan is not None and not isinstance(plan, ShardingPlan):
        raise TypeError(f"plan: a ShardingPlan or None, got "
                        f"{type(plan).__name__}")
    if not isinstance(model, MultiTaskModel):
        if plan is not None and plan.distributed:
            raise NotImplementedError(
                "a single-task model on a task-parallel plan (data "
                "parallelism) is not ported: ROADMAP.md, queue 1, item 9b")
        return single_grad_fn(model)
    if plan is None or not plan.distributed:
        return multitask_grad_fn(model, model.n_tasks, task_weights)
    if plan.resolved_backend == "hier":
        raise ValueError("a hier plan's grad is built per group by "
                         "plan.compile(make_step(...))")
    per_shard = plan.resolved_backend == "shard_map"
    if per_shard and task_weights is not None:
        raise ValueError("the shard_map backend supports uniform task "
                         "weights only")
    return mtp_value_and_grad_dist(
        model, plan.shard, normalized_task_weights(plan.n_tasks,
                                                   task_weights),
        head_group=plan.head_group, per_shard=per_shard)


def _grad_fn(model, plan, accum, task_weights):
    if accum > 1 and isinstance(plan, ShardingPlan) and plan.distributed:
        raise NotImplementedError(
            "gradient accumulation on a task-parallel plan is not ported: "
            "use accum=1")
    axis = 1 if isinstance(model, MultiTaskModel) else 0
    return with_grad_accum(make_grad_fn(model, plan,
                                        task_weights=task_weights), accum,
                           axis)


def _norm_fn(plan):
    return plan.norm_fn() if plan is not None and plan.distributed \
        else global_norm


def make_step(model, optimizer, plan=None, *, accum: int = 1,
              task_weights=None):
    """One call from model + optimizer (+ plan) to a TrainStep; run it
    through ``plan.compile(step)``. A hierarchical plan gets a
    ``HierStepSpec`` (same ``plan.compile()`` call, the rank's group step
    built there)."""
    if isinstance(plan, ShardingPlan) and plan.resolved_backend == "hier":
        if not isinstance(model, MultiTaskModel):
            raise TypeError("backend='hier' shards per-task heads — needs a "
                            "MultiTaskModel")
        return HierStepSpec(model=model, optimizer=optimizer, accum=accum,
                            task_weights=task_weights)
    return make_train_step(_grad_fn(model, plan, accum, task_weights),
                           optimizer, _norm_fn(plan))


def make_guarded_step(model, optimizer, plan=None, *, guard,
                      accum: int = 1, task_weights=None) -> TrainStep:
    """``make_step`` with the guard (a ``GuardConfig``) threaded in. A flat
    task-parallel plan's guard reads the global loss and norm, equal on
    every rank, so every rank decides alike; a hierarchical plan raises,
    as ``repro``'s session does."""
    if isinstance(plan, ShardingPlan) and plan.resolved_backend == "hier":
        raise NotImplementedError(
            "guarded stepping (resilience.guard) is not supported on the "
            "hierarchical backend")
    return make_guarded_train_step(
        _grad_fn(model, plan, accum, task_weights), optimizer, guard,
        _norm_fn(plan))
