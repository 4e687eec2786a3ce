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
``plan.compile``. A single-task model on a mesh is data parallelism
(``data_parallel_grad_fn``). Gradient accumulation on any of them takes
each microbatch from the global batch first and the rank's rows of it
second (``plan.slice_batch(batch, accum)``), as ``repro`` does.

A plan with ``spec_fn`` / ``shared_spec_fn`` (``engine.plan``) keeps each
rank's block of every cut leaf, and the clip norm sums each block once
across the ranks (``plan.norm_fn(layout)``). A transformer LM
(``SingleTaskModel.cfg`` in ``configs.sharding.tensor_parallel_family`` at
the mesh's ``model`` size: GQA or MLA attention, a dense SwiGLU or a MoE,
or the encoder-decoder, its encoder and cross-attention on local heads)
computes in the layout ``repro``'s specs name (``tensor_parallel_grad_fn``;
lm-mtl's trunk likewise, its heads over ``model`` by task:
``multitask_tensor_parallel_grad_fn``):
the batch's rows split over the data axes only, a row's ``model`` ranks
share it, and the forward runs on the rank's blocks — local heads (MLA's
after the replicated latent), column- then row-parallel SwiGLU, a MoE's
local experts or ``d_ff_expert`` columns with its routing replicated and
one SUM over ``model`` a layer, a vocab-parallel embedding, logits and
loss, each block unit's FSDP-cut leaves gathered just before use and
their gradients reduce-scattered into the rank's blocks over ``data``.
The gradients of the other leaves, ``model``-local or replicated, are
summed over the data axes only (a replicated leaf's is already whole and
equal on every ``model`` rank: a MoE's router, MLA's ``wq_a`` and
``wkv_a``), and nothing is gathered whole; bf16 params (deepseek's) go
through the same flat reductions, one buffer a dtype. Every
other model keeps the data-parallel step (``sharded_grad_fn``): it
gathers the cut leaves (``plan.gather``, one all-reduce a cut leaf over
the ranks that hold its blocks), runs the grad_fn above on the whole tree
— the rank's rows, all gradients reduced as the unsharded plan reduces
them — and keeps the rank's block of each gradient for AdamW: ZeRO-3's
storage with data-parallel compute, its peak the whole tree and its
gradients.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.taskpar import (MultiTaskModel, _all_reduce, _flat,
                                      _unflat, leaf_grads,
                                      mtp_value_and_grad_dist)
from repro_torch.interop import leaves as tree_leaves
from repro_torch.interop import tree_map, unflatten
from repro_torch.optim.adamw import global_norm

from .plan import ShardingPlan
from .state import GuardState, StepOutput, TrainState

# step(state, batch) -> (state, StepOutput)
TrainStep = Callable[[TrainState, Any], tuple[TrainState, StepOutput]]


class SingleTaskModel(NamedTuple):
    """init(seed, device) -> params; loss_fn(params, batch, norm=None) ->
    scalar loss. ``init`` takes a seed (or a generator) and a device, as
    ``MultiTaskModel``'s does.

    ``batch_counts(batch) -> (c,)`` gives the loss's denominators (an
    LM's tokens, a GFM branch's graphs and atoms), the counterpart of
    ``MultiTaskModel``'s: a rank that holds a shard of the batch passes
    them summed over the ranks as ``norm`` (``{"counts": (c,), "share":
    1 / ranks, "balance": models.moe.Balance}``, and on a tensor-parallel
    plan ``"tp"``, the rank's ``models.common.TensorParallel``), and its
    loss is then its share of the loss over the whole batch. None: no data
    parallelism (a distributed plan raises). ``cfg``: an LM's config,
    which decides whether a ``spec_fn`` plan computes it
    tensor-parallel."""
    init: Callable
    loss_fn: Callable
    name: str = "single"
    batch_counts: Callable | None = None
    cfg: Any = None          # an LM's ArchConfig (tensor-parallel plans)


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
            grads = leaf_grads(loss, leaves)
        return loss.detach(), {}, unflatten(params, dict(zip(leaves, grads)))
    return grad_fn


def _reduce_leaves(tensors: list, group, size: int) -> list:
    """SUM all-reduce of a list of tensors over ``group``: one flat buffer
    a dtype."""
    out = list(tensors)
    for dt in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        buf = _all_reduce(_flat([tensors[i] for i in idx]), group, size)
        for i, t in zip(idx, _unflat(buf, [tensors[i] for i in idx])):
            out[i] = t
    return out


def data_parallel_grad_fn(model: SingleTaskModel, plan) -> Callable:
    """grad_fn of a ``SingleTaskModel`` on a flat distributed plan (data
    parallelism, ``repro``'s ``single_grad_fn`` under pjit): over the
    rank's rows of the flat batch, with global semantics. The loss's
    denominators (``model.batch_counts``) are summed over the ``data``
    ranks that split the rows, so each rank's loss is its share of the
    loss over the whole batch (``norm``), MoE balance terms included.
    Gradients and the loss SUM over every rank, only the first ``model``
    column's contributing (``plan.model_lead``): params stay bitwise equal
    on every rank."""
    if model.batch_counts is None:
        raise ValueError(
            f"single-task model '{model.name}' gives no batch_counts: data "
            "parallelism normalises its loss over the whole batch from "
            "counts summed over the ranks (SingleTaskModel.batch_counts); "
            "averaging per-rank means is another loss")
    import torch.distributed as dist

    from repro_torch.models.moe import Balance
    shard = plan.shard
    n, group = shard.size, plan.head_group
    world = dist.get_world_size()
    lead = plan.model_lead
    balance = Balance(group, n)

    def grad_fn(params, batch):
        counts = model.batch_counts(batch).float().contiguous()
        _all_reduce(counts, group, n)
        norm = {"counts": counts, "share": 1.0 / n, "balance": balance}
        leaves, p = _requires_grad(params)
        with torch.enable_grad():
            loss = model.loss_fn(p, batch, norm=norm)
            grads = leaf_grads(loss, leaves)
        parts = grads + [loss.detach().float().reshape(1)]
        if not lead:
            parts = [torch.zeros_like(g) for g in parts]
        parts = _reduce_leaves(parts, None, world)
        return parts[-1][0], {}, unflatten(params, dict(zip(leaves,
                                                            parts[:-1])))
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
            grads = leaf_grads(loss, leaves)
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
    ``loss <= spike_factor * |EMA| + spike_slack``. The loss and the norm
    come to the host in one read first, and only an accepted step runs
    the update — no select pass over the parameters, and a donating
    optimizer (``adamw(donate=True)``), which overwrites its inputs, never
    touches a tripped step's state. A tripped step returns params,
    moments AND the step counter unchanged (so the schedule's step stays
    where it was); tripped losses never enter the EMA. The guard's
    scalars follow ``repro``'s float32 / int32 arithmetic on the host
    (``repro`` selects between the updated and the old trees: the same
    state). ``norm_fn`` as in ``make_train_step``."""
    spike = np.float32(gcfg.spike_factor)
    slack = np.float32(gcfg.spike_slack)
    decay = np.float32(gcfg.ema_decay)
    rest = np.float32(1.0 - gcfg.ema_decay)

    def step(state: TrainState, batch):
        g = state.guard
        loss, metrics, grads = grad_fn(state.params, batch)
        gnorm = norm_fn(grads)
        # the step's one host read: the loss and the global norm together
        # (one non-finite gradient makes the norm non-finite)
        lv, gv = torch.stack([loss.float(), gnorm.float()]).cpu().numpy()
        warm = int(g.good) >= gcfg.warmup_steps
        threshold = spike * np.abs(g.ema) + slack if warm \
            else np.float32(np.inf)
        ok = bool(np.isfinite(lv) and np.isfinite(gv) and lv <= threshold)
        if ok:
            new_params, new_opt = optimizer.update(grads, state.opt_state,
                                                   state.params, norm_fn)
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
    (uniform task weights only). A single-task model on a distributed plan
    gets ``data_parallel_grad_fn``."""
    if plan is not None and not isinstance(plan, ShardingPlan):
        raise TypeError(f"plan: a ShardingPlan or None, got "
                        f"{type(plan).__name__}")
    if not isinstance(model, MultiTaskModel):
        if plan is not None and plan.distributed:
            return data_parallel_grad_fn(model, plan)
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


def sharded_grad_fn(grad_fn: Callable, plan, layout: dict) -> Callable:
    """``grad_fn`` over the whole tree, on a rank that holds blocks:
    gather the cut leaves (``plan.gather``), run it, keep the rank's block
    of each reduced gradient (``plan.cut``)."""
    def fn(params, batch):
        loss, metrics, grads = grad_fn(plan.gather(params, layout), batch)
        return loss, metrics, plan.cut(grads, layout)
    return fn


class _TensorParallelReduce(NamedTuple):
    """The collectives of a tensor-parallel step: ``rows``, the group of
    the ``n`` ranks over the data axes that split a row (its ``model``
    ranks share it), and the gradient reduction (``__call__``)."""
    rows: Any
    n: int
    pod: Any
    pod_n: int
    fsdp: frozenset

    @classmethod
    def of(cls, plan, layout: dict) -> "_TensorParallelReduce":
        from repro_torch.configs.sharding import FSDP, mesh_shape, read_spec
        sizes = mesh_shape(plan.mesh)
        axes = plan.data_axes()
        n = int(np.prod([sizes[a] for a in axes]))
        pod = tuple(a for a in axes if a != FSDP)
        return cls(plan.gather_group(axes), n,
                   plan.gather_group(pod) if pod else None,
                   n // sizes[FSDP] if pod else 1,
                   frozenset(p for p, (_, s) in layout.items()
                             if read_spec(s).fsdp))

    def __call__(self, leaves: dict, grads: list, extra: list) -> tuple:
        """``{name: reduced gradient}`` and ``extra`` (loss terms) summed
        over the data axes: the gradients of leaves cut over ``data`` come
        out of ``gather_unit``'s reduce-scatter summed over ``data`` and
        are summed over ``pod`` where the mesh has one; the others (and
        ``extra``) over every data axis, one flat buffer a dtype."""
        names = list(leaves)
        cut = [i for i, k in enumerate(names) if k in self.fsdp]
        rest = [i for i, k in enumerate(names) if k not in self.fsdp]
        parts = _reduce_leaves([grads[i] for i in rest] + extra, self.rows,
                               self.n)
        out = dict(zip([names[i] for i in rest], parts))
        if cut:
            out.update(zip([names[i] for i in cut], _reduce_leaves(
                [grads[i] for i in cut], self.pod, self.pod_n)))
        return out, parts[len(rest):]


def tensor_parallel_grad_fn(model: SingleTaskModel, plan, layout: dict
                            ) -> Callable:
    """grad_fn of a transformer LM on a ``spec_fn`` plan, over this rank's
    blocks and its rows (see the module docstring). The loss's
    denominators and the loss are summed over the data axes, and the
    gradients reduced by ``_TensorParallelReduce``."""
    from repro_torch.models.moe import Balance
    tp = plan.tensor_parallel(layout)
    reduce = _TensorParallelReduce.of(plan, layout)
    balance = Balance(reduce.rows, reduce.n)

    def grad_fn(params, batch):
        counts = model.batch_counts(batch).float().contiguous()
        _all_reduce(counts, reduce.rows, reduce.n)
        norm = {"counts": counts, "share": 1.0 / reduce.n,
                "balance": balance, "tp": tp}
        leaves, p = _requires_grad(params)
        with torch.enable_grad():
            loss = model.loss_fn(p, batch, norm=norm)
            grads = leaf_grads(loss, leaves)
        out, (loss,) = reduce(leaves, grads,
                              [loss.detach().float().reshape(1)])
        return loss[0], {}, unflatten(params, out)
    return grad_fn


def multitask_tensor_parallel_grad_fn(model: MultiTaskModel, plan,
                                      layout: dict, task_weights=None
                                      ) -> Callable:
    """grad_fn of an LM ``MultiTaskModel`` (lm-mtl) on a ``shared_spec_fn``
    plan that computes its trunk tensor-parallel: the rank's trunk blocks
    and heads, every task's rows of its data slice (``plan.rows_shard``).
    Each task's loss is its cross-entropy summed over the rank's rows and
    divided by its tokens summed over the data axes; the loss function
    decodes the rank's own tasks (``norm["tasks"]``: its heads) after
    Megatron's f in ``"par"``, every task in ``"base"``. The paper's two
    collective scopes inside one tensor-parallel step
    (``_TensorParallelReduce``, one flat buffer a dtype):

      * the trunk's gradients as ``tensor_parallel_grad_fn`` reduces a
        single-task model's: ``model``-local and replicated leaves summed
        over the data axes, FSDP leaves reduce-scattered by
        ``gather_unit`` (and summed over ``pod``);
      * each head's gradient summed over the data axes only, over the
        ranks that hold that head (``"par"``: the rank's ``model``
        column; ``"base"``: every head is whole on every rank and equal
        across ``model``).

    The per-task losses are made whole on every rank by one SUM over the
    world of a (T,) vector that holds the rank's own tasks' shares (in
    ``"base"`` only the first ``model`` column's, whose tasks are all)."""
    import torch.distributed as dist

    from repro_torch.models.moe import Balance
    tp = plan.tensor_parallel(layout)
    reduce = _TensorParallelReduce.of(plan, layout)
    balance = Balance(reduce.rows, reduce.n)
    T = model.n_tasks
    tasks = tuple(plan.shard.heads)
    world = dist.get_world_size()
    lead = len(tasks) < T or plan.model_lead      # the rank reports its
    tw_host = normalized_task_weights(T, task_weights)   # tasks' losses
    on_device = {}

    def grad_fn(params, batch):
        counts = model.batch_counts(batch).float().contiguous()
        _all_reduce(counts, reduce.rows, reduce.n)
        dev = counts.device
        if dev not in on_device:
            own = torch.zeros(T, dtype=torch.bool)
            own[list(tasks)] = lead
            on_device[dev] = (tw_host.to(dev), own.to(dev))
        tw, own = on_device[dev]
        norm = {"counts": counts, "share": torch.full((T,), 1.0 / reduce.n,
                                                      device=dev),
                "balance": balance, "tp": tp, "tasks": tasks}
        leaves, p = _requires_grad(params)
        with torch.enable_grad():
            pt, metrics = model.loss_fn(p["shared"], p["heads"], batch,
                                        norm=norm)
            # zero-weight (quarantined) tasks are excluded by select
            objective = torch.where(tw > 0, pt * tw,
                                    torch.zeros((), device=dev)).sum()
            grads = leaf_grads(objective, leaves)
        out, _ = reduce(leaves, grads, [])
        mnames = list(metrics)
        vec = torch.stack([pt.detach().float()] + [
            metrics[k].detach().float() for k in mnames])
        vec = _all_reduce(torch.where(own, vec, torch.zeros_like(vec)),
                          None, world)
        per_task = vec[0]
        loss = torch.where(tw > 0, per_task * tw,
                           torch.zeros((), device=dev)).sum()
        out_metrics = {k: vec[1 + i] for i, k in enumerate(mnames)}
        out_metrics["per_task_loss"] = per_task
        return loss, out_metrics, unflatten(params, out)
    return grad_fn


def _tensor_parallel(model, plan, layout) -> bool:
    """Whether ``model`` computes on the rank's blocks of ``layout``: a
    config in ``tensor_parallel_family`` at the mesh's ``model`` size.
    A multi-task model follows its plan (``plan.computes_tensor_parallel``,
    which also slices its batches): a ``shard_map`` plan keeps the
    data-parallel step, whose per-shard semantics (each rank normalises
    over its own rows, one head a ``model`` rank) have no tensor-parallel
    counterpart — it carries no ``shared_spec_fn``, so ``layout`` is
    empty there; so does a ``shared_spec_fn`` that carries no config."""
    from repro_torch.configs.sharding import (MODEL, mesh_shape,
                                             tensor_parallel_family)
    if not layout:
        return False
    if isinstance(model, MultiTaskModel):
        if not plan.computes_tensor_parallel:
            return False
        if model.cfg is None or not tensor_parallel_family(
                model.cfg, mesh_shape(plan.mesh)[MODEL]):
            raise ValueError(
                f"model '{model.name}': its plan computes the trunk "
                "tensor-parallel (shared_spec_fn's config) and slices its "
                "batches so, but the model's cfg does not")
        return True
    return model.cfg is not None and tensor_parallel_family(
        model.cfg, mesh_shape(plan.mesh)[MODEL])


def _layout(model, plan) -> dict:
    return plan.param_layout(model) if isinstance(plan, ShardingPlan) and \
        plan.sharded else {}


def _grad_fn(model, plan, accum, task_weights, layout=None):
    axis = 1 if isinstance(model, MultiTaskModel) else 0
    if _tensor_parallel(model, plan, layout):
        fn = multitask_tensor_parallel_grad_fn(
            model, plan, layout, task_weights) if axis else \
            tensor_parallel_grad_fn(model, plan, layout)
        return with_grad_accum(fn, accum, axis)
    fn = with_grad_accum(make_grad_fn(model, plan,
                                      task_weights=task_weights), accum, axis)
    return sharded_grad_fn(fn, plan, layout) if layout else fn


def _norm_fn(plan, layout=None):
    return plan.norm_fn(layout) if plan is not None and plan.distributed \
        else global_norm


def make_step(model, optimizer, plan=None, *, accum: int = 1,
              task_weights=None):
    """One call from model + optimizer (+ plan) to a TrainStep; run it
    through ``plan.compile(step)``. A hierarchical plan gets a
    ``HierStepSpec`` (same ``plan.compile()`` call, the rank's group step
    built there). With ``accum`` > 1 on a distributed plan the step takes
    ``plan.slice_batch(batch, accum)``: the rank's rows of each
    microbatch."""
    if isinstance(plan, ShardingPlan) and plan.resolved_backend == "hier":
        if not isinstance(model, MultiTaskModel):
            raise TypeError("backend='hier' shards per-task heads — needs a "
                            "MultiTaskModel")
        return HierStepSpec(model=model, optimizer=optimizer, accum=accum,
                            task_weights=task_weights)
    layout = _layout(model, plan)
    return make_train_step(_grad_fn(model, plan, accum, task_weights, layout),
                           optimizer, _norm_fn(plan, layout))


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
    layout = _layout(model, plan)
    return make_guarded_train_step(
        _grad_fn(model, plan, accum, task_weights, layout), optimizer, guard,
        _norm_fn(plan, layout))
