"""Hierarchical multi-task parallelism — data-parallel replicas x per-head
model shards (port of ``repro.engine.hier``: the paper's §4.3–4.4 process
sub-groups, generalised to UNEVEN head-to-device assignment).

A ``HeadPlacement`` deals the ranks into groups (``launch.mesh
.make_group_meshes``, contiguous by ``device_counts``): group g holds the
trunk plus ONLY its heads' rows, its batch slice is data-parallel over the
group's ranks (``hier_batch_spec``), and groups run concurrently. The two
collective scopes are explicit (``core.taskpar.mtp_value_and_grad_dist``):
head grads all-reduce inside the group's process group, trunk grads sum
across groups over the world — the paper's "local DDP for heads, global
all-reduce for the trunk".

Numerics are the flat path's: each group's loss uses the GLOBAL normalised
task-weight slice (``tw[heads]``, not re-normalised in the group), and
each task's loss is normalised over its whole batch, so

    Σ_g Σ_{t∈g} ŵ_t L_t  ==  Σ_t ŵ_t L_t   (summation order only)

and per-task losses are gathered back by head index. Every rank applies
one AdamW update to the trunk and its heads. Gradient accumulation
(``spec.accum``) microbatches the group's grad as ``repro``'s
``with_grad_accum`` does; the rank's batch holds its rows of each
microbatch of the global batch (``plan.slice_batch(batch, accum)``).

``repro`` runs every group from one controller and combines on the host;
here every rank runs its own group's step (one program per rank, as the
paper's HydraGNN does).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.taskpar import hier_shard, mtp_value_and_grad_dist

from .plan import CompiledStep
from .step import make_train_step, normalized_task_weights, with_grad_accum


class HierCompiledStep:
    """The ``plan.compile()`` product for ``backend="hier"``. Called on
    every rank as ``(state, batch) -> (state, StepOutput)`` with the rank's
    state (trunk + its heads) and its batch slice (``plan.shard_batch``).

    One group step function is built per (heads, ranks) key the rank has
    run under (``functions()`` / ``cache_size()``, the seam a recompile
    sanitizer reads); ``update_placement`` swaps the placement and moves
    the heads that change owner, and only a changed key builds anew."""

    def __init__(self, plan, spec):
        from .step import HierStepSpec
        if not isinstance(spec, HierStepSpec):
            raise TypeError("backend='hier' compiles the HierStepSpec "
                            "returned by make_step(model, optimizer, plan) "
                            f"— got {type(spec).__name__}")
        if plan.placement is None:
            raise ValueError("hier plan needs a placement")
        self.plan = plan
        self.spec = spec
        self.placement = plan.placement
        self.n_tasks = self.placement.n_heads
        model_tasks = getattr(spec.model, "n_tasks", 0)
        if model_tasks not in (0, self.n_tasks):
            raise ValueError(f"placement covers {self.n_tasks} heads but "
                             f"model '{spec.model.name}' has {model_tasks}")
        self._groups = {}      # (heads, ranks) -> the group's train step

    def _get_group(self):
        plan = self.plan
        shard = plan.shard
        key = (shard.heads, shard.ranks)
        fn = self._groups.get(key)
        if fn is None:
            # old entries are kept: flipping a placement back reuses them
            grad_fn = mtp_value_and_grad_dist(
                self.spec.model, shard,
                normalized_task_weights(self.n_tasks,
                                        self.spec.task_weights),
                head_group=plan.head_group)
            fn = self._groups[key] = CompiledStep(make_train_step(
                with_grad_accum(grad_fn, self.spec.accum, axis=1),
                self.spec.optimizer, norm_fn=plan.norm_fn()))
        return fn

    def __call__(self, state, batch):
        return self._get_group()(state, batch)

    # -- placement changes ---------------------------------------------------

    def update_placement(self, placement, state=None):
        """Swap the head->group assignment. With ``state`` (this rank's
        TrainState under the old placement), the heads that change owner
        move their params and both AdamW moments from the old owner to
        every rank of the new group (a collective: every rank calls it);
        returns the state under the new placement. Groups whose (heads,
        ranks) key is unchanged keep their step function."""
        import torch.distributed as dist
        if placement.n_heads != self.n_tasks:
            raise ValueError(f"new placement covers {placement.n_heads} "
                             f"heads, step has {self.n_tasks}")
        world = dist.get_world_size()
        old = [hier_shard(self.placement, r).heads for r in range(world)]
        new = [hier_shard(placement, r).heads for r in range(world)]
        self.placement = placement
        self.plan = dataclasses.replace(self.plan, placement=placement)
        if state is None:
            return None
        from repro_torch.core.taskpar import move_heads
        opt = state.opt_state
        p, m, v = move_heads([state.params["heads"], opt.m["heads"],
                              opt.v["heads"]], old, new, dist.get_rank())
        return state._replace(
            params=dict(state.params, heads=p),
            opt_state=opt._replace(m=dict(opt.m, heads=m),
                                   v=dict(opt.v, heads=v)))

    # -- probe seams -----------------------------------------------------------

    def functions(self):
        """Every group step function built so far on this rank, each a
        ``CompiledStep`` (``Session.compiled_functions()`` hands them to a
        recompile sanitizer)."""
        return tuple(self._groups.values())

    def cache_size(self) -> int:
        """The number of group step functions built on this rank."""
        return len(self._groups)
