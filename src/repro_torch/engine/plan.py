"""ShardingPlan — one object that owns the parallelism decisions (port of
``repro.engine.plan``).

A plan bundles the mesh, the multi-task-parallelism config (``MTPConfig``)
and the backend behind one ``plan.compile(step)`` call. Every rank of a job
builds the same plan and runs the same program; a rank holds the trunk,
only its own heads' rows (and their AdamW moments) and its slice of each
batch:

  * ``mesh=None``                       -> one device (``"jit"``)
  * ``mesh=..., backend="pjit"``        -> a ``(data, model)`` mesh of
    ranks, global semantics: each task's loss is normalised over its whole
    batch, so training equals one device's up to summation order (mode
    ``"par"``: heads sliced over ``model``; ``"base"``: heads whole, pure
    DDP)
  * ``mesh=..., backend="shard_map"``   -> per-shard semantics: each rank
    normalises over its own rows and the scopes average (``repro``'s
    explicit ``psum`` scopes; one head per ``model`` rank, uniform task
    weights)
  * ``placement=..., backend="hier"``   -> a ``HeadPlacement``: heads on
    uneven rank groups (``engine.hier``), global semantics
  * ``mesh=...`` without ``mtp``        -> a single-task model's data
    parallelism: its flat ``(B, ...)`` batch splits over the ``data``
    ranks (the ``model`` ranks compute the same rows), params whole on
    every rank, global semantics

``donate``: a ``Session`` on the plan updates params and moments in their
own storage (it builds ``adamw(donate=plan.donate)``), as ``repro``'s
donated step buffers are reused for its outputs; a step from
``make_step`` takes whatever optimizer it is given.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core.taskpar import (HeadPlacement, MTPConfig, TaskShard,
                                      dist_global_norm, flat_shard,
                                      hier_shard, move_heads, take_batch,
                                      take_flat_batch, take_heads)
from repro_torch.optim.adamw import global_norm

from .state import TrainState

BACKENDS = ("auto", "jit", "pjit", "shard_map", "hier")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any = None                   # DeviceMesh ("data", "model")
    mtp: MTPConfig | None = None
    backend: str = "auto"              # auto | jit | pjit | shard_map | hier
    donate: bool = True                # in-place AdamW (see above)
    # hierarchical backend: a HeadPlacement (heads -> uneven rank groups,
    # core.solve_placement) INSTEAD of a mesh — the plan deals the ranks
    # into per-group sub-groups itself
    placement: HeadPlacement | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend '{self.backend}' not in {BACKENDS}")
        if self.backend in ("pjit", "shard_map") and self.mesh is None:
            raise ValueError(f"backend '{self.backend}' needs a mesh")
        if self.backend == "hier" and self.placement is None:
            raise ValueError("backend='hier' needs a placement (see "
                             "repro_torch.core.solve_placement / "
                             "round_robin_placement)")
        if self.placement is not None:
            if self.mesh is not None:
                raise ValueError(
                    "placement and mesh are exclusive — a hierarchical plan "
                    "builds its own per-group sub-groups from the ranks")
            if self.backend not in ("auto", "hier"):
                raise ValueError(f"placement needs backend 'auto' or "
                                 f"'hier', got '{self.backend}'")

    @property
    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        if self.placement is not None:
            return "hier"
        return "jit" if self.mesh is None else "pjit"

    @property
    def distributed(self) -> bool:
        return self.resolved_backend != "jit"

    @property
    def task_parallel(self) -> bool:
        """Heads sharded over ranks (an ``mtp`` or a placement); False for
        a single-task model's plan."""
        return self.mtp is not None or self.placement is not None

    @property
    def n_tasks(self) -> int:
        if self.placement is not None:
            return self.placement.n_heads
        if self.mtp is None:
            raise ValueError("a mesh plan needs mtp (an MTPConfig)")
        return self.mtp.n_tasks

    # -- which rows each rank holds ------------------------------------------

    def _mesh_ranks(self) -> np.ndarray:
        ranks = np.asarray(self.mesh.mesh.tolist())
        if ranks.ndim != 2 or tuple(self.mesh.mesh_dim_names) != (
                "data", "model"):
            raise ValueError("a flat plan's mesh has dims ('data', 'model') "
                             "(launch.mesh.make_host_mesh)")
        return ranks

    def shard_of(self, rank: int) -> TaskShard:
        """What ``rank`` holds under this plan (every rank can ask)."""
        if self.placement is not None:
            return hier_shard(self.placement, rank)
        ranks = self._mesh_ranks()
        if self.mtp is None:
            # a single-task model: no heads, B over the rank's data column
            d, m = (int(x) for x in np.argwhere(ranks == rank)[0])
            col = tuple(int(r) for r in ranks[:, m])
            return TaskShard(heads=(), ranks=col, index=d)
        if self.resolved_backend == "shard_map" and (
                ranks.shape[1] != self.mtp.n_tasks or self.mtp.mode != "par"):
            raise ValueError(f"shard_map slices one head to a 'model' rank: "
                             f"needs mode 'par' and n_tasks == mesh['model'] "
                             f"({self.mtp.n_tasks} vs {ranks.shape[1]})")
        return flat_shard(self.mtp, ranks, rank)

    @functools.cached_property
    def shard(self) -> TaskShard:
        """This rank's ``TaskShard`` (the whole model on one device)."""
        if not self.distributed:
            return TaskShard(heads=tuple(range(self.n_tasks)) if
                             self.task_parallel else (), ranks=(0,), index=0)
        import torch.distributed as dist
        return self.shard_of(dist.get_rank())

    @functools.cached_property
    def head_group(self):
        """This rank's head group: the process group over
        ``shard.ranks`` (created on every rank, in one order)."""
        from repro_torch.launch.mesh import make_group_meshes, process_group
        if self.placement is not None:
            meshes = make_group_meshes(self.placement)
            return next(m.group for m in meshes if m.group is not None)
        if self.mtp is not None and self.mtp.mode == "base":
            return process_group(self.shard.ranks)
        return self.mesh.get_group("data")

    @property
    def model_lead(self) -> bool:
        """Whether this rank is on the mesh's first ``model`` column: a
        single-task model's ``model`` ranks compute the same rows, and only
        the first column's gradients enter the sum (the others add zeros),
        so one SUM over every rank leaves the same bits on each."""
        import torch.distributed as dist
        return dist.get_rank() in self._mesh_ranks()[:, 0]

    def all_heads(self) -> list:
        """The heads every rank holds, by rank."""
        import torch.distributed as dist
        return [self.shard_of(r).heads
                for r in range(dist.get_world_size())]

    # -- placement helpers ---------------------------------------------------

    def shard_params(self, params):
        """A full ``{"shared", "heads"}`` tree -> this rank's: the trunk and
        its heads' rows (a single-task model's params, whole)."""
        if not (self.distributed and self.task_parallel):
            return params
        return {"shared": params["shared"],
                "heads": take_heads(params["heads"], self.shard.heads)}

    def shard_state(self, state: TrainState) -> TrainState:
        """A full TrainState -> this rank's: params and both moments keep
        the trunk and the rank's heads (the optimizer's other fields as
        they are)."""
        if not (self.distributed and self.task_parallel):
            return state
        opt = state.opt_state
        opt = opt._replace(m=self.shard_params(opt.m),
                           v=self.shard_params(opt.v))
        return state._replace(params=self.shard_params(state.params),
                              opt_state=opt)

    def slice_batch(self, batch: dict, accum: int = 1) -> dict:
        """A task-major batch -> this rank's task rows and B rows; a
        single-task model's flat batch -> its rows (numpy or tensors, where
        they are). With ``accum`` microbatches the rank takes its rows of
        each microbatch of the global batch (``core.taskpar.micro_rows``),
        as ``repro`` shards each microbatch."""
        if not self.distributed:
            return batch
        if not self.task_parallel:
            return take_flat_batch(batch, self.shard, accum)
        return take_batch(batch, self.shard, self.n_tasks, accum)

    def shard_batch(self, batch: dict, device=None, accum: int = 1) -> dict:
        """This rank's slice (``slice_batch``) of a host batch, placed on
        ``device`` (default: the rank's device; one device: ``cuda``,
        raising without a GPU — the CPU must be asked for)."""
        if device is None:
            from repro_torch import resolve_device
            from repro_torch.launch.mesh import rank_device
            device = rank_device() if self.distributed else resolve_device()
        return {k: (v if isinstance(v, torch.Tensor) else
                    torch.from_numpy(np.ascontiguousarray(v))).to(device)
                for k, v in self.slice_batch(batch, accum).items()}

    def gather_heads(self, trees):
        """Every head's rows on every rank: this rank's head trees (e.g.
        params, m and v heads) -> the full ``(n_tasks, ...)`` trees, each
        head broadcast from the first rank that holds it (a collective:
        every rank calls it)."""
        if not self.distributed:
            return list(trees)
        import torch.distributed as dist
        everything = tuple(range(self.n_tasks))
        world = dist.get_world_size()
        return move_heads(trees, self.all_heads(), [everything] * world,
                          dist.get_rank())

    def gather_params(self, params):
        """This rank's params -> the full tree (a collective; a
        single-task model's params are whole on every rank already)."""
        if not (self.distributed and self.task_parallel):
            return params
        return {"shared": params["shared"],
                "heads": self.gather_heads([params["heads"]])[0]}

    def norm_fn(self):
        """The global gradient norm over this plan's reduced grads (a
        single-task model's are whole on every rank)."""
        if not self.task_parallel:
            return global_norm
        return dist_global_norm(self.shard)

    # -- compilation ---------------------------------------------------------

    def compile(self, step):
        """The one public way to build a step. Eager PyTorch compiles
        nothing: a flat plan's step comes back as a ``CompiledStep`` around
        it; hierarchical plans take the ``HierStepSpec`` from ``make_step``
        and return a ``HierCompiledStep`` (same call signature)."""
        from .step import HierStepSpec
        if self.resolved_backend == "hier":
            from .hier import HierCompiledStep
            return HierCompiledStep(self, step)
        if isinstance(step, HierStepSpec):
            raise TypeError(f"a HierStepSpec can only be compiled by a hier "
                            f"plan (this plan resolves to "
                            f"'{self.resolved_backend}')")
        return CompiledStep(step)


class CompiledStep:
    """A step function as ``plan.compile`` returns it: called as the step
    itself, with ``cache_size()`` the seam ``repro_torch.analysis.
    RecompileSanitizer`` reads (``repro``'s ``CompiledStep.cache_size``).
    Eager PyTorch builds no executable, so the one "compilation" is the
    build: 1 from construction on, and a rebuilt step is a new object that
    counts 1 again."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state, batch):
        return self.fn(state, batch)

    def cache_size(self) -> int:
        return 1
