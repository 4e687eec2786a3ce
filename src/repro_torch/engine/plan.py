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
    parallelism: its flat ``(B, ...)`` batch splits over the data ranks
    (``pod`` and ``data``; the ``model`` ranks compute the same rows),
    params whole on every rank, global semantics

``spec_fn`` (a single-task model's flat params) and ``shared_spec_fn``
(the trunk of the multi-task layout) shard parameters: ``fn(path, leaf)
-> spec`` (``configs.sharding.make_spec_fn``), and a rank stores only its
block of every leaf whose spec names an axis, for the params and both
AdamW moments. A transformer LM of GQA or MLA attention with a dense or a
MoE feed-forward, or the encoder-decoder
(``configs.sharding.tensor_parallel_family`` at the mesh's ``model``
size, read off the spec function's ``cfg``: ``computes_tensor_parallel``)
then computes in the layout ``repro``'s specs name (``tensor_parallel``;
lm-mtl's trunk so under ``shared_spec_fn``, its per-source heads over
``model`` by task, every task's rows of a data slice on each of its
``model`` ranks, ``rows_shard``): a dim cut over ``model`` stays local
and its product runs on the block, a dim cut over ``data`` (FSDP) is gathered
just before use by ``gather_unit`` — one all-gather a block unit, inside
its remat checkpoint, whose backward reduce-scatters the gradients into
the rank's blocks — and a leaf that names no axis is replicated compute;
``engine.step`` says how the gradients are reduced. Every other model
keeps the data-parallel step: it gathers every cut leaf before the
forward (``gather``), computes the rank's rows with the whole tree,
reduces the gradients as the unsharded plan does, and keeps the rank's
block of each. On both the clip norm sums each block once across the
ranks (``norm_fn``). Semantics stay global: one device's training up to
summation order. ``gather``'s collective is a SUM all-reduce, over the
ranks that hold the leaf's blocks between them, of a buffer that holds
the rank's block and ``-0.0`` everywhere else (``-0.0`` is the exact
additive identity), which gloo runs on CUDA tensors too.

``donate``: a ``Session`` on the plan updates params and moments in their
own storage (it builds ``adamw(donate=plan.donate)``), as ``repro``'s
donated step buffers are reused for its outputs; a step from
``make_step`` takes whatever optimizer it is given.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.taskpar import (HeadPlacement, MTPConfig, TaskShard,
                                      dist_global_norm, flat_shard,
                                      hier_shard, move_heads, take_batch,
                                      take_flat_batch, take_heads)
from repro_torch.configs.sharding import (FSDP, MODEL, holds_first_copy,
                                         local_shard, mesh_shape,
                                         rank_slices, read_spec, spec_axes,
                                         tree_specs)
from repro_torch.interop import leaves, unflatten
from repro_torch.optim.adamw import global_norm

from .state import TrainState

BACKENDS = ("auto", "jit", "pjit", "shard_map", "hier")


def _mesh_array(mesh) -> np.ndarray:
    """A ``DeviceMesh``'s ranks as numpy, read outside any dispatch mode
    (the dry run builds plans under ``FakeTensorMode``; the mesh's rank
    tensor is a real one)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return np.asarray(mesh.mesh.tolist())


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
    shared_spec_fn: Callable | None = None   # trunk params (multitask layout)
    spec_fn: Callable | None = None          # flat params (single-task layout)

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
        if (self.spec_fn or self.shared_spec_fn) is not None and (
                self.mesh is None or self.backend == "shard_map"):
            raise ValueError("spec_fn / shared_spec_fn shard params over a "
                             "mesh with global semantics: a 'pjit' plan")

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
        """The mesh's ranks as (data, model): a multi-pod mesh's ``pod``
        and ``data`` axes flattened, pod-major."""
        ranks = _mesh_array(self.mesh)
        names = tuple(self.mesh.mesh_dim_names)
        if names not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError("a flat plan's mesh has dims ('data', 'model') "
                             "or ('pod', 'data', 'model') (launch.mesh)")
        return ranks.reshape(-1, ranks.shape[-1])

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

    # -- parameter sharding (spec_fn / shared_spec_fn) -----------------------

    @property
    def sharded(self) -> bool:
        """Whether the plan cuts parameter leaves over its mesh."""
        return self.distributed and (self.spec_fn is not None or
                                     self.shared_spec_fn is not None)

    @functools.cached_property
    def computes_tensor_parallel(self) -> bool:
        """Whether the plan computes its model on the rank's blocks: a
        ``"pjit"`` plan whose ``spec_fn`` (single-task) or
        ``shared_spec_fn`` (the multi-task trunk) carries a config
        (``configs.sharding.make_spec_fn`` leaves it as ``fn.cfg``) in
        ``tensor_parallel_family`` at the mesh's ``model`` size. A
        multi-task batch is then sliced for that step (``slice_batch``)."""
        from repro_torch.configs.sharding import tensor_parallel_family
        if not self.sharded or self.resolved_backend != "pjit":
            return False
        fn = self.shared_spec_fn if self.task_parallel else self.spec_fn
        cfg = getattr(fn, "cfg", None)
        return cfg is not None and tensor_parallel_family(
            cfg, mesh_shape(self.mesh)[MODEL])

    @functools.cached_property
    def rows_shard(self) -> TaskShard:
        """The rows this rank computes on a tensor-parallel plan: every
        task's rows (a multi-task model's; none for a single-task one), B
        split over the data axes (the rank's ``model`` column, ``pod``
        and ``data`` flattened), which its ``model`` ranks share."""
        import torch.distributed as dist
        ranks = self._mesh_ranks()
        d, m = (int(x) for x in np.argwhere(ranks == dist.get_rank())[0])
        heads = tuple(range(self.n_tasks)) if self.task_parallel else ()
        return TaskShard(heads=heads, ranks=tuple(int(r) for r in
                                                  ranks[:, m]), index=d)

    def coords_of(self, rank: int) -> dict:
        """``{axis: index}`` of ``rank`` on the mesh."""
        idx = np.argwhere(_mesh_array(self.mesh) == rank)[0]
        return dict(zip(self.mesh.mesh_dim_names, (int(i) for i in idx)))

    @functools.cached_property
    def coords(self) -> dict:
        import torch.distributed as dist
        return self.coords_of(dist.get_rank())

    def layout(self, params) -> dict:
        """``{path: (full shape, spec)}`` of the leaves of a full params
        tree that the plan cuts (a spec naming at least one axis); every
        other leaf is whole on every rank. The multi-task layout's trunk
        goes through ``shared_spec_fn`` with paths inside the trunk, as
        ``repro``'s ``param_shardings`` builds them; heads are sliced by
        task, not here."""
        if not self.sharded:
            return {}
        if set(params) == {"shared", "heads"}:
            if self.shared_spec_fn is None:
                return {}
            specs = {f"shared/{p}": s for p, s in tree_specs(
                params["shared"], self.shared_spec_fn).items()}
        else:
            if self.spec_fn is None:
                return {}
            specs = tree_specs(params, self.spec_fn)
        flat = leaves(params)
        return {p: (tuple(flat[p].shape), s) for p, s in specs.items()
                if any(e is not None for e in s)}

    def param_layout(self, model) -> dict:
        """``layout`` of ``model``'s full tree, read off a ``meta``
        init (no allocation)."""
        return self.layout(model.init(0, device="meta"))

    def cut(self, tree, layout: dict):
        """A full tree -> this rank's: each leaf of ``layout`` cut to the
        rank's block (contiguous), the others as they are."""
        if not layout:
            return tree
        flat = leaves(tree)
        return unflatten(tree, {
            p: (local_shard(x, layout[p][1], self.mesh, self.coords)
                if p in layout else x) for p, x in flat.items()})

    @functools.cached_property
    def _gather_groups(self) -> dict:
        return {}

    def gather_group(self, spec):
        """The process group of the ranks that share this rank's
        coordinates on every mesh axis ``spec`` does not name: between them
        they hold each block of the leaf once. One named axis takes the
        mesh's own group of that axis; several take a group of their
        product, which every rank creates for every such row of the mesh
        in one order (``launch.mesh.process_group``), the world when they
        are all the axes."""
        names = tuple(self.mesh.mesh_dim_names)
        named = tuple(n for n in names if n in spec_axes(spec))
        if named not in self._gather_groups:
            if len(named) == 1:
                group = self.mesh.get_group(named[0])
            else:
                from repro_torch.launch.mesh import process_group
                keep = [i for i, n in enumerate(names) if n in named]
                rest = [i for i, n in enumerate(names) if n not in named]
                ranks = _mesh_array(self.mesh).transpose(rest + keep)
                group = None
                for row in ranks.reshape(
                        -1, int(np.prod(ranks.shape[len(rest):]))):
                    group = process_group(row) or group
            self._gather_groups[named] = group
        return self._gather_groups[named]

    def gather(self, tree, layout: dict):
        """This rank's tree -> the full one (a collective: every rank
        calls it). Each cut leaf is one SUM all-reduce, over the ranks
        that hold its blocks between them (``gather_group``), of a
        full-size buffer holding the rank's block and -0.0 elsewhere, so
        the result is the blocks' exact bits."""
        if not layout:
            return tree
        import torch.distributed as dist
        flat = leaves(tree)
        out = {}
        for p, x in flat.items():
            if p not in layout:
                out[p] = x
                continue
            shape, spec = layout[p]
            buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device)
            buf[rank_slices(shape, spec, self.mesh, self.coords)] = x
            dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                            group=self.gather_group(spec))
            out[p] = buf
        return unflatten(tree, out)

    # -- tensor-parallel compute (the transformer LM families) --------------

    def data_axes(self) -> tuple:
        """The mesh's axes other than ``model``: the batch's rows split
        over them, and a row's ``model`` ranks share it."""
        return tuple(n for n in self.mesh.mesh_dim_names if n != MODEL)

    def gather_unit(self, tree, path: str, layout: dict):
        """``tree``, the params at ``path`` of this rank's tree (one
        repetition of a stacked unit: its leaves lack the leading ``reps``
        dim), with every leaf that ``layout`` cuts over ``data`` gathered
        whole along that dim, whichever it is (a 3-D expert leaf's is
        ``d_model``, dim 1 of ``w_gate`` / ``w_up`` and 2 of ``w_down``):
        one all-gather a dtype over the FSDP group (``gather_group`` of
        ``data``), whose backward reduce-scatters the unit's gradients
        into the rank's blocks. A dim cut over ``model`` stays the rank's
        block (a collective: every rank calls it for the same units in
        the same order)."""
        flat = leaves(tree)
        cut = {}
        for sub, x in flat.items():
            entry = layout.get(f"{path}/{sub}")
            if entry is None:
                continue
            spec = entry[1][len(entry[1]) - x.dim():]
            dims = read_spec(spec).fsdp
            if dims:
                if len(dims) > 1:
                    raise ValueError(f"{path}/{sub}: {spec} cuts more than "
                                     "one dim over data")
                cut[sub] = dims[0]
        if not cut:
            return tree
        group = self.gather_group((FSDP,))
        size = mesh_shape(self.mesh)[FSDP]
        out = dict(flat)
        for dt in dict.fromkeys(flat[k].dtype for k in cut):
            keys = [k for k in cut if flat[k].dtype == dt]
            whole = _GatherUnit.apply(group, size, tuple(cut[k] for k in keys),
                                      *(flat[k] for k in keys))
            out.update(zip(keys, whole))
        return unflatten(tree, out)

    def tensor_parallel(self, layout: dict):
        """The ``models.common.TensorParallel`` of this rank for a params
        tree cut by ``layout``: which products the ``model`` axis cuts
        (read off the leaves' specs: ``wq``'s and ``wk``'s columns,
        ``w_gate``'s, the embedding's rows; a MoE's experts or their
        ``d_ff_expert`` columns, its shared experts' ``w_gate`` columns;
        MLA's ``wq_b`` columns) and, when a leaf is cut over ``data``,
        ``gather_unit`` over the layout. A multi-task layout is read at
        its trunk's leaves (``shared/``), by their paths inside it."""
        import re

        from repro_torch.models.common import TensorParallel
        if any(p.startswith("shared/") for p in layout):   # the trunk's
            layout = {p[len("shared/"):]: v for p, v in layout.items()
                      if p.startswith("shared/")}

        def find(pattern):
            return next(((shape, spec) for p, (shape, spec) in layout.items()
                         if re.search(pattern, p)), None)

        def cut(pattern, dim) -> bool:
            hit = find(pattern)
            return hit is not None and dim in [
                i - len(hit[1]) for i in read_spec(hit[1]).model]
        fsdp = any(read_spec(s).fsdp for _, s in layout.values())
        size = mesh_shape(self.mesh)[MODEL]
        index = self.coords[MODEL]
        vocab = cut(r"^embed/table$", -2)
        if "lm_head/w" in layout and cut(r"^lm_head/w$", -1) != vocab:
            raise ValueError("the embedding's rows and lm_head's columns "
                             "are cut differently over model")
        experts = None
        if cut(r"ffn/w_gate$", -3):         # (E, d, f): whole experts
            n = find(r"ffn/w_gate$")[0][-3] // size
            experts = (index * n, (index + 1) * n)
        mla = cut(r"attn/wq_b/w$", -1)
        if mla and not cut(r"attn/wo/w$", -2):
            raise ValueError("MLA's wq_b columns are cut over model and its "
                             "wo rows are not")
        return TensorParallel(
            group=self.mesh.get_group(MODEL), size=size, index=index,
            heads=cut(r"attn/wq/w$", -1), kv=cut(r"attn/wk/w$", -1),
            ffn=cut(r"ffn/w_gate/w$", -1), vocab=vocab,
            gather=functools.partial(self.gather_unit, layout=layout)
            if fsdp else None,
            experts=experts, expert_ffn=cut(r"ffn/w_gate$", -1),
            shared=cut(r"ffn/shared/w_gate/w$", -1), mla=mla)

    def all_heads(self) -> list:
        """The heads every rank holds, by rank."""
        import torch.distributed as dist
        return [self.shard_of(r).heads
                for r in range(dist.get_world_size())]

    # -- placement helpers ---------------------------------------------------

    def shard_params(self, params):
        """A full ``{"shared", "heads"}`` tree -> this rank's: the trunk and
        its heads' rows (a single-task model's params, whole); with
        ``spec_fn`` / ``shared_spec_fn`` each cut leaf is the rank's block.
        """
        layout = self.layout(params)
        if not (self.distributed and self.task_parallel):
            return self.cut(params, layout)
        return self.cut({"shared": params["shared"],
                         "heads": take_heads(params["heads"],
                                             self.shard.heads)}, layout)

    def shard_state(self, state: TrainState) -> TrainState:
        """A full TrainState -> this rank's: params and both moments keep
        the trunk and the rank's heads (the optimizer's other fields as
        they are)."""
        if not (self.distributed and (self.task_parallel or self.sharded)):
            return state
        opt = state.opt_state
        opt = opt._replace(m=self.shard_params(opt.m),
                           v=self.shard_params(opt.v))
        return state._replace(params=self.shard_params(state.params),
                              opt_state=opt)

    def slice_batch(self, batch: dict, accum: int = 1) -> dict:
        """A task-major batch -> this rank's task rows and B rows (on a
        plan that computes tensor-parallel, every task's rows of its data
        slice, ``rows_shard``); a single-task model's flat batch -> its
        rows (numpy or tensors, where they are). With ``accum``
        microbatches the rank takes its rows of each microbatch of the
        global batch (``core.taskpar.micro_rows``), as ``repro`` shards
        each microbatch."""
        if not self.distributed:
            return batch
        if not self.task_parallel:
            return take_flat_batch(batch, self.shard, accum)
        if self.computes_tensor_parallel:
            return take_batch(batch, self.rows_shard, self.n_tasks, accum)
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

    def norm_fn(self, layout: dict | None = None):
        """The global gradient norm over this plan's reduced grads (a
        single-task model's are whole on every rank). With a ``layout``
        each cut leaf's block adds its squares once, at its first holder,
        to one SUM over the world (with the heads' when task-parallel)."""
        if not layout:
            if not self.task_parallel:
                return global_norm
            return dist_global_norm(self.shard)
        import torch.distributed as dist
        mesh, coords = self.mesh, self.coords
        own = [p for p, (_, s) in layout.items()
               if holds_first_copy(s, mesh, coords)]
        heads = self.task_parallel and self.shard.index == 0

        def norm_fn(grads):
            flat = leaves(grads)
            sq = {p: (g.float() ** 2).sum() for p, g in flat.items()}
            whole = sum(v for p, v in sq.items() if p not in layout and
                        not p.startswith("heads/"))
            cut = sum((sq[p] for p in own), torch.zeros(
                (), device=next(iter(sq.values())).device))
            if heads:
                cut = cut + sum(v for p, v in sq.items()
                                if p.startswith("heads/"))
            cut = cut.reshape(1)
            dist.all_reduce(cut, op=dist.ReduceOp.SUM)
            return torch.sqrt(whole + cut[0])

        return norm_fn

    def state_template(self, init_fn, optimizer):
        """This rank's ``TrainState`` of ``meta`` tensors (no
        allocation): ``init_fn(seed, device="meta")``'s tree cut as the
        rank holds it, and the optimizer's state over it."""
        params = self.shard_params(init_fn(0, device="meta"))
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0)

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


class _GatherUnit(torch.autograd.Function):
    """A unit's FSDP-cut blocks -> the leaves whole along their cut dim:
    one all-gather of the blocks flattened into one buffer (the group's
    rank ``i`` holds block ``i`` of each, ``configs.sharding.
    rank_slices``); backward, the whole gradients cut the same way and
    reduce-scattered, so each rank receives its blocks' gradients summed
    over the group."""

    @staticmethod
    def forward(ctx, group, size, dims, *blocks):
        from repro_torch.launch.mesh import all_gather_flat
        ctx.group, ctx.size, ctx.dims = group, size, dims
        ctx.shapes = [tuple(b.shape) for b in blocks]
        parts = all_gather_flat(torch.cat([b.reshape(-1) for b in blocks]),
                                group, size)
        out, off = [], 0
        for b, d in zip(blocks, dims):
            n = b.numel()
            p = parts[:, off:off + n].reshape((size,) + tuple(b.shape))
            out.append(p.movedim(0, d).reshape(
                b.shape[:d] + (size * b.shape[d],) + b.shape[d + 1:]))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.launch.mesh import reduce_scatter_flat
        n = ctx.size
        pieces = []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            g = g.reshape(shape[:d] + (n, shape[d]) + shape[d + 1:])
            pieces.append(g.movedim(d, 0).reshape(n, -1))
        mine = reduce_scatter_flat(torch.cat(pieces, dim=1), ctx.group, n)
        out, off = [], 0
        for shape in ctx.shapes:
            k = int(np.prod(shape))
            out.append(mine[off:off + k].reshape(shape))
            off += k
        return (None, None, None) + tuple(out)


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
