"""Multi-task parallelism (the paper's contribution), on ``torch.distributed``
(port of ``repro.core.taskpar``).

The paper (§4.3–4.4) distributes the per-dataset decoding heads across
process sub-groups: every process holds the shared trunk plus its own heads;
head gradients all-reduce only inside the head's sub-group (local DDP) while
trunk gradients all-reduce globally. Memory per process falls from
``P_s + N_h·P_h`` to ``P_s + P_h``.

One process (rank) stands for one device. ``repro`` states the layout as
shardings of global arrays; here each rank holds only its rows, and these
plain functions say which:

  * heads are stacked ``(n_tasks, ...)``; mode ``"par"`` slices them over
    the mesh's ``model`` (task) ranks, mode ``"base"`` keeps them whole on
    every rank (the paper's MTL-base baseline, pure DDP);
  * the batch is task-major ``(n_tasks, B, ...)``: its task rows follow the
    heads, its B rows split over the ranks that hold the same heads (the
    head's data group) — over the ``data`` ranks in ``"par"``, over all
    ranks in ``"base"``, over a group's ranks under a ``HeadPlacement``
    (``hier_batch_spec``: replicated when B does not split evenly).

``mtp_value_and_grad_dist`` makes the two collective scopes explicit (the
counterpart of ``repro``'s ``mtp_value_and_grad_shardmap``). Train-step
construction lives in ``repro_torch.engine``: ``ShardingPlan(...)
.compile(make_step(model, optimizer, plan))`` on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.interop import leaves, unflatten


def leaf_grads(loss, leaves: dict) -> list:
    """d loss / d each leaf; a leaf the loss does not reach (a vision
    model's projector on a text-only batch) gets zeros, as ``jax.grad``
    gives it."""
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for g, v in zip(grads, leaves.values())]


@dataclasses.dataclass(frozen=True)
class MTPConfig:
    """``repro``'s ``MTPConfig`` without its axis names: a flat plan's
    mesh always has dims ``("data", "model")``, the task axis ``model``."""
    n_tasks: int
    mode: str = "par"              # "par" (task-sliced heads) | "base" (whole)


class MultiTaskModel(NamedTuple):
    """init(seed, device) -> {"shared": ..., "heads": stacked-leading-task-
    dim}. loss_fn(shared, heads, batch, norm=None) -> (per_task_loss
    (n_tasks,), metrics) over a task-major batch. n_tasks: number of
    heads/branches.

    ``batch_counts(batch) -> (k, c)`` gives each task row's loss
    denominators (the GFM's graphs and atoms, an LM's tokens). A rank that
    holds a shard of a task's batch passes the counts summed over the
    task's ranks as ``norm``: ``{"counts": (k, c), "share": (k,),
    "balance": models.moe.Balance}``; its loss is then its share of the
    global loss, normalised over the whole batch, and the shares of a
    task's ranks sum to that loss (``share`` scales the terms that do not
    depend on the batch, ``balance`` names the ranks an MoE balance term
    is shared by). None: normalise over the batch given.

    ``cfg``: an LM trunk's config (``core.mtl.make_lm_multitask``), which
    decides whether a ``shared_spec_fn`` plan computes the trunk
    tensor-parallel (``SingleTaskModel.cfg``'s counterpart; None: the
    GFM models, data-parallel). On such a plan ``norm`` also carries
    ``"tp"`` (the rank's ``models.common.TensorParallel``) and
    ``"tasks"`` (the tasks whose heads the rank holds and decodes), and
    the batch holds every task's rows of the rank's data slice."""
    init: Callable
    loss_fn: Callable
    name: str = "mtl"
    n_tasks: int = 0
    batch_counts: Callable | None = None
    cfg: Any = None


# ---------------------------------------------------------------------------
# Which rows a rank holds
# ---------------------------------------------------------------------------

def head_rows(mtp: MTPConfig, model_index: int, model_size: int) -> tuple:
    """Head indices held by the rank at ``model_index`` on a task axis of
    ``model_size`` ranks: a contiguous block of ``n_tasks / model_size`` in
    ``"par"``, every head in ``"base"``."""
    if mtp.mode == "base":
        return tuple(range(mtp.n_tasks))
    if mtp.n_tasks % model_size:
        raise ValueError(f"mode 'par' slices {mtp.n_tasks} heads over a "
                         f"task axis of {model_size}: it must divide them")
    k = mtp.n_tasks // model_size
    return tuple(range(model_index * k, (model_index + 1) * k))


def hier_batch_spec(batch_size: int, n_devices: int, index: int) -> slice:
    """The B rows one of a group's ``n_devices`` ranks holds (``repro``'s
    ``configs.sharding.hier_batch_spec``): B splits evenly over the group's
    ranks, and is replicated on each when it does not tile evenly."""
    n = max(n_devices, 1)
    if batch_size % n:
        return slice(0, batch_size)
    per = batch_size // n
    return slice(index * per, (index + 1) * per)


class TaskShard(NamedTuple):
    """What one rank holds: the head rows ``heads`` (in row order), and
    the head group — the ``ranks`` that hold the same heads, over which the
    heads' gradients all-reduce and the batch's B rows split — with this
    rank at ``ranks[index]``."""
    heads: tuple
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def batch_rows(self, batch_size: int) -> slice:
        return hier_batch_spec(batch_size, self.size, self.index)


def flat_shard(mtp: MTPConfig, mesh_ranks: np.ndarray, rank: int
               ) -> TaskShard:
    """The ``TaskShard`` of ``rank`` on a ``(data, model)`` mesh whose
    ``mesh_ranks[d, m]`` is the rank at that coordinate. ``"par"``: heads
    by ``m``, B over the ``data`` ranks of column ``m``; ``"base"``: every
    head, B over all ranks (row-major)."""
    mesh_ranks = np.asarray(mesh_ranks)
    where = np.argwhere(mesh_ranks == rank)
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not on the mesh {mesh_ranks}")
    d, m = (int(x) for x in where[0])
    heads = head_rows(mtp, m, mesh_ranks.shape[1])
    if mtp.mode == "base":
        ranks = tuple(int(r) for r in mesh_ranks.reshape(-1))
    else:
        ranks = tuple(int(r) for r in mesh_ranks[:, m])
    return TaskShard(heads=heads, ranks=ranks, index=ranks.index(rank))


def group_ranks(placement: "HeadPlacement") -> list:
    """Ranks of each group of a placement: dealt contiguously by
    ``device_counts`` (``repro``'s ``make_group_meshes``)."""
    out, off = [], 0
    for c in placement.device_counts:
        out.append(tuple(range(off, off + c)))
        off += c
    return out


def hier_shard(placement: "HeadPlacement", rank: int) -> TaskShard:
    """The ``TaskShard`` of ``rank`` under a hierarchical placement."""
    for heads, ranks in zip(placement.groups, group_ranks(placement)):
        if rank in ranks:
            return TaskShard(heads=tuple(heads), ranks=ranks,
                             index=ranks.index(rank))
    raise ValueError(f"rank {rank} is outside the placement's "
                     f"{placement.n_devices} devices")


def take_heads(tree, heads):
    """The rows ``heads`` of every leaf's leading (task) dim: tensors or
    numpy arrays, nested dicts."""
    if isinstance(tree, dict):
        return {k: take_heads(v, heads) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[torch.as_tensor(heads, dtype=torch.long,
                                    device=tree.device)]
    return np.asarray(tree)[np.asarray(heads, np.int64)]


def micro_rows(shard: TaskShard, batch_size: int, accum: int = 1):
    """The B rows a rank holds of a batch that ``with_grad_accum`` splits
    into ``accum`` microbatches, as ``repro`` splits the global batch
    first and shards each microbatch: microbatch m is global rows
    ``[m·B/accum, (m+1)·B/accum)``, and the rank holds its
    ``batch_rows`` of each, in microbatch order — so splitting the rank's
    rows into ``accum`` pieces gives its part of each microbatch. A slice
    at ``accum`` 1, else an index array."""
    if accum <= 1:
        return shard.batch_rows(batch_size)
    if batch_size % accum:
        raise ValueError(f"batch dim {batch_size} not divisible by "
                         f"accum={accum}")
    per = batch_size // accum
    own = np.arange(per)[shard.batch_rows(per)]
    return np.concatenate([m * per + own for m in range(accum)])


def _take_rows(v, rows, axis: int):
    if isinstance(rows, slice):
        return v[(slice(None),) * axis + (rows,)]
    if isinstance(v, torch.Tensor):
        return v.index_select(axis, torch.as_tensor(rows, device=v.device))
    return np.take(v, rows, axis=axis)


def take_batch(batch: dict, shard: TaskShard, n_tasks: int,
               accum: int = 1) -> dict:
    """A rank's view of a task-major batch: its task rows and its B rows
    (``micro_rows``). Leaves without a leading ``(n_tasks,)`` dim pass
    whole."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n_tasks:
            v = take_heads(v, shard.heads)
            if v.ndim >= 2:
                v = _take_rows(v, micro_rows(shard, v.shape[1], accum), 1)
        out[k] = v
    return out


def take_flat_batch(batch: dict, shard: TaskShard, accum: int = 1) -> dict:
    """A rank's rows of a flat ``(B, ...)`` batch of a single-task model:
    B splits evenly over the ``shard.ranks`` (``repro``'s pjit shards dim
    0 over the data axes; an uneven split raises), microbatch by
    microbatch (``micro_rows``). 0-d leaves pass whole."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            b = v.shape[0]
            if (b // max(accum, 1)) % shard.size:
                raise ValueError(
                    f"'{k}': a flat batch of {b} rows in {accum} "
                    f"microbatch(es) does not split evenly over "
                    f"{shard.size} data ranks")
            v = _take_rows(v, micro_rows(shard, b, accum), 0)
        out[k] = v
    return out


def memory_per_device(p_shared: int, p_head: int, n_heads: int,
                      mode: str) -> int:
    """Paper §4.3: parameter count resident per device."""
    return p_shared + (p_head if mode == "par" else n_heads * p_head)


# ---------------------------------------------------------------------------
# Hierarchical placement vocabulary: heads -> (possibly uneven) device groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPlacement:
    """Head -> device-group assignment for the hierarchical backend.

    ``groups[g]`` is the tuple of head indices owned by group g;
    ``device_counts[g]`` is how many devices (ranks) group g gets. Groups
    partition BOTH the heads (every head in exactly one group) and the
    device pool (counts sum to ``n_devices``). Within a group the batch is
    data-parallel over the group's ranks and the group's head slice is
    resident only there: memory per device is ``P_s + Σ_{t∈g} P_h(t)``,
    the paper's §4.3 number when groups hold one head each.

    ``loads`` optionally records the per-head load model the placement was
    solved against (``data.mixing`` weights); it is bookkeeping only.
    Invalid layouts raise ``ValueError`` (``repro`` asserts).
    """
    groups: tuple                  # ((head, ...), ...) — disjoint, exhaustive
    device_counts: tuple           # devices per group, all >= 1
    loads: tuple | None = None     # per-head load model used by the solver

    def __post_init__(self):
        groups = tuple(tuple(int(h) for h in g) for g in self.groups)
        counts = tuple(int(c) for c in self.device_counts)
        object.__setattr__(self, "groups", groups)
        object.__setattr__(self, "device_counts", counts)
        if len(groups) != len(counts):
            raise ValueError(f"{len(groups)} groups vs {len(counts)} device "
                             "counts")
        if not all(c >= 1 for c in counts):
            raise ValueError(f"empty device group: {counts}")
        if not all(len(g) >= 1 for g in groups):
            raise ValueError(f"headless group: {groups}")
        flat = [h for g in groups for h in g]
        if sorted(flat) != list(range(len(flat))):
            raise ValueError(f"groups must partition heads "
                             f"0..{len(flat) - 1}, got {groups}")
        if self.loads is not None:
            loads = tuple(float(x) for x in self.loads)
            object.__setattr__(self, "loads", loads)
            if len(loads) != len(flat):
                raise ValueError(f"{len(loads)} loads for {len(flat)} heads")

    @property
    def n_heads(self) -> int:
        return sum(len(g) for g in self.groups)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_devices(self) -> int:
        return sum(self.device_counts)

    def group_of(self, head: int) -> int:
        for g, heads in enumerate(self.groups):
            if head in heads:
                return g
        raise KeyError(head)

    def group_loads(self, loads=None) -> tuple:
        """Modeled per-DEVICE load of each group: Σ_{t∈g} load_t / n_g.
        ``loads`` defaults to the solver's recorded load model (uniform if
        none was recorded)."""
        w = self.loads if loads is None else tuple(float(x) for x in loads)
        if w is None:
            w = (1.0,) * self.n_heads
        if len(w) != self.n_heads:
            raise ValueError(f"{len(w)} loads for {self.n_heads} heads")
        return tuple(sum(w[t] for t in g) / c
                     for g, c in zip(self.groups, self.device_counts))

    def max_group_load(self, loads=None) -> float:
        """The placement's modeled bottleneck: the max per-device group
        load — what the solver minimizes."""
        return max(self.group_loads(loads))


def round_robin_placement(n_heads: int, n_devices: int) -> HeadPlacement:
    """The load-blind baseline: heads dealt cyclically over
    ``min(n_heads, n_devices)`` groups, devices dealt cyclically over the
    same groups — even-as-possible sizes, no regard for per-head load."""
    if n_heads < 1 or n_devices < 1:
        raise ValueError(f"need >= 1 head and device, got {n_heads}, "
                         f"{n_devices}")
    n_groups = min(n_heads, n_devices)
    groups = [[] for _ in range(n_groups)]
    for t in range(n_heads):
        groups[t % n_groups].append(t)
    counts = [n_devices // n_groups + (1 if g < n_devices % n_groups else 0)
              for g in range(n_groups)]
    return HeadPlacement(groups=tuple(tuple(g) for g in groups),
                         device_counts=tuple(counts))


# ---------------------------------------------------------------------------
# The two collective scopes, explicit
# ---------------------------------------------------------------------------

def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors]) if tensors else None


def _unflat(buf, like):
    out, off = [], 0
    for t in like:
        out.append(buf[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def _all_reduce(buf, group, size):
    """SUM all-reduce of one flat buffer over ``group`` (``size`` ranks; a
    group of one has nothing to reduce). gloo reduces CUDA tensors by
    staging them through the host; the sum's order is fixed for a fixed
    group, and every rank receives the same bits."""
    if buf is not None and size > 1:
        import torch.distributed as dist
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def mtp_value_and_grad_dist(model: MultiTaskModel, shard: TaskShard,
                            task_weights: torch.Tensor, *, head_group=None,
                            per_shard: bool = False):
    """The explicit two-scope gradient sync on every rank. Returns
    ``f(params, batch) -> (loss, metrics, grads)`` over the rank's params
    (trunk + its heads' rows) and its batch slice; ``metrics`` holds
    ``per_task_loss`` and the model's per-task metrics, each ``(n_tasks,)``
    and equal on every rank, and ``grads`` are the reduced gradients of the
    rank's params. ``task_weights``: the global normalised per-task loss
    weights, ``(n_tasks,)`` on the host, summing to 1:

      * trunk grads SUM over all ranks (the global scope);
      * head grads SUM over the head group (``head_group``, the ranks of
        ``shard.ranks``) only;
      * per-task losses and metrics are gathered by head index (one SUM of
        a ``(n_tasks,)`` vector per quantity, zero off the rank's heads).

    Each rank's objective is its share of the global one, so plain sums
    give it. ``per_shard=False`` (``"pjit"`` / ``"hier"``): global
    semantics — the task's loss denominators (``model.batch_counts``) are
    summed over the head group first, so the loss is normalised over the
    task's whole batch and equals single-device training; task weights are
    the global normalised ones, sliced at the rank's heads. ``per_shard=
    True`` (``"shard_map"``): each rank normalises over its own rows and
    the head group averages (``repro``'s ``pmean`` scopes; uniform task
    weights: head grads carry the 1/n_tasks of the mean over tasks)."""
    import torch.distributed as dist
    if not per_shard and model.batch_counts is None:
        raise ValueError(f"model '{model.name}' gives no batch_counts: a "
                         "global loss over sharded batches needs them")
    heads = list(shard.heads)
    n = shard.size
    world = dist.get_world_size()
    tw_host = torch.as_tensor(task_weights, dtype=torch.float32)
    n_tasks = int(tw_host.numel())
    on_device = {}

    def grad_fn(params, batch):
        flat = {k: v.detach().requires_grad_(True)
                for k, v in leaves(params).items()}
        p = unflatten(params, flat)
        dev = next(iter(batch.values())).device
        if dev not in on_device:
            on_device[dev] = (tw_host.to(dev),
                              torch.as_tensor(heads, device=dev))
        tw, idx = on_device[dev]
        norm = None
        if not per_shard:
            from repro_torch.models.moe import Balance
            counts = model.batch_counts(batch).float().contiguous()
            _all_reduce(counts, head_group, n)
            norm = {"counts": counts,
                    "share": torch.full((len(heads),), 1.0 / n,
                                        device=dev),
                    "balance": Balance(head_group, n)}
        with torch.enable_grad():
            if norm is None:
                pt, metrics = model.loss_fn(p["shared"], p["heads"], batch)
                pt = pt / n
                metrics = {k: v / n for k, v in metrics.items()}
            else:
                pt, metrics = model.loss_fn(p["shared"], p["heads"], batch,
                                            norm=norm)
            w = tw[idx]
            # zero-weight (quarantined) tasks are excluded by select, not
            # by multiplication: 0 * non-finite is still non-finite
            objective = torch.where(w > 0, pt * w,
                                    torch.zeros((), device=dev)).sum()
            grads = leaf_grads(objective, flat)
        g = dict(zip(flat, grads))
        trunk = [k for k in flat if k.startswith("shared/")]
        own = [k for k in flat if not k.startswith("shared/")]
        hbuf = _all_reduce(_flat([g[k] for k in own]), head_group, n)
        tbuf = _all_reduce(_flat([g[k] for k in trunk]), None, world)
        for keys, buf in ((own, hbuf), (trunk, tbuf)):
            if buf is not None:
                g.update(zip(keys, _unflat(buf, [g[k] for k in keys])))
        names = list(metrics)
        vec = torch.zeros((1 + len(names), n_tasks), device=dev)
        vec[0, idx] = pt.detach()
        for i, k in enumerate(names):
            vec[1 + i, idx] = metrics[k].detach()
        _all_reduce(vec, None, world)
        per_task = vec[0]
        loss = torch.where(tw > 0, per_task * tw,
                           torch.zeros((), device=dev)).sum()
        out = {k: vec[1 + i] for i, k in enumerate(names)}
        out["per_task_loss"] = per_task
        return loss, out, unflatten(params, g)

    return grad_fn


def dist_global_norm(shard: TaskShard):
    """``norm_fn(grads)`` for a rank's reduced grads: the global norm over
    the trunk (equal on every rank) and every head once — each head
    group's first rank adds its heads' squares to one SUM over all
    ranks."""
    import torch.distributed as dist
    world = dist.get_world_size()

    def norm_fn(grads):
        trunk = sum((x.float() ** 2).sum()
                    for x in leaves(grads["shared"]).values())
        head = sum((x.float() ** 2).sum()
                   for x in leaves(grads["heads"]).values())
        head = (head if shard.index == 0 else torch.zeros_like(head)
                ).reshape(1)
        _all_reduce(head, None, world)
        return torch.sqrt(trunk + head[0])

    return norm_fn


def move_heads(trees, old: list, new: list, rank: int):
    """Move head rows between ranks. ``trees``: this rank's head trees
    (e.g. params, m, v), leading dim in the order of ``old[rank]``;
    ``old[r]`` / ``new[r]``: the heads rank r holds before / after, for
    every rank (equal lists on every rank). Every head that some rank
    gains is broadcast from the lowest rank that held it, over all ranks,
    head by head and leaf by leaf in one order — every rank joins every
    broadcast. Returns the trees with rows in the order of ``new[rank]``."""
    import torch.distributed as dist
    mine, want = list(old[rank]), list(new[rank])
    flat = [leaves(t) for t in trees]
    rows = {}
    n_heads = 1 + max(h for hs in old for h in hs)
    for t in range(n_heads):
        if t in mine:
            rows[t] = [{k: v[mine.index(t)] for k, v in f.items()}
                       for f in flat]
        if not any(t in new[r] and t not in old[r] for r in range(len(old))):
            continue
        src = min(r for r in range(len(old)) if t in old[r])
        got = []
        for f in flat:
            leaf = {}
            for k, v in f.items():
                buf = v[mine.index(t)].clone() if rank == src else \
                    torch.empty(v.shape[1:], dtype=v.dtype, device=v.device)
                dist.broadcast(buf, src=src)
                leaf[k] = buf
            got.append(leaf)
        if t in want and t not in mine:
            rows[t] = got
    out = []
    for i, (tree, f) in enumerate(zip(trees, flat)):
        out.append(unflatten(tree, {k: torch.stack([rows[t][i][k]
                                                    for t in want])
                                    for k in f}))
    return out
