"""Session — the training front door (port of ``repro.engine.session``, one
device).

``Session.from_config(cfg, sources=...).run()`` composes the model registry,
the batcher (``GroupBatcher`` one source a head; a task-major
``MixingBatcher`` for one branch over several sources, the paper's
GFM-Baseline-All; for a single-task model — ``"lm"``, a fine-tuning
``SingleTaskModel`` — a ``SingleBatcher`` over one source or a flat
``MixingBatcher`` over several; a ``BucketingBatcher`` around any), a
``Prefetcher``
whose producer thread places batches on the device (pinned memory, a side
stream), AdamW with its schedule, gradient accumulation,
``EarlyStopping``, ``MetricLogger``, eval and checkpointing with the
datapipe sidecar — then runs the train loop and returns a
``SessionResult``. With ``cfg.resilience`` set, ``run()`` is the resilient
runner (``repro_torch.resilience``): guarded steps, full-state
checkpoints, rollback, quarantine and fault injection.

Multi-task parallelism (``engine.plan``): every rank of a
``torch.distributed`` job (``launch.mesh.init_distributed``) builds the same
Session. ``Session(mesh=make_host_mesh(d, m))`` trains on a flat ``(data,
model)`` mesh in ``cfg.mode`` ``"par"`` (heads sliced over ``model``) or
``"base"`` (heads whole); ``cfg.placement`` (a device count, ``"auto"`` =
the world size, or a ``HeadPlacement``) trains hierarchically, heads on
uneven rank groups solved from the per-source load. Every rank runs the
same seeded batcher and takes its slice (``repro``'s single-controller
semantics); a rank holds the trunk and only its heads and their moments.
``cfg.donate`` is accepted and has no effect (eager PyTorch donates
nothing). ``device=None`` means ``cuda`` (a rank's own device in a job) and
raises without a GPU; the CPU must be asked for (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.taskpar import HeadPlacement, MTPConfig, MultiTaskModel
from repro_torch.data.bucketing import BucketingBatcher, BucketSpec
from repro_torch.data.loader import GroupBatcher, SingleBatcher, _source_len
from repro_torch.data.mixing import MixingBatcher, MixingConfig
from repro_torch.data.prefetch import DevicePlacer, Prefetcher
from repro_torch.interop import leaves
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import checkpoint
from repro_torch.train.loop import EarlyStopping, MetricLogger, train_loop

from .plan import ShardingPlan
from .registry import build_model
from .state import GuardState, TrainState, prng_key
from .step import make_guarded_step, make_step


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    model: str                        # registry name (see engine.registry)
    arch: Any                         # ArchConfig
    steps: int = 100
    batch_per_task: int = 16          # per-task batch
    # optimizer
    lr: float = 1e-3
    warmup: int = 0                   # >0 => warmup_cosine(lr, warmup, steps)
    weight_decay: float = 0.01
    grad_clip: float = 0.0
    accum: int = 1                    # gradient-accumulation microbatches
    # parallelism (the mesh itself is passed to Session: it is runtime state)
    mode: str = "par"                 # MTP head sharding: "par" | "base"
    backend: str = "auto"             # auto | jit | pjit | shard_map | hier
    # accepted for repro's signature; eager PyTorch donates no buffers
    donate: bool = True
    # loop control
    log_every: int = 10
    eval_every: int = 50
    patience: int = 0                 # >0 => early stopping
    min_delta: float = 1e-4
    val_metric: str = "val_loss"      # row key EarlyStopping watches
    # input pipeline: assemble + place batches on a background thread
    prefetch: bool = True
    prefetch_depth: int = 2
    # multi-source mixing (data.mixing): None = one source a head. A
    # MixingConfig, a float (MixingConfig(temperature=...)) or a tuple of
    # per-source weights. A one-branch model over several sources draws
    # its batches from the mixture (task-major MixingBatcher); a
    # multi-task model turns the weights into per-task LOSS weights
    # (unless task_weights is set)
    mixing: Any = None
    # size-bucketed batching (data.bucketing): None = one global pad
    # shape. A BucketSpec, or an int n (plan an n x n grid from the
    # session's sources); batches are re-padded to their bucket
    bucketing: Any = None
    # hierarchical multi-task parallelism: heads on UNEVEN rank groups,
    # load-balanced by the per-task loss weights (the mixing weights) as
    # the per-head load model. None = flat plans. An int n = solve over n
    # ranks; "auto" = over the job's world size; a HeadPlacement is used
    # as-is. Exclusive with passing a mesh to Session
    placement: Any = None
    # fault tolerance (repro_torch.resilience): a ResilienceConfig makes
    # run() the resilient runner
    resilience: Any = None
    # misc
    seed: int = 0
    task_weights: tuple | None = None
    ckpt_path: str | None = None
    verbose: bool = True

    def replace(self, **kw) -> "SessionConfig":
        return dataclasses.replace(self, **kw)


def _as_mixing(mixing) -> MixingConfig | None:
    """SessionConfig.mixing shorthands -> MixingConfig."""
    if mixing is None or isinstance(mixing, MixingConfig):
        return mixing
    if isinstance(mixing, bool):   # bool IS int — reject the likely typo
        raise TypeError("cfg.mixing=True/False is ambiguous — pass a "
                        "MixingConfig, a float temperature, or None")
    if isinstance(mixing, (int, float)):
        return MixingConfig(temperature=float(mixing))
    if isinstance(mixing, (tuple, list)):
        return MixingConfig(weights=tuple(mixing))
    raise TypeError(f"cfg.mixing: expected MixingConfig | float temperature "
                    f"| weight tuple | None, got {type(mixing).__name__}")


def _as_bucket_spec(bucketing, sources, batcher) -> BucketSpec:
    """SessionConfig.bucketing shorthands -> BucketSpec (an int plans an
    n x n grid from the session's sources)."""
    if isinstance(bucketing, BucketSpec):
        return bucketing
    if isinstance(bucketing, bool):   # bool IS int — reject the likely typo
        raise TypeError("cfg.bucketing=True/False is ambiguous — pass a "
                        "BucketSpec, an int grid size, or None")
    if isinstance(bucketing, int):
        srcs = sources if sources is not None \
            else getattr(batcher, "sources", None)
        if srcs is None:
            raise ValueError("cfg.bucketing=<int> needs sources to plan the "
                             "grid from; pass an explicit BucketSpec")
        return BucketSpec.from_sources(srcs, n_atom_buckets=bucketing,
                                       n_edge_buckets=bucketing)
    raise TypeError(f"cfg.bucketing: expected BucketSpec | int | None, "
                    f"got {type(bucketing).__name__}")


def _resolve_placement(placement, n_tasks, loads, seed) -> HeadPlacement:
    """SessionConfig.placement shorthands -> HeadPlacement (int n / "auto"
    run the imbalance-aware solver over n ranks / the world size)."""
    from repro_torch.core.balancing import solve_placement
    if isinstance(placement, HeadPlacement):
        if placement.n_heads != n_tasks:
            raise ValueError(f"placement covers {placement.n_heads} heads, "
                             f"session has {n_tasks} tasks")
        return placement
    if isinstance(placement, bool):   # bool IS int — reject the likely typo
        raise TypeError("cfg.placement=True/False is ambiguous — pass a "
                        "device count, \"auto\", or a HeadPlacement")
    if placement == "auto":
        import torch.distributed as dist
        return solve_placement(dist.get_world_size(), loads, seed=seed)
    if isinstance(placement, int):
        return solve_placement(placement, loads, seed=seed)
    raise TypeError(f"cfg.placement: expected HeadPlacement | int device "
                    f"count | \"auto\" | None, got {type(placement).__name__}")


def _tasks_of(batcher) -> int:
    """Task rows a batcher's batches carry: a ``GroupBatcher``'s source
    count, looked for through wrappers (bucketing, prefetch); 1 otherwise
    (a task-major ``MixingBatcher``)."""
    b = batcher
    while not isinstance(b, GroupBatcher) and hasattr(b, "batcher"):
        b = b.batcher
    return len(b.sources) if isinstance(b, GroupBatcher) else 1


@dataclasses.dataclass
class SessionResult:
    state: TrainState
    logger: MetricLogger
    final_loss: float
    last_metrics: dict
    stopped_early: bool
    # resilient runs only: the run exited on a (real or simulated)
    # preemption after flushing a resumable checkpoint
    preempted: bool = False
    # resilient runs only: the runner's trip/rollback/recovery report
    resilience: dict | None = None

    @property
    def params(self):
        return self.state.params


class Session:
    """One declarative training session; see module docstring.

    sources: list of per-task sample dicts (numpy arrays; task t feeds head
    t) or gather-style readers (``data.store.ShardedSource``); for a
    single-task model one sample dict (or a list of them with
    ``cfg.mixing``). A single-task model trains on one device: a mesh or
    ``cfg.placement`` raises. model: a built ``MultiTaskModel`` or
    ``SingleTaskModel`` in place of the registry's ``cfg.model`` (e.g. a
    fine-tuning model). batcher: a
    ready batcher in place of sources (e.g. a ``PrefetchingBatcher``; its
    batches may already be on the device). eval_fn(params) -> dict of
    scalar metrics, merged into logged rows (put cfg.val_metric in it to
    early-stop on validation, paper §5.1); on a task-parallel plan it sees
    the full params, on rank 0 only, and every rank logs its result."""

    def __init__(self, cfg: SessionConfig, *, sources=None, batcher=None,
                 mesh=None, eval_fn: Callable | None = None,
                 task_names: list[str] | None = None, model=None,
                 model_kwargs: dict | None = None, device=None):
        if cfg.steps < 1:
            raise ValueError(f"SessionConfig.steps must be >= 1, got "
                             f"{cfg.steps}")
        self.cfg = cfg
        self.eval_fn = eval_fn

        if batcher is not None:
            n_tasks = _tasks_of(batcher)
        else:
            if sources is None:
                raise ValueError("Session needs sources or a batcher")
            n_tasks = len(sources) if isinstance(sources, (list, tuple)) \
                else 1
        self.model = model if model is not None else \
            build_model(cfg.model, cfg.arch, n_tasks=n_tasks,
                        **(model_kwargs or {}))
        # batching follows the BUILT model's flavour
        multitask = isinstance(self.model, MultiTaskModel)
        mixing = _as_mixing(cfg.mixing)
        task_weights = cfg.task_weights
        if batcher is None and not multitask:
            batcher = self._single_batcher(sources, mixing)
            n_tasks = 1
        elif batcher is None:
            if not isinstance(sources, (list, tuple)):
                raise TypeError(f"multi-task model '{cfg.model}' takes a "
                                "list of per-task sources")
            heads = self.model.n_tasks or n_tasks
            if heads == 1 and len(sources) > 1:
                # one branch over several sources (GFM-Baseline-All): one
                # task row drawn from the weighted MIXTURE of all sources
                if mixing is None:
                    raise ValueError(
                        f"model '{cfg.model}' has one branch but got "
                        f"{len(sources)} sources — set cfg.mixing to train "
                        "it on the mixture, or pool the sources yourself")
                batcher = MixingBatcher(list(sources), cfg.batch_per_task,
                                        mixing=mixing, seed=cfg.seed,
                                        task_major=True)
                n_tasks = 1
            else:
                if heads != len(sources):
                    raise ValueError(
                        f"model '{cfg.model}' has {heads} branches but got "
                        f"{len(sources)} sources")
                batcher = GroupBatcher(list(sources), cfg.batch_per_task,
                                       seed=cfg.seed)
                if mixing is not None and task_weights is None:
                    # every head sees ITS source every step, so the batch
                    # composition is fixed: the mixing weights become
                    # per-task LOSS weights
                    sizes = [_source_len(s) for s in sources]
                    task_weights = tuple(float(w)
                                         for w in mixing.resolve(sizes))
        if cfg.bucketing is not None:
            batcher = BucketingBatcher(
                batcher, _as_bucket_spec(cfg.bucketing, sources, batcher))
        self.batcher = batcher
        self.task_names = task_names or [f"task{t}" for t in range(n_tasks)]
        if len(self.task_names) != n_tasks:
            raise ValueError(f"{len(self.task_names)} task_names for "
                             f"{n_tasks} tasks")
        self.plan = self._make_plan(mesh, n_tasks, task_weights, multitask)
        if self.plan.distributed:
            from repro_torch.launch.mesh import rank_device
            self.device = rank_device() if device is None else \
                torch.device(device)
        else:
            self.device = resolve_device(device)
        self.task_weights = task_weights
        lr = warmup_cosine(cfg.lr, cfg.warmup, cfg.steps) if cfg.warmup \
            else cfg.lr
        self.optimizer = adamw(lr, weight_decay=cfg.weight_decay,
                               grad_clip=cfg.grad_clip)
        # quarantine bookkeeping (repro_torch.resilience): loss-weight-
        # quarantined task indices and sampling-quarantined source indices
        # (MixingBatcher sessions)
        self._quarantined: set[int] = set()
        self._quarantined_sources: set[int] = set()
        self._rebuild_step()
        params = self.plan.shard_params(self.model.init(cfg.seed,
                                                        self.device))
        guard0 = GuardState.init() if self._guard_cfg() is not None \
            else None
        self.state = TrainState.create(params, self.optimizer,
                                       rng=prng_key(cfg.seed + 1),
                                       guard=guard0)
        self._placer = DevicePlacer(self.device)
        # ONE prefetcher for the session's lifetime (created on first run):
        # closing it between runs would discard already-drawn batches
        self._prefetcher = None
        # consumed-position snapshot taken when the prefetcher is closed
        self._dp_snapshot = None

    def _single_batcher(self, sources, mixing):
        """A single-task model's flat batches: one source through a
        ``SingleBatcher``; several, with ``cfg.mixing``, composed from all
        of them by a flat ``MixingBatcher`` (one head over mixed data)."""
        cfg = self.cfg
        if isinstance(sources, (list, tuple)):
            if mixing is not None and len(sources) > 1:
                return MixingBatcher(list(sources), cfg.batch_per_task,
                                     mixing=mixing, seed=cfg.seed)
            if len(sources) != 1:
                raise ValueError(
                    f"single-task model '{cfg.model}' got {len(sources)} "
                    "sources; use a multi-task model (e.g. 'lm-mtl'), pass "
                    "one source, or set cfg.mixing to train one head on the "
                    "mixture")
            sources = sources[0]
        return SingleBatcher(sources, cfg.batch_per_task, seed=cfg.seed)

    def _make_plan(self, mesh, n_tasks, task_weights,
                   multitask=True) -> ShardingPlan:
        cfg = self.cfg
        placement = None
        if cfg.placement is not None and not multitask:
            raise ValueError("cfg.placement shards per-task heads — needs a "
                             "multi-task model")
        if cfg.placement is not None:
            if mesh is not None:
                raise ValueError(
                    "cfg.placement and an explicit mesh are exclusive — the "
                    "hierarchical plan deals the ranks into groups itself")
            if self._guard_cfg() is not None:
                raise NotImplementedError(
                    "guarded stepping (resilience.guard) is not supported "
                    "on the hierarchical backend yet — drop cfg.placement "
                    "or the guard")
            # the solver's load model: the per-task loss weights (the
            # mixing weights land there); uniform when neither is set
            loads = tuple(task_weights) if task_weights is not None \
                else (1.0,) * n_tasks
            placement = _resolve_placement(cfg.placement, n_tasks, loads,
                                           cfg.seed)
        if mesh is not None and getattr(mesh, "mesh_dim_names",
                                        None) is None:
            raise TypeError("mesh= takes a DeviceMesh with dims ('data', "
                            "'model') (launch.mesh.make_host_mesh)")
        mtp = MTPConfig(n_tasks=n_tasks, mode=cfg.mode) if multitask \
            else None
        plan = ShardingPlan(mesh=mesh, mtp=mtp, backend=cfg.backend,
                            donate=cfg.donate, placement=placement)
        if plan.distributed:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "a task-parallel plan runs in a torch.distributed job: "
                    "call launch.mesh.init_distributed on every rank first")
        if plan.distributed and cfg.resilience is not None:
            raise NotImplementedError(
                "the resilient runner's full-state checkpoints of a sharded "
                "state are not ported: drop cfg.resilience on a "
                "task-parallel plan")
        if task_weights is not None and plan.resolved_backend == "shard_map":
            raise ValueError(
                "the shard_map backend supports uniform task weights only — "
                "drop cfg.mixing/task_weights or use backend='pjit'")
        return plan

    def _guard_cfg(self):
        res = self.cfg.resilience
        return getattr(res, "guard", None) if res is not None else None

    def _rebuild_step(self):
        """(Re)build the train step from the model, optimizer and task
        weights: guarded when the session's ResilienceConfig carries a
        GuardConfig. Called at construction and when quarantine changes
        the task weights."""
        gcfg = self._guard_cfg()
        if gcfg is not None:
            step = make_guarded_step(
                self.model, self.optimizer, self.plan, guard=gcfg,
                accum=self.cfg.accum, task_weights=self.task_weights)
        else:
            step = make_step(self.model, self.optimizer, self.plan,
                             accum=self.cfg.accum,
                             task_weights=self.task_weights)
        self.step_fn = self.plan.compile(step)

    @classmethod
    def from_config(cls, cfg: SessionConfig, **kw) -> "Session":
        return cls(cfg, **kw)

    def n_params(self) -> int:
        """Parameters this rank holds (the trunk and its heads)."""
        return sum(int(x.numel()) for x in leaves(self.state.params).values())

    def set_placement(self, placement):
        """Swap a hierarchical session's head->rank-group assignment in
        place (the shorthands of ``cfg.placement``; every rank calls it).
        Heads that change owner move with both moments; only the groups
        whose (heads, ranks) changed build a new step function."""
        if self.plan.resolved_backend != "hier":
            raise ValueError("set_placement needs a hierarchical session "
                             "(cfg.placement)")
        loads = tuple(self.task_weights) if self.task_weights is not None \
            else (1.0,) * len(self.task_names)
        placement = _resolve_placement(placement, len(self.task_names),
                                       loads, self.cfg.seed)
        self.state = self.step_fn.update_placement(placement, self.state)
        self.plan = self.step_fn.plan
        if self._prefetcher is not None:
            # read-ahead was sliced for the old placement: draw it again
            self._prefetcher.restore(self._prefetcher.state())

    def close(self):
        """Stop the background prefetcher (if any); batches it had drawn are
        discarded, so close only when done with the session."""
        if self._prefetcher is not None:
            self._dp_snapshot = self._prefetcher.state()
            self._prefetcher.close()
            self._prefetcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- input-pipeline checkpointing ---------------------------------------

    def datapipe_state(self) -> dict:
        """JSON-serializable state of the input pipeline, as of the last
        batch the TRAINING LOOP consumed (read-ahead is not credited)."""
        if self._prefetcher is None and self._dp_snapshot is not None:
            return self._dp_snapshot
        src = self._prefetcher if self._prefetcher is not None else \
            self.batcher
        return src.state()

    def restore_datapipe(self, state):
        """Rewind the input pipeline to a ``datapipe_state()`` snapshot (or a
        checkpoint path whose ``.datapipe.json`` sidecar holds one): the
        next batch is byte-identical to the one an uninterrupted run would
        have drawn."""
        if isinstance(state, str):
            path = state
            state = checkpoint.load_datapipe(path)
            stamp = checkpoint.load_datapipe_step(path)
            try:
                meta_step = checkpoint.load_metadata(path).get("step")
            except FileNotFoundError:
                meta_step = None
            if stamp is not None and meta_step is not None \
                    and stamp != meta_step:
                raise RuntimeError(
                    f"checkpoint desync at {path}: params are at step "
                    f"{meta_step} but the datapipe sidecar was written at "
                    f"step {stamp} — resuming would replay or skip batches")
        if self._prefetcher is not None:
            self._prefetcher.restore(state)
        else:
            self.batcher.restore(state)
        self._dp_snapshot = None

    # -- fault tolerance (repro_torch.resilience) ---------------------------

    def _inner_batcher(self):
        b = self.batcher
        return b.batcher if isinstance(b, BucketingBatcher) else b

    def quarantine_tasks(self, tasks):
        """Quarantine fidelity sources so they stop influencing the params.

        Multi-head sessions zero the per-task LOSS weight and rebuild the
        step (the resilient runner also sanitizes the quarantined batch
        slices: 0 * nan == nan in the backward pass). MixingBatcher
        sessions zero the source's SAMPLING weight instead. Idempotent;
        refuses to quarantine every source."""
        tasks = sorted({int(t) for t in tasks})
        if not tasks:
            return
        inner = self._inner_batcher()
        if isinstance(inner, MixingBatcher):
            w = np.asarray(inner.weights, np.float64).copy()
            for t in tasks:
                if not 0 <= t < w.size:
                    raise ValueError(f"source {t} out of range")
                w[t] = 0.0
            inner.set_weights(w)   # refuses to zero every source
            self._quarantined_sources |= set(tasks)
            return
        if not isinstance(self.model, MultiTaskModel):
            raise ValueError("quarantine_tasks needs per-task loss weights "
                             "(a multi-task model) or a MixingBatcher "
                             "session")
        if self.plan.resolved_backend == "shard_map":
            raise ValueError(
                "the shard_map backend supports uniform task weights only — "
                "cannot quarantine a source; use backend='pjit'")
        n = len(self.task_names)
        w = np.ones(n, np.float64) if self.task_weights is None else \
            np.asarray(self.task_weights, np.float64).copy()
        for t in tasks:
            if not 0 <= t < n:
                raise ValueError(f"task {t} out of range for {n} tasks")
            w[t] = 0.0
        if not w.sum() > 0:
            raise ValueError("cannot quarantine every task")
        self.task_weights = tuple(float(x) for x in w)
        self._quarantined |= set(tasks)
        self._rebuild_step()

    def _reapply_quarantine(self):
        """A rollback restores a datapipe snapshot that may predate a
        sampling quarantine, which would resurrect the source's weight:
        re-zero it. The loss-weight path lives in the step and survives a
        rollback."""
        if not self._quarantined_sources:
            return
        inner = self._inner_batcher()
        w = np.asarray(inner.weights, np.float64).copy()
        w[sorted(self._quarantined_sources)] = 0.0
        inner.set_weights(w)

    def resume(self, ckpt_dir: str | None = None) -> int:
        """Rewind this session to the latest checkpoint a resilient run
        wrote (the full TrainState: params, moments, step, rng, guard; and
        the datapipe position); the next ``run()`` continues from there to
        ``cfg.steps``. Returns the resumed step."""
        from repro_torch.resilience.policy import CheckpointManager
        d = ckpt_dir if ckpt_dir is not None else \
            getattr(self.cfg.resilience, "ckpt_dir", None)
        if not d:
            raise ValueError("resume() needs cfg.resilience.ckpt_dir or an "
                             "explicit directory")
        mgr = CheckpointManager(d, getattr(self.cfg.resilience, "policy",
                                           None))
        path, state = mgr.load_latest(template=self.state)
        self.state = state
        if checkpoint.has_datapipe(path):
            self.restore_datapipe(path)
        return int(state.step)

    # -- the loop -----------------------------------------------------------

    def _metric_fn(self, out) -> dict:
        pt = out.metrics.get("per_task_loss")
        if pt is None:
            return {}
        pt = pt.tolist()
        return {self.task_names[t]: pt[t] for t in range(len(pt))}

    def _batches(self):
        """The batch-drawing callable run() loops over: on the prefetch
        thread, placement overlaps the running step."""
        place = self._placer

        def transform(batch):        # this rank's slice, then the device
            return place(self.plan.slice_batch(batch))
        if self.cfg.prefetch:
            if self._prefetcher is None:
                self._prefetcher = Prefetcher(
                    self.batcher, transform=transform,
                    depth=self.cfg.prefetch_depth)
            pf = self._prefetcher
            return lambda: place.ready(pf.next_batch())
        return lambda: place.ready(transform(self.batcher.next_batch()))

    def _eval(self):
        """The eval_fn train_loop calls. On a task-parallel plan a rank
        holds only its heads, so every rank gathers the full params (a
        collective), rank 0 evaluates them — ``repro``'s single controller
        evaluates once — and broadcasts its metrics: every rank logs the
        same row and reaches the same early-stopping decision."""
        fn = self.eval_fn
        if fn is None or not self.plan.distributed:
            return fn
        import torch.distributed as dist

        def eval_full(params):
            full = self.plan.gather_params(params)
            row = [{k: float(v) for k, v in fn(full).items()}
                   if dist.get_rank() == 0 else None]
            dist.broadcast_object_list(row, src=0)
            return row[0]
        return eval_full

    def run(self) -> SessionResult:
        if self.cfg.resilience is not None:
            from repro_torch.resilience.runner import run_resilient
            return run_resilient(self)
        cfg = self.cfg
        early = EarlyStopping(patience=cfg.patience,
                              min_delta=cfg.min_delta) \
            if cfg.patience > 0 else None
        state, logger, last_out = train_loop(
            self.step_fn, self.state, self._batches(),
            steps=cfg.steps, eval_fn=self._eval(),
            eval_every=cfg.eval_every, log_every=cfg.log_every,
            early_stop=early, val_metric=cfg.val_metric,
            metric_fn=self._metric_fn, verbose=cfg.verbose)
        self.state = state
        stopped = bool(early and early.bad >= early.patience)
        final_loss = float(last_out.loss)
        if cfg.ckpt_path:
            checkpoint.save_sharded(
                cfg.ckpt_path, {"params": state.params}, self.plan,
                metadata={"model": cfg.model, "arch": cfg.arch.name,
                          "step": int(state.step),
                          "final_loss": final_loss},
                datapipe=self.datapipe_state())
        return SessionResult(
            state=state, logger=logger, final_loss=final_loss,
            last_metrics={k: v.cpu().numpy()
                          for k, v in last_out.metrics.items()},
            stopped_early=stopped)
