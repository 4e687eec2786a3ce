"""Session — the training front door (port of ``repro.engine.session``, one
device).

``Session.from_config(cfg, sources=...).run()`` composes the model registry,
``GroupBatcher`` feeding through a ``Prefetcher`` whose producer thread
places batches on the device (pinned memory, a side stream), AdamW with its
schedule, gradient accumulation, ``EarlyStopping``, ``MetricLogger``, eval
and checkpointing with the datapipe sidecar — then runs the train loop and
returns a ``SessionResult``.

The knobs of later slices — ``mixing``, ``bucketing``, ``placement``,
``resilience`` and a mesh — raise ``NotImplementedError``; ``repro``'s
``mode``, ``backend`` and ``donate`` (sharding and jit buffer donation)
have no counterpart on one eager device.
``device=None`` means ``cuda`` and raises without a GPU; the CPU must be
asked for (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch import resolve_device
from repro_torch.core.taskpar import MultiTaskModel
from repro_torch.data.loader import GroupBatcher
from repro_torch.data.prefetch import DevicePlacer, Prefetcher
from repro_torch.interop import leaves
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import checkpoint
from repro_torch.train.loop import EarlyStopping, MetricLogger, train_loop

from .registry import build_model
from .state import TrainState
from .step import make_step


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
    # loop control
    log_every: int = 10
    eval_every: int = 50
    patience: int = 0                 # >0 => early stopping
    min_delta: float = 1e-4
    val_metric: str = "val_loss"      # row key EarlyStopping watches
    # input pipeline: assemble + place batches on a background thread
    prefetch: bool = True
    prefetch_depth: int = 2
    # later slices (must stay None here)
    mixing: Any = None
    bucketing: Any = None
    placement: Any = None
    resilience: Any = None
    # misc
    seed: int = 0
    task_weights: tuple | None = None
    ckpt_path: str | None = None
    verbose: bool = True

    def replace(self, **kw) -> "SessionConfig":
        return dataclasses.replace(self, **kw)


_LATER = {"mixing": "multi-source mixing (data.mixing)",
          "bucketing": "size-bucketed batching (data.bucketing)",
          "placement": "hierarchical head placement (engine.hier)",
          "resilience": "fault tolerance (repro.resilience)"}


@dataclasses.dataclass
class SessionResult:
    state: TrainState
    logger: MetricLogger
    final_loss: float
    last_metrics: dict
    stopped_early: bool

    @property
    def params(self):
        return self.state.params


class Session:
    """One declarative training session; see module docstring.

    sources: list of per-task sample dicts (numpy arrays, task t feeds head
    t). eval_fn(params) -> dict of scalar metrics, merged into logged rows
    (put cfg.val_metric in it to early-stop on validation, paper §5.1)."""

    def __init__(self, cfg: SessionConfig, *, sources, mesh=None,
                 eval_fn: Callable | None = None,
                 task_names: list[str] | None = None,
                 model_kwargs: dict | None = None, device=None):
        if cfg.steps < 1:
            raise ValueError(f"SessionConfig.steps must be >= 1, got "
                             f"{cfg.steps}")
        for knob, what in _LATER.items():
            if getattr(cfg, knob) is not None:
                raise NotImplementedError(
                    f"cfg.{knob}: {what} is not ported yet")
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: mesh= is not ported yet")
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.device = resolve_device(device)

        if not isinstance(sources, (list, tuple)):
            raise TypeError("Session takes a list of per-task sources")
        n_tasks = len(sources)
        self.model = build_model(cfg.model, cfg.arch, n_tasks=n_tasks,
                                 **(model_kwargs or {}))
        if not isinstance(self.model, MultiTaskModel):
            raise NotImplementedError("single-task (LM) models are not "
                                      "ported yet")
        heads = self.model.n_tasks or n_tasks
        if heads != n_tasks:
            raise NotImplementedError(
                f"model '{cfg.model}' has {heads} branch(es) but got "
                f"{n_tasks} sources; training one branch on a mixture "
                "needs cfg.mixing, which is not ported yet")
        self.batcher = GroupBatcher(list(sources), cfg.batch_per_task,
                                    seed=cfg.seed)
        self.task_names = task_names or [f"task{t}" for t in range(n_tasks)]
        if len(self.task_names) != n_tasks:
            raise ValueError(f"{len(self.task_names)} task_names for "
                             f"{n_tasks} tasks")
        self.task_weights = cfg.task_weights
        lr = warmup_cosine(cfg.lr, cfg.warmup, cfg.steps) if cfg.warmup \
            else cfg.lr
        self.optimizer = adamw(lr, weight_decay=cfg.weight_decay,
                               grad_clip=cfg.grad_clip)
        self.step_fn = make_step(self.model, self.optimizer,
                                 accum=cfg.accum,
                                 task_weights=self.task_weights)
        params = self.model.init(cfg.seed, self.device)
        self.state = TrainState.create(params, self.optimizer)
        self._placer = DevicePlacer(self.device)
        # ONE prefetcher for the session's lifetime (created on first run):
        # closing it between runs would discard already-drawn batches
        self._prefetcher = None
        # consumed-position snapshot taken when the prefetcher is closed
        self._dp_snapshot = None

    @classmethod
    def from_config(cls, cfg: SessionConfig, **kw) -> "Session":
        return cls(cfg, **kw)

    def n_params(self) -> int:
        return sum(int(x.numel()) for x in leaves(self.state.params).values())

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
        if self.cfg.prefetch:
            if self._prefetcher is None:
                self._prefetcher = Prefetcher(
                    self.batcher, transform=place,
                    depth=self.cfg.prefetch_depth)
            pf = self._prefetcher
            return lambda: place.ready(pf.next_batch())
        return lambda: place.ready(place(self.batcher.next_batch()))

    def run(self) -> SessionResult:
        cfg = self.cfg
        early = EarlyStopping(patience=cfg.patience,
                              min_delta=cfg.min_delta) \
            if cfg.patience > 0 else None
        state, logger, last_out = train_loop(
            self.step_fn, self.state, self._batches(),
            steps=cfg.steps, eval_fn=self.eval_fn,
            eval_every=cfg.eval_every, log_every=cfg.log_every,
            early_stop=early, val_metric=cfg.val_metric,
            metric_fn=self._metric_fn, verbose=cfg.verbose)
        self.state = state
        stopped = bool(early and early.bad >= early.patience)
        final_loss = float(last_out.loss)
        if cfg.ckpt_path:
            checkpoint.save(cfg.ckpt_path, {"params": state.params},
                            metadata={"model": cfg.model,
                                      "arch": cfg.arch.name,
                                      "step": int(state.step),
                                      "final_loss": final_loss},
                            datapipe=self.datapipe_state())
        return SessionResult(
            state=state, logger=logger, final_loss=final_loss,
            last_metrics={k: v.cpu().numpy()
                          for k, v in last_out.metrics.items()},
            stopped_early=stopped)
