"""Preemption-safe checkpointing: policy, retention, signals, retried IO
(port of ``repro.resilience.policy``).

``CheckpointPolicy`` decides WHEN to checkpoint (every N steps, plus a
step-0 rollback anchor); ``CheckpointManager`` decides WHERE and HOW — one
``ckpt-<step>`` triple (atomic ``.npz`` + ``.meta.json`` +
``.datapipe.json``, see ``repro_torch.train.checkpoint``) per saved step in
one directory, retention of the last K plus the best-metric checkpoint, and
every filesystem touch wrapped in ``with_retry`` backoff.

A checkpoint holds the FULL ``TrainState`` under ``repro``'s keys:
``state/params/...``, ``state/opt_state/{step,m,v}/...``, ``state/step``,
``state/rng`` and ``state/guard/{ema,good,trips}``. Host ints are written as
int32 scalars, as ``repro`` holds them, so a checkpoint written by either
package restores in the other, f32 leaves bit for bit.

On a distributed plan (``CheckpointManager(plan=...)``) every rank calls
``save``: the head rows of params and both AdamW moments are gathered,
rank 0 alone writes and prunes (with the retries), and its outcome, retry
count and time reach every rank, so every rank proceeds or raises
``CheckpointWriteError`` alike; ``latest()`` is rank 0's listing on every
rank, and ``load`` gives each rank its own rows of the file rank 0 wrote.

``PreemptionHandler`` turns SIGTERM/SIGUSR1 (what SLURM-class schedulers
deliver before reclaiming a node) into a cooperative flag the training loop
polls between steps; ``trigger()`` delivers the same preemption
deterministically, without a real signal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import signal as _signal
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import interop
from repro_torch.train import checkpoint

from .retry import RetryError, with_retry


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """every_steps: checkpoint cadence (0 = only the anchor + final flush).
    keep_last: retained trailing checkpoints (older ones are pruned).
    keep_best: also retain the best-``metric`` checkpoint ever written
    (smaller is better — it is the loss).
    save_initial: write a step-0 anchor before the first step, so rollback
    always has a target."""
    every_steps: int = 50
    keep_last: int = 3
    keep_best: bool = True
    save_initial: bool = True

    def should_save(self, step: int) -> bool:
        return self.every_steps > 0 and step > 0 \
            and step % self.every_steps == 0


def _host_tree(tree):
    """A TrainState as the checkpoint writes it: host ints as int32
    scalars (repro's step counters), everything else as it is."""
    if hasattr(tree, "_fields"):
        return type(tree)(**{k: _host_tree(getattr(tree, k))
                             for k in tree._fields})
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, int) and not isinstance(tree, bool):
        return np.int32(tree)
    return tree


def _like(arr, template):
    """A restored numpy leaf in the live state's form: a tensor on the
    template tensor's device, an int for an int, a numpy scalar or array
    of the template's dtype otherwise."""
    if hasattr(template, "_fields"):
        return type(template)(**{k: _like(getattr(arr, k),
                                          getattr(template, k))
                                 for k in template._fields})
    if isinstance(template, dict):
        return {k: _like(arr[k], v) for k, v in template.items()}
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return interop.to_torch(arr, template.device)
    if isinstance(template, int) and not isinstance(template, bool):
        return int(arr)
    arr = np.asarray(arr)
    return arr[()] if arr.ndim == 0 else arr


class CheckpointWriteError(OSError):
    """Injected (or wrapped) checkpoint-write failure; an OSError so the
    retry layer classifies it as transient."""


class CheckpointManager:
    """Retention + retried IO over ``repro_torch.train.checkpoint`` in one
    directory. Every write goes through a temp file + ``os.replace``, so
    the directory only ever holds complete files and its listing is the
    index.

    ``fault_hook`` is the fault-injection seam, called at the START of
    every raw save attempt (it may raise); ``arm_failures(n)`` fails the
    next ``n`` attempts with ``CheckpointWriteError``, then lets them
    succeed. ``save_ms`` records each successful save's wall time.
    ``plan``: a distributed ``ShardingPlan`` makes saving and the latest
    checkpoint collectives (module docstring); every rank names the same
    directory."""

    def __init__(self, directory: str, policy: CheckpointPolicy | None = None,
                 *, attempts: int = 3, base_delay: float = 0.05,
                 sleep=time.sleep, plan=None):
        self.dir = directory
        self.plan = plan if plan is not None and plan.distributed else None
        self.policy = policy or CheckpointPolicy()
        self.io_retries = 0
        self.fault_hook = None
        self.save_ms: list[float] = []
        self._armed = 0

        def _count(attempt, exc):
            self.io_retries += 1

        self._retry = with_retry(attempts=attempts, base_delay=base_delay,
                                 exceptions=(OSError, IOError),
                                 sleep=sleep, on_retry=_count)
        os.makedirs(directory, exist_ok=True)

    # -- fault injection seam ------------------------------------------------

    def arm_failures(self, n: int = 1):
        """The next ``n`` raw save attempts raise ``CheckpointWriteError``."""
        self._armed += int(n)

    def _maybe_fail(self, stage: str):
        if self._armed > 0:
            self._armed -= 1
            raise CheckpointWriteError(
                f"injected checkpoint {stage} failure "
                f"({self._armed} more armed)")
        if self.fault_hook is not None:
            self.fault_hook(stage)

    # -- paths / listing -----------------------------------------------------

    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt-{step:08d}")

    def checkpoints(self) -> list[tuple[int, str]]:
        """(step, path-without-.npz) pairs, ascending by step."""
        out = []
        for npz in glob.glob(os.path.join(self.dir, "ckpt-*.npz")):
            base = npz[:-len(".npz")]
            try:
                out.append((int(base.rsplit("-", 1)[1]), base))
            except ValueError:
                continue
        return sorted(out)

    def _last(self):
        """The newest (step, path), or None: rank 0's, on every rank of a
        distributed plan (a collective), so no rank reads a listing that
        rank 0 is about to change."""
        cks = self.checkpoints()
        last = [cks[-1] if cks else None]
        if self.plan is not None:
            import torch.distributed as dist
            dist.broadcast_object_list(last, src=0)
        return last[0]

    def latest(self) -> str | None:
        last = self._last()
        return last[1] if last else None

    def latest_step(self) -> int | None:
        last = self._last()
        return last[0] if last else None

    def best(self) -> str | None:
        """Path of the smallest-metric checkpoint (None when none carries a
        metric)."""
        best, best_m = None, None
        for _, path in self.checkpoints():
            try:
                m = checkpoint.load_metadata(path).get("metric")
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            if m is not None and (best_m is None or m < best_m):
                best, best_m = path, m
        return best

    # -- save / load ---------------------------------------------------------

    def save(self, state: Any, *, datapipe: dict | None = None,
             metric: float | None = None, metadata: dict | None = None) -> str:
        """Write the full TrainState (params + optimizer + step + rng +
        guard) plus the datapipe sidecar for ``step = int(state.step)``,
        with retries, then prune per the policy. Returns the path. On a
        distributed plan every rank calls it (rank 0's datapipe state is
        the one written: every rank draws the same global batches)."""
        step = int(state.step)
        path = self.path_for(step)
        meta = dict(metadata or {}, step=step)
        if metric is not None:
            meta["metric"] = float(metric)
        tree = {"state": _host_tree(self._gather(state))}

        def _write():
            self._maybe_fail("save")
            checkpoint.save(path, tree, metadata=meta, datapipe=datapipe)

        if self.plan is None:
            t0 = time.perf_counter()
            self._retry(_write)()
            self.save_ms.append((time.perf_counter() - t0) * 1e3)
            self.prune()
            return path
        import torch.distributed as dist
        err, ms = None, 0.0
        if dist.get_rank() == 0:
            t0 = time.perf_counter()
            try:
                self._retry(_write)()
                self.prune()
            except (OSError, RetryError) as e:
                err = e
            ms = (time.perf_counter() - t0) * 1e3
        # rank 0's outcome, retry count and time, to every rank: the
        # broadcast also orders every later listing after the write
        told = torch.tensor([float(err is None), float(self.io_retries), ms],
                            dtype=torch.float64)
        dist.broadcast(told, src=0)
        ok, self.io_retries, ms = bool(told[0]), int(told[1]), float(told[2])
        if not ok:
            if err is not None:
                raise err
            raise CheckpointWriteError(f"rank 0 could not write {path}")
        self.save_ms.append(ms)
        return path

    def _gather(self, state):
        """A rank's TrainState -> the full one: the head rows of params and
        both moments gathered from their ranks (a collective; a
        single-task model's state is whole on every rank)."""
        if self.plan is None or not self.plan.task_parallel:
            return state
        opt = state.opt_state
        p, m, v = self.plan.gather_heads([state.params["heads"],
                                          opt.m["heads"], opt.v["heads"]])
        return state._replace(
            params=dict(state.params, heads=p),
            opt_state=opt._replace(m=dict(opt.m, heads=m),
                                   v=dict(opt.v, heads=v)))

    def load(self, path: str, template: Any) -> Any:
        """Restore a TrainState saved by ``save`` (by either package); the
        template (the session's live state) gives the structure, dtypes
        and devices; on a distributed plan, the rank's own head rows."""
        def _read():
            tree = checkpoint.restore_sharded(
                path, {"state": _host_tree(template)}, self.plan)
            return _like(tree["state"], template)
        return self._retry(_read)()

    def load_latest(self, template: Any) -> tuple[str, Any]:
        path = self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return path, self.load(path, template)

    # -- retention -----------------------------------------------------------

    def prune(self):
        """Delete everything but the last ``keep_last`` checkpoints (and the
        best-metric one, when ``keep_best``)."""
        cks = self.checkpoints()
        keep = {p for _, p in cks[-max(self.policy.keep_last, 1):]}
        if self.policy.keep_best:
            b = self.best()
            if b is not None:
                keep.add(b)
        for _, path in cks:
            if path in keep:
                continue
            for suffix in (".npz", ".meta.json", ".datapipe.json"):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path + suffix)


class PreemptionHandler:
    """Cooperative preemption flag, settable by OS signal or by hand.

    install=True registers handlers for ``signals`` (default SIGTERM +
    SIGUSR1) that set the flag; ``uninstall()`` / context-manager exit
    restores the previous handlers. Off the main thread, where CPython
    forbids ``signal.signal``, installation is skipped (installed ==
    False) and the flag still works via ``trigger()``."""

    DEFAULT_SIGNALS = (_signal.SIGTERM, _signal.SIGUSR1)

    def __init__(self, install: bool = False, signals=None):
        self.signals = tuple(signals) if signals is not None \
            else self.DEFAULT_SIGNALS
        self._flag = threading.Event()
        self._prev: dict = {}
        self.installed = False
        self.received: int | None = None
        if install:
            self.install()

    def install(self) -> bool:
        try:
            for sig in self.signals:
                self._prev[sig] = _signal.signal(sig, self._on_signal)
            self.installed = True
        except ValueError:   # not the main thread
            self.installed = False
        return self.installed

    def uninstall(self):
        for sig, prev in self._prev.items():
            with contextlib.suppress(ValueError):
                _signal.signal(sig, prev)
        self._prev.clear()
        self.installed = False

    def _on_signal(self, signum, frame):
        self.received = signum
        self._flag.set()

    def trigger(self, signum: int | None = None):
        """Deliver a simulated preemption (the fault-injection path)."""
        self.received = signum
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def clear(self):
        self._flag.clear()
        self.received = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False
