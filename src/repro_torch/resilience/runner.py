"""The resilient training loop: guard -> rollback -> quarantine -> survive
(port of ``repro.resilience.runner``).

``run_resilient(session)`` is what ``Session.run()`` dispatches to when
``SessionConfig.resilience`` is set. Progress is measured by
``state.step`` (which only advances on ACCEPTED steps), not by loop
iterations — so a tripped step retries against the next batch, a rollback
rewinds progress, and the loop still ends exactly at ``cfg.steps``
accepted updates. Loop iterations are counted by a *tick* (monotonic,
never rewound), which is what ``FaultSchedule`` pins faults to.

Per tick:

  1. fire scheduled faults (arm checkpoint failures, kill the producer,
     trigger a simulated preemption, queue batch corruption);
  2. preemption flag set? -> flush a final checkpoint (params + optimizer +
     guard + datapipe position) and exit cleanly with ``preempted=True``;
  3. draw a batch; a dead producer is recovered in place — the prefetcher
     is rewound to the last CONSUMED position and restarted, so the stream
     continues byte-identically (bounded by ``max_pipeline_recoveries``);
  4. step through the guarded step; on a trip: after
     ``max_consecutive_trips``, roll params + optimizer + guard + datapipe
     back to the last good checkpoint; a source crossing
     ``quarantine_after`` attributed trips is quarantined (loss weight
     zeroed + batch slice sanitized, or its sampling weight zeroed);
  5. on an accepted step: log/eval on the usual cadence and checkpoint per
     ``CheckpointPolicy`` (retried with exponential backoff).

On a distributed plan (flat, or hierarchical without a guard, as
``repro``) every rank runs this loop over its rows of the same global
batches: the schedule fires each fault at the same tick on every rank,
rank 0 writes the checkpoints that every rank restores its rows from
(``CheckpointManager(plan=...)``), and one tiny all-reduce a tick makes a
preemption that any rank sees, or a draw that fails on any rank, the whole
job's at that tick — every rank flushes, or every rank rewinds its
pipeline to the last consumed batch and draws again (a producer killed on
one rank is then a recovery of all). The guard's decisions, rollback and
quarantine come from the global loss, norm and per-task losses, equal on
every rank.

Determinism contract: for rollback-covered faults the run's final params,
moments and step are bitwise equal to a never-faulted run — rollback
restores them with the guard's scalars and the byte-identical datapipe
stream, the kernels use no atomics, and the npz round trip is bit-exact
for f32. The report's events have ``repro``'s kinds at ``repro``'s ticks.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.train.loop import EarlyStopping, MetricLogger

from .faults import FaultSchedule, ProducerKilled, corrupt_batch
from .guard import GuardConfig, StepGuard, zero_task_slices
from .policy import CheckpointManager, CheckpointPolicy, PreemptionHandler


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Everything ``SessionConfig.resilience`` needs.

    ckpt_dir: directory the ``CheckpointManager`` owns — required: it is
    the rollback target and the preemption flush destination.
    guard: ``GuardConfig`` or None to disable guarded stepping (keeps the
    checkpoint/preemption/recovery machinery only).
    faults: a ``FaultSchedule`` for chaos runs; None in production.
    handle_signals: install SIGTERM/SIGUSR1 handlers for the run (main
    thread only; simulated preemptions work regardless).
    max_ticks: hard bound on loop iterations (None = ``20 * steps + 100``),
    so a pathological trip/rollback cycle raises instead of spinning.
    """
    ckpt_dir: str
    guard: GuardConfig | None = GuardConfig()
    policy: CheckpointPolicy = CheckpointPolicy()
    faults: FaultSchedule | None = None
    handle_signals: bool = False
    max_pipeline_recoveries: int = 3
    retry_attempts: int = 3
    retry_base_delay: float = 0.05
    max_ticks: int | None = None

    def replace(self, **kw) -> "ResilienceConfig":
        return dataclasses.replace(self, **kw)


def run_resilient(session):
    """Train ``session`` (a ``repro_torch.engine.Session`` whose config
    carries a ``ResilienceConfig``) to ``cfg.steps`` accepted steps; returns
    its ``SessionResult`` with ``preempted`` and the ``resilience`` report
    (``repro``'s keys, plus ``save_ms``: each checkpoint write's wall
    time)."""
    from repro_torch.engine.session import SessionResult
    from repro_torch.train import checkpoint as ckpt_mod

    cfg = session.cfg
    res: ResilienceConfig = cfg.resilience
    if not res.ckpt_dir:
        raise ValueError("ResilienceConfig.ckpt_dir is required")
    plan = session.plan
    mgr = CheckpointManager(res.ckpt_dir, res.policy,
                            attempts=res.retry_attempts,
                            base_delay=res.retry_base_delay, plan=plan)
    faults = res.faults if res.faults is not None else FaultSchedule()
    n_sources = getattr(session.model, "n_tasks", 0) or 0
    guard = StepGuard(res.guard, n_sources=n_sources) \
        if res.guard is not None else None
    preempt = PreemptionHandler(install=res.handle_signals)
    logger = MetricLogger()
    early = EarlyStopping(patience=cfg.patience, min_delta=cfg.min_delta) \
        if cfg.patience > 0 else None
    log_every = cfg.log_every or cfg.eval_every
    eval_fn = session._eval()
    batches = session._batches()
    state = session.state
    events: list[dict] = []
    recoveries = 0
    saved = 0
    preempted = stopped = False
    out = None
    pending_corrupt = []
    sync_kill = []

    def save(metric=None):
        nonlocal saved
        mgr.save(state, datapipe=session.datapipe_state(), metric=metric)
        saved += 1

    # rollback anchor: without it the guard could trip on step 1 with
    # nothing to roll back to
    if res.policy.save_initial and mgr.latest_step() != int(state.step):
        save()

    step_h = int(state.step)
    tick = 0
    max_ticks = res.max_ticks if res.max_ticks is not None \
        else 20 * cfg.steps + 100
    try:
        while step_h < cfg.steps:
            tick += 1
            if tick > max_ticks:
                raise RuntimeError(
                    f"resilient loop exceeded {max_ticks} ticks at step "
                    f"{step_h}/{cfg.steps} — persistent faulting without "
                    "progress (see the resilience report events)")

            for f in faults.take(tick):
                if f.kind == "kill_producer":
                    if session._prefetcher is not None:
                        session._prefetcher.inject_producer_fault(
                            ProducerKilled(f"injected at tick {tick}"))
                    else:
                        sync_kill.append(f)
                elif f.kind == "ckpt_write_fail":
                    mgr.arm_failures(f.repeats)
                elif f.kind == "preempt":
                    preempt.trigger()
                else:
                    pending_corrupt.append(f)

            batch = err = None
            before = session.datapipe_state() if plan.distributed else None
            if not (preempt.triggered or sync_kill):
                try:
                    batch = batches()
                except Exception as e:
                    err = e
            stop, err_name = preempt.triggered, \
                None if err is None else type(err).__name__
            if plan.distributed:
                stop, err_name = _agree(stop, err_name)
                if (stop or err_name) and batch is not None:
                    # this rank drew a batch the job will not step on:
                    # give it back, so every rank stays at one position
                    session.restore_datapipe(before)
                    session._reapply_quarantine()
                    batch = None

            if stop:
                t0 = time.perf_counter()
                save(metric=float(out.loss) if out is not None else None)
                events.append({"kind": "preempt_flush", "tick": tick,
                               "step": step_h,
                               "ms": (time.perf_counter() - t0) * 1e3})
                preempted = True
                break

            if sync_kill:
                # a synchronous session has no producer thread to kill: the
                # fault is a failed draw, recovered by drawing again (the
                # batcher did not advance)
                sync_kill.clear()
                recoveries += 1
                events.append({"kind": "pipeline_recovery", "tick": tick,
                               "error": "ProducerKilled", "ms": 0.0})
                continue

            if err_name is not None:
                recoveries += 1
                if recoveries > res.max_pipeline_recoveries:
                    if err is not None:
                        raise err
                    raise RuntimeError(f"the input pipeline failed on "
                                       f"another rank ({err_name})")
                t0 = time.perf_counter()
                if session._prefetcher is not None:
                    # rewind to the last CONSUMED position (read-ahead and
                    # the dying producer's partial draw are discarded) and
                    # restart the producer; a fault injected into this
                    # rank's producer is covered by the job's recovery
                    session._prefetcher.clear_producer_fault()
                    session._prefetcher.restore(session._prefetcher.state())
                events.append({"kind": "pipeline_recovery", "tick": tick,
                               "error": err_name,
                               "ms": (time.perf_counter() - t0) * 1e3})
                continue

            quarantined = session._local_tasks(session._quarantined)
            if quarantined:              # the port's batches are task-major
                batch = zero_task_slices(batch, quarantined)
            for f in pending_corrupt:
                f = session._local_fault(f)
                if f is not None:
                    batch = corrupt_batch(batch, f)
            pending_corrupt.clear()

            state, out = session.step_fn(state, batch)
            ok = guard.observe(out) if guard is not None else True
            if ok:
                step_h += 1
            else:
                if guard.should_rollback():
                    t0 = time.perf_counter()
                    path, state = mgr.load_latest(template=state)
                    session.state = state
                    if ckpt_mod.has_datapipe(path):
                        session.restore_datapipe(path)
                    session._reapply_quarantine()
                    guard.on_rollback()
                    step_h = int(state.step)
                    events.append({"kind": "rollback", "tick": tick,
                                   "to_step": step_h,
                                   "ms": (time.perf_counter() - t0) * 1e3})
                q = guard.quarantine_candidates()
                if q:
                    session.quarantine_tasks(q)
                    guard.mark_quarantined(q)
                    events.append({"kind": "quarantine", "tick": tick,
                                   "sources": q})
                continue

            is_eval = step_h % cfg.eval_every == 0 or step_h == 1 \
                or step_h == cfg.steps
            is_log = step_h % log_every == 0 or step_h == 1 \
                or step_h == cfg.steps
            if is_eval or is_log:
                extras = session._metric_fn(out)
                row = logger.log(step_h, loss=out.loss, **extras)
                if eval_fn is not None and is_eval:
                    row.update({k: float(v) for k, v
                                in eval_fn(state.params).items()})
                if cfg.verbose:
                    print(json.dumps({k: round(v, 5)
                                      if isinstance(v, float) else v
                                      for k, v in row.items()}))
                if early is not None and is_eval:
                    criterion = row.get(cfg.val_metric, row["loss"])
                    if early.update(float(criterion)):
                        stopped = True
            if res.policy.should_save(step_h):
                save(metric=float(out.loss))
            if stopped:
                break
    finally:
        session.state = state
        if res.handle_signals:
            preempt.uninstall()

    if not preempted and mgr.latest_step() != step_h:
        # final flush: a completed (or early-stopped) run is resumable too
        save(metric=float(out.loss) if out is not None else None)

    final_loss = float(out.loss) if out is not None else float("nan")
    report = {
        "ticks": tick, "steps": step_h, "preempted": preempted,
        "checkpoints_saved": saved, "io_retries": mgr.io_retries,
        "pipeline_recoveries": recoveries,
        "faults_fired": len(faults.fired), "faults_pending": faults.pending(),
        "events": events, "save_ms": list(mgr.save_ms),
    }
    if guard is not None:
        report.update(guard.report())
    if cfg.ckpt_path:
        ckpt_mod.save_sharded(
            cfg.ckpt_path, {"params": state.params}, plan,
            metadata={"model": cfg.model, "arch": cfg.arch.name,
                      "step": step_h,
                      "final_loss": final_loss if out is not None else None},
            datapipe=session.datapipe_state())
    return SessionResult(
        state=state, logger=logger, final_loss=final_loss,
        last_metrics={} if out is None else
        {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
         for k, v in out.metrics.items()},
        stopped_early=stopped, preempted=preempted, resilience=report)


def _agree(stop: bool, err_name):
    """One tiny all-reduce a tick over every rank: whether any rank saw a
    preemption and whether any rank's draw failed; on a failure tick the
    lowest failing rank's error name (else None) on every rank."""
    import torch.distributed as dist
    flags = torch.tensor([int(stop), int(err_name is not None)],
                         dtype=torch.int32)
    dist.all_reduce(flags, op=dist.ReduceOp.SUM)
    if not flags[1]:
        return bool(flags[0]), None
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, err_name)
    return bool(flags[0]), next(n for n in names if n is not None)
