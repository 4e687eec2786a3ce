"""Guarded stepping: loss/grad finiteness + EMA spike checks (port of
``repro.resilience.guard``).

At 24M+-structure multi-fidelity scale the occasional poisoned batch — a
corrupt record, an outlier geometry, a fidelity source whose labels go bad —
is routine, and one NaN gradient is enough to destroy a parameter tree. The
guard makes every optimizer update conditional:

    ok = isfinite(loss) & isfinite(|grads|) & (loss <= spike_factor * EMA)

The guarded step itself is ``repro_torch.engine.step.make_guarded_step`` /
``make_guarded_train_step`` (re-exported here, as ``repro`` exports them
from this module): it reads the loss and the global norm once a step and
keeps either the new trees or the old ones by reference, so a tripped step
returns params, moments and the step counter unchanged. The EMA, warmup and
consecutive-trip counters travel in ``TrainState.guard`` (a ``GuardState``),
so they are part of every checkpoint and every rollback.

``StepGuard`` is the host-side half: it reads ``guard_ok`` per step, counts
consecutive trips to decide when the runner should roll back to the last
good checkpoint, and attributes trips to fidelity sources (the non-finite
or loudest entry of ``per_task_loss``) so a persistently bad source can be
quarantined — its loss weight zeroed and its batch slice sanitized —
instead of killing the run. ``repro_torch.resilience.runner`` acts on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.engine.state import GuardState
from repro_torch.engine.step import (make_guarded_step,
                                     make_guarded_train_step)

__all__ = ["GuardConfig", "GuardState", "StepGuard", "make_guarded_step",
           "make_guarded_train_step", "zero_task_slices"]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs for guarded stepping.

    spike_factor: trip when ``loss > spike_factor * |EMA| + spike_slack``
        (only after ``warmup_steps`` accepted steps have seeded the EMA).
    ema_decay: EMA smoothing of the accepted-step loss. Tripped losses never
        enter the EMA.
    warmup_steps: accepted steps before the spike check arms (finiteness is
        always checked).
    max_consecutive_trips: consecutive tripped steps before the runner rolls
        params + optimizer + datapipe back to the last good checkpoint.
    quarantine_after: per-source attributed trips before the runner zeroes
        that source's loss weight (0 = never quarantine).
    """
    spike_factor: float = 4.0
    spike_slack: float = 0.0
    ema_decay: float = 0.98
    warmup_steps: int = 10
    max_consecutive_trips: int = 3
    quarantine_after: int = 0


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StepGuard:
    """Host-side guard bookkeeping over a guarded step's metrics.

    ``observe(out)`` reads ``guard_ok``; on a trip it also pulls
    ``per_task_loss`` to attribute the trip to a fidelity source: non-finite
    entries are charged directly, a finite spike is charged to the
    per-task-loss argmax. ``should_rollback()`` and
    ``quarantine_candidates()`` are the two decisions the runner acts on."""

    def __init__(self, cfg: GuardConfig, n_sources: int = 0):
        self.cfg = cfg
        self.consecutive = 0
        self.trips_total = 0
        self.rollbacks = 0
        self.source_trips = np.zeros(max(n_sources, 0), np.int64)
        self.quarantined: set[int] = set()

    def observe(self, out) -> bool:
        """True if the step was accepted."""
        m = out.metrics
        if bool(_host(m["guard_ok"])):
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.trips_total += 1
        pt = m.get("per_task_loss")
        if pt is not None and self.source_trips.size:
            pt = _host(pt).astype(np.float64)
            bad = ~np.isfinite(pt)
            if bad.any():
                self.source_trips[bad] += 1
            else:  # finite spike: charge the loudest source
                self.source_trips[int(np.argmax(pt))] += 1
        return False

    def should_rollback(self) -> bool:
        return self.consecutive >= self.cfg.max_consecutive_trips

    def on_rollback(self):
        """The consecutive streak is over; per-source attribution is
        cumulative, so a persistently bad source still reaches quarantine
        through repeated rollback cycles."""
        self.consecutive = 0
        self.rollbacks += 1

    def quarantine_candidates(self) -> list[int]:
        """Sources whose attributed trips crossed ``quarantine_after`` and
        are not quarantined yet (empty when the knob is off)."""
        if self.cfg.quarantine_after <= 0:
            return []
        hot = np.nonzero(self.source_trips >= self.cfg.quarantine_after)[0]
        return [int(s) for s in hot if int(s) not in self.quarantined]

    def mark_quarantined(self, sources):
        self.quarantined |= {int(s) for s in sources}

    def report(self) -> dict:
        return {"trips": self.trips_total, "rollbacks": self.rollbacks,
                "source_trips": self.source_trips.tolist(),
                "quarantined": sorted(self.quarantined)}


def zero_task_slices(batch: dict, tasks) -> dict:
    """Sanitize a task-major batch: the given task slices become inert
    zeros (floats 0.0, ints 0, masks False), in new tensors. Zeroing the
    LOSS weight of a quarantined source is not enough on its own: a zero
    cotangent back-propagated through non-finite activations is still
    non-finite (0 * nan == nan), so the poisoned rows must never enter the
    forward at all."""
    tasks = sorted(int(t) for t in tasks)
    if not tasks:
        return batch

    def scrub(x):
        x = x.clone()
        for t in tasks:
            x[t] = 0
        return x

    return {k: scrub(v) for k, v in batch.items()}
