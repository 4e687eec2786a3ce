"""Deterministic fault injection: seeded, tick-indexed, replayable (port of
``repro.resilience.faults``).

Chaos testing a trainer is only useful if a failing run can be replayed
exactly, so every fault here is pinned to a *tick* — the resilient runner's
loop-iteration counter, which (unlike ``state.step``) increases even when a
step trips or rolls back, so a fault fires exactly once and a rollback can
never re-trigger it. A ``FaultSchedule`` is either written out explicitly
(``Fault(tick=5, kind="nan_grad")``) or drawn from a seeded RNG
(``FaultSchedule.random``) — both are bit-reproducible.

Fault classes (``Fault.kind``):

  * ``nan_grad``        — the drawn batch's float leaves become NaN, so the
                          loss and every gradient is non-finite (the guard's
                          finiteness trip);
  * ``corrupt_batch``   — float leaves scaled by ``magnitude`` (finite
                          garbage: the guard's EMA-spike trip);
  * ``kill_producer``   — the ``Prefetcher`` producer thread raises
                          ``ProducerKilled`` (synchronous sessions raise it
                          at the draw site instead);
  * ``ckpt_write_fail`` — the next ``repeats`` checkpoint-save attempts
                          fail with ``CheckpointWriteError`` (exercises the
                          retry/backoff path);
  * ``preempt``         — a simulated SIGTERM via
                          ``PreemptionHandler.trigger()``: flush-and-exit.

The injectors (``poison_nan`` / ``scale_floats``) operate on already-placed
batches (dicts of torch tensors, after ``DevicePlacer.ready``, on the
consumer's stream), so injection composes with the async prefetch pipeline:
the clean batch was drawn and placed normally — the corruption is what the
step sees, exactly as a flipped bit in device memory would be. They return
new tensors and leave the batch they were given alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

KINDS = ("nan_grad", "corrupt_batch", "kill_producer", "ckpt_write_fail",
         "preempt")


class InjectedFault(RuntimeError):
    """Base class for every injected failure."""


class ProducerKilled(InjectedFault):
    """Simulated death of the input-pipeline producer."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``source`` limits batch corruption to a single
    task-major slice (None poisons the whole batch); ``magnitude`` scales
    ``corrupt_batch``; ``repeats`` is how many consecutive save attempts a
    ``ckpt_write_fail`` poisons (keep it below the manager's retry budget
    for a recoverable fault, at/above it for a fatal one)."""
    tick: int
    kind: str
    source: int | None = None
    magnitude: float = 1e4
    repeats: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind '{self.kind}'; known: {KINDS}")
        if self.tick < 1:
            raise ValueError(f"ticks are 1-based, got {self.tick}")


class FaultSchedule:
    """A set of tick-pinned faults; each fires exactly once.

    ``take(tick)`` pops and returns the faults pinned to that tick (tick
    order within one tick follows construction order). ``pending()`` counts
    what has not fired yet — a soak test asserts it reaches zero.
    """

    def __init__(self, faults=()):
        self._by_tick: dict[int, list[Fault]] = {}
        for f in faults:
            if not isinstance(f, Fault):
                raise TypeError(f"not a Fault: {f!r}")
            self._by_tick.setdefault(f.tick, []).append(f)
        self.fired: list[Fault] = []

    @classmethod
    def from_dict(cls, ticks: dict) -> "FaultSchedule":
        """{tick: kind} shorthand for single-fault ticks."""
        return cls([Fault(tick=t, kind=k) for t, k in sorted(ticks.items())])

    @classmethod
    def random(cls, seed: int, n_ticks: int,
               rates: dict | None = None) -> "FaultSchedule":
        """Seeded random schedule: each tick independently draws each fault
        kind with probability ``rates[kind]`` (default 0.01 per kind).
        Deterministic: same (seed, n_ticks, rates) -> same schedule."""
        rates = dict(rates or {})
        rng = np.random.default_rng(seed)
        faults = []
        for tick in range(1, n_ticks + 1):
            for kind in KINDS:
                if rng.random() < rates.get(kind, 0.01):
                    faults.append(Fault(tick=tick, kind=kind))
        return cls(faults)

    def take(self, tick: int) -> list[Fault]:
        out = self._by_tick.pop(tick, [])
        self.fired.extend(out)
        return out

    def pending(self) -> int:
        return sum(len(v) for v in self._by_tick.values())

    def __len__(self) -> int:
        return self.pending() + len(self.fired)

    def __bool__(self) -> bool:
        return len(self) > 0


# ---------------------------------------------------------------------------
# batch injectors
# ---------------------------------------------------------------------------

def _map_floats(batch: dict, fn, source: int | None) -> dict:
    """Apply ``fn`` to every float leaf (the whole leaf, or the task slice
    ``leaf[source]`` of a task-major batch when ``source`` is given)."""

    def apply(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        if source is None:
            return fn(x)
        if x.dim() < 1:
            raise ValueError("source-targeted corruption needs task-major "
                             "leaves")
        out = x.clone()
        out[source] = fn(x[source])
        return out

    return {k: apply(v) for k, v in batch.items()}


def poison_nan(batch: dict, source: int | None = None) -> dict:
    """Every float value becomes NaN -> non-finite loss AND gradients."""
    return _map_floats(batch, lambda x: torch.full_like(x, float("nan")),
                       source)


def scale_floats(batch: dict, magnitude: float,
                 source: int | None = None) -> dict:
    """Finite corruption: float leaves scaled by ``magnitude`` (a huge but
    finite loss — the EMA-spike trip, not the finiteness trip)."""
    return _map_floats(batch, lambda x: x * magnitude, source)


def corrupt_batch(batch: dict, fault: Fault) -> dict:
    """Dispatch one batch-corruption fault."""
    if fault.kind == "nan_grad":
        return poison_nan(batch, fault.source)
    if fault.kind == "corrupt_batch":
        return scale_floats(batch, fault.magnitude, fault.source)
    raise ValueError(f"'{fault.kind}' is not a batch-corruption fault")
