"""Retry-with-exponential-backoff for checkpoint/store IO (port of
``repro.resilience.retry``).

On Perlmutter/Aurora/Frontier-class machines the parallel filesystem is a
shared, occasionally-flaky resource: a checkpoint write can fail transiently
(quota races, metadata-server hiccups, preemption of a sibling job) without
the run itself being unhealthy. ``with_retry`` wraps any callable so those
transient failures cost a bounded backoff instead of the whole run.

The sleeper is injectable so tests (and the deterministic fault-injection
harness, ``repro_torch.resilience.faults``) never wall-clock sleep, and the
delay sequence is fully deterministic: ``base_delay * factor**attempt`` — no
jitter, because a single-process trainer has nothing to decorrelate from
and reproducible recovery timelines are worth more than thundering-herd
protection here.
"""
from __future__ import annotations

import functools
import time


class RetryError(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


def with_retry(fn=None, *, attempts: int = 3, base_delay: float = 0.05,
               factor: float = 2.0, exceptions=(OSError,),
               sleep=time.sleep, on_retry=None):
    """Wrap ``fn`` so it is retried up to ``attempts`` times.

    attempts:   total tries (>= 1); the last failure raises ``RetryError``
                chained to the underlying exception.
    base_delay: seconds before the first retry; each further retry waits
                ``factor`` times longer.
    exceptions: exception types considered transient. Anything else
                propagates immediately (a ``ValueError`` from a corrupt
                argument is not cured by waiting).
    sleep:      injectable sleeper (tests pass a recorder).
    on_retry:   optional ``on_retry(attempt_index, exc)`` observer, called
                before each backoff sleep (e.g. to count IO retries).

    Usable directly (``with_retry(fn, ...)``) or as a decorator
    (``@with_retry(attempts=5)``).
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if fn is None:
        return functools.partial(with_retry, attempts=attempts,
                                 base_delay=base_delay, factor=factor,
                                 exceptions=exceptions, sleep=sleep,
                                 on_retry=on_retry)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        delay = base_delay
        for attempt in range(attempts):
            try:
                return fn(*args, **kw)
            except exceptions as e:
                if attempt == attempts - 1:
                    raise RetryError(
                        f"{getattr(fn, '__name__', 'call')} failed after "
                        f"{attempts} attempts: {e}", attempts) from e
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)
                delay *= factor
    return wrapped
