"""ThreadSanitizer-style contract checking for the threaded layers (the
port's copy of ``repro.analysis.tsan``).

``data/prefetch.py`` and ``serve/queue.py`` make concurrency promises their
docstrings state but no test can see breaking: exactly one producer thread
draws from the wrapped batcher at a time (the bitwise-replay guarantee),
exactly one engine worker drains the request queue, and shared state that a
lock is supposed to guard is only touched while holding it. A violation is
a *benign-looking race* — the run usually still passes, just no longer
bitwise-replayably. This module makes the contracts executable:

  * ``TrackedLock`` — a lock wrapper that knows its owner thread;
  * ``ThreadSanitizer.wrap_mutual_exclusion(obj, methods)`` — records a
    violation when two threads are inside the named methods concurrently
    (re-entry by the SAME thread is fine; sequential generations of
    producer threads are fine — this checks overlap, not identity);
  * ``ThreadSanitizer.guard_attrs(obj, attrs, lock)`` — instruments the
    instance (class swap) so touching a guarded attribute without holding
    the lock records a violation;
  * ``check()`` raises ``ThreadContractViolation`` listing every recorded
    violation with thread names and call sites.

Instrumented in tests and in ``chip_smoke.py``'s ``analysis`` phase only:
the ``__getattribute__`` hook costs real overhead, so production objects
are never wrapped. Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import threading
import traceback


class ThreadContractViolation(AssertionError):
    """One or more recorded thread-contract violations (see .violations)."""

    def __init__(self, violations):
        self.violations = list(violations)
        lines = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(
            f"{len(self.violations)} thread-contract violation(s):\n{lines}")


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str       # "concurrent-entry" | "unguarded-read" | "unguarded-write"
    target: str     # "Type.method" / "Type.attr"
    thread: str
    detail: str
    site: str       # "file.py:123"

    def __str__(self):
        return (f"[{self.kind}] {self.target} from thread {self.thread} "
                f"at {self.site}: {self.detail}")


def _call_site() -> str:
    """First stack frame outside this module — where the access happened."""
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.endswith("tsan.py"):
            return f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}"
    return "?"


class TrackedLock:
    """``threading.Lock`` with ownership tracking (supports same-thread
    re-entry bookkeeping so ``held()`` answers 'does THIS thread hold
    it')."""

    def __init__(self):
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._depth = 0

    def acquire(self, *a, **kw) -> bool:
        got = self._lock.acquire(*a, **kw)
        if got:
            self._owner = threading.get_ident()
            self._depth += 1
        return got

    def release(self):
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    def held(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class ThreadSanitizer:
    """Collects thread-contract violations; raise them all via check()."""

    def __init__(self):
        self.violations: list[Violation] = []
        self._mx = threading.Lock()

    def _record(self, kind, target, detail):
        v = Violation(kind=kind, target=target,
                      thread=threading.current_thread().name,
                      detail=detail, site=_call_site())
        with self._mx:
            self.violations.append(v)

    # -- mutual exclusion ---------------------------------------------------

    def wrap_mutual_exclusion(self, obj, methods, *, group: str | None = None):
        """Patch the named bound methods so that concurrent entry by two
        threads records a violation. All listed methods share one exclusion
        group (``Prefetcher``'s contract: batcher draws never overlap, no
        matter which producer generation makes them)."""
        label = group or f"{type(obj).__name__}.{{{','.join(methods)}}}"
        state = {"owner": None, "depth": 0}
        state_mx = threading.Lock()
        san = self

        def _wrap(name, orig):
            def wrapped(*a, **kw):
                me = threading.get_ident()
                with state_mx:
                    if state["owner"] not in (None, me):
                        san._record(
                            "concurrent-entry",
                            f"{type(obj).__name__}.{name}",
                            f"entered while thread id {state['owner']} is "
                            f"inside exclusion group {label}")
                    else:
                        state["owner"] = me
                    state["depth"] += 1
                try:
                    return orig(*a, **kw)
                finally:
                    with state_mx:
                        state["depth"] -= 1
                        if state["depth"] == 0:
                            state["owner"] = None
            wrapped.__name__ = name
            return wrapped

        for name in methods:
            orig = getattr(obj, name)
            setattr(obj, name, _wrap(name, orig))
        return obj

    # -- lock-guarded attributes --------------------------------------------

    def guard_attrs(self, obj, attrs, lock: TrackedLock):
        """Swap ``obj``'s class for an instrumented subclass: any read or
        write of a guarded attribute while ``lock`` is NOT held by the
        current thread records a violation. Test-only instrumentation —
        never wrap production instances."""
        attrs = frozenset(attrs)
        san = self
        cls = type(obj)

        class Instrumented(cls):
            def __getattribute__(self, name):
                if name in attrs and not lock.held():
                    san._record("unguarded-read", f"{cls.__name__}.{name}",
                                "read without holding the guarding lock")
                return super().__getattribute__(name)

            def __setattr__(self, name, value):
                if name in attrs and not lock.held():
                    san._record("unguarded-write", f"{cls.__name__}.{name}",
                                "written without holding the guarding lock")
                super().__setattr__(name, value)

        Instrumented.__name__ = f"Instrumented{cls.__name__}"
        obj.__class__ = Instrumented
        return obj

    # -- reporting ----------------------------------------------------------

    def check(self):
        """Raise ThreadContractViolation if any violation was recorded."""
        with self._mx:
            if self.violations:
                raise ThreadContractViolation(self.violations)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.check()
        return False
