"""RecompileSanitizer — declared compilation budgets, enforced (the port's
counterpart of ``repro.analysis.recompile``: the same accounting).

Eager PyTorch compiles no executable, but the port still builds things
once and reuses them, and a leak there costs what a recompile storm costs
``repro``: a step function rebuilt every call, a serving session meeting a
new padded shape per request, a kernel plan cache keyed by tensor
identity, a CUDA library built again. Each of these is a "compilation"
here:

  * a step function built (``Session.compiled_functions()``: a flat
    plan's ``CompiledStep`` counts 1 once built, a hierarchical plan's one
    per (heads, ranks) group step; a quarantine rebuild counts again);
  * a bucket shape a serving session runs (``ServeSession.jit_functions()``
    and ``ReplicaServeSession.jit_functions()``: ``cache_size()`` is the
    session's ``_shapes_compiled``);
  * an entry a kernel plan cache adds (the ``functools.lru_cache`` s of
    ``kernels/egnn_edge/gemm_plan`` and ``kernels/flash_decode/ops``:
    ``cache_info().currsize``);
  * a CUDA library ``kernels._build`` builds or loads
    (``_build.cache_size()``).

Usage::

    from repro_torch.analysis import RecompileSanitizer

    with RecompileSanitizer(budget=0, label="20-step session") as san:
        san.track_session(session)
        session.run()
    # exit raises RecompileBudgetError if compilations exceeded the budget

Counting is by cache-size *delta* since ``track()``: what was built before
tracking starts from zero. Stdlib-only: the probe duck-types on
``cache_size()`` or an ``lru_cache``'s ``cache_info().currsize``.
"""
from __future__ import annotations

import threading


class RecompileBudgetError(RuntimeError):
    """Tracked callables built more than the declared budget allows."""


def _probe_for(fn):
    """A zero-arg callable returning ``fn``'s current compile count, or
    None if ``fn`` exposes no cache-size seam."""
    probe = getattr(fn, "cache_size", None)   # CompiledStep, serving, _build
    if callable(probe):
        return probe
    info = getattr(fn, "cache_info", None)    # a functools.lru_cache
    if callable(info):
        return lambda: info().currsize
    return None


class RecompileSanitizer:
    """Fail when tracked callables exceed a declared compilation budget.

    budget: max NEW compilations across all tracked functions (cache-size
    growth since each was tracked). ``check()`` raises
    ``RecompileBudgetError``; as a context manager, ``__exit__`` checks
    automatically (only on a clean exit — an in-flight exception wins).
    """

    def __init__(self, budget: int, *, label: str = ""):
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.budget = int(budget)
        self.label = label
        self._mx = threading.Lock()
        self._tracked: list[tuple[str, object, int]] = []  # (name, probe, base)

    # -- registration -------------------------------------------------------

    def track(self, fn, name: str | None = None) -> bool:
        """Track one callable (or module, or cache). Returns False (and
        skips it) when the
        object exposes no cache-size seam — callers that require tracking
        can assert on the return value."""
        probe = _probe_for(fn)
        if probe is None:
            return False
        with self._mx:
            self._tracked.append(
                (name or getattr(fn, "__name__", type(fn).__name__),
                 probe, int(probe())))
        return True

    def track_session(self, session, name: str = "session"):
        """Track an ``engine.Session`` LIVE: the probe re-reads
        ``session.compiled_functions()`` at every check, so a step rebuilt
        mid-run (e.g. quarantine rebuilds it) still counts against the
        budget instead of silently escaping the tracker. Every callable ever
        seen stays in the sum (holding a reference, so ids are stable) —
        swapping in a fresh step must not erase the old one's compiles."""
        seen: dict[int, tuple] = {}   # id(fn) -> (fn ref, probe)

        def probe():
            for f in session.compiled_functions():
                p = _probe_for(f)
                if p is not None:
                    seen[id(f)] = (f, p)
            return sum(int(p()) for _f, p in seen.values())
        with self._mx:
            self._tracked.append((name, probe, int(probe())))

    # -- accounting ---------------------------------------------------------

    def compilations(self) -> int:
        """NEW compilations across all tracked functions since tracking."""
        with self._mx:
            return sum(max(0, int(probe()) - base)
                       for _, probe, base in self._tracked)

    def report(self) -> dict:
        """Per-function compile counts, for test assertions and logs."""
        with self._mx:
            return {name: max(0, int(probe()) - base)
                    for name, probe, base in self._tracked}

    def check(self):
        n = self.compilations()
        if n > self.budget:
            detail = ", ".join(f"{k}={v}" for k, v in self.report().items()
                               if v) or "untracked"
            label = f" [{self.label}]" if self.label else ""
            raise RecompileBudgetError(
                f"recompile budget exceeded{label}: {n} compilation(s) > "
                f"budget {self.budget} ({detail}) — a step rebuilt, a "
                "padded shape outside the warmed grid, a plan cache keyed "
                "by tensor identity (rule RCP003) or a kernel library "
                "built again")

    # -- context manager ----------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.check()
        return False
