"""repro_torch.analysis — static analysis and runtime sanitizers for the
port's contracts (the counterpart of ``repro.analysis``, with the same
exports).

What each contract means for the port:

  * ``repro_torch.analysis.lint`` — an AST linter with the port's rules
    (``python -m repro_torch.analysis.lint src/repro_torch examples
    chip_smoke.py``; ``--list-rules`` prints the catalog, ``rules.py``'s
    docstring says which of ``repro``'s rules have no counterpart and
    why). Bitwise replay means no global RNG and no float atomics on a
    path held bitwise; a kernel's launch is checked, counted, and never
    hidden behind a fallback.
  * ``repro_torch.analysis.baseline`` — the accepted-findings file
    (``lint_baseline_torch.json``, committed empty), in ``repro``'s
    version-1 format: a baseline written by either package loads in the
    other. DET and KRN findings are never baselined.
  * ``repro_torch.analysis.recompile`` — ``RecompileSanitizer``: eager
    PyTorch compiles nothing, so a "compilation" is a step function built,
    a bucket shape a serving session runs, an entry a kernel plan cache
    adds, or a CUDA library built or loaded; the seams are
    ``Session.compiled_functions()``, ``jit_functions()`` of the serving
    sessions, the plans' ``lru_cache`` s and ``kernels._build``.
  * ``repro_torch.analysis.tsan`` — ``ThreadSanitizer``: the threaded
    pieces' contracts (one producer drawing for a ``Prefetcher``, one
    worker draining a ``RequestQueue``, lock-guarded state touched only
    under its lock: the launch counters, the serving streams' pool);
    instrumented in tests and in ``chip_smoke.py``'s ``analysis`` phase.

Every module here imports only the standard library.
"""
from .baseline import Baseline, apply_baseline
from .findings import Finding
from .recompile import RecompileBudgetError, RecompileSanitizer
from .rules import RULES, rule_ids
from .tsan import ThreadContractViolation, ThreadSanitizer, TrackedLock

__all__ = [
    "Finding", "Baseline", "apply_baseline", "RULES", "rule_ids",
    "RecompileSanitizer", "RecompileBudgetError",
    "ThreadSanitizer", "ThreadContractViolation", "TrackedLock",
]
