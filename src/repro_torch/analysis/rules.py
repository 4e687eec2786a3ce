"""The port's rule catalog: AST checks over PyTorch and CUDA-binding code.

Every rule is a pure function ``(ModuleInfo) -> list[Finding]`` registered
in ``RULES``. Rules resolve names through the module's import aliases
(``th.rand`` -> ``torch.rand`` whatever the local alias; relative imports
such as ``from .. import _build`` keep their dots), so renaming an import
does not dodge a rule. The rule ids are grouped by contract:

  DET — determinism (global RNGs, numpy's, the stdlib's and torch's;
        wall-clock time in replayable or measured paths)
  ATM — float atomics (CUDA adds in no fixed order: bitwise replay breaks)
  TRC — host syncs in hot loops
  RCP — cache keys hashed by identity (a plan cache that never hits)
  DON — donation discipline (reads after the donated AdamW update)
  KRN — the port's kernel contracts (a launch's error code checked, its
        launch counted, no fallback that hides a kernel)

What ``repro.analysis.rules`` has and this catalog does not, rule by rule:

  * TRC001 / TRC002 read Python control flow and host coercions inside
    jit-traced functions. The port runs eagerly: a Python ``if`` on a
    tensor is a host sync, not a trace error, and nothing is traced or
    graph-captured yet. So ``ModuleInfo`` keeps no jit reachability, and
    TRC003 looks at every loop.
  * RCP001 (``jax.jit`` built in a loop) and RCP002 (an array baked into a
    jaxpr as a constant) need a compiler that caches executables. The
    port's caches are its kernel plans' ``functools.lru_cache`` s: RCP003
    watches what keys them.
  * PAL001–003 check Pallas index tuples, VMEM block planning and scratch
    dtypes. The port has no Pallas; its CUDA kernels plan their blocks in
    Python (``kernels/*/ops.plan``, ``gemm_plan``) and their contracts are
    the KRN family's.
  * DON001 is kept, for the port's one donating API: ``adamw(donate=True)``
    writes the update into the params and moments it is given.

Heuristics err toward precision: a rule that cries wolf gets allowed into
silence, which is worse than a narrow rule that always means it. The
fixtures in ``tests/fixtures/lint_torch/`` pin each new rule's seeded
violation AND its clean twin; the carried DET001–003 are held to
``repro``'s own fixtures (``tests/fixtures/lint/``).
"""
from __future__ import annotations

import ast
import dataclasses
import re

from .baseline import NEVER_BASELINE
from .findings import Finding

# canonical prefixes after alias resolution
_NP = "numpy"
_TORCH = "torch"

# determinism-critical packages: their bitwise-replay guarantees are what
# the resilience soak and the serving parity checks depend on
REPLAY_SCOPED = ("repro_torch/data/", "repro_torch/serve/",
                 "repro_torch/resilience/")

# numpy.random constructors that are seeded/deterministic by design
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "SFC64", "BitGenerator"}

# torch's samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like"}
_TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                           "exponential_"}
_TORCH_SEEDING = {"torch.manual_seed", "torch.seed",
                  "torch.random.manual_seed", "torch.random.seed"}

# scatter-style reductions CUDA computes with float atomics
_ATOMIC_METHODS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                   "scatter_reduce_", "scatter_reduce"}
_ACCUMULATE_METHODS = {"index_put_": 2, "index_put": 2, "put_": 2, "put": 2}

# tensor -> host reads that wait for the device
_HOST_READS = {"item", "tolist", "cpu", "numpy"}

# constructors whose results hash by value (fine as a cache key)
_HASHABLE_BY_VALUE = {"torch.device", "torch.Size", "numpy.dtype",
                      "numpy.int32", "numpy.int64", "numpy.float32",
                      "numpy.float64", "numpy.bool_"}


# ---------------------------------------------------------------------------
# module model
# ---------------------------------------------------------------------------

class ModuleInfo:
    """Parsed module + alias table + parent links, shared by all rules."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src)
        self.aliases: dict[str, str] = {}       # local name -> dotted module
        self.from_imports: dict[str, str] = {}  # local name -> qualified name
        self._collect_imports()
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # -- imports ------------------------------------------------------------

    def _collect_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and \
                    (node.module or node.level):
                # a relative import keeps its dots: ``from .. import
                # _build`` -> ``.._build``
                base = "." * node.level + (node.module or "")
                sep = "." if node.module else ""
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{base}{sep}{a.name}"

    def qualname(self, node) -> str | None:
        """Resolve a Name/Attribute chain to its canonical dotted path, or
        None if the root is not an imported module / from-import."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = node.id
        if root in self.aliases:
            base = self.aliases[root]
        elif root in self.from_imports:
            base = self.from_imports[root]
        elif not parts and root in ("bool", "float", "int"):
            base = root
        else:
            return None
        return ".".join([base] + list(reversed(parts)))

    # -- findings helpers ---------------------------------------------------

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str,
                hint: str) -> Finding:
        return Finding(rule=rule, path=self.path, line=node.lineno,
                       col=node.col_offset, message=message, hint=hint,
                       snippet=self.snippet(node.lineno))


def _functions(mi: ModuleInfo):
    return [n for n in ast.walk(mi.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _own_nodes(fn):
    """The nodes of ``fn``'s body outside the functions nested in it."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _method(node) -> str | None:
    """``x.name(...)`` -> ``name``."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# ---------------------------------------------------------------------------
# DET — determinism (DET001–003 carried from repro.analysis.rules)
# ---------------------------------------------------------------------------

def rule_det001(mi: ModuleInfo) -> list[Finding]:
    """The legacy numpy global RNG (``np.random.<fn>``): process-global,
    unseedable per-stream, and invisible to the datapipe checkpoint
    sidecar — it breaks the bitwise batch-replay guarantee."""
    out = []
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        qn = mi.qualname(node.func)
        if not qn or not qn.startswith(_NP + ".random."):
            continue
        fn = qn.rsplit(".", 1)[-1]
        if fn in _NP_RANDOM_OK:
            continue
        out.append(mi.finding(
            "DET001", node,
            f"legacy global numpy RNG `np.random.{fn}` — unseeded, "
            "process-global state outside the datapipe checkpoint",
            "use a held np.random.default_rng(seed) Generator (the repo "
            "convention; see repro_torch.data.loader)"))
    return out


def rule_det002(mi: ModuleInfo) -> list[Finding]:
    """The Python stdlib ``random`` module's global functions — same
    process-global nondeterminism as DET001, same fix."""
    out = []
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        qn = mi.qualname(node.func)
        if not qn or not qn.startswith("random."):
            continue
        fn = qn.split(".", 1)[1]
        if fn.split(".")[0] in ("Random", "SystemRandom"):
            continue  # an instance is held + seeded explicitly (or crypto)
        out.append(mi.finding(
            "DET002", node,
            f"stdlib global RNG `random.{fn}` — unseeded process-global "
            "state",
            "hold a random.Random(seed) instance, or use "
            "np.random.default_rng(seed)"))
    return out


def rule_det003(mi: ModuleInfo) -> list[Finding]:
    """``time.time()`` — non-monotonic (NTP steps it) so durations computed
    from it are wrong, and as a *value* in the replay-scoped packages it is
    nondeterministic input."""
    out = []
    scoped = any(s in mi.path for s in REPLAY_SCOPED)
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        if mi.qualname(node.func) not in ("time.time", "time.time_ns"):
            continue
        where = "a bitwise-replay-scoped module" if scoped else \
            "a measured/timed path"
        out.append(mi.finding(
            "DET003", node,
            f"`time.time()` in {where} — non-monotonic wall clock",
            "time durations with time.perf_counter(); drive deadlines with "
            "time.monotonic(); replay-scoped code must not read clocks"))
    return out


def rule_det004(mi: ModuleInfo) -> list[Finding]:
    """torch's global generator: a sampler (``torch.rand`` ... ``randperm``,
    ``normal``, ``bernoulli``, ``multinomial``, the ``*_like`` forms) or an
    in-place one (``uniform_``, ``normal_``, ``random_``, ``bernoulli_``,
    ``exponential_``) called without ``generator=``, and any reseeding of
    it (``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed*``).
    The port draws from explicit generators and numpy's ``default_rng``;
    the global stream is shared by every caller in the process, so a draw
    elsewhere changes what this one sees."""
    out = []
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        qn = mi.qualname(node.func) or ""
        if qn in _TORCH_SEEDING or qn.startswith(
                (_TORCH + ".cuda.manual_seed", _TORCH + ".cuda.seed")):
            out.append(mi.finding(
                "DET004", node,
                f"`{qn}` reseeds torch's process-global generator",
                "hold a torch.Generator (or np.random.default_rng(seed)) "
                "and pass it where the draw happens"))
            continue
        if _kwarg(node, "generator") is not None:
            continue
        sampler = qn.startswith(_TORCH + ".") and \
            qn.rsplit(".", 1)[-1] in _TORCH_SAMPLERS and \
            qn.count(".") == 1
        inplace = _method(node) in _TORCH_INPLACE_SAMPLERS
        if sampler or inplace:
            what = qn if sampler else f".{_method(node)}"
            out.append(mi.finding(
                "DET004", node,
                f"`{what}` without `generator=` draws from torch's "
                "process-global generator",
                "pass generator=<a seeded torch.Generator>, or draw with "
                "np.random.default_rng(seed) and copy the values in"))
    return out


# ---------------------------------------------------------------------------
# ATM — float atomics
# ---------------------------------------------------------------------------

def rule_atm001(mi: ModuleInfo) -> list[Finding]:
    """Scatter-style reductions that CUDA computes with float atomics:
    ``index_add_``, ``scatter_add_``, ``scatter_reduce_`` and their
    out-of-place forms, and ``index_put_`` / ``put_`` with
    ``accumulate=True``. On a CUDA float tensor the adds land in no fixed
    order, so a rerun from the same seed differs in the last bits and the
    bitwise-replay contract breaks. The port sums by index with kernel #1
    (``kernels.segment_sum``) or a one-hot product. May be allowed inline,
    and only with a reason on the line (``# lint: allow(ATM001): why``)."""
    out = []
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _method(node)
        qn = mi.qualname(node.func) or ""
        if qn.startswith(_TORCH + ".") and qn.count(".") == 1:
            name = qn.rsplit(".", 1)[-1]
        elif qn:
            continue            # a module's function, not a tensor method
        if name in _ATOMIC_METHODS:
            bad = True
        elif name in _ACCUMULATE_METHODS:
            acc = _kwarg(node, "accumulate")
            pos = _ACCUMULATE_METHODS[name]
            if acc is None and len(node.args) > pos:
                acc = node.args[pos]
            bad = acc is not None and not (
                isinstance(acc, ast.Constant) and not acc.value)
        else:
            bad = False
        if bad:
            out.append(mi.finding(
                "ATM001", node,
                f"`{name}` adds with float atomics on CUDA — no fixed "
                "order, so runs from one seed differ bitwise",
                "sum by index with repro_torch.kernels.segment_sum (#1: "
                "fixed order, no atomics) or a one-hot product; where the "
                "path is not held bitwise, allow it inline with the reason"))
    return out


# ---------------------------------------------------------------------------
# TRC — host syncs in hot loops
# ---------------------------------------------------------------------------

def _loop_bodies(loop):
    """What a loop runs every iteration: the body (and a ``while``'s
    test); a ``for``'s iterable is evaluated once."""
    parts = list(loop.body)
    if isinstance(loop, ast.While):
        parts.append(loop.test)
    return parts


def rule_trc003(mi: ModuleInfo) -> list[Finding]:
    """Per-iteration host syncs in loops: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` or ``torch.cuda.synchronize()`` inside a
    ``for``/``while`` body waits for the device every iteration — the
    queue drains, and the host and the card take turns. Only in modules
    that import torch: elsewhere (the JAX package and its examples) these
    names are numpy's or jax's, which ``repro``'s own TRC003 covers."""
    if not any(v.split(".")[0] == _TORCH for v in
               list(mi.aliases.values()) + list(mi.from_imports.values())):
        return []
    out = []
    for loop in ast.walk(mi.tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for part in _loop_bodies(loop):
            for node in ast.walk(part):
                if not isinstance(node, ast.Call):
                    continue
                name = _method(node)
                qn = mi.qualname(node.func)
                if qn == _TORCH + ".cuda.synchronize":
                    what = "torch.cuda.synchronize()"
                elif name in _HOST_READS and not node.args and \
                        qn is None:
                    what = f".{name}()"
                else:
                    continue
                out.append(mi.finding(
                    "TRC003", node,
                    f"`{what}` inside a loop body — a device->host sync "
                    "every iteration",
                    "keep the values on the device and read them back once "
                    "after the loop (stack, then one .cpu()), or log every "
                    "N steps (see train_loop's log_every)"))
    return out


# ---------------------------------------------------------------------------
# RCP — cache keys hashed by identity
# ---------------------------------------------------------------------------

def _is_cache_decorator(mi: ModuleInfo, dec) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    qn = mi.qualname(target) or ""
    return qn in ("functools.lru_cache", "functools.cache")


def rule_rcp003(mi: ModuleInfo) -> list[Finding]:
    """A call to a ``functools.lru_cache`` / ``functools.cache`` function
    of the same module that passes a ``torch.*`` / ``np.*`` array
    expression or a list, dict or set literal: an array or a list raises
    (unhashable), and a tensor hashes by IDENTITY — the cache misses on
    every call and grows without bound (the kernel plans' caches:
    ``gemm_plan.fwd_splits``, ``flash_decode.ops._card_plan``)."""
    cached = {fn.name for fn in _functions(mi)
              if any(_is_cache_decorator(mi, d) for d in fn.decorator_list)}
    if not cached:
        return []
    out = []
    for node in ast.walk(mi.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in cached):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            bad = None
            if isinstance(arg, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                ast.DictComp, ast.SetComp)):
                bad = "an unhashable container"
            elif isinstance(arg, ast.Call):
                qn = mi.qualname(arg.func) or ""
                if qn.startswith((_TORCH + ".", _NP + ".")) and \
                        qn not in _HASHABLE_BY_VALUE:
                    bad = "an array expression"
            if bad:
                out.append(mi.finding(
                    "RCP003", arg,
                    f"`{node.func.id}` is cached and receives {bad} — "
                    "unhashable, or hashed by identity so the cache misses "
                    "every call and grows",
                    "key the cache on shapes, dtypes and ints (hashable "
                    "values), and pass the tensors outside the cached "
                    "function"))
    return out


# ---------------------------------------------------------------------------
# DON — donation discipline
# ---------------------------------------------------------------------------

# adamw(...).update(grads, state, params): the moments and the params are
# written in place when donating
_DONATED_UPDATE_ARGS = {1: "state", 2: "params"}


def _is_donating_adamw(mi: ModuleInfo, call) -> bool:
    if not isinstance(call, ast.Call):
        return False
    qn = mi.qualname(call.func) or (
        call.func.id if isinstance(call.func, ast.Name) else "")
    donate = _kwarg(call, "donate")
    return qn.rsplit(".", 1)[-1] == "adamw" and \
        isinstance(donate, ast.Constant) and donate.value is True


def rule_don001(mi: ModuleInfo) -> list[Finding]:
    """Use-after-donate: ``adamw(donate=True)``'s ``update(grads, state,
    params)`` writes the new params and moments into the tensors it is
    given. A name passed at a donated position and read afterwards (not
    rebound) reads the UPDATED values where the code means the old ones."""
    out = []

    def _enclosing_stmt(node):
        cur = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = mi._parents.get(cur)
        return cur

    for fn in _functions(mi):
        donating = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    _is_donating_adamw(mi, node.value):
                donating |= {t.id for t in node.targets
                             if isinstance(t, ast.Name)}
        if not donating:
            continue
        # source-position-ordered event scan, as repro's DON001: within one
        # line loads run before stores before donations, so the safe
        # `params, st = opt.update(g, st, params)` never taints
        events = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                kind = 0 if isinstance(node.ctx, ast.Load) else 1
                events.append((node.lineno, kind, node.col_offset, node))
            elif _method(node) == "update" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in donating:
                events.append((node.lineno, 2, node.col_offset, node))
        donated: dict[str, int] = {}
        for lineno, kind, _col, node in sorted(events, key=lambda e: e[:3]):
            if kind == 0 and node.id in donated:
                out.append(mi.finding(
                    "DON001", node,
                    f"`{node.id}` read after the donated AdamW update on "
                    f"line {donated[node.id]} — it holds the updated "
                    "values now",
                    "rebind the result (`params, st = opt.update(g, st, "
                    "params)`) and use only the returned trees, or build "
                    "adamw(donate=False) where the old values are needed"))
                del donated[node.id]
            elif kind == 1 and node.id in donated:
                del donated[node.id]
            elif kind == 2:
                stmt = _enclosing_stmt(node)
                args = {i: a for i, a in enumerate(node.args)}
                args.update({i: _kwarg(node, k)
                             for i, k in _DONATED_UPDATE_ARGS.items()
                             if _kwarg(node, k) is not None})
                for i in _DONATED_UPDATE_ARGS:
                    a = args.get(i)
                    if not isinstance(a, ast.Name):
                        continue
                    rebinds = stmt is not None and any(
                        isinstance(n, ast.Name) and n.id == a.id and
                        isinstance(n.ctx, ast.Store) for n in ast.walk(stmt))
                    if not rebinds:
                        donated[a.id] = node.lineno
    return out


# ---------------------------------------------------------------------------
# KRN — the port's kernel contracts
# ---------------------------------------------------------------------------

def _is_build(mi: ModuleInfo, call, *names) -> bool:
    """A call of ``kernels._build.<one of names>``, however imported."""
    if not isinstance(call, ast.Call):
        return False
    qn = mi.qualname(call.func) or ""
    return any(qn == f"_build.{n}" or qn.endswith(f"._build.{n}")
               for n in names)


def _returned_libraries(mi: ModuleInfo) -> set[str]:
    """Module functions that return a library from ``_build.load``
    (``_lib()`` helpers)."""
    out = set()
    for fn in _functions(mi):
        libs = _library_names(mi, fn, set())
        for node in _own_nodes(fn):
            if isinstance(node, ast.Return) and node.value is not None and (
                    _is_build(mi, node.value, "load") or
                    (isinstance(node.value, ast.Name)
                     and node.value.id in libs)):
                out.add(fn.name)
    return out


def _library_names(mi: ModuleInfo, fn, lib_funcs) -> set[str]:
    """Names ``fn`` binds to a library: ``lib = _build.load(...)`` or
    ``lib = _lib(...)`` of a function returning one."""
    names = set()
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if _is_build(mi, v, "load") or (
                isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id in lib_funcs):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def _launches(mi: ModuleInfo, fn, lib_funcs) -> list[ast.Call]:
    """The launches in ``fn``'s own body: ``lib.<x>_launch(...)`` on a
    library it holds."""
    libs = _library_names(mi, fn, lib_funcs)
    return [n for n in _own_nodes(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr.endswith("_launch")
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id in libs]


def rule_krn001(mi: ModuleInfo) -> list[Finding]:
    """A kernel launch whose return code never reaches ``_build.check``:
    every launcher returns its ``cudaError_t`` (a refused launch never
    runs, and a later synchronize would not report it), so an unchecked
    code is a kernel that silently did nothing."""
    lib_funcs = _returned_libraries(mi)
    out = []
    for fn in _functions(mi):
        launches = _launches(mi, fn, lib_funcs)
        if not launches:
            continue
        checks = [n for n in _own_nodes(fn) if _is_build(mi, n, "check")]
        checked_ids = {id(a) for c in checks for a in c.args}
        checked_names = {a.id for c in checks for a in c.args
                         if isinstance(a, ast.Name)}
        for call in launches:
            parent = mi._parents.get(call)
            if id(call) in checked_ids:
                continue
            if isinstance(parent, ast.Assign) and all(
                    isinstance(t, ast.Name) and t.id in checked_names
                    for t in parent.targets):
                continue
            out.append(mi.finding(
                "KRN001", call,
                f"`{call.func.attr}`'s return code is not passed to "
                "_build.check — a refused launch would pass silently",
                "`code = lib.<x>_launch(...)` then `_build.check(lib, code, "
                "\"<x>_launch\")`"))
    return out


def rule_krn002(mi: ModuleInfo) -> list[Finding]:
    """A function that launches a kernel and never calls
    ``_build.count_launch``: the contract's ``kernels`` line and the
    kernel-count tests read those counters to show that a path really went
    through its kernel."""
    lib_funcs = _returned_libraries(mi)
    out = []
    for fn in _functions(mi):
        launches = _launches(mi, fn, lib_funcs)
        if launches and not any(_is_build(mi, n, "count_launch")
                                for n in _own_nodes(fn)):
            out.append(mi.finding(
                "KRN002", launches[0],
                f"`{fn.name}` launches `{launches[0].func.attr}` and never "
                "calls _build.count_launch — the launch is invisible to the "
                "kernel counts",
                "call _build.count_launch(<the wrapper>) after the checked "
                "launch"))
    return out


def rule_krn003(mi: ModuleInfo) -> list[Finding]:
    """An ``except`` handler around a kernel's launch, or around a call of
    ``_build.load`` / ``build_all`` (or of a function returning a library),
    that neither raises nor re-raises: a fallback that hides the kernel
    (the path goes on without it, and nothing says so). A handler whose
    ``try`` holds none of these (a queue poll after the build) is not
    one."""
    lib_funcs = _returned_libraries(mi)
    out = []
    for fn in _functions(mi):
        kernel = {id(n) for n in _launches(mi, fn, lib_funcs)}
        kernel |= {id(n) for n in _own_nodes(fn)
                   if _is_build(mi, n, "load", "build_all") or (
                       isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Name)
                       and n.func.id in lib_funcs)}
        if not kernel:
            continue
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Try) or not any(
                    id(n) in kernel for stmt in node.body
                    for n in ast.walk(stmt)):
                continue
            for handler in node.handlers:
                raises = any(isinstance(n, ast.Raise)
                             for stmt in handler.body
                             for n in ast.walk(stmt))
                if raises:
                    continue
                out.append(mi.finding(
                    "KRN003", handler,
                    f"`except` in `{fn.name}` swallows the error of a "
                    "kernel's build, load or launch — a silent fallback",
                    "let the error propagate (or re-raise it with context); "
                    "the plain path is chosen by the tensor's device, never "
                    "by a failed kernel"))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str
    fn: object

    def run(self, mi: ModuleInfo) -> list[Finding]:
        return self.fn(mi)


def _mk(id, name, fn):
    return Rule(id=id, name=name, doc=(fn.__doc__ or "").strip(), fn=fn)


RULES: list[Rule] = [
    _mk("DET001", "det-np-global-rng", rule_det001),
    _mk("DET002", "det-py-random", rule_det002),
    _mk("DET003", "det-wallclock", rule_det003),
    _mk("DET004", "det-torch-global-rng", rule_det004),
    _mk("ATM001", "cuda-float-atomics", rule_atm001),
    _mk("TRC003", "hotloop-host-sync", rule_trc003),
    _mk("RCP003", "recompile-identity-cache-key", rule_rcp003),
    _mk("DON001", "donate-use-after", rule_don001),
    _mk("KRN001", "kernel-unchecked-launch", rule_krn001),
    _mk("KRN002", "kernel-uncounted-launch", rule_krn002),
    _mk("KRN003", "kernel-hidden-fallback", rule_krn003),
]

# rules whose inline allow must carry a reason after the pragma
ALLOW_NEEDS_REASON = ("ATM001",)


def rule_ids() -> list[str]:
    return [r.id for r in RULES]


_ALLOW_RE = re.compile(r"lint:\s*allow\(([A-Z0-9_,\s]+)\)(?::\s*(\S.*))?")


def _inline_allowed(mi: ModuleInfo, f: Finding) -> bool:
    """``# lint: allow(RULEID): reason`` on the flagged line (or the line
    above) suppresses that rule there — for deliberate exceptions a
    baseline entry would misrepresent. DET*/KRN* findings cannot be
    inline-allowed (they must be fixed: ``baseline.NEVER_BASELINE``), and
    an ATM001 allow counts only with its reason written after the
    pragma."""
    if f.rule.startswith(NEVER_BASELINE):
        return False
    for ln in (f.line, f.line - 1):
        m = _ALLOW_RE.search(mi.snippet(ln))
        if m and f.rule in {x.strip() for x in m.group(1).split(",")}:
            return f.rule not in ALLOW_NEEDS_REASON or bool(m.group(2))
    return False


def run_rules(path: str, src: str, *, rules=None) -> list[Finding]:
    """All findings for one module, deduplicated (nested AST walks can
    visit a node once per enclosing scope) and filtered through inline
    ``lint: allow(...)`` pragmas. ``rules``: optional filter by rule id or
    name."""
    mi = ModuleInfo(path, src)
    wanted = set(rules) if rules else None
    out: list[Finding] = []
    seen: set[tuple] = set()
    for rule in RULES:
        if wanted is not None and rule.id not in wanted \
                and rule.name not in wanted:
            continue
        for f in rule.run(mi):
            key = (f.rule, f.line, f.col)
            if key not in seen and not _inline_allowed(mi, f):
                seen.add(key)
                out.append(f)
    return out
