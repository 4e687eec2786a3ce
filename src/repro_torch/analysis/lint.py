"""The port's linter CLI: ``python -m repro_torch.analysis.lint src/repro_torch
examples chip_smoke.py`` (``repro.analysis.lint``'s flags and exit codes).

Collects ``*.py`` under the given paths, runs every rule in
``repro_torch.analysis.rules.RULES``, filters through the committed
baseline (``lint_baseline_torch.json`` by default, when present) and exits
non-zero when NEW findings exist. The analysis modules import only the
standard library; no GPU is needed to lint.

Exit codes: 0 clean (or fully baselined), 1 new findings, 2 usage or
unparseable-source errors.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from .baseline import DEFAULT_NAME, Baseline, apply_baseline
from .findings import Finding, assign_occurrences, dump_json
from .rules import RULES, run_rules

EXCLUDED_PARTS = {"__pycache__", ".git", "fixtures"}


def collect_files(paths) -> list[pathlib.Path]:
    """``*.py`` files under the given files/dirs, sorted, minus caches and
    lint fixtures (fixtures are violations on purpose)."""
    out: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        if p.is_file() and p.suffix == ".py":
            out.add(p)
        elif p.is_dir():
            for f in p.rglob("*.py"):
                if not EXCLUDED_PARTS & set(f.parts):
                    out.add(f)
        else:
            raise FileNotFoundError(f"lint path does not exist: {p}")
    return sorted(out)


def lint_paths(paths, *, rules=None, root: pathlib.Path | None = None):
    """Run the rule set over paths -> (findings, parse_errors). Paths in
    findings are relative to ``root`` (default: cwd) when possible, posix
    separators, so baselines are machine-independent."""
    root = pathlib.Path(root) if root is not None else pathlib.Path.cwd()
    findings: list[Finding] = []
    errors: list[str] = []
    for f in collect_files(paths):
        try:
            rel = f.resolve().relative_to(root.resolve())
        except ValueError:
            rel = f
        try:
            src = f.read_text()
            findings.extend(run_rules(rel.as_posix(), src, rules=rules))
        except SyntaxError as e:
            errors.append(f"{rel.as_posix()}:{e.lineno}: unparseable: "
                          f"{e.msg}")
    return assign_occurrences(findings), errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's static analysis: determinism, float "
                    "atomics, host syncs, cache keys, donation, kernel "
                    "contracts (--list-rules)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"accepted-findings file (default: ./{DEFAULT_NAME} "
                         "when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline; every finding gates")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the new baseline "
                         "(refuses DET*/KRN* unless --allow-all)")
    ap.add_argument("--allow-all", action="store_true",
                    help="let --write-baseline record even fix-only "
                         "(DET*/KRN*) findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids/names to run")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULES:
            first = r.doc.splitlines()[0] if r.doc else ""
            print(f"{r.id}  {r.name:<26} {first}")
        return 0

    rules = [s.strip() for s in args.rules.split(",")] if args.rules else None
    try:
        findings, errors = lint_paths(args.paths, rules=rules)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for e in errors:
        print(f"error: {e}", file=sys.stderr)

    bl_path = pathlib.Path(args.baseline) if args.baseline else \
        pathlib.Path(DEFAULT_NAME)
    if args.write_baseline:
        Baseline.from_findings(findings, allow_all=args.allow_all) \
            .save(bl_path)
        print(f"wrote {len(findings)} finding(s) to {bl_path}")
        return 0

    baseline = None
    if not args.no_baseline and bl_path.exists():
        baseline = Baseline.load(bl_path)
    new, suppressed, stale = apply_baseline(findings, baseline)

    if args.format == "json":
        print(dump_json(new))
    else:
        for f in new:
            print(f.format())
        for e in stale:
            print(f"note: stale baseline entry {e['rule']} at {e['path']} "
                  f"(finding fixed?) — rewrite with --write-baseline")
        tail = f"{len(new)} finding(s)"
        if suppressed:
            tail += f", {len(suppressed)} baselined"
        if stale:
            tail += f", {len(stale)} stale baseline entr" + \
                ("y" if len(stale) == 1 else "ies")
        print(tail if new or suppressed or stale else "clean")
    if errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
