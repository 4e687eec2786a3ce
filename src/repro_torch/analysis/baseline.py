"""Baseline file: accepted findings that pass while new ones gate (the
port's copy of ``repro.analysis.baseline``: the same fingerprint and the
same version-1 file, so a baseline written by either package loads in the
other).

Workflow:

  * first adoption — ``python -m repro_torch.analysis.lint src/repro_torch
    --write-baseline`` records every current finding in
    ``lint_baseline_torch.json``; commit it;
  * from then on the linter exits non-zero only for findings NOT in the
    baseline (new code must be clean; legacy debt is inventoried, not
    blocking);
  * fixing a baselined finding leaves a *stale* entry — the linter reports
    it so the baseline can be re-written and shrinks monotonically.

Determinism (DET*) and kernel-contract (KRN*) findings are policy NEVER to
baseline (they break bitwise replay, or hide a kernel's failure or its
launch count, silently); ``Baseline.add`` refuses them unless
``allow_all=True``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from .findings import Finding

DEFAULT_NAME = "lint_baseline_torch.json"
# rule-id prefixes whose findings must be FIXED, not suppressed
NEVER_BASELINE = ("DET", "KRN")


class BaselinePolicyError(ValueError):
    """Tried to baseline a finding from a fix-only rule family."""


@dataclasses.dataclass
class Baseline:
    """In-memory view of the accepted-findings file."""
    entries: list[dict] = dataclasses.field(default_factory=list)

    # -- construction -------------------------------------------------------

    @classmethod
    def load(cls, path) -> "Baseline":
        data = json.loads(pathlib.Path(path).read_text())
        if data.get("version") != 1:
            raise ValueError(f"unknown baseline version in {path}: "
                             f"{data.get('version')!r}")
        return cls(entries=list(data.get("entries", [])))

    @classmethod
    def from_findings(cls, findings: list[Finding], *,
                      allow_all: bool = False) -> "Baseline":
        b = cls()
        for f in findings:
            b.add(f, allow_all=allow_all)
        return b

    def add(self, f: Finding, *, allow_all: bool = False):
        if not allow_all and f.rule.startswith(NEVER_BASELINE):
            raise BaselinePolicyError(
                f"{f.rule} findings must be fixed, not baselined "
                f"({f.path}:{f.line}) — determinism and kernel-contract "
                "violations break replay or hide a kernel silently")
        self.entries.append({
            "rule": f.rule, "path": f.path, "fingerprint": f.fingerprint,
            "line": f.line, "snippet": f.snippet,
        })

    # -- persistence --------------------------------------------------------

    def save(self, path):
        entries = sorted(self.entries,
                         key=lambda e: (e["path"], e["line"], e["rule"]))
        payload = {"version": 1, "entries": entries}
        pathlib.Path(path).write_text(json.dumps(payload, indent=2) + "\n")

    # -- matching -----------------------------------------------------------

    def _keys(self) -> set[tuple]:
        return {(e["rule"], e["path"], e["fingerprint"])
                for e in self.entries}


def apply_baseline(findings: list[Finding], baseline: Baseline | None):
    """Split findings against the baseline.

    Returns ``(new, suppressed, stale)``: findings not in the baseline
    (these gate), findings matched by it, and baseline entries whose
    finding no longer exists (fixed or moved — rewrite the baseline)."""
    if baseline is None:
        return list(findings), [], []
    keys = baseline._keys()
    new = [f for f in findings
           if (f.rule, f.path, f.fingerprint) not in keys]
    suppressed = [f for f in findings
                  if (f.rule, f.path, f.fingerprint) in keys]
    live = {(f.rule, f.path, f.fingerprint) for f in findings}
    stale = [e for e in baseline.entries
             if (e["rule"], e["path"], e["fingerprint"]) not in live]
    return new, suppressed, stale
