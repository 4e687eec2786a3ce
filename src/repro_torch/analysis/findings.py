"""Finding — one linter hit, with a drift-stable fingerprint (the port's
copy of ``repro.analysis.findings``: the same fingerprint).

A finding is keyed for baseline matching by ``(rule, path, fingerprint)``
where the fingerprint hashes the rule id, the *normalized source line text*
and an occurrence index among identical (rule, line-text) pairs in the same
file — NOT the line number. Inserting unrelated lines above a finding
therefore does not invalidate a baseline entry, while editing the flagged
line (presumably to fix it) does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # rule id, e.g. "DET003"
    path: str          # repo-relative posix path
    line: int          # 1-based line of the offending node
    col: int           # 0-based column
    message: str       # one-line statement of the defect
    hint: str          # fix recipe
    snippet: str       # stripped source line (fingerprint input)
    occurrence: int = 0  # index among identical (rule, snippet) in this file

    @property
    def fingerprint(self) -> str:
        norm = " ".join(self.snippet.split())
        raw = f"{self.rule}|{norm}|{self.occurrence}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def format(self, *, show_hint: bool = True) -> str:
        out = f"{self.path}:{self.line}:{self.col + 1}: {self.rule} " \
              f"{self.message}"
        if show_hint and self.hint:
            out += f"\n    fix: {self.hint}"
        if self.snippet:
            out += f"\n    >>> {self.snippet}"
        return out

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def assign_occurrences(findings: list[Finding]) -> list[Finding]:
    """Disambiguate findings that share (path, rule, snippet) — e.g. the
    same offending expression repeated in a file — by a stable per-file
    occurrence index (source order)."""
    seen: dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.path, f.rule, " ".join(f.snippet.split()))
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        out.append(dataclasses.replace(f, occurrence=idx))
    return out


def dump_json(findings: list[Finding]) -> str:
    return json.dumps([f.to_json() for f in findings], indent=2)
