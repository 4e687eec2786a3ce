"""The port's lint catalog (``repro_torch.analysis``): every rule catches its
seeded fixture and passes its clean twin; the carried rules give
``repro``'s findings on ``repro``'s own fixtures; baselines round-trip
between the packages; the port itself lints clean with no baseline.

Fixtures: the new rules' in ``tests/fixtures/lint_torch/`` (one
``<rule>_bad.py`` + ``<rule>_clean.py`` pair each), the carried DET001–003
on ``repro``'s ``tests/fixtures/lint/``. The ``fixtures`` path segment is
excluded from normal lint collection because the bad halves violate on
purpose. Neither linter imports jax.
"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

from repro.analysis import Baseline as JBaseline
from repro.analysis import apply_baseline as j_apply_baseline
from repro.analysis.rules import run_rules as j_run_rules
from repro_torch.analysis import (Baseline, Finding, apply_baseline,
                                  rule_ids)
from repro_torch.analysis.baseline import BaselinePolicyError
from repro_torch.analysis.findings import assign_occurrences
from repro_torch.analysis.lint import collect_files, lint_paths, main
from repro_torch.analysis.rules import (ModuleInfo, _launches,
                                        _returned_libraries, run_rules)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXDIR = REPO / "tests" / "fixtures" / "lint_torch"
CARRIED_FIXDIR = REPO / "tests" / "fixtures" / "lint"
ALL_RULES = rule_ids()
CARRIED = ("DET001", "DET002", "DET003")


def _fixture(rule: str, kind: str) -> pathlib.Path:
    d = CARRIED_FIXDIR if rule in CARRIED else FIXDIR
    return d / f"{rule.lower()}_{kind}.py"


def _lint_file(path: pathlib.Path, lint=run_rules):
    return lint(path.as_posix(), path.read_text())


# ---------------------------------------------------------------------------
# per-rule golden fixtures
# ---------------------------------------------------------------------------

def test_every_rule_has_a_fixture_pair():
    assert ALL_RULES == ["DET001", "DET002", "DET003", "DET004", "ATM001",
                         "TRC003", "RCP003", "DON001", "KRN001", "KRN002",
                         "KRN003"]
    for rule in ALL_RULES:
        assert _fixture(rule, "bad").exists(), rule
        assert _fixture(rule, "clean").exists(), rule


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_fires_on_seeded_violation(rule):
    fired = {f.rule for f in _lint_file(_fixture(rule, "bad"))}
    # precision: a bad fixture trips ONLY its own rule
    assert fired == {rule}, f"{rule}: fixture tripped {fired}"


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_passes_clean_twin(rule):
    findings = _lint_file(_fixture(rule, "clean"))
    assert findings == [], [f.format() for f in findings]


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", CARRIED)
def test_carried_rules_give_repros_findings(rule, kind):
    """DET001–003 are repro's code: on repro's fixtures the same rule,
    line, column and fingerprint."""
    path = _fixture(rule, kind)

    def key(findings):
        return [(f.rule, f.line, f.col, f.fingerprint)
                for f in assign_occurrences(findings)]
    want = key(_lint_file(path, j_run_rules))
    assert key(_lint_file(path)) == want
    assert bool(want) == (kind == "bad")


def test_findings_carry_location_and_hint():
    for f in _lint_file(_fixture("ATM001", "bad")):
        assert f.path.endswith("atm001_bad.py")
        assert f.line > 0 and f.message and f.hint
        assert f"{f.path}:{f.line}" in f.format()


# ---------------------------------------------------------------------------
# alias resolution + inline pragmas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,rule", [
    ("import torch as th\n"
     "def f(n):\n"
     "    return th.randperm(n)\n", "DET004"),
    ("from torch import cuda\n"
     "def f(xs):\n"
     "    for x in xs:\n"
     "        cuda.synchronize()\n", "TRC003"),
    ("from .. import _build as b\n"
     "def f(x):\n"
     "    lib = b.load('k')\n"
     "    lib.k_launch(x)\n"
     "    b.count_launch(f)\n", "KRN001"),
], ids=["alias", "from-import", "relative-import"])
def test_import_alias_does_not_dodge_rules(src, rule):
    assert {f.rule for f in run_rules("x.py", src)} == {rule}


def test_trc003_reads_loop_bodies_only_in_torch_modules():
    body = ("def f(xs):\n"
            "    for x in xs.tolist():\n"        # the iterable: once
            "        print(x)\n"
            "    while xs.sum().item() > 0:\n"   # a while test: each time
            "        xs = xs - 1\n")
    assert [f.line for f in run_rules("x.py", "import torch\n" + body)] \
        == [5]
    # a module without torch holds no tensors (the JAX package's arrays
    # are repro's linter's)
    assert run_rules("x.py", "import numpy as np\n" + body) == []


def test_atm001_allow_needs_a_reason():
    src = ("import torch\n"
           "def f(out, i, v):\n"
           "    return out.index_add_(0, i, v)  # lint: allow(ATM001)\n")
    assert {f.rule for f in run_rules("x.py", src)} == {"ATM001"}
    why = src.replace("allow(ATM001)", "allow(ATM001): a timed yardstick")
    assert run_rules("x.py", why) == []
    acc = ("import torch\n"
           "def f(out, i, v, acc):\n"
           "    out.index_put_(i, v, accumulate=False)\n"
           "    out.index_put_(i, v, acc)\n"
           "    return out.put_(i, v, accumulate=True)\n")
    assert [f.line for f in run_rules("x.py", acc)] == [4, 5]


@pytest.mark.parametrize("src", [
    "import torch\n"
    "def f():\n"
    "    torch.manual_seed(0)  # lint: allow(DET004): a test\n",
    "from repro_torch.kernels import _build\n"
    "def f(x):\n"
    "    lib = _build.load('k')\n"
    "    code = lib.k_launch(x)  # lint: allow(KRN002): no counter\n"
    "    _build.check(lib, code, 'k')\n",
], ids=["DET", "KRN"])
def test_inline_allow_cannot_suppress_det_or_krn(src):
    assert len(run_rules("x.py", src)) == 1


def test_the_scatter_paths_allow_is_what_silences_it():
    """``models/gnn.py``'s ``"scatter"`` aggregation was the port's one
    float-atomic path, allowed with its reason; it now sums in edge order
    (``edge_order_sum`` on the CPU, #2 on the card), so the file lints
    clean with no allow at all, and the scatter-add it was still fires
    without one."""
    path = REPO / "src" / "repro_torch" / "models" / "gnn.py"
    src = path.read_text()
    assert "lint: allow(ATM001)" not in src
    assert run_rules("gnn.py", src) == []
    was = ("import torch\n"
           "def agg(out, idx, m):\n"
           "    return out.index_put_(idx, m, accumulate=True)\n")
    assert [f.rule for f in run_rules("gnn.py", was)] == ["ATM001"]


def test_krn_rules_see_every_launch_of_the_port():
    """The KRN rules are not vacuous: they find each wrapper's launches
    (#3's two forwards and #4, #5, #6, #1/#2)."""
    want = {"egnn_edge": 3, "flash_attention": 1, "flash_decode": 1,
            "segment_sum": 1}
    for name, n in want.items():
        path = REPO / "src" / "repro_torch" / "kernels" / name / "ops.py"
        mi = ModuleInfo(path.as_posix(), path.read_text())
        libs = _returned_libraries(mi)
        fns = [f for f in ast.walk(mi.tree)
               if isinstance(f, ast.FunctionDef)]
        assert sum(len(_launches(mi, f, libs)) for f in fns) == n, name


# ---------------------------------------------------------------------------
# baseline: the same file in both packages
# ---------------------------------------------------------------------------

def test_baseline_files_round_trip_between_packages(tmp_path):
    """A baseline written by either package loads in the other and
    suppresses the same findings (the same fingerprint, version 1)."""
    bad = CARRIED_FIXDIR / "rcp001_bad.py"
    j_found = assign_occurrences(_lint_file(bad, j_run_rules))
    src = "import torch\ndef f(xs):\n    for x in xs:\n        x.item()\n"
    t_found = assign_occurrences(run_rules("t.py", src))
    j_path, t_path = tmp_path / "repro.json", tmp_path / "torch.json"
    JBaseline.from_findings(j_found).save(j_path)
    Baseline.from_findings(t_found).save(t_path)
    assert json.loads(t_path.read_text())["version"] == 1
    for path, found in ((j_path, j_found), (t_path, t_found)):
        for load, apply in ((JBaseline.load, j_apply_baseline),
                            (Baseline.load, apply_baseline)):
            new, suppressed, stale = apply(found, load(path))
            assert (new, len(suppressed), stale) == ([], len(found), [])
    assert Baseline.load(j_path).entries == JBaseline.load(j_path).entries
    extra = Finding(rule="TRC003", path="t.py", line=9, col=0, message="m",
                    hint="h", snippet="y.cpu()")
    new, _, _ = apply_baseline(t_found + [extra], JBaseline.load(t_path))
    assert [f.snippet for f in new] == ["y.cpu()"]


def test_baseline_refuses_det_and_krn():
    for rule in ("DET003", "DET004", "KRN001"):
        with pytest.raises(BaselinePolicyError):
            Baseline.from_findings(_lint_file(_fixture(rule, "bad")))
    found = _lint_file(_fixture("DET004", "bad"))
    assert len(Baseline.from_findings(found, allow_all=True).entries) == 1
    # an allowable family baselines
    assert len(Baseline.from_findings(
        _lint_file(_fixture("ATM001", "bad"))).entries) == 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    bad = str(_fixture("TRC003", "bad"))
    clean = str(_fixture("TRC003", "clean"))
    assert main([clean, "--no-baseline"]) == 0
    assert main([bad, "--no-baseline"]) == 1
    assert main(["--list-rules", "."]) == 0
    assert main([str(tmp_path / "missing_dir")]) == 2
    bl = str(tmp_path / "bl.json")
    assert main([bad, "--write-baseline", "--baseline", bl]) == 0
    assert main([bad, "--baseline", bl]) == 0
    assert "baselined" in capsys.readouterr().out


def test_cli_runs_as_module():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--list-rules",
         "."], capture_output=True, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for rule in ALL_RULES:
        assert rule in proc.stdout


# ---------------------------------------------------------------------------
# the port itself
# ---------------------------------------------------------------------------

def test_fixture_dirs_excluded_from_collection():
    files = collect_files([str(REPO / "tests")])
    assert not any("fixtures" in f.parts for f in files)


def test_port_lints_clean_without_baseline():
    """src/repro_torch, the examples and chip_smoke.py carry ZERO findings
    with no baseline: DET and KRN fixed, every other finding fixed or
    allowed inline with its reason."""
    findings, errors = lint_paths(
        [str(REPO / "src" / "repro_torch"), str(REPO / "examples"),
         str(REPO / "chip_smoke.py")], root=REPO)
    assert errors == []
    assert findings == [], "\n".join(f.format() for f in findings)


def test_committed_torch_baseline_is_empty():
    assert Baseline.load(REPO / "lint_baseline_torch.json").entries == []
