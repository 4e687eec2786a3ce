"""The port's six examples (``examples/*_torch.py``) run on the CPU at
their smallest settings, each in a few seconds, through their ``main``.

``finetune_downstream_torch.py``'s two held-out MAEs are compared with
``repro``'s ``examples/finetune_downstream.py`` run at the same small step
counts (its source with the step constants replaced; the file itself is
untouched). The two runs draw their initial weights differently (the port
from numpy seeds, ``repro`` from JAX keys) and train 10 + 5 steps, so they
agree as two seeds of one experiment do, not bit for bit: energy MAEs
within 20% and force MAEs within 5% of ``repro``'s (measured 6.2% and
0.4%). The protocol itself is held to ``repro``'s step for step in
tests/test_torch_single_task.py.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

RUNS = {
    "quickstart_torch": ["--steps", "5"],
    "pretrain_gfm_torch": ["--steps", "3", "--width", "32", "--samples",
                           "16", "--batch", "4"],
    "serve_gfm_torch": ["--requests", "12"],
    "finetune_downstream_torch": ["--steps", "10", "--ft-steps", "5"],
    "multitask_lm_torch": ["--steps", "3", "--seq", "16", "--batch", "2"],
    "serve_lm_torch": ["--new", "4", "--batch", "2", "--prompt-len", "8"],
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return all(_finite(v) for v in x)
    if hasattr(x, "numpy"):
        return bool(np.isfinite(x.float().numpy()).all())
    if isinstance(x, np.ndarray):
        return bool(np.isfinite(x).all())
    return math.isfinite(float(x))


@pytest.fixture(scope="module")
def finetune_port():
    return _load("finetune_downstream_torch").main(
        ["--device", "cpu"] + RUNS["finetune_downstream_torch"])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_cpu(name, tmp_path, finetune_port):
    argv = ["--device", "cpu"] + RUNS[name]
    if name == "pretrain_gfm_torch":
        argv += ["--ckpt", str(tmp_path / "gfm_ck")]
    out = finetune_port if name == "finetune_downstream_torch" else \
        _load(name).main(argv)
    if name == "serve_gfm_torch":
        c = out["counters"]
        assert c["completed"] == c["submitted"] == 12 and c["failed"] == 0
    elif name == "pretrain_gfm_torch":
        assert np.isfinite(out.final_loss)
        assert (tmp_path / "gfm_ck.npz").exists() or \
            (tmp_path / "gfm_ck").exists()
    elif name == "serve_lm_torch":
        assert tuple(out.shape) == (2, 4)
    else:
        assert _finite(out)


def test_finetune_example_maes_agree_with_repro(finetune_port):
    src = (EXAMPLES / "finetune_downstream.py").read_text()
    assert "STEPS_PT, STEPS_FT = 400, 200" in src
    src = src.replace("STEPS_PT, STEPS_FT = 400, 200",
                      "STEPS_PT, STEPS_FT = 10, 5")
    scope = {"__name__": "finetune_downstream"}
    exec(compile(src, str(EXAMPLES / "finetune_downstream.py"), "exec"),
         scope)
    want = {"pretrained": (scope["e_ft"], scope["f_ft"]),
            "scratch": (scope["e_sc"], scope["f_sc"])}
    for path, (e, f) in want.items():
        got_e, got_f = finetune_port[path]
        assert abs(got_e - float(e)) <= 0.2 * float(e), (path, got_e, e)
        assert abs(got_f - float(f)) <= 0.05 * float(f), (path, got_f, f)
