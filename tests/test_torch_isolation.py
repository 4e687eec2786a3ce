"""The port stands alone: it imports neither ``jax`` nor ``repro``, and its
entry points refuse to run on a CPU-only host unless the CPU is asked for."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(k for k, m in sys.modules.items() if m is not None and (
    k == "repro" or k.startswith("repro.") or k.split(".")[0] == "jax"))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20        # every submodule was imported


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None legitimately runs there")
    from repro_torch import resolve_device
    from repro_torch.configs import hydragnn_gfm
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.serve import ServeSession
    cfg = hydragnn_gfm.smoke()
    params = gfm_mtl_init(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(params, cfg, spec=BucketSpec((16,), (64,)))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    srv = ServeSession(params, cfg, spec=BucketSpec((16,), (64,)),
                       device="cpu")
    with srv:
        out = srv.predict_one({"species": np.ones(3, np.int32),
                               "pos": np.eye(3, dtype=np.float32)})
    assert np.isfinite(out["energy"])
    assert srv.stats()["plan"]["device"] == "cpu"
