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
    # every submodule was imported, the training, LM serving and serving
    # scale-out slices' among them
    assert int(r.stdout.strip()) >= 58


EXAMPLES = SRC.parent / "examples"
PORT_EXAMPLES = ("quickstart_torch", "pretrain_gfm_torch", "serve_gfm_torch",
                 "finetune_downstream_torch", "multitask_lm_torch",
                 "serve_lm_torch")

EXAMPLE_SCRIPT = r"""
import importlib.util, sys
sys.modules["jax"] = None            # any `import jax` now raises
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("ex", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(k for k, m in sys.modules.items() if m is not None and (
    k == "repro" or k.startswith("repro.") or k.split(".")[0] == "jax"))
assert not leaked, leaked
print(len(sys.argv) - 1)
"""


def test_port_examples_import_without_jax_or_repro():
    """The six ``examples/*_torch.py`` import only ``repro_torch`` (each
    module loaded, its ``main`` not run)."""
    paths = [str(EXAMPLES / f"{n}.py") for n in PORT_EXAMPLES]
    assert sorted(p.stem for p in EXAMPLES.glob("*_torch.py")) == \
        sorted(PORT_EXAMPLES)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", EXAMPLE_SCRIPT, *paths],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) == 6


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
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    from repro_torch.engine import Session, SessionConfig
    from repro_torch.launch import train as launch_train
    sources = source_dicts(generate_all(4, max_atoms=16, max_edges=64))[:2]
    scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=1,
                         batch_per_task=2, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(scfg, sources=sources)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--samples", "4", "--batch", "2"])
    # the entry points that place data: a resilient session and the
    # store's prefetching batcher
    import tempfile

    from repro_torch.data.store import (PrefetchingBatcher, ShardedSource,
                                        write_store)
    from repro_torch.resilience import ResilienceConfig
    with tempfile.TemporaryDirectory() as d:
        rcfg = scfg.replace(resilience=ResilienceConfig(ckpt_dir=d))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Session(rcfg, sources=sources)
        with Session(rcfg, sources=sources, device="cpu") as sess:
            assert sess.run().resilience["steps"] == 1
        write_store(d + "/s0", sources[0])
        readers = [ShardedSource(d + "/s0")]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PrefetchingBatcher(readers, 2)
        with PrefetchingBatcher(readers, 2, device="cpu") as pb:
            assert pb.next_batch()["pos"].device.type == "cpu"
    with Session(scfg, sources=sources, device="cpu") as sess:
        assert np.isfinite(sess.run().final_loss)
    srv = ServeSession(params, cfg, spec=BucketSpec((16,), (64,)),
                       device="cpu")
    with srv:
        out = srv.predict_one({"species": np.ones(3, np.int32),
                               "pos": np.eye(3, dtype=np.float32)})
    assert np.isfinite(out["energy"])
    assert srv.stats()["plan"]["device"] == "cpu"
    # multi-device serving: the serving meshes, a sharded session and
    # replicas
    from repro_torch.launch.mesh import ServeMesh, make_replica_meshes
    from repro_torch.serve import ReplicaServeSession
    spec = BucketSpec((16,), (64,))
    one = {"species": np.ones(3, np.int32),
           "pos": np.eye(3, dtype=np.float32)}
    with pytest.raises(RuntimeError, match="devices=\\['cpu'"):
        make_replica_meshes(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(params, cfg, spec=spec,
                     mesh=ServeMesh((torch.device("cuda"),) * 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaServeSession(params, cfg, meshes=[None, None], spec=spec)
    mesh = make_replica_meshes(1, devices_per_replica=2,
                               devices=["cpu"] * 2)[0]
    with ServeSession(params, cfg, spec=spec, mesh=mesh) as sharded:
        out = sharded.submit(one).result(timeout=60)
    assert np.isfinite(out["energy"])
    assert sharded.stats()["plan"]["mode"] == "sharded"
    with ReplicaServeSession(
            params, cfg, spec=spec,
            meshes=make_replica_meshes(2, devices=["cpu"] * 2)) as rep:
        out = rep.submit(one).result(timeout=60)
    assert np.isfinite(out["energy"])
    with ReplicaServeSession(params, cfg, meshes=[None], spec=spec,
                             device="cpu") as rep:
        assert np.isfinite(rep.predict_one(one)["energy"])


RANKS = r"""
import operator
from repro_torch.launch.mesh import run_ranks
try:
    run_ranks(operator.add, 2, timeout=120)
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("run_ranks ran without a GPU and without device='cpu'")
print(run_ranks(operator.add, 2, device="cpu", timeout=120))
"""


def test_run_ranks_needs_a_gpu_unless_cpu_is_asked_for():
    """``run_ranks`` refuses before it spawns a rank, and runs two gloo
    ranks on the CPU when asked (a script of its own: the ranks are
    spawned processes)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None legitimately runs there")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", RANKS], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[2, 3]"


def test_lm_entry_points_need_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None legitimately runs there")
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer
    from repro_torch.train.serve import greedy_generate
    cfg = get_smoke("h2o-danube-1.8b")
    params = transformer.lm_init(np.random.default_rng(0), cfg)
    prompt = np.ones((2, 5), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(params, cfg, prompt, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--new", "2", "--prompt-len", "4"])
    out = greedy_generate(params, cfg, prompt, 3, device="cpu")
    assert out.shape == (2, 3) and out.device.type == "cpu"
    assert serve_lm.main(["--device", "cpu", "--new", "2", "--prompt-len",
                          "4", "--batch", "1"]).shape == (1, 2)
