"""lm-mtl across ranks on the card: its drift from one process is the
rounding of a reordered sum, not a fault.

qwen1.5-0.5b at full width in f32, its two task heads on the ``"base"``
plan, one row a task a rank, 3 steps, at lr 3e-4 and 1e-4: two gloo ranks
on the card (``launch.mesh.run_ranks``), and one process at accum 1 and at
accum 2, whose two microbatches are the ranks' rows (the same sums in the
ranks' order). The ranks' total and per-task losses equal accum 2's within
1e-2 x the cross-plan tolerance (rtol 5e-5, atol 1e-6) at every step, so
what separates them from accum 1 is the order of the sums; at 1e-4 accum 2
stays within the tolerance of accum 1 for all 3 steps, so the drift grows
with the rate that AdamW applies it at.

The ranks run in ONE subprocess (this file as a script) under a hard
timeout. Needs the card (``gpu``):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_mtl_drift.py
"""
import os
import pickle
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LRS = (3e-4, 1e-4)
STEPS, WORLD, SEQ = 3, 2, 512
RTOL, ATOL = 5e-5, 1e-6


def _session(lr, accum, mesh=None):
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.engine import Session, SessionConfig
    cfg = qwen1_5_0_5b.CONFIG.replace(compute_dtype=torch.float32,
                                      n_tasks=2)
    sources = make_lm_sources(2, 8, SEQ, cfg.vocab)
    return Session(SessionConfig(
        arch=cfg, model="lm-mtl", batch_per_task=WORLD, mode="base",
        steps=STEPS, lr=lr, accum=accum, log_every=1, eval_every=10 ** 9,
        seed=0, verbose=False), sources=sources, mesh=mesh, device="cuda")


def _rows(sess):
    with sess:
        res = sess.run()
    return [[r["loss"], r["task0"], r["task1"]] for r in res.logger.history]


def _rank_main(rank, world):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1)
    return {lr: _rows(_session(lr, 1, mesh)) for lr in LRS}


def _main(workdir):
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import run_ranks
    one = {(lr, accum): _rows(_session(lr, accum))
           for lr in LRS for accum in (1, 2)}
    torch.cuda.empty_cache()
    ranks = run_ranks(_rank_main, WORLD, backend="gloo", device="cuda",
                      timeout=600, rdzv_dir=workdir)
    with open(os.path.join(workdir, "out.pkl"), "wb") as f:
        pickle.dump({"one": one, "ranks": ranks}, f)


def _err(got, want) -> float:
    """The largest |got - want| over the cross-plan tolerance."""
    return max(abs(g - w) / (ATOL + RTOL * abs(w))
               for gr, wr in zip(got, want) for g, w in zip(gr, wr))


def test_lm_mtl_ranks_drift_as_one_process_summing_in_their_order(
        tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ranks train on the card)")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    one, ranks = out["one"], out["ranks"]
    for lr in LRS:
        for r in ranks:
            assert len(r[lr]) == STEPS
            assert _err(r[lr], one[lr, 2]) <= 1e-2, lr
    assert _err(one[1e-4, 2], one[1e-4, 1]) <= 1.0


if __name__ == "__main__":
    _main(sys.argv[1])
