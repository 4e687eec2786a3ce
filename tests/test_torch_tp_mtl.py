"""lm-mtl on ``shared_spec_fn`` plans: the trunk tensor-parallel, the
per-source heads over ``model`` by task, against ``repro``.

Four gloo ranks on a (2, 2) ``(data, model)`` mesh (one subprocess, this
file as a script) train four smoke configs with ``fsdp=True`` from
``repro``'s parameters on the same numpy-seeded task-major batches, each
rank taking every task's rows of its data slice:

  * ``par``: qwen's lm-mtl, 4 tasks, ``"par"`` (2 heads a ``model``
    rank, each decoding its own tasks after Megatron's f), remat on;
  * ``par_accum2``: the same at 2 microbatches (axis 1);
  * ``base``: 3 tasks, ``"base"`` (every head on every rank: ``model`` 2
    does not divide 3; every rank decodes every task), no remat;
  * ``moe``: granite's MoE lm-mtl in ``"par"``, f32, its 4 experts over
    ``model``, each task's tokens routed as ``repro``'s per-task map
    routes them, remat on (the recompute all-reduces the expert counts
    again).

Held, for each, against ``repro``'s one-device jitted lm-mtl step
(``repro.engine.make_step`` on an ``MTPConfig`` plan without a mesh):

  * the losses and the per-task losses of 2 steps within rtol 5e-5 /
    atol 1e-6, the first step's gradients (trunk and heads gathered)
    within 1e-5 x max(1, max|ref|) per leaf, the params after 2 steps
    within ``PARAM_ATOL`` and bitwise equal on every rank
    (``tests/test_torch_tp.py``'s tolerances);
  * ``make_guarded_step`` on the same plan accepts both steps and leaves
    the params bitwise equal to the unguarded step's;
  * bytes: a rank holds its trunk blocks and its heads (params, m, v) as
    ``param_bytes_per_device`` counts them, and no step gathers a cut
    leaf whole (``ShardingPlan.gather``);
  * its step's counted peak (``launch.cost.count``; and that of its
    gradient phase, forward, backward and reductions, before the AdamW
    update) is below that of the data-parallel step on the same mesh and
    specs (a ``shared_spec_fn`` that carries no config: every cut trunk
    leaf gathered whole, each rank computing only its own tasks' rows in
    ``"par"``, its quarter of the rows in ``"base"``).

The widths are those at which parameters, not activations, set a rank's
peak, as at production width: a tensor-parallel rank runs every task's
rows of its data slice, ``model`` times the data-parallel step's rows, so
at the narrowest smoke widths its activations set its peak above the
data-parallel step's (qwen at d_model 32, ``"base"``: 1.93 against 1.55
MB in the gradient phase; granite's MoE without remat: 24.4 against 21.9
MB) — the trade of the design, which cuts the trunk's bytes by
``model``.
"""
import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
RTOL, ATOL = 5e-5, 1e-6          # repro's cross-plan parity tolerance
GRAD_TOL = 1e-5                  # x max(1, max|ref|) per gradient leaf
LR, STEPS = 1e-3, 2
PARAM_ATOL = 2 * LR * STEPS      # tests/test_torch_sharding.py's reason
# widths at which parameters, not activations, set a rank's peak, as at
# production width (the docstring's last point)
QWEN = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
            n_layers=4, fsdp=True)
MOE = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
           n_layers=2, fsdp=True, remat=True, n_experts=4, top_k=2,
           d_ff_expert=256)
# case: (arch, config overrides, tasks, mode, accum, (B, S) a task)
CASES = {
    "par": ("qwen1.5-0.5b", dict(QWEN, remat=True), 4, "par", 1, (2, 16)),
    "par_accum2": ("qwen1.5-0.5b", dict(QWEN, remat=True), 4, "par", 2,
                   (4, 16)),
    "base": ("qwen1.5-0.5b", dict(QWEN, remat=False), 3, "base", 1,
             (2, 16)),
    # a data rank's 2 x 256 tokens of a task are one routing group of 512
    "moe": ("granite-moe-3b-a800m", MOE, 4, "par", 1, (4, 256)),
}


def _cfg(pkg, case):
    name, kw, T = CASES[case][:3]
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs import get_smoke
        return get_smoke(name).replace(compute_dtype=jnp.float32, n_tasks=T,
                                       **kw)
    import torch

    from repro_torch.configs import get_smoke
    return get_smoke(name).replace(compute_dtype=torch.float32, n_tasks=T,
                                   **kw)


def _inputs(case, i):
    import jax

    from repro.engine import build_model
    cfg = _cfg("repro", case)
    params = jax.tree_util.tree_map(
        np.asarray, build_model("lm-mtl", cfg).init(jax.random.PRNGKey(i)))
    rng = np.random.default_rng(40 + i)
    B, S = CASES[case][5]
    batches = [{k: rng.integers(0, cfg.vocab, (cfg.n_tasks, B, S))
                .astype(np.int32) for k in ("tokens", "labels")}
               for _ in range(STEPS)]
    return {"params": params, "batches": batches}


# ---------------------------------------------------------------------------
# the ranks (``python test_torch_tp_mtl.py DIR``)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _whole_gathers():
    """A list that receives one entry for every ``ShardingPlan.gather``
    (every cut leaf gathered whole) made while the block runs."""
    from repro_torch.engine import ShardingPlan
    calls, real = [], ShardingPlan.gather

    def counted(self, tree, layout):
        calls.append(len(layout))
        return real(self, tree, layout)
    ShardingPlan.gather = counted
    try:
        yield calls
    finally:
        ShardingPlan.gather = real


def _whole(plan, tree, layout) -> dict:
    """A rank's params or grads -> every leaf whole, as numpy (the trunk
    gathered over its blocks, the heads from their holders)."""
    from repro_torch import interop
    full = {"shared": plan.gather({"shared": tree["shared"]},
                                  layout)["shared"],
            "heads": plan.gather_heads([tree["heads"]])[0]}
    return {k: v.numpy() for k, v in interop.leaves(full).items()}


def _train(case, inp, mesh):
    import torch

    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.core.taskpar import MTPConfig, take_heads
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.engine.state import GuardState
    from repro_torch.engine.step import _grad_fn, make_guarded_step
    from repro_torch.resilience import GuardConfig
    from repro_torch.launch import cost
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.optim import adamw
    cfg = _cfg("repro_torch", case)
    T, mode, accum = CASES[case][2:5]
    spec_fn = make_spec_fn(cfg, mesh)
    mtp = MTPConfig(n_tasks=T, mode=mode)
    plan = ShardingPlan(mesh=mesh, mtp=mtp, shared_spec_fn=spec_fn)
    model = build_model("lm-mtl", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    full = interop.to_torch(inp["params"])
    layout = plan.layout(full)
    state = TrainState.create(plan.shard_params(full), opt)
    held = sum(nbytes(t) for t in (state.params, state.opt_state.m,
                                   state.opt_state.v))
    trunk = {p[len("shared/"):]: s for p, (_, s) in layout.items()}
    own = plan.shard.heads
    blocks = 3 * (nbytes(full["shared"], specs=trunk, mesh=mesh) +
                  nbytes(take_heads(full["heads"], own)))
    batches = [plan.shard_batch(b, device="cpu", accum=accum)
               for b in inp["batches"]]
    _, _, g = _grad_fn(model, plan, accum, None, layout)(state.params,
                                                         batches[0])
    grads = _whole(plan, g, layout)
    # the first step and its gradient phase counted on this plan and on
    # the data-parallel one (the same specs through a function that
    # carries no config)
    dp = ShardingPlan(mesh=mesh, mtp=mtp,
                      shared_spec_fn=lambda p, x: spec_fn(p, x))
    counts = {}
    for name, pl in (("tp", plan), ("dp", dp)):
        st = TrainState.create(pl.shard_params(full), opt)
        b = pl.shard_batch(inp["batches"][0], device="cpu", accum=accum)
        track = (st.params, st.opt_state, b)
        _, c = cost.count(_grad_fn(model, pl, accum, None, pl.layout(full)),
                          st.params, b, track=track)
        counts[name] = c["peak_bytes"]
        _, c = cost.count(make_step(model, opt, pl, accum=accum), st, b,
                          track=track)
        counts[f"{name}_step"] = c["peak_bytes"]
    step = make_step(model, opt, plan, accum=accum)
    guarded = make_guarded_step(model, opt, plan, guard=GuardConfig(),
                                accum=accum)
    gstate = TrainState.create(plan.shard_params(full), opt,
                               guard=GuardState.init())
    losses, per_task, same = [], [], []
    with _whole_gathers() as whole:
        for b in batches:
            state, out = step(state, b)
            losses.append(float(out.loss))
            per_task.append(out.metrics["per_task_loss"].tolist())
            gstate, gout = guarded(gstate, b)
            same.append(bool(gout.metrics["guard_ok"]) and all(
                torch.equal(x, y) for x, y in zip(
                    interop.leaves(gstate.params).values(),
                    interop.leaves(state.params).values())))
    return {"losses": losses, "per_task": per_task, "grads": grads,
            "guarded_same": same,
            "params": _whole(plan, state.params, layout), "held": held,
            "blocks": blocks, "heads": list(own), "peaks": counts,
            "rows": tuple(batches[0]["tokens"].shape),
            "cut": sorted(layout), "whole_gathers": len(whole)}


def _rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_host_mesh(2, 2)
    return {case: _train(case, inputs[case], mesh) for case in CASES}


def _main(workdir):
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_rank_main, 4, device="cpu", args=(workdir,),
                    timeout=240, rdzv_dir=workdir)
    with open(os.path.join(workdir, "ranks.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# repro's references, in the test process
# ---------------------------------------------------------------------------

def _repro(case, inp):
    import jax
    import jax.numpy as jnp

    from repro.core.taskpar import MTPConfig
    from repro.engine import ShardingPlan, TrainState, build_model, make_step
    from repro.engine.step import make_grad_fn, with_grad_accum
    from repro.optim import adamw
    from repro_torch import interop
    cfg = _cfg("repro", case)
    accum = CASES[case][4]
    model = build_model("lm-mtl", cfg)
    plan = ShardingPlan(mtp=MTPConfig(n_tasks=cfg.n_tasks))
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    params = inp["params"]
    dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in inp["batches"]]
    _, _, g = jax.jit(with_grad_accum(make_grad_fn(model, plan), accum,
                                      axis=1))(params, dev[0])
    step = jax.jit(make_step(model, opt, plan, accum=accum))
    state = TrainState.create(params, opt)
    losses, per_task = [], []
    for b in dev:
        state, out = step(state, b)
        losses.append(float(out.loss))
        per_task.append(np.asarray(out.metrics["per_task_loss"]).tolist())
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    return {"losses": losses, "per_task": per_task,
            "grads": interop.leaves(jax.tree_util.tree_map(np.asarray, g)),
            "params": interop.leaves(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_mtl"))
    inputs = {case: _inputs(case, i) for i, case in enumerate(CASES)}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        refs = {case: _repro(case, inputs[case]) for case in CASES}
        _, err = proc.communicate(timeout=270)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(os.path.join(workdir, "ranks.pkl"), "rb") as f:
        ranks = pickle.load(f)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("case", list(CASES))
def test_mtl_tp_losses_and_grads_match_repro(runs, case):
    ref = runs["refs"][case]
    for r in runs["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["per_task"], ref["per_task"],
                                   rtol=RTOL, atol=ATOL)
        assert set(got["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got["grads"][k] - want).max())
            assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_mtl_tp_params_match_repro_and_agree(runs, case):
    ref = runs["refs"][case]["params"]
    first = runs["ranks"][0][case]["params"]
    for r in runs["ranks"]:
        got = r[case]["params"]
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            assert np.array_equal(got[k], first[k]), k
        # the guarded step on the same plan accepts every step and leaves
        # the same bits
        assert r[case]["guarded_same"] == [True] * STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_mtl_tp_rank_holds_its_blocks_and_heads(runs, case):
    T, mode, accum, (B, S) = CASES[case][2:]
    for i, r in enumerate(runs["ranks"]):
        got = r[case]
        assert got["cut"] and got["held"] == got["blocks"]
        # par: a model rank's tasks (ranks are row-major on (data,
        # model)); base: every head
        k = T // 2 if mode == "par" else T
        m = i % 2
        assert got["heads"] == (list(range(m * k, (m + 1) * k))
                                if mode == "par" else list(range(T)))
        # every task's rows of the rank's data slice
        assert got["rows"] == (T, B // 2, S)
        assert got["whole_gathers"] == 0
        peaks = got["peaks"]
        assert peaks["tp"] < peaks["dp"], peaks
        assert peaks["tp_step"] < peaks["dp_step"], peaks


if __name__ == "__main__":
    _main(sys.argv[1])
