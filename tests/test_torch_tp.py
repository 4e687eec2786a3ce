"""Tensor-parallel and FSDP compute on ``spec_fn`` plans, against ``repro``.

Four gloo ranks on a (2, 2) ``(data, model)`` mesh (one subprocess, this
file as a script) train and serve three smoke configs of the dense GQA
families with ``fsdp=True``, from ``repro``'s parameters on the same
numpy-seeded batches:

  * ``qwen``: heads and kv heads split over ``model``, remat on;
  * ``gqa``: h2o-danube's (``swa`` then ``attn``, a remainder layer) with
    one kv head, which ``model`` does not divide: replicated kv heads,
    each rank taking the one its q heads read, remat on;
  * ``odd``: qwen's (QKV bias) with 6 q heads over 3 kv heads, so a rank's
    q heads straddle two kv groups (its kv heads repeated to one a q
    head), and ``d_ff`` = 63, which ``model`` does not divide (``_fit``
    keeps it whole: a replicated SwiGLU), no remat.

Held, for each:

  * training against ``repro``'s one-device jitted step: 2 steps' losses
    within rtol 5e-5 / atol 1e-6, the first step's gradients (gathered)
    within 1e-5 x max(1, max|ref|) per leaf, the params after 2 steps
    within ``PARAM_ATOL`` — ``tests/test_torch_sharding.py``'s tolerances
    — and bitwise equal on every rank;
  * serving: each data rank's rows prefilled on its ``model`` ranks (#5's
    plain version under ``"pallas"``), the logits gathered over the vocab
    within 1e-5 x max|ref| of ``repro``'s ``make_prefill_step``, and 4
    greedy tokens (#6's plain version) equal to ``repro``'s
    ``greedy_generate``;
  * bytes: a rank holds its blocks (params, m, v) as
    ``param_bytes_per_device``'s sharded count says, and no step, prefill
    or decode gathers a cut leaf whole (``ShardingPlan.gather``); its
    step's counted
    peak (``launch.cost.count``) is below that of the data-parallel step
    on the same plan (every cut leaf gathered whole), it issues
    all-gathers and reduce-scatters, and its all-reduce bytes are below
    the data-parallel step's.
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
LOGIT_TOL = 1e-5                 # x max|ref| on the prefill's logits
LR, STEPS = 1e-3, 2
PARAM_ATOL = 2 * LR * STEPS      # tests/test_torch_sharding.py's reason
BATCH, SEQ = (4, 16)             # training rows: 2 a data rank
PROMPT, N_NEW = (2, 12), 4       # serving rows: 1 a data rank
TINY = dict(d_model=32, head_dim=8, d_ff=64, n_layers=2, fsdp=True)
CASES = {
    "qwen": ("qwen1.5-0.5b", dict(TINY, n_heads=4, n_kv_heads=4,
                                  remat=True)),
    "gqa": ("h2o-danube-1.8b", dict(TINY, n_heads=4, n_kv_heads=1,
                                    n_layers=3, window=8, remat=True,
                                    block_pattern=("swa", "attn"))),
    "odd": ("qwen1.5-0.5b", dict(TINY, d_model=48, n_heads=6, n_kv_heads=3,
                                 d_ff=63, remat=False)),
}


def _cfg(pkg, case):
    name, kw = CASES[case]
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs import get_smoke
        return get_smoke(name).replace(compute_dtype=jnp.float32, **kw)
    import torch

    from repro_torch.configs import get_smoke
    return get_smoke(name).replace(compute_dtype=torch.float32, **kw)


def _inputs(case, i):
    import jax

    from repro.engine import build_model
    cfg = _cfg("repro", case)
    params = jax.tree_util.tree_map(
        np.asarray, build_model("lm", cfg).init(jax.random.PRNGKey(i)))
    rng = np.random.default_rng(20 + i)
    batches = [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    prompt = rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
    return {"params": params, "batches": batches, "prompt": prompt}


# ---------------------------------------------------------------------------
# the ranks (``python test_torch_tp.py DIR``)
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


def _train(case, inp, mesh):
    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.engine.step import _grad_fn
    from repro_torch.launch import cost
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.optim import adamw
    cfg = _cfg("repro_torch", case)
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    full = interop.to_torch(inp["params"])
    layout = plan.layout(full)
    state = TrainState.create(plan.shard_params(full), opt)
    held = sum(nbytes(t) for t in (state.params, state.opt_state.m,
                                   state.opt_state.v))
    blocks = 3 * nbytes(full, specs={p: s for p, (_, s) in layout.items()},
                        mesh=mesh)
    batches = [plan.shard_batch(b, device="cpu") for b in inp["batches"]]
    _, _, g = _grad_fn(model, plan, 1, None, layout)(state.params, batches[0])
    grads = {k: v.numpy() for k, v in
             interop.leaves(plan.gather(g, layout)).items()}
    # the first step counted on this plan and on the data-parallel one
    counts = {}
    for name, m in (("tp", model), ("dp", model._replace(cfg=None))):
        st = TrainState.create(plan.shard_params(full), opt)
        _, c = cost.count(make_step(m, opt, plan), st, batches[0],
                          track=(st.params, st.opt_state, batches[0]))
        counts[name] = {"peak": c["peak_bytes"],
                        "collectives": c["collectives"]}
    step = make_step(model, opt, plan)
    losses = []
    with _whole_gathers() as whole:
        for b in batches:
            state, out = step(state, b)
            losses.append(float(out.loss))
    params = {k: v.numpy() for k, v in
              interop.leaves(plan.gather(state.params, layout)).items()}
    return {"losses": losses, "grads": grads, "params": params,
            "held": held, "blocks": blocks, "counts": counts,
            "cut": sorted(layout), "whole_gathers": len(whole)}


def _serve(case, inp, mesh):
    import torch

    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import ShardingPlan
    from repro_torch.train.serve import (greedy_generate, make_prefill_step,
                                         serving_tp)
    cfg = _cfg("repro_torch", case)
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    full = interop.to_torch(inp["params"])
    local = plan.shard_params(full)
    rows = plan.slice_batch({"tokens": torch.from_numpy(inp["prompt"])})
    rows = rows["tokens"]
    with _whole_gathers() as whole:
        logits, caches = make_prefill_step(cfg, "pallas", plan)(local, rows)
        toks = greedy_generate(local, cfg, rows, N_NEW, impl="pallas",
                               device="cpu", plan=plan)
    logits = serving_tp(cfg, plan).gather_vocab(logits)
    kv = list(caches["scan"]) + list(caches.get("rem", {}).values())
    return {"logits": logits.numpy(), "tokens": toks.numpy(),
            "rows": plan.shard.index, "whole_gathers": len(whole),
            "kv_heads": sorted({c[k].shape[-2] for c in kv for k in "kv"})}


def _rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_host_mesh(2, 2)
    return {case: {"train": _train(case, inputs[case], mesh),
                   "serve": _serve(case, inputs[case], mesh)}
            for case in CASES}


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

    from repro.engine import TrainState, build_model, make_step
    from repro.optim import adamw
    from repro.train import serve as js
    from repro_torch import interop
    cfg = _cfg("repro", case)
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    params = inp["params"]
    _, g = jax.jit(jax.value_and_grad(model.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in inp["batches"][0].items()})
    step = jax.jit(make_step(model, opt, None))
    state = TrainState.create(params, opt)
    losses = []
    for b in inp["batches"]:
        state, out = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(out.loss))
    prompt = jnp.asarray(inp["prompt"])
    logits, _ = jax.jit(js.make_prefill_step(cfg))(params, prompt)
    toks = js.greedy_generate(params, cfg, prompt, N_NEW)
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    return {"losses": losses,
            "grads": interop.leaves(jax.tree_util.tree_map(np.asarray, g)),
            "params": interop.leaves(tree), "logits": np.asarray(logits),
            "tokens": np.asarray(toks)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp"))
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
def test_tp_losses_and_grads_match_repro(runs, case):
    ref = runs["refs"][case]
    for r in runs["ranks"]:
        got = r[case]["train"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got["grads"][k] - want).max())
            assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_params_match_repro_and_agree(runs, case):
    ref = runs["refs"][case]["params"]
    first = runs["ranks"][0][case]["train"]["params"]
    for r in runs["ranks"]:
        got = r[case]["train"]["params"]
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            assert np.array_equal(got[k], first[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_tp_prefill_and_greedy_match_repro(runs, case):
    ref = runs["refs"][case]
    rows = PROMPT[0] // 2
    for r in runs["ranks"]:
        got = r[case]["serve"]
        sl = slice(got["rows"] * rows, (got["rows"] + 1) * rows)
        want = ref["logits"][sl]
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_TOL * float(np.abs(want).max()), err
        np.testing.assert_array_equal(got["tokens"], ref["tokens"][sl])


@pytest.mark.parametrize("case", list(CASES))
def test_tp_rank_holds_its_blocks_and_peaks_below_data_parallel(runs, case):
    heads = {"qwen": [2], "gqa": [1], "odd": [3]}[case]
    for r in runs["ranks"]:
        got = r[case]["train"]
        assert got["cut"] and got["held"] == got["blocks"]
        tp, dp = got["counts"]["tp"], got["counts"]["dp"]
        assert tp["peak"] < dp["peak"], (tp["peak"], dp["peak"])
        assert tp["collectives"]["all-gather"]["count"] > 0
        assert tp["collectives"]["reduce-scatter"]["count"] > 0
        assert "all-gather" not in dp["collectives"]
        assert tp["collectives"]["all-reduce"]["bytes"] < \
            dp["collectives"]["all-reduce"]["bytes"]
        # the caches hold the rank's kv heads: 4 / 2 a rank, the one kv
        # head, and 3 q heads' repeated kv heads
        assert r[case]["serve"]["kv_heads"] == heads
        # no cut leaf was gathered whole in training, prefill or decode
        assert got["whole_gathers"] == r[case]["serve"]["whole_gathers"] == 0


if __name__ == "__main__":
    _main(sys.argv[1])
