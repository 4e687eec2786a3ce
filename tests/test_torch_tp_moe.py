"""Expert-parallel MoE and MLA's local heads on ``spec_fn`` plans, against
``repro``.

Four gloo ranks on a (2, 2) ``(data, model)`` mesh (one subprocess, this
file as a script) train and serve three smoke configs with ``fsdp=True``,
from ``repro``'s parameters on the same numpy-seeded batches:

  * ``ep``: granite-moe's (4 experts over ``model`` 2: a rank owns 2
    whole experts; 4 q / 2 kv heads, 2 and 1 a rank), remat on;
  * ``hidden``: granite-moe's with 3 experts, which ``model`` does not
    divide, so every expert's ``d_ff_expert`` is cut over it, and one
    shared expert (its ``d_ff`` column/row-parallel);
  * ``mla``: deepseek-v2's in f32: MLA with 4 heads (2 a rank after the
    replicated latent), 4 experts expert-parallel, 1 shared expert.

Held, for each:

  * training against ``repro``'s one-device jitted step:
    ``tests/test_torch_tp.py``'s tolerances — 2 steps' losses within
    rtol 5e-5 / atol 1e-6, the first step's gradients (gathered) within
    1e-5 x max(1, max|ref|) per leaf, the replicated leaves that Megatron's
    f placement decides (``ffn/router``, MLA's ``wq_a`` / ``wkv_a``)
    named where they fail, and the params after 2 steps within
    ``PARAM_ATOL`` and bitwise equal on every rank;
  * serving: each data rank's row prefilled on its ``model`` ranks (#5's
    plain version under ``"pallas"``), the logits gathered over the vocab
    within 1e-5 x max|ref| of ``repro``'s ``make_prefill_step`` on that
    row, and 4 greedy tokens equal to ``repro``'s ``greedy_generate`` of
    it (MLA: the absorbed decode on the rank's heads);
  * bytes and work: a rank holds its blocks (params, m, v), no step,
    prefill or decode gathers a cut leaf whole (``ShardingPlan.gather``),
    and a MoE layer's counted FLOPs a rank (``launch.cost.count``) less
    the replicated router's are exactly half of one process's, in both
    layouts (the expert and shared-expert products are cut over
    ``model``), with one all-reduce over ``model`` the layer.

Granite's smoke config with ``naive_tp`` keeps the data-parallel step
where a ``model`` size splits its heads, and says so.
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
BATCH, SEQ = (4, 256)            # training rows: 2 a data rank, one
                                 # routing group of 512 tokens
PROMPT, N_NEW = (2, 12), 4       # serving rows: 1 a data rank
CASES = {
    "ep": ("granite-moe-3b-a800m", dict(fsdp=True, remat=True)),
    "hidden": ("granite-moe-3b-a800m", dict(fsdp=True, n_experts=3,
                                            n_shared_experts=1)),
    "mla": ("deepseek-v2-236b", dict(fsdp=True)),
}
# the replicated leaves whose gradients Megatron's f placement decides
REPLICATED = ("ffn/router", "attn/wq_a/w", "attn/wkv_a/w")


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
    rng = np.random.default_rng(40 + i)
    batches = [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    prompt = rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    return {"params": params, "batches": batches, "prompt": prompt, "x": x}


# ---------------------------------------------------------------------------
# the ranks (``python test_torch_tp_moe.py DIR``)
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


def _moe_flops(cfg, full, local, plan, layout, x):
    """One MoE layer's forward counted on this rank's blocks (layer 0's
    FSDP leaves gathered first) and on the whole layer in one process:
    (the rank's FLOPs, one process's, the rank's collectives)."""
    import torch

    from repro_torch.interop import tree_map
    from repro_torch.launch import cost
    from repro_torch.models.moe import moe_apply
    tp = plan.tensor_parallel(layout)
    first = tree_map(lambda a: a[0], local["scan"]["u0"]["ffn"])
    mine = tp.unit(first, "scan/u0/ffn")
    whole = tree_map(lambda a: a[0], full["scan"]["u0"]["ffn"])
    x = torch.from_numpy(x)
    with torch.no_grad():
        _, rank = cost.count(lambda: moe_apply(mine, x, cfg=cfg, tp=tp))
        _, one = cost.count(lambda: moe_apply(whole, x, cfg=cfg))
    return rank["flops"], one["flops"], rank["collectives"]


def _train(case, inp, mesh):
    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.engine.step import _grad_fn
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
    tp = plan.tensor_parallel(layout)
    flops = _moe_flops(cfg, full, state.params, plan, layout, inp["x"])
    batches = [plan.shard_batch(b, device="cpu") for b in inp["batches"]]
    with _whole_gathers() as whole:
        _, _, g = _grad_fn(model, plan, 1, None, layout)(state.params,
                                                         batches[0])
        step = make_step(model, opt, plan)
        losses = []
        for b in batches:
            state, out = step(state, b)
            losses.append(float(out.loss))
    grads = {k: v.numpy() for k, v in
             interop.leaves(plan.gather(g, layout)).items()}
    params = {k: v.numpy() for k, v in
              interop.leaves(plan.gather(state.params, layout)).items()}
    return {"losses": losses, "grads": grads, "params": params,
            "held": held, "blocks": blocks, "cut": sorted(layout),
            "whole_gathers": len(whole), "flops": flops,
            "tp": {"experts": tp.experts, "expert_ffn": tp.expert_ffn,
                   "shared": tp.shared, "mla": tp.mla, "heads": tp.heads}}


def _serve(case, inp, mesh):
    import torch

    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import ShardingPlan
    from repro_torch.train.serve import (greedy_generate, make_prefill_step,
                                         serving_tp)
    cfg = _cfg("repro_torch", case)
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    local = plan.shard_params(interop.to_torch(inp["params"]))
    rows = plan.slice_batch({"tokens": torch.from_numpy(inp["prompt"])})
    rows = rows["tokens"]
    with _whole_gathers() as whole:
        logits, caches = make_prefill_step(cfg, "pallas", plan)(local, rows)
        toks = greedy_generate(local, cfg, rows, N_NEW, impl="pallas",
                               device="cpu", plan=plan)
    logits = serving_tp(cfg, plan).gather_vocab(logits)
    return {"logits": logits.numpy(), "tokens": toks.numpy(),
            "rows": plan.shard.index, "whole_gathers": len(whole),
            "cache": {k: tuple(v.shape) for k, v in
                      interop.leaves({"c": caches["scan"][0]}).items()}}


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
    # each data rank serves its row alone: repro serving that row
    prefill = jax.jit(js.make_prefill_step(cfg))
    logits, toks = [], []
    for row in inp["prompt"]:
        prompt = jnp.asarray(row[None])
        logits.append(np.asarray(prefill(params, prompt)[0]))
        toks.append(np.asarray(js.greedy_generate(params, cfg, prompt,
                                                  N_NEW)))
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    return {"losses": losses,
            "grads": interop.leaves(jax.tree_util.tree_map(np.asarray, g)),
            "params": interop.leaves(tree), "logits": logits,
            "tokens": toks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_moe"))
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
def test_tp_moe_losses_and_grads_match_repro(runs, case):
    ref = runs["refs"][case]
    replicated = [k for k in ref["grads"] if any(r in k for r in REPLICATED)]
    assert any("ffn/router" in k for k in replicated)
    if case == "mla":
        assert {"attn/wq_a/w", "attn/wkv_a/w"} <= {
            k.split("/", 2)[-1] for k in replicated}
    for r in runs["ranks"]:
        got = r[case]["train"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got["grads"][k] - want).max())
            what = " (a replicated leaf: Megatron's f placement)" \
                if k in replicated else ""
            assert err <= tol, f"{k}{what}: {err} > {tol}"


@pytest.mark.parametrize("case", list(CASES))
def test_tp_moe_params_match_repro_and_agree(runs, case):
    ref = runs["refs"][case]["params"]
    first = runs["ranks"][0][case]["train"]["params"]
    for r in runs["ranks"]:
        got = r[case]["train"]["params"]
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            assert np.array_equal(got[k], first[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_tp_moe_prefill_and_greedy_match_repro(runs, case):
    ref = runs["refs"][case]
    for r in runs["ranks"]:
        got = r[case]["serve"]
        want = ref["logits"][got["rows"]]
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_TOL * float(np.abs(want).max()), err
        np.testing.assert_array_equal(got["tokens"], ref["tokens"][got["rows"]])


@pytest.mark.parametrize("case", list(CASES))
def test_tp_moe_rank_holds_its_blocks_and_halves_the_expert_work(runs, case):
    cfg = _cfg("repro_torch", case)
    E, d = cfg.n_experts, cfg.d_model
    for i, r in enumerate(runs["ranks"]):
        got = r[case]["train"]
        assert got["cut"] and got["held"] == got["blocks"]
        assert got["whole_gathers"] == r[case]["serve"]["whole_gathers"] == 0
        tp = got["tp"]
        index = i % 2                      # the rank's model coordinate
        if case == "hidden":
            assert tp["experts"] is None and tp["expert_ffn"] and tp["shared"]
        else:
            assert tuple(tp["experts"]) == (2 * index, 2 * index + 2)
            assert not tp["expert_ffn"]
        assert tp["mla"] == (case == "mla")
        assert tp["heads"] == (case != "mla")
        # the replicated router's products, then the cut ones: half
        rank, one, coll = got["flops"]
        router = 2 * 2 * SEQ * d * E
        assert rank - router == (one - router) / 2, (rank, one, router)
        assert coll == {"all-reduce": {"count": 1,
                                       "bytes": 4 * 2 * SEQ * d}}
    if case == "mla":
        # the latent cache whole on every model rank: (reps, B, S, r)
        c = runs["ranks"][0][case]["serve"]["cache"]
        assert c["c/ckv"][-1] == cfg.kv_lora and c["c/ckv"][1] == 1


def test_fractional_heads_keep_the_data_parallel_step():
    """granite's smoke config (4 q / 2 kv heads, ``naive_tp``): on a
    ``model`` axis of 2 it computes tensor-parallel; of 4 (kv heads) or 8
    (q heads) its heads would be fractional, and it keeps the
    data-parallel step, naming why."""
    import types

    from repro_torch.configs import get_smoke
    from repro_torch.configs.sharding import tensor_parallel_reason
    from repro_torch.engine import build_model
    from repro_torch.engine.step import _tensor_parallel
    from repro_torch.launch import dryrun
    cfg = get_smoke("granite-moe-3b-a800m")
    assert cfg.naive_tp
    model = build_model("lm", cfg)
    for m, why in ((2, None), (4, "naive_tp's fractional heads (2 kv heads "
                               "over model 4)"),
                   (8, "naive_tp's fractional heads (4 heads over model "
                       "8)")):
        assert tensor_parallel_reason(cfg, m) == why
        plan = types.SimpleNamespace(mesh={"data": 2, "model": m})
        assert _tensor_parallel(model, plan, {"cut": ()}) == (why is None)
        want = dryrun.TENSOR_PARALLEL if why is None else \
            f"{dryrun.DATA_PARALLEL} ({why})"
        assert dryrun.figures(cfg, m) == want
    # MLA with heads that model does not divide would split a head
    ds = get_smoke("deepseek-v2-236b")
    assert tensor_parallel_reason(ds, 2) is None
    assert "MLA's heads" in tensor_parallel_reason(ds, 8)


if __name__ == "__main__":
    _main(sys.argv[1])
