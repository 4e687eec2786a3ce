"""seamless-m4t-medium's encoder and cross-attention tensor-parallel on a
``spec_fn`` plan, against ``repro``.

Four gloo ranks on a (2, 2) ``(data, model)`` mesh (one subprocess, this
file as a script) train and serve seamless's smoke config (2 encoder + 2
decoder layers, 4 / 4 heads, ``fsdp=True``, f32, remat on) from
``repro``'s parameters (every bias, norm scale and norm bias drawn, so
each leaf matters) on the same numpy-seeded tokens and source frames. A
rank computes its 2 local heads in every encoder block, every decoder
self-attention and every cross-attention (the memory, whole on every
``model`` rank after the encoder's final norm, enters each cross-
attention through Megatron's f), its ``d_ff`` columns, its vocab block;
the audio projector is replicated compute. Held:

  * training against ``repro``'s one-device jitted step (``src_embed``
    encoded inside the loss): 2 steps' losses within rtol 5e-5 / atol
    1e-6, the first step's gradients (gathered) within 1e-5 x max(1,
    max|ref|) per leaf, the params after 2 steps within ``PARAM_ATOL``
    and bitwise equal on every rank (``tests/test_torch_tp.py``'s);
  * serving under ``"pallas"`` (#5 and #6's plain versions on CPU
    tensors): each data rank's row encoded on its ``model`` ranks
    (``make_encode_step``) within 1e-5 x max|ref| of ``repro``'s
    ``encode``, prefilled with ``memory=`` — the logits gathered over the
    vocab within 1e-5 x max|ref| of ``repro``'s ``make_prefill_step`` —
    and 4 greedy tokens equal to ``repro``'s ``greedy_generate(memory=)``;
  * bytes: a rank holds its blocks (params, m, v) as
    ``param_bytes_per_device`` counts them, its caches its 2 kv heads, and
    no step, encoding, prefill or decode gathers a cut leaf whole
    (``ShardingPlan.gather``).

And ``repro_torch.launch.dryrun.run_one("seamless-m4t-medium",
"train_4k", "pod", device="cpu")`` (rank 0 of the 16 x 16 pod, counted
on fake tensors; no ``repro`` compile): its ``figures`` read
tensor-parallel, its counted peak is under one H100's 80 GB (the
data-parallel step's read 616) and its FLOPs under a quarter of the
data-parallel step's 488 TFLOP.
"""
import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "seamless-m4t-medium"
RTOL, ATOL = 5e-5, 1e-6          # repro's cross-plan parity tolerance
GRAD_TOL = 1e-5                  # x max(1, max|ref|) per gradient leaf
LOGIT_TOL = 1e-5                 # x max|ref| on the memory and logits
LR, STEPS = 1e-3, 2
PARAM_ATOL = 2 * LR * STEPS      # tests/test_torch_sharding.py's reason
BATCH, SEQ, FRAMES = 4, 12, 16   # training rows: 2 a data rank
PROMPT, N_NEW = (2, 12), 4       # serving rows: 1 a data rank
KW = dict(n_layers=2, n_enc_layers=2, fsdp=True, remat=True)
H100_BYTES = 80e9                # one card's memory
DP_TFLOP = 488                   # train_4k on the pod, the data-parallel
                                 # step's count (PERF.md §6)


def _cfg(pkg):
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs import get_smoke
        return get_smoke(ARCH).replace(compute_dtype=jnp.float32, **KW)
    import torch

    from repro_torch.configs import get_smoke
    return get_smoke(ARCH).replace(compute_dtype=torch.float32, **KW)


def _inputs():
    import jax

    from repro.models import transformer as jt
    from repro_torch.models.frontends import AUDIO_EMBED_DIM
    cfg = _cfg("repro")
    rng = np.random.default_rng(30)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if any(f"'{k}'" in name for k in ("b", "scale", "bias")):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    params = jax.tree_util.tree_map_with_path(
        perturb, jt.lm_init(jax.random.PRNGKey(3), cfg))

    def frames(b):
        return rng.standard_normal((b, FRAMES, AUDIO_EMBED_DIM)).astype(
            np.float32)
    batches = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                        "src_embed": frames(BATCH)})
    prompt = rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
    return {"params": params, "batches": batches, "prompt": prompt,
            "src": frames(PROMPT[0])}


# ---------------------------------------------------------------------------
# the ranks (``python test_torch_tp_encdec.py DIR``)
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


def _train(inp, plan, full):
    from repro_torch import interop
    from repro_torch.engine import TrainState, build_model, make_step
    from repro_torch.engine.step import _grad_fn
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.optim import adamw
    cfg = _cfg("repro_torch")
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    layout = plan.layout(full)
    state = TrainState.create(plan.shard_params(full), opt)
    held = sum(nbytes(t) for t in (state.params, state.opt_state.m,
                                   state.opt_state.v))
    blocks = 3 * nbytes(full, specs={p: s for p, (_, s) in layout.items()},
                        mesh=plan.mesh)
    batches = [plan.shard_batch(b, device="cpu") for b in inp["batches"]]
    step = make_step(model, opt, plan)
    losses = []
    with _whole_gathers() as whole:
        _, _, g = _grad_fn(model, plan, 1, None, layout)(state.params,
                                                         batches[0])
        for b in batches:
            state, out = step(state, b)
            losses.append(float(out.loss))
    grads = {k: v.numpy() for k, v in
             interop.leaves(plan.gather(g, layout)).items()}
    params = {k: v.numpy() for k, v in
              interop.leaves(plan.gather(state.params, layout)).items()}
    return {"losses": losses, "grads": grads, "params": params,
            "held": held, "blocks": blocks, "cut": sorted(layout),
            "whole_gathers": len(whole)}


def _serve(inp, plan, full):
    import torch

    from repro_torch.train.serve import (greedy_generate, make_encode_step,
                                         make_prefill_step, serving_tp)
    cfg = _cfg("repro_torch")
    local = plan.shard_params(full)
    rows = plan.slice_batch({"tokens": torch.from_numpy(inp["prompt"]),
                             "src": torch.from_numpy(inp["src"])})
    with _whole_gathers() as whole:
        memory = make_encode_step(cfg, "pallas", plan)(local, rows["src"])
        logits, caches = make_prefill_step(cfg, "pallas", plan)(
            local, rows["tokens"], memory=memory)
        toks = greedy_generate(local, cfg, rows["tokens"], N_NEW,
                               impl="pallas", device="cpu", plan=plan,
                               memory=memory)
    logits = serving_tp(cfg, plan).gather_vocab(logits)
    kv = [c["self"][k] for c in caches["scan"] for k in "kv"]
    return {"memory": memory.numpy(), "logits": logits.numpy(),
            "tokens": toks.numpy(), "rows": plan.shard.index,
            "whole_gathers": len(whole),
            "kv_heads": sorted({x.shape[-2] for x in kv})}


def _rank_main(rank, world, workdir):
    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_host_mesh(2, 2)
    cfg = _cfg("repro_torch")
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    full = interop.to_torch(inp["params"])
    return {"train": _train(inp, plan, full),
            "serve": _serve(inp, plan, full),
            "computes_tensor_parallel": plan.computes_tensor_parallel}


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

def _repro(inp):
    import jax
    import jax.numpy as jnp

    from repro.engine import TrainState, build_model, make_step
    from repro.models import transformer as jt
    from repro.optim import adamw
    from repro.train import serve as js
    from repro_torch import interop
    cfg = _cfg("repro")
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    params = inp["params"]
    dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in inp["batches"]]
    _, g = jax.jit(jax.value_and_grad(model.loss_fn))(params, dev[0])
    step = jax.jit(make_step(model, opt, None))
    state = TrainState.create(params, opt)
    losses = []
    for b in dev:
        state, out = step(state, b)
        losses.append(float(out.loss))
    prompt = jnp.asarray(inp["prompt"])
    mem = jax.jit(lambda p, s: jt.encode(p, s, cfg))(
        params, jnp.asarray(inp["src"]))
    logits, _ = jax.jit(js.make_prefill_step(cfg))(params, prompt,
                                                  memory=mem)
    toks = js.greedy_generate(params, cfg, prompt, N_NEW, memory=mem)
    return {"losses": losses,
            "grads": interop.leaves(jax.tree_util.tree_map(np.asarray, g)),
            "params": interop.leaves(jax.tree_util.tree_map(
                np.asarray, state.params)),
            "memory": np.asarray(mem), "logits": np.asarray(logits),
            "tokens": np.asarray(toks)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_encdec"))
    inputs = _inputs()
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = _repro(inputs)
        _, err = proc.communicate(timeout=270)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(os.path.join(workdir, "ranks.pkl"), "rb") as f:
        ranks = pickle.load(f)
    return {"ranks": ranks, "ref": ref}


def test_encdec_tp_losses_and_grads_match_repro(runs):
    ref = runs["ref"]
    for r in runs["ranks"]:
        assert r["computes_tensor_parallel"]
        got = r["train"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got["grads"][k] - want).max())
            assert err <= tol, (k, err, tol)


def test_encdec_tp_params_match_repro_and_agree(runs):
    ref = runs["ref"]["params"]
    first = runs["ranks"][0]["train"]["params"]
    for r in runs["ranks"]:
        got = r["train"]["params"]
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            assert np.array_equal(got[k], first[k]), k


def test_encdec_tp_encode_prefill_and_greedy_match_repro(runs):
    ref = runs["ref"]
    rows = PROMPT[0] // 2
    for r in runs["ranks"]:
        got = r["serve"]
        sl = slice(got["rows"] * rows, (got["rows"] + 1) * rows)
        for key in ("memory", "logits"):
            want = ref[key][sl]
            err = float(np.abs(got[key] - want).max())
            assert err <= LOGIT_TOL * float(np.abs(want).max()), (key, err)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"][sl])


def test_encdec_tp_rank_holds_its_blocks(runs):
    for r in runs["ranks"]:
        got = r["train"]
        assert got["cut"] and got["held"] == got["blocks"]
        # the encoder's, the self- and the cross-attention's leaves cut
        for part in ("enc/blocks/e0/attn/wq/w", "scan/u0/xattn/wk/w",
                     "scan/u0/attn/wo/w"):
            assert part in got["cut"], part
        assert r["serve"]["kv_heads"] == [2]
        assert got["whole_gathers"] == r["serve"]["whole_gathers"] == 0


@pytest.fixture(scope="module")
def dry():
    from repro_torch.launch import dryrun
    return dryrun.run_one(ARCH, "train_4k", "pod", device="cpu")


def test_encdec_dryrun_reads_tensor_parallel(dry):
    from repro_torch.launch import dryrun
    assert dry["status"] == "ok", dry.get("trace")
    assert dry["memory"]["figures"] == dry["hlo"]["figures"] == \
        dryrun.TENSOR_PARALLEL
    assert dry["memory"]["param_bytes"] == dry["memory"]["param_bytes_model"]


def test_encdec_dryrun_peak_and_flops_under_the_data_parallel_step(dry):
    assert dry["status"] == "ok", dry.get("trace")
    assert dry["memory"]["peak_bytes"] < H100_BYTES, dry["memory"]
    assert dry["hlo"]["flops"] < DP_TFLOP * 1e12 / 4, dry["hlo"]["flops"]
    # seamless's config cuts nothing over data: no FSDP gather, and the
    # row-parallel sums and gradient reductions are all-reduces
    assert set(dry["hlo"]["collectives"]) == {"all-reduce"}
    # the encoder counted at 1 and 2 of its 12 layers, extrapolated
    assert dry["hlo"]["traced"]["enc_layers"] == [1, 2]


if __name__ == "__main__":
    _main(sys.argv[1])
