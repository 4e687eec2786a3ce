"""The port's sharding rules, input and cache specs, and its sharded step,
against ``repro``.

  * every config of ``ARCHS`` on its full-width tree (``meta`` tensors on
    the port's side, ``jax.eval_shape`` on ``repro``'s): each leaf's spec
    equals ``repro``'s ``make_spec_fn`` on an ``AbstractMesh`` (no
    devices), on the ``pod``, ``multipod`` and ``pod32x8`` meshes, with
    and without ``naive_tp``; the GFM's trunk through the same rules;
  * ``input_specs`` and ``cache_specs`` shapes and dtypes equal ``repro``'s
    for every (arch x shape), and each cache leaf's data-axis split equals
    ``repro``'s on the production meshes;
  * ``spec_fn`` training: four gloo ranks on a (2, 2) mesh (one
    subprocess, this file as a script) train a smoke config with
    ``fsdp=True`` for 2 steps — granite's MoE (4 experts: expert-parallel
    over ``model``, its 2 heads one a rank; its step computes
    tensor-parallel, ``tests/test_torch_tp_moe.py``) and qwen (dense,
    heads split over ``model``; its step computes tensor-parallel,
    ``tests/test_torch_tp.py``) — against
    ``repro``'s one-device jitted step from the same params on the same
    batches: each step's loss within rtol 5e-5, atol 1e-6 (``repro``'s
    cross-plan tolerance), the first step's gradients, gathered, each leaf
    within 1e-5 x max(1, max|ref|), and the params after 2 steps within
    ``PARAM_ATOL`` (AdamW's update divides by the root of v, so a
    gradient that is rounding noise in both moves its param by up to lr a
    step in either package); every rank's params equal after gathering,
    and the bytes a rank holds (params, m, v) equal its blocks' and the
    sharded count of ``launch.memory.param_bytes_per_device``;
  * ``shared_spec_fn``: qwen's ``lm-mtl`` (two heads, ``"par"``: a head a
    ``model`` column) with its trunk cut by the same rules on the four
    ranks, 2 steps, against the port's one-process step (itself held to
    ``repro`` by ``tests/test_torch_lm_train.py``): total and per-task
    losses within the same tolerance, the rank's trunk bytes its blocks'.
    The plan computes the trunk tensor-parallel on the rank's blocks and
    each rank decodes its own task's head
    (``engine.step.multitask_tensor_parallel_grad_fn``; held to
    ``repro`` by ``tests/test_torch_tp_mtl.py``); a ``shard_map`` plan of
    the same model keeps the data-parallel step, its rank's batch the
    rows of its one task;
  * ``tensor_parallel_reason``: None for lm-mtl and seamless at ``model``
    2 and 16; the reason named for the recurrent blocks (xlstm, zamba2),
    the vision frontend (internvl2) and granite's ``naive_tp`` on the
    pod;
  * the scatter repair (``models.gnn``): on the CPU the ``"scatter"`` sum
    keeps the values of ``index_put_(accumulate=True)`` and the ordered
    gather's gradient equals ``torch.take_along_dim``'s.
"""
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
PARAM_ATOL = 2 * LR * STEPS      # see the docstring
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "pod32x8": ((32, 8), ("data", "model"))}
CASES = {"granite": dict(name="granite-moe-3b-a800m", batch=8, seq=256),
         "qwen": dict(name="qwen1.5-0.5b", batch=8, seq=16)}
LM_KW = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
             n_layers=2, fsdp=True, remat=False)
MOE_KW = dict(LM_KW, n_experts=4, top_k=2, d_ff_expert=32)


def _flat(tree, prefix=""):
    """``{path: leaf}`` of nested dicts / tuples (the port's trees)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, tuple, list)):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _jflat(tree):
    import jax

    from repro.configs.sharding import path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p): leaf for p, leaf in flat}


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _full_trees(arch, naive):
    """(repro cfg, port cfg, repro shapes, port meta tree) at full width."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as jc
    from repro_torch import configs as tc
    jcfg, tcfg = jc.get(arch), tc.get(arch)
    if naive:
        jcfg, tcfg = jcfg.replace(naive_tp=True), tcfg.replace(naive_tp=True)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    if jcfg.family == "gnn":
        from repro.core.mtl import make_gfm_mtl as j_mtl
        from repro_torch.core.mtl import make_gfm_mtl
        jp = jax.eval_shape(j_mtl(jcfg, jcfg.n_tasks).init, key)["shared"]
        tp = make_gfm_mtl(tcfg, tcfg.n_tasks).init(0, device="meta")["shared"]
    else:
        from repro.models.transformer import lm_init as j_init
        from repro_torch.models.transformer import lm_init
        jp = jax.eval_shape(lambda k: j_init(k, jcfg), key)
        tp = lm_init(np.random.default_rng(0), tcfg, "meta")
    assert all(t.device == torch.device("meta") for t in _flat(tp).values())
    return jcfg, tcfg, jp, tp


def _archs():
    from repro_torch.configs import ARCHS
    return list(ARCHS)


@pytest.mark.parametrize("naive", [False, True], ids=["aligned", "naive_tp"])
@pytest.mark.parametrize("arch", _archs())
def test_spec_fn_matches_repro_on_every_mesh(arch, naive):
    from jax.sharding import AbstractMesh

    from repro.configs.sharding import make_spec_fn as j_make
    from repro_torch.configs.sharding import make_spec_fn
    jcfg, tcfg, jp, tp = _full_trees(arch, naive)
    jf, tf = _jflat(jp), _flat(tp)
    assert set(jf) == set(tf)
    for mk, (shape, names) in MESHES.items():
        jfn = j_make(jcfg, AbstractMesh(shape, names))
        tfn = make_spec_fn(tcfg, dict(zip(names, shape)))
        for k in jf:
            assert tuple(jf[k].shape) == tuple(tf[k].shape), k
            want = tuple(jfn(k, jf[k]))
            want += (None,) * (len(jf[k].shape) - len(want))
            assert tfn(k, tf[k]) == want, (mk, k)
    # no mesh: the rules' default model axis of 16, nothing fitted
    jfn, tfn = j_make(jcfg), make_spec_fn(tcfg)
    for k in jf:
        want = tuple(jfn(k, jf[k]))
        assert tfn(k, tf[k]) == want + (None,) * (len(jf[k].shape) - len(want))


def test_check_divisibility_matches_repro():
    from jax.sharding import AbstractMesh

    from repro import configs as jc
    from repro.configs.sharding import check_divisibility as j_check
    from repro_torch import configs as tc
    from repro_torch.configs.sharding import check_divisibility
    for arch in tc.ARCHS:
        for shape, names in MESHES.values():
            assert check_divisibility(tc.get(arch), dict(zip(names, shape))) \
                == j_check(jc.get(arch), AbstractMesh(shape, names))


def _shapes():
    from repro_torch.configs import SHAPES
    return list(SHAPES)


@pytest.mark.parametrize("shape", _shapes())
def test_input_and_cache_specs_match_repro(shape):
    from jax.sharding import AbstractMesh

    from repro import configs as jc
    from repro.configs.specs import cache_specs as j_cache
    from repro.configs.specs import input_specs as j_in
    from repro_torch import configs as tc
    from repro_torch.configs.specs import (cache_leaf_spec, cache_specs,
                                           data_axes, input_specs)
    for arch in tc.ASSIGNED:
        jcfg, tcfg = jc.get(arch), tc.get(arch)
        for reduced in (False, True):
            a = j_in(jcfg, jc.SHAPES[shape], reduced=reduced)
            b = input_specs(tcfg, tc.SHAPES[shape], reduced=reduced)
            assert set(a) == set(b), arch
            for k in a:
                assert tuple(b[k].shape) == tuple(a[k].shape), (arch, k)
                assert _dtype(b[k].dtype) == str(a[k].dtype), (arch, k)
                assert b[k].device.type == "meta"
        if tc.SHAPES[shape].kind != "decode" or not tcfg.supports_decode:
            continue
        ja, jeff = j_cache(jcfg, jc.SHAPES[shape])
        tb, teff = cache_specs(tcfg, tc.SHAPES[shape])
        assert teff.block_pattern == jeff.block_pattern
        assert teff.window == jeff.window
        jf, tf = _jflat(ja), _flat(tb)
        assert set(jf) == set(tf), arch
        for k in jf:
            assert tuple(tf[k].shape) == tuple(jf[k].shape), (arch, k)
            assert _dtype(tf[k].dtype) == str(jf[k].dtype), (arch, k)
        B = tc.SHAPES[shape].global_batch
        for mk in ("pod", "multipod"):
            am = AbstractMesh(*MESHES[mk])
            mesh = dict(zip(MESHES[mk][1], MESHES[mk][0]))
            assert data_axes(mesh) == tuple(
                a for a in ("pod", "data") if a in am.shape)
            js = _jflat(j_cache(jcfg, jc.SHAPES[shape], am)[0])
            for k in jf:
                want = tuple(js[k].sharding.spec)
                want += (None,) * (tf[k].dim() - len(want))
                assert cache_leaf_spec(tf[k], mesh, B) == want, (arch, mk, k)


# ---------------------------------------------------------------------------
# spec_fn training across four gloo ranks (the ranks run in a subprocess:
# ``python test_torch_sharding.py DIR``)
# ---------------------------------------------------------------------------

def _cfg(pkg, case):
    kw = MOE_KW if case == "granite" else LM_KW
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs import get_smoke
        return get_smoke(CASES[case]["name"]).replace(
            compute_dtype=jnp.float32, **kw)
    import torch

    from repro_torch.configs import get_smoke
    return get_smoke(CASES[case]["name"]).replace(
        compute_dtype=torch.float32, **kw)


def _batches(case):
    cfg = _cfg("repro_torch", case)
    rng = np.random.default_rng(11)
    B, S = CASES[case]["batch"], CASES[case]["seq"]
    return [{k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _rank_case(case, inputs):
    import torch

    from repro_torch import interop
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    cfg = _cfg("repro_torch", case)
    mesh = make_host_mesh(2, 2)
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    full = interop.to_torch(inputs["params"][case])
    layout = plan.layout(full)
    state = TrainState.create(plan.shard_params(full), opt)
    held = nbytes(state.params) + nbytes(state.opt_state.m) + \
        nbytes(state.opt_state.v)
    model_bytes = 3 * nbytes(
        full, specs={p: s for p, (_, s) in layout.items()}, mesh=mesh)
    step = make_step(model, opt, plan)
    batches = inputs["batches"][case]
    # one batch's gradients, gathered (the step's own grad_fn)
    from repro_torch.engine.step import _grad_fn
    _, _, g = _grad_fn(model, plan, 1, None, layout)(
        state.params, plan.shard_batch(batches[0], device="cpu"))
    grads = {k: v.numpy() for k, v in
             interop.leaves(plan.gather(g, layout)).items()}
    losses = []
    for b in batches:
        state, out = step(state, plan.shard_batch(b, device="cpu"))
        losses.append(float(out.loss))
    params = {k: v.numpy() for k, v in
              interop.leaves(plan.gather(state.params, layout)).items()}
    return {"losses": losses, "grads": grads, "params": params,
            "held": held, "model_bytes": model_bytes,
            "cut": sorted(layout), "n_leaves": len(interop.leaves(full)),
            "shapes": {k: tuple(v.shape) for k, v in
                       interop.leaves(state.params).items()}}


def _mtl_run(inputs, mesh=None):
    """qwen's lm-mtl for ``STEPS`` steps, on a ``shared_spec_fn`` plan over
    ``mesh`` (``"par"``) or on one process (None): the losses, the
    per-task losses, the trunk bytes held and its blocks' count."""
    import torch

    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.core.taskpar import MTPConfig
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.optim import adamw
    cfg = _cfg("repro_torch", "qwen").replace(n_tasks=2)
    model = build_model("lm-mtl", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    full = model.init(0, device="cpu")
    plan = None if mesh is None else ShardingPlan(
        mesh=mesh, mtp=MTPConfig(n_tasks=2, mode="par"),
        shared_spec_fn=make_spec_fn(cfg, mesh))
    out = {}
    params = full
    if plan is not None:
        layout = plan.layout(full)
        params = plan.shard_params(full)
        out["held"] = nbytes(params["shared"])
        out["blocks"] = nbytes(
            full["shared"], specs={p[len("shared/"):]: s for p, (_, s) in
                                   layout.items()}, mesh=mesh)
        out["cut"] = len(layout)
        out["tensor_parallel"] = plan.computes_tensor_parallel
    state = TrainState.create(params, opt)
    step = make_step(model, opt, plan)
    losses, per_task = [], []
    for b in inputs["mtl_batches"]:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        if plan is not None:
            batch = plan.shard_batch(batch, device="cpu")
        state, o = step(state, batch)
        losses.append(float(o.loss))
        per_task.append(o.metrics["per_task_loss"].tolist())
    return dict(out, losses=losses, per_task=per_task)


def _shard_map_run(inputs, mesh):
    """qwen's lm-mtl on a ``shard_map`` plan (one head a ``model`` rank):
    whether its step is the tensor-parallel one, the shape of the rank's
    batch, and whether a ``shared_spec_fn`` is refused on it."""
    import torch

    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.core.taskpar import MTPConfig
    from repro_torch.engine import ShardingPlan, build_model
    from repro_torch.engine.step import _layout, _tensor_parallel
    cfg = _cfg("repro_torch", "qwen").replace(n_tasks=2)
    model = build_model("lm-mtl", cfg)
    mtp = MTPConfig(n_tasks=2, mode="par")
    plan = ShardingPlan(mesh=mesh, mtp=mtp, backend="shard_map")
    batch = {k: torch.from_numpy(v) for k, v in
             inputs["mtl_batches"][0].items()}
    try:
        ShardingPlan(mesh=mesh, mtp=mtp, backend="shard_map",
                     shared_spec_fn=make_spec_fn(cfg, mesh))
        refused = False
    except ValueError:
        refused = True
    return {"tensor_parallel": _tensor_parallel(model, plan,
                                                _layout(model, plan)),
            "computes_tensor_parallel": plan.computes_tensor_parallel,
            "rows": tuple(plan.slice_batch(batch)["tokens"].shape),
            "spec_fn_refused": refused}


def _rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {case: _rank_case(case, inputs) for case in CASES}
    out["lm_mtl"] = _mtl_run(inputs, make_host_mesh(2, 2))
    out["shard_map"] = _shard_map_run(inputs, make_host_mesh(2, 2))
    return out


def _main(workdir):
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_rank_main, 4, device="cpu", args=(workdir,),
                    timeout=240, rdzv_dir=workdir)
    with open(os.path.join(workdir, "ranks.pkl"), "wb") as f:
        pickle.dump(res, f)


def _repro_run(case, params, batches):
    import jax

    from repro.engine import TrainState, build_model, make_step
    from repro.optim import adamw
    cfg = _cfg("repro", case)
    model = build_model("lm", cfg)
    opt = adamw(LR, weight_decay=0.01, grad_clip=1.0)
    grad = jax.jit(jax.value_and_grad(model.loss_fn))
    _, g = grad(params, {k: jax.numpy.asarray(v)
                         for k, v in batches[0].items()})
    step = jax.jit(make_step(model, opt, None))
    state = TrainState.create(params, opt)
    losses = []
    for b in batches:
        state, out = step(state, {k: jax.numpy.asarray(v)
                                  for k, v in b.items()})
        losses.append(float(out.loss))
    from repro_torch import interop
    return {"losses": losses,
            "grads": interop.leaves(jax.tree_util.tree_map(np.asarray, g)),
            "params": interop.leaves(jax.tree_util.tree_map(
                np.asarray, state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.engine import build_model
    workdir = str(tmp_path_factory.mktemp("sharding"))
    params, batches = {}, {}
    for i, case in enumerate(CASES):
        model = build_model("lm", _cfg("repro", case))
        params[case] = jax.tree_util.tree_map(
            np.asarray, model.init(jax.random.PRNGKey(i)))
        batches[case] = _batches(case)
    rng = np.random.default_rng(12)
    mtl_batches = [{k: rng.integers(0, 512, (2, 4, 16)).astype(np.int32)
                    for k in ("tokens", "labels")} for _ in range(STEPS)]
    inputs = {"params": params, "batches": batches,
              "mtl_batches": mtl_batches}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        refs = {case: _repro_run(case, params[case], batches[case])
                for case in CASES}
        refs["lm_mtl"] = _mtl_run(inputs)
        _, err = proc.communicate(timeout=270)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(os.path.join(workdir, "ranks.pkl"), "rb") as f:
        ranks = pickle.load(f)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_losses_and_grads_match_repro(runs, case):
    ref = runs["refs"][case]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[case]["losses"], ref["losses"],
                                   rtol=RTOL, atol=ATOL)
        for k, want in ref["grads"].items():
            tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            err = float(np.abs(r[case]["grads"][k] - want).max())
            assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_params_match_repro_and_agree(runs, case):
    ref = runs["refs"][case]["params"]
    first = runs["ranks"][0][case]["params"]
    for r in runs["ranks"]:
        for k, want in ref.items():
            np.testing.assert_allclose(r[case]["params"][k], want, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
            assert np.array_equal(r[case]["params"][k], first[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_blocks(runs, case):
    ranks = runs["ranks"]
    for r in ranks:
        got = r[case]
        assert got["held"] == got["model_bytes"]
        assert got["cut"], "fsdp=True cuts leaves over the (2, 2) mesh"
    # blocks differ in shape from the whole leaf wherever a leaf is cut
    full = runs["refs"][case]["params"]
    for k in ranks[0][case]["cut"]:
        assert ranks[0][case]["shapes"][k] != tuple(full[k].shape), k


def test_shared_spec_fn_trunk_matches_one_process(runs):
    ref = runs["refs"]["lm_mtl"]
    for r in runs["ranks"]:
        got = r["lm_mtl"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["per_task"], ref["per_task"],
                                   rtol=RTOL, atol=ATOL)
        assert got["cut"] > 0 and got["held"] == got["blocks"]
        assert got["tensor_parallel"]


def test_shard_map_multitask_plan_keeps_the_data_parallel_step(runs):
    for r in runs["ranks"]:
        got = r["shard_map"]
        assert not got["tensor_parallel"]
        assert not got["computes_tensor_parallel"]
        # its one task's rows, B over the data ranks
        assert got["rows"] == (1, 2, 16)
        assert got["spec_fn_refused"]


def _reason_cfg(arch, tasks=1):
    from repro_torch import configs
    return configs.get(arch).replace(n_tasks=tasks)


@pytest.mark.parametrize("model_size", [2, 16])
@pytest.mark.parametrize("arch,tasks,reason", [
    ("qwen1.5-0.5b", 4, None),                   # lm-mtl on a pjit plan
    ("seamless-m4t-medium", 1, None),
    ("xlstm-125m", 1, "blocks ['mlstm', 'slstm']"),
    ("zamba2-1.2b", 1, "blocks ['mamba2', 'shared_attn']"),
    # naive_tp: at model 16 its 14 heads split fractionally first
    ("internvl2-1b", 1, {2: "vision_embed frontend",
                         16: "naive_tp's fractional heads (14 heads"}),
])
def test_tensor_parallel_reason(arch, tasks, reason, model_size):
    from repro_torch.configs.sharding import (tensor_parallel_family,
                                             tensor_parallel_reason)
    cfg = _reason_cfg(arch, tasks)
    why = tensor_parallel_reason(cfg, model_size)
    if isinstance(reason, dict):
        reason = reason[model_size]
    if reason is None:
        assert why is None and tensor_parallel_family(cfg, model_size)
    else:
        assert why is not None and why.startswith(reason), why
        assert not tensor_parallel_family(cfg, model_size)


def test_tensor_parallel_reason_names_naive_tp_on_the_pod():
    from repro_torch.configs.sharding import tensor_parallel_reason
    cfg = _reason_cfg("granite-moe-3b-a800m")
    assert cfg.naive_tp
    assert tensor_parallel_reason(cfg, 16) == \
        "naive_tp's fractional heads (24 heads over model 16)"


# ---------------------------------------------------------------------------
# the scatter repair (models.gnn)
# ---------------------------------------------------------------------------

def _edges(seed, B=3, E=40, A=9, F=5, dtype=None):
    import torch
    g = torch.Generator().manual_seed(seed)
    msg = torch.randn(B, E, F, generator=g).to(dtype or torch.float32)
    dst = torch.randint(0, A + 2, (B, E), generator=g).int()
    em = torch.rand(B, E, generator=g) < 0.8
    return msg, dst, em, A


@pytest.mark.parametrize("seed,E,dtype", [(0, 40, "float32"),
                                          (1, 400, "float32"),
                                          (2, 400, "bfloat16")])
def test_scatter_sum_keeps_its_cpu_values(seed, E, dtype):
    """Bitwise the serial scatter-add the CPU path was."""
    import torch

    from repro_torch.models.gnn import segment_sum_nodes
    msg, dst, em, A = _edges(seed, E=E, dtype=getattr(torch, dtype))
    keep = em & (dst >= 0) & (dst < A)
    want = torch.zeros(msg.shape[0], A, msg.shape[2], dtype=msg.dtype)
    b_idx = torch.arange(msg.shape[0])[:, None].expand_as(dst)
    want.index_put_((b_idx[keep], dst[keep].long()), msg[keep],
                    accumulate=True)
    got = segment_sum_nodes(msg, dst, A, edge_mask=em, impl="scatter")
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_gather_grad_equals_take_along_dim(seed):
    import torch

    from repro_torch.models.gnn import OrderedGather, _OrderedSegmentSum
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 9, 6, generator=g, requires_grad=True)
    idx = torch.randint(0, 9, (3, 40), generator=g)
    up = torch.randn(3, 40, 6, generator=g)
    want = torch.autograd.grad(
        (torch.take_along_dim(x, idx[..., None], dim=1) * up).sum(), x)[0]
    got_y = OrderedGather.apply(x, idx)
    got = torch.autograd.grad((got_y * up).sum(), x)[0]
    assert torch.equal(got_y, torch.take_along_dim(x, idx[..., None], dim=1))
    # f32 sums of <= 40 terms in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the ordered segment sum's backward is the masked gather
    msg, dst, em, A = _edges(seed)
    msg = msg.requires_grad_(True)
    gout = torch.randn(msg.shape[0], A, msg.shape[2], generator=g)
    keep = em & (dst < A)
    ref = torch.zeros_like(gout).index_put(
        (torch.arange(3)[:, None].expand_as(dst)[keep], dst[keep].long()),
        msg[keep], accumulate=True)
    want = torch.autograd.grad((ref * gout).sum(), msg)[0]
    out = _OrderedSegmentSum.apply(msg, dst, em, A, None, None)
    torch.testing.assert_close(out, ref.detach(), rtol=1e-5, atol=1e-6)
    assert torch.equal(torch.autograd.grad((out * gout).sum(), msg)[0], want)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ordered_gather_grad_is_the_one_hot_sum(seed):
    """``"jnp"``'s gathers (``plain``) sum their backward with the one-hot
    product: ``segment_sum_ref`` of the cotangent rows, bitwise."""
    import torch

    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    from repro_torch.models.gnn import OrderedGather
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 9, 6, generator=g, requires_grad=True)
    idx = torch.randint(0, 9, (3, 40), generator=g)
    up = torch.randn(3, 40, 6, generator=g)
    got = torch.autograd.grad((OrderedGather.apply(x, idx, True) * up).sum(),
                              x)[0]
    assert torch.equal(got, segment_sum_ref(up, idx, 9))
    want = torch.autograd.grad(
        (torch.take_along_dim(x, idx[..., None], dim=1) * up).sum(), x)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    _main(sys.argv[1])
