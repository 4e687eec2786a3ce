"""Training across ranks that ``repro`` trains on a mesh, in the port:
single-task data parallelism (``lm``, fine-tuning), ``lm-mtl`` over a
task's ranks on ``"pjit"`` and ``"hier"`` plans, the MoE balance term
across ranks, gradient accumulation on flat and hier plans, and the
resilient runner on a task-parallel plan.

Four gloo ranks on the CPU, spawned by ``launch.mesh.run_ranks``, run
every case in ONE subprocess (this file as a script) under a hard
timeout, while this process computes ``repro``'s one-device references.
Each port session starts from ``repro``'s initial parameters and draws
the same batches as ``repro``'s session from the same sources. Widths:
the GFM at hidden 24, 2 layers; the LMs at d=32, 2 layers; the MoE with 4
experts, top-2, each rank holding 512 tokens of a segment (one of
``repro``'s routing groups of ``min(512, tokens)``).

  * every case: each step's total (and per-task) loss within rtol 5e-5,
    atol 1e-6 of ``repro``'s one-device session (repro's cross-plan
    tolerance), and the full params bitwise equal on every rank after
    every step; and one batch's reduced gradients, gathered on every rank,
    each leaf within 1e-5 x max(1, max|ref|) of ``repro``'s one-device
    gradients (AdamW's normalised update would hide a gradient off by a
    constant factor from the losses);
  * accumulation: accum 2 on a flat plan (``lm``, the GFM on a (2, 2)
    mesh) and on a hier plan (the GFM), against ``repro``'s one-device
    accum 2 — each microbatch is global rows first, the rank's rows of it
    second, so masked-atom normalisation per microbatch is ``repro``'s;
  * the soak: the GFM on the 4-rank ``"base"`` plan under the five fault
    classes (NaN gradients, a corrupt batch, a producer kill, checkpoint
    write failures, a preemption, then ``resume()``) ends with params,
    moments, step and guard bitwise equal to a clean 4-rank run; its
    events are ``repro``'s one-device soak's (the producer kill's
    recovery tick follows the producer thread, as ROADMAP.md's queue 3
    records), and every rank ends at the same step with the same report
    and checkpoint listing; a write that fails past its retries raises
    on every rank;
  * refusals: a single-task model without ``batch_counts`` on a
    distributed plan, a rank whose tokens do not tile the routing group,
    a flat batch that does not split over the data ranks, the guard on a
    hier plan (as ``repro``).
"""
import hashlib
import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

RTOL, ATOL = 5e-5, 1e-6          # repro's cross-plan parity tolerance
GRAD_TOL = 1e-5                  # x max(1, max|ref|) per gradient leaf
WORLD = 4
STEPS = 3
SOAK_STEPS = 14
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples", "finetune_downstream_torch.py")
GFM_SRC = ["ani1x", "qm7x"]
SOAK_SRC = ["ani1x", "qm7x", "mptrj"]
LM_KW = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
             n_layers=2)
MOE_KW = dict(LM_KW, n_experts=4, top_k=2, d_ff_expert=32)
# name: the session both packages run; "mesh" (data, model) or
# "placement" makes the port's plan, the reference runs on one device
CASES = {
    "lm": dict(model="lm", arch="qwen", batch=8, seq=16, mesh=(4, 1)),
    "lm-accum2": dict(model="lm", arch="qwen", batch=8, seq=16,
                      mesh=(4, 1), accum=2),
    # remat: the recomputed blocks all-reduce their expert counts again
    "lm-moe": dict(model="lm", arch="granite", batch=8, seq=256,
                   mesh=(2, 2), remat=True),
    "lm-mtl-pjit": dict(model="lm-mtl", arch="qwen", batch=4, seq=16,
                        mesh=(2, 2), mode="par"),
    "lm-mtl-hier": dict(model="lm-mtl", arch="qwen", batch=4, seq=16,
                        placement=WORLD),
    "lm-mtl-moe": dict(model="lm-mtl", arch="granite", batch=8, seq=256,
                       mesh=(4, 1), mode="base"),
    "finetune": dict(model="gfm-finetune", arch="gfm", batch=8,
                     mesh=(4, 1)),
    "gfm-pjit-accum2": dict(model="gfm-mtl", arch="gfm", batch=8,
                            mesh=(2, 2), mode="par", accum=2),
    "gfm-hier-accum2": dict(model="gfm-mtl", arch="gfm", batch=8,
                            placement=WORLD, accum=2),
}
# cases whose one-device reference is another case's
SAME_REF = {"lm-mtl-hier": "lm-mtl-pjit"}
MULTITASK = [c for c, s in CASES.items() if s["model"] in ("lm-mtl",
                                                           "gfm-mtl")]
SOAK = [(5, "nan_grad", {}), (9, "corrupt_batch", {"magnitude": 1e6}),
        (12, "kill_producer", {}), (15, "ckpt_write_fail", {}),
        (18, "preempt", {})]


# ---------------------------------------------------------------------------
# configurations and data (numpy; both packages)
# ---------------------------------------------------------------------------

def _lm_arch(pkg, spec):
    """The LM config of ``spec`` in package ``pkg`` (``repro`` or
    ``repro_torch``), f32 compute."""
    name = "granite-moe-3b-a800m" if spec["arch"] == "granite" \
        else "qwen1.5-0.5b"
    kw = dict(MOE_KW if spec["arch"] == "granite" else LM_KW,
              remat=spec.get("remat", False))
    if spec["model"] == "lm-mtl":
        kw["n_tasks"] = 2
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs import get_smoke
        return get_smoke(name).replace(compute_dtype=jnp.float32, **kw)
    import torch

    from repro_torch.configs import get_smoke
    return get_smoke(name).replace(compute_dtype=torch.float32, **kw)


def _gfm_arch(pkg):
    kw = dict(name="g", family="gnn", gnn_hidden=24, gnn_layers=2,
              n_species=64, head_hidden=12, head_layers=2)
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.configs.base import ArchConfig
        return ArchConfig(remat=False, compute_dtype=jnp.float32, **kw)
    import torch

    from repro_torch.configs.base import ArchConfig
    return ArchConfig(compute_dtype=torch.float32, **kw)


def _sources(case):
    """The numpy sources of ``case`` (one dict for a single-task model, a
    list of per-task dicts otherwise)."""
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.data.synthetic_atoms import (generate_all,
                                                  generate_source,
                                                  source_dicts)
    spec = CASES[case] if case in CASES else None
    if case.startswith("soak"):
        return source_dicts(generate_all(16, max_atoms=8, max_edges=24,
                                         sources=SOAK_SRC))
    if spec["arch"] == "gfm":
        if spec["model"] == "gfm-finetune":
            sd = generate_source("transition1x", 24, max_atoms=10,
                                 max_edges=40, seed=99)
            return source_dicts({"transition1x": sd})[0]
        return source_dicts(generate_all(16, max_atoms=10, max_edges=40,
                                         sources=GFM_SRC))
    n = 2 if spec["model"] == "lm-mtl" else 1
    vocab = _lm_arch("repro_torch", spec).vocab
    src = make_lm_sources(n, 32, spec["seq"], vocab)
    return src if spec["model"] == "lm-mtl" else src[0]


def _common(spec, steps=STEPS):
    return dict(steps=steps, batch_per_task=spec["batch"], lr=2e-3,
                log_every=1, eval_every=10 ** 9, verbose=False,
                seed=0, accum=spec.get("accum", 1))


def _example():
    spec = importlib.util.spec_from_file_location("finetune_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the ranks (run in the subprocess: ``python test_torch_dist_train.py DIR``)
# ---------------------------------------------------------------------------

def _digest(trees) -> str:
    from repro_torch import interop
    h = hashlib.sha256()
    for tree in trees:
        for k, v in sorted(interop.leaves(tree).items()):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _full_state(sess, state):
    """Params and both moments, gathered to full trees (a collective)."""
    plan = sess.plan
    if not plan.task_parallel:
        return [state.params, state.opt_state.m, state.opt_state.v]
    opt = state.opt_state
    heads = plan.gather_heads([state.params["heads"], opt.m["heads"],
                               opt.v["heads"]])
    return [dict(t, heads=h) for t, h in
            zip((state.params, opt.m, opt.v), heads)]


def _trace(sess, sink):
    """Record the full params' digest after every step of ``sess``."""
    inner = sess.step_fn

    def traced(state, batch):
        state, out = inner(state, batch)
        sink.append(_digest(_full_state(sess, state)[:1]))
        return state, out
    sess.step_fn = traced


def _port_session(case, inputs, **over):
    """The port's Session of ``case`` on this rank, from repro's initial
    params."""
    from repro_torch import interop
    from repro_torch.engine import Session, SessionConfig, TrainState
    from repro_torch.launch.mesh import make_host_mesh
    spec = CASES[case]
    kw = dict(_common(spec), **over)
    if "mode" in spec:
        kw["mode"] = spec["mode"]
    if "placement" in spec:
        kw["placement"] = spec["placement"]
    mesh = make_host_mesh(*spec["mesh"]) if "mesh" in spec else None
    model = None
    if spec["arch"] == "gfm":
        arch = _gfm_arch("repro_torch")
        if spec["model"] == "gfm-finetune":
            model = _example().finetune_model(
                arch, interop.to_torch(inputs["params"][case]["shared"]))
    else:
        arch = _lm_arch("repro_torch", spec)
    sess = Session(SessionConfig(model=spec["model"], arch=arch, **kw),
                   sources=inputs["sources"][case], mesh=mesh, model=model,
                   device="cpu")
    full = TrainState.create(interop.to_torch(inputs["params"][case]),
                             sess.optimizer, rng=sess.state.rng,
                             guard=sess.state.guard)
    sess.state = sess.plan.shard_state(full)
    return sess


def _rows(result, n_tasks):
    return [[r[f"task{t}"] for t in range(n_tasks)]
            for r in result.logger.history]


def _run_case(case, inputs):
    sess = _port_session(case, inputs)
    hashes = []
    _trace(sess, hashes)
    res = sess.run()
    sess.close()
    n = len(sess.task_names)
    return {"losses": [r["loss"] for r in res.logger.history],
            "per_task": _rows(res, n) if CASES[case]["model"] in (
                "lm-mtl", "gfm-mtl") else None,
            "params": hashes, "heads": list(sess.plan.shard.heads)}


def _soak_session(inputs, ckpt_dir, faults=None):
    from repro_torch import resilience as tres
    from repro_torch.engine import Session, SessionConfig
    from repro_torch.launch.mesh import make_host_mesh
    res = tres.ResilienceConfig(
        ckpt_dir=ckpt_dir, guard=tres.GuardConfig(
            warmup_steps=3, spike_factor=50.0, max_consecutive_trips=1),
        policy=tres.CheckpointPolicy(every_steps=5, keep_last=2),
        faults=None if faults is None else tres.FaultSchedule(
            [tres.Fault(tick=t, kind=k, **kw) for t, k, kw in faults]),
        retry_base_delay=0.0)
    sess = Session(SessionConfig(
        model="gfm-mtl", arch=_gfm_arch("repro_torch"), steps=SOAK_STEPS,
        batch_per_task=8, eval_every=100, log_every=100, verbose=False,
        mode="base", resilience=res), sources=inputs["sources"]["soak"],
        mesh=make_host_mesh(WORLD, 1), device="cpu")
    from repro_torch import interop
    p0 = interop.to_torch(inputs["params"]["soak"])
    sess.state = sess.plan.shard_state(sess.state._replace(
        params=p0, opt_state=sess.optimizer.init(p0)))
    return sess


def _soak(inputs, workdir):
    """The faulted run, its resume, and a clean run, on every rank."""
    out = {}
    fdir, cdir = (os.path.join(workdir, d) for d in ("soak-f", "soak-c"))
    for name, ckpt, faults, resume in (
            ("faulted", fdir, SOAK, False), ("resumed", fdir, None, True),
            ("clean", cdir, None, False)):
        sess = _soak_session(inputs, ckpt, faults)
        hashes = []
        _trace(sess, hashes)
        with sess:
            if resume:
                sess.resume()
            res = sess.run()
        st = res.state
        out[name] = {
            "report": res.resilience, "preempted": res.preempted,
            "step": int(st.step), "opt_step": int(st.opt_state.step),
            "guard": None if st.guard is None else
            [float(st.guard.ema), int(st.guard.good), int(st.guard.trips)],
            "state": _digest(_full_state(sess, st)), "params": hashes,
            "listing": sorted(os.listdir(ckpt))}
    return out


def _first_batch(case, sources):
    """The global batch a session of ``case`` draws first (numpy)."""
    from repro_torch.data.loader import GroupBatcher, SingleBatcher
    B = CASES[case]["batch"]
    if isinstance(sources, list):
        return GroupBatcher(sources, B, seed=0).next_batch()
    return SingleBatcher(sources, B, seed=0).next_batch()


def _rank_grads(case, inputs):
    """One batch's reduced gradients on this rank's plan (the group's grad
    of a hier plan, as ``HierCompiledStep`` builds it; accumulated over
    the case's microbatches), gathered to the full tree."""
    from repro_torch import interop
    from repro_torch.core.taskpar import (MultiTaskModel,
                                          mtp_value_and_grad_dist)
    from repro_torch.engine import (make_grad_fn, normalized_task_weights,
                                    with_grad_accum)
    sess = _port_session(case, inputs)
    sess.close()
    plan, model = sess.plan, sess.model
    if plan.resolved_backend == "hier":
        fn = mtp_value_and_grad_dist(
            model, plan.shard, normalized_task_weights(plan.n_tasks),
            head_group=plan.head_group)
    else:
        fn = make_grad_fn(model, plan)
    accum = CASES[case].get("accum", 1)
    fn = with_grad_accum(fn, accum, 1 if isinstance(model, MultiTaskModel)
                         else 0)
    batch = plan.shard_batch(_first_batch(case, inputs["sources"][case]),
                             "cpu", accum)
    loss, _, grads = fn(sess.state.params, batch)
    return {"loss": float(loss),
            "grads": interop.leaves(interop.to_numpy(
                plan.gather_params(grads)))}


def _unwritable(inputs, workdir):
    """A checkpoint write that fails past its retries: every rank raises
    (rank 0 the retry's error, the others ``CheckpointWriteError``) and
    none waits for another."""
    sess = _soak_session(inputs, os.path.join(workdir, "soak-x"),
                         [(1, "ckpt_write_fail", {"repeats": 10})])
    try:
        with sess:
            sess.run()
    except Exception as e:                        # noqa: BLE001
        return type(e).__name__
    return None


def _rank_main(rank, world, workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {case: _run_case(case, inputs) for case in CASES}
    out["grads"] = {case: _rank_grads(case, inputs) for case in CASES}
    out["unwritable"] = _unwritable(inputs, workdir)
    out["soak"] = _soak(inputs, workdir)
    return out


def _main(workdir):
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_rank_main, WORLD, device="cpu", args=(workdir,),
                    timeout=400, rdzv_dir=workdir)
    with open(os.path.join(workdir, "ranks.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the references: repro's one-device sessions, in this process
# ---------------------------------------------------------------------------

def _j_finetune_model(cfg, shared):
    """``examples/finetune_downstream.py``'s model (a fresh branch from
    key 1 on ``shared``)."""
    import jax

    from repro.core.mtl import gfm_loss_terms
    from repro.engine import SingleTaskModel
    from repro.models import gnn, heads

    def init(key):
        return {"branch": heads.branch_init(jax.random.PRNGKey(1), cfg),
                "shared": shared}

    def loss_fn(fp, batch):
        feats = gnn.egnn_apply(fp["shared"], batch, cfg=cfg)
        e, f = heads.branch_apply(fp["branch"], feats, batch["node_mask"],
                                  cfg=cfg)
        return gfm_loss_terms(e, f, batch)[0]

    return SingleTaskModel(init=init, loss_fn=loss_fn, name="gfm-finetune")


def _repro_session(case, sources, steps=STEPS, **over):
    import jax

    from repro.engine import Session, SessionConfig
    from repro.models import gnn
    spec = CASES[case]
    model = None
    if spec["arch"] == "gfm":
        arch = _gfm_arch("repro")
        if spec["model"] == "gfm-finetune":
            model = _j_finetune_model(arch, gnn.egnn_init(
                jax.random.PRNGKey(7), arch))
    else:
        arch = _lm_arch("repro", spec)
    return Session(SessionConfig(model=spec["model"], arch=arch,
                                 **dict(_common(spec, steps), **over)),
                   sources=sources, model=model)


def _repro_soak(sources, ckpt_dir):
    from repro import resilience as jres
    from repro.engine import Session, SessionConfig
    res = jres.ResilienceConfig(
        ckpt_dir=ckpt_dir, guard=jres.GuardConfig(
            warmup_steps=3, spike_factor=50.0, max_consecutive_trips=1),
        policy=jres.CheckpointPolicy(every_steps=5, keep_last=2),
        faults=jres.FaultSchedule(
            [jres.Fault(tick=t, kind=k, **kw) for t, k, kw in SOAK]),
        retry_base_delay=0.0)
    return Session(SessionConfig(
        model="gfm-mtl", arch=_gfm_arch("repro"), steps=SOAK_STEPS,
        batch_per_task=8, eval_every=100, log_every=100, verbose=False,
        resilience=res), sources=sources)


def _repro_grads(sess, case, sources, params):
    """``repro``'s one-device gradients of the case's first batch,
    accumulated as its step accumulates them."""
    import jax
    import jax.numpy as jnp

    from repro.core import MultiTaskModel
    from repro.engine import (multitask_grad_fn, single_grad_fn,
                              with_grad_accum)

    from repro_torch import interop
    model = sess.model
    if isinstance(model, MultiTaskModel):
        fn, axis = multitask_grad_fn(model, len(sources)), 1
    else:
        fn, axis = single_grad_fn(model), 0
    fn = with_grad_accum(fn, CASES[case].get("accum", 1), axis)
    batch = {k: jnp.asarray(v) for k, v in
             _first_batch(case, sources).items()}
    loss, _, grads = jax.jit(fn)(params, batch)
    return {"loss": float(loss), "grads": interop.leaves(
        jax.tree_util.tree_map(np.asarray, grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    workdir = str(tmp_path_factory.mktemp("dist_train"))
    sources, params, sessions = {}, {}, {}
    for case in CASES:
        sources[case] = _sources(case)
        if case not in SAME_REF:
            sessions[case] = _repro_session(case, sources[case])
        params[case] = jax.tree_util.tree_map(
            np.asarray, sessions[SAME_REF.get(case, case)].state.params)
    sources["soak"] = _sources("soak")
    soak = _repro_soak(sources["soak"], os.path.join(workdir, "soak-j"))
    params["soak"] = jax.tree_util.tree_map(np.asarray, soak.state.params)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"sources": sources, "params": params}, f)
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        refs = {}
        for case, sess in sessions.items():
            with sess:
                res = sess.run()
            refs[case] = {"losses": [r["loss"] for r in res.logger.history],
                          "per_task": _rows(res, len(sess.task_names))
                          if case in MULTITASK else None}
        refs.update({c: refs[r] for c, r in SAME_REF.items()})
        for case in CASES:
            refs[case] = dict(refs[case], **_repro_grads(
                sessions[SAME_REF.get(case, case)], case, sources[case],
                params[case]))
        with soak:
            refs["soak"] = soak.run().resilience
        _, err = proc.communicate(timeout=420)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(os.path.join(workdir, "ranks.pkl"), "rb") as f:
        ranks = pickle.load(f)
    return {"ranks": ranks, "refs": refs}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_repro(runs, case):
    want = runs["refs"][case]["losses"]
    assert len(want) == STEPS
    for r in runs["ranks"]:
        _close(r[case]["losses"], want)


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_repro(runs, case):
    want = runs["refs"][case]
    for r in runs["ranks"]:
        got = r["grads"][case]
        _close([got["loss"]], [want["loss"]])
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            err = float(np.abs(got["grads"][k] - w).max())
            assert err <= GRAD_TOL * max(1.0, float(np.abs(w).max())), \
                (k, err)


@pytest.mark.parametrize("case", MULTITASK)
def test_per_task_losses_match_repro(runs, case):
    want = runs["refs"][case]["per_task"]
    for r in runs["ranks"]:
        _close(r[case]["per_task"], want)


@pytest.mark.parametrize("case", list(CASES))
def test_params_bitwise_equal_across_ranks(runs, case):
    hashes = [r[case]["params"] for r in runs["ranks"]]
    assert len(hashes[0]) == STEPS and len(set(hashes[0])) == STEPS
    assert all(h == hashes[0] for h in hashes)


@pytest.mark.parametrize("case", ["lm-mtl-pjit", "lm-mtl-hier",
                                  "gfm-pjit-accum2", "gfm-hier-accum2"])
def test_each_rank_holds_its_task_rows(runs, case):
    """Each task's rows split over its ranks: every task is held by two
    of the four ranks."""
    held = [r[case]["heads"] for r in runs["ranks"]]
    assert sorted(t for h in held for t in h) == [0, 0, 1, 1]


def test_lm_accum2_first_loss_is_the_batch_mean(runs):
    """An LM's microbatches hold equal token counts, so accum 2's first
    loss (the mean of the two microbatch means) is accum 1's within
    rounding, on every rank as in ``repro``."""
    for r in runs["ranks"]:
        assert r["lm-accum2"]["losses"][0] == pytest.approx(
            r["lm"]["losses"][0], rel=1e-6)


def _events(report, skip_kill=True):
    return [(e["kind"], e["tick"]) for e in report["events"]
            if not (skip_kill and e["kind"] == "pipeline_recovery")]


def test_soak_ends_bitwise_equal_to_the_clean_run(runs):
    for r in runs["ranks"]:
        s = r["soak"]
        assert s["faulted"]["preempted"] and not s["resumed"]["preempted"]
        rep = s["faulted"]["report"]
        assert rep["faults_fired"] == 5 and rep["faults_pending"] == 0
        assert rep["rollbacks"] >= 2 and rep["pipeline_recoveries"] == 1
        assert rep["io_retries"] >= 1
        assert s["clean"]["report"]["trips"] == 0
        a, b = s["resumed"], s["clean"]
        assert a["step"] == b["step"] == SOAK_STEPS
        assert a["opt_step"] == b["opt_step"] == SOAK_STEPS
        assert a["state"] == b["state"] and a["guard"] == b["guard"]


def test_soak_events_match_repro(runs):
    ref = runs["refs"]["soak"]
    for r in runs["ranks"]:
        rep = r["soak"]["faulted"]["report"]
        assert _events(rep) == _events(ref)
        kinds = [e["kind"] for e in rep["events"]]
        assert kinds.count("pipeline_recovery") == 1
        for key in ("steps", "preempted", "checkpoints_saved", "io_retries",
                    "pipeline_recoveries", "faults_fired", "trips",
                    "rollbacks", "source_trips", "quarantined"):
            assert rep[key] == ref[key], key
        rb = [e["to_step"] for e in rep["events"] if e["kind"] == "rollback"]
        assert rb == [e["to_step"] for e in ref["events"]
                      if e["kind"] == "rollback"]


@pytest.mark.parametrize("run", ["faulted", "resumed", "clean"])
def test_soak_ranks_agree(runs, run):
    """Every rank ends at the same step with the same events (the
    recovery's tick included), checkpoint listing and params after every
    step."""
    first = runs["ranks"][0]["soak"][run]
    for r in runs["ranks"][1:]:
        s = r["soak"][run]
        assert s["step"] == first["step"] and s["state"] == first["state"]
        assert _events(s["report"], False) == _events(first["report"], False)
        assert s["listing"] == first["listing"]
        assert s["params"] == first["params"]
    assert first["listing"]


def test_unrecoverable_write_raises_on_every_rank(runs):
    assert [r["unwritable"] for r in runs["ranks"]] == \
        ["RetryError"] + ["CheckpointWriteError"] * (WORLD - 1)


# ---------------------------------------------------------------------------
# in-process checks: the refusals and the rows a rank takes
# ---------------------------------------------------------------------------

def test_single_task_model_without_counts_refuses_a_distributed_plan():
    from repro_torch.engine import ShardingPlan, make_grad_fn
    ft = _example().finetune_model(_gfm_arch("repro_torch"), None)
    assert ft.batch_counts is not None
    with pytest.raises(ValueError, match="batch_counts"):
        make_grad_fn(ft._replace(batch_counts=None),
                     ShardingPlan(mesh=object(), backend="pjit"))


def test_tokens_that_do_not_tile_the_routing_group_raise():
    """A rank's 256 tokens of a segment routed over 2 ranks: ``repro``
    routes the segment's 512 in one group of 512, which no rank holds."""
    import torch

    from repro_torch.models.moe import Balance, moe_apply, moe_init
    cfg = _lm_arch("repro_torch", CASES["lm-moe"])
    p = moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 128, cfg.d_model)
    with pytest.raises(ValueError, match="routing groups"):
        moe_apply(p, x, cfg=cfg, balance=Balance(None, 2))
    y, aux = moe_apply(p, x, cfg=cfg, balance=Balance(None, 1))
    y0, aux0 = moe_apply(p, x, cfg=cfg)
    assert torch.equal(y, y0)
    torch.testing.assert_close(aux, aux0, rtol=1e-6, atol=0)


def test_flat_batch_that_does_not_split_raises():
    from repro_torch.core.taskpar import TaskShard, take_flat_batch
    shard = TaskShard(heads=(), ranks=(0, 1, 2, 3), index=1)
    with pytest.raises(ValueError, match="does not split evenly"):
        take_flat_batch({"tokens": np.zeros((6, 4))}, shard)


def test_guard_on_a_hier_plan_raises():
    from repro_torch.core import round_robin_placement
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.engine import ShardingPlan, make_guarded_step
    from repro_torch.optim import adamw
    from repro_torch.resilience import GuardConfig
    plan = ShardingPlan(placement=round_robin_placement(2, 4))
    with pytest.raises(NotImplementedError, match="hierarchical"):
        make_guarded_step(make_gfm_mtl(_gfm_arch("repro_torch"), 2),
                          adamw(1e-3), plan, guard=GuardConfig())


@pytest.mark.parametrize("B,accum,size,index,want", [
    (8, 1, 4, 1, [2, 3]),
    (8, 2, 4, 1, [1, 5]),
    (8, 2, 2, 0, [0, 1, 4, 5]),
    (12, 3, 2, 1, [2, 3, 6, 7, 10, 11]),
    (6, 2, 2, 1, [0, 1, 2, 3, 4, 5]),   # 3 rows a microbatch: replicated
])
def test_micro_rows_take_each_microbatch_then_the_ranks_rows(
        B, accum, size, index, want):
    from repro_torch.core.taskpar import TaskShard, micro_rows
    shard = TaskShard(heads=(), ranks=tuple(range(size)), index=index)
    got = np.arange(B)[micro_rows(shard, B, accum)]
    assert got.tolist() == want


if __name__ == "__main__":
    _main(sys.argv[1])
