"""Multi-task parallelism in the port (``repro_torch.core.taskpar``,
``engine.plan`` / ``engine.hier``, ``launch.mesh``) against ``repro``.

Eight gloo ranks on the CPU, spawned by ``launch.mesh.run_ranks`` with a
file rendezvous, run in ONE subprocess (this file as a script) under a hard
timeout; every case enters through the port's ``Session``. Each session
starts from ``repro``'s initial parameters (its ``PRNGKey(0)`` draw) and
draws the same batches as ``repro``'s session from the same sources.
Width as tests/test_parallel_parity.py: ``gnn_hidden=24``,
``gnn_layers=2``.

  * "even4-par" (a (2, 4) mesh, heads sliced over ``model``),
    "even4-base" (the same mesh, heads whole), "even4-hier" and
    "ragged5-hier" (``placement=8``: 5 heads on groups of (2, 1, 3, 1, 1)):
    3 steps' per-task and total losses within rtol 5e-5, atol 1e-6 of
    ``repro``'s single-device session (repro's cross-plan tolerance);
  * "shard_map" (the (2, 4) mesh, per-shard semantics): 3 steps' losses
    at that tolerance, and one batch's grads within 1e-5 x max(1, max|ref|)
    per leaf, of ``repro``'s shard_map on 8 host devices (a JAX
    subprocess, as tests/test_taskpar.py runs it);
  * every case: trunk params bitwise equal across ranks after every step,
    and each rank holding only its heads' rows (and their moments);
  * ``set_placement`` mid-run: within the tolerance of the run that keeps
    its placement; the checkpoint the 8 ranks write restores in ``repro``
    and in a one-device port session, bit for bit;
  * an eval_fn with early stopping on the hierarchical plan: it sees the
    full params (gathered), and every rank logs its rows and stops at the
    same step;
  * placement with a guard raises; the plan's own checks; NCCL with two
    ranks on one card raises; a failing rank fails the job; the launcher
    and a one-device plan's ``shard_batch`` run on the CPU only when it
    is asked for.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

RTOL, ATOL = 5e-5, 1e-6          # repro's cross-plan parity tolerance
GRAD_TOL = 1e-5                  # x max(1, max|ref|) per leaf
WORLD = 8
STEPS = 3
SRC4 = ["ani1x", "qm7x", "mptrj", "alexandria"]
SRC5 = ["ani1x", "qm7x", "transition1x", "mptrj", "alexandria"]
CASES = {  # name: (sources, port session kwargs, mesh shape or None,
    #                 kwargs of both packages' sessions)
    "even4-par": (SRC4, {"mode": "par"}, (2, 4), {}),
    "even4-base": (SRC4, {"mode": "base"}, (2, 4), {}),
    "even4-hier": (SRC4, {"placement": WORLD}, None, {}),
    "ragged5-hier": (SRC5, {"placement": WORLD}, None, {}),
    # clipping by the global norm over every rank's grads
    "clip5-hier": (SRC5, {"placement": WORLD}, None, {"grad_clip": 0.05}),
    # Kendall weighting: its log-variance terms split by the ranks' shares
    "unc4-par": (SRC4, {"mode": "par"}, (2, 4), {"uncertainty": True}),
    "shard_map": (SRC4, {"backend": "shard_map"}, (2, 4), {}),
}
GLOBAL = ["even4-par", "even4-base", "even4-hier", "ragged5-hier",
          "clip5-hier", "unc4-par"]
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _weights(names, case):
    from repro_torch.data.synthetic_atoms import PAPER_REL_SIZES
    return None if case == "shard_map" else \
        tuple(PAPER_REL_SIZES[s] for s in names)


def _arch():
    import torch

    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="g", family="gnn", gnn_hidden=24, gnn_layers=2,
                      n_species=64, head_hidden=12, head_layers=2,
                      compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the ranks (run in the subprocess: ``python test_torch_taskpar.py DIR``)
# ---------------------------------------------------------------------------

def _session(case, inputs, steps=STEPS, ckpt=None, **over):
    """A port Session of ``case`` on this rank, started from repro's
    initial params."""
    from repro_torch import interop
    from repro_torch.engine import Session, SessionConfig, TrainState
    from repro_torch.launch.mesh import make_host_mesh
    names, kw, shape, both = CASES[case]
    unc = both.get("uncertainty", False)
    kw = dict({"eval_every": 10 ** 9, **kw},
              **{k: v for k, v in both.items() if k != "uncertainty"},
              **over)
    cfg = SessionConfig(model="gfm-mtl", arch=_arch(), steps=steps,
                        batch_per_task=8, lr=1e-3, log_every=1,
                        seed=0, verbose=False,
                        task_weights=_weights(names, case), ckpt_path=ckpt,
                        **kw)
    mesh = make_host_mesh(*shape) if shape else None
    sess = Session(cfg, sources=inputs["sources"][len(names)], mesh=mesh,
                   device="cpu", model_kwargs={"uncertainty": unc})
    full = TrainState.create(
        interop.to_torch(inputs["params"][len(names), unc]),
        sess.optimizer, rng=sess.state.rng)
    sess.state = sess.plan.shard_state(full)
    return sess


def _trace(sess, sink):
    """Record the trunk's bytes' hash after every step of ``sess``."""
    import hashlib

    from repro_torch import interop
    inner = sess.step_fn

    def traced(state, batch):
        state, out = inner(state, batch)
        h = hashlib.sha256()
        for v in interop.leaves(state.params["shared"]).values():
            h.update(v.detach().numpy().tobytes())
        sink.append(h.hexdigest())
        return state, out
    sess.step_fn = traced


def _rows(result, T):
    return [[r[f"task{t}"] for t in range(T)] for r in result.logger.history]


def _held(state):
    """Leading dims of the rank's head leaves (params and both moments)."""
    from repro_torch import interop
    return sorted({int(v.shape[0]) for tree in
                   (state.params, state.opt_state.m, state.opt_state.v)
                   for v in interop.leaves(tree["heads"]).values()})


def _run_case(case, inputs):
    from repro_torch import interop
    names = CASES[case][0]
    sess = _session(case, inputs)
    hashes = []
    _trace(sess, hashes)
    res = sess.run()
    sess.close()
    return {"per_task": _rows(res, len(names)),
            "losses": [r["loss"] for r in res.logger.history],
            "trunk": hashes, "heads": list(sess.plan.shard.heads),
            "held": _held(res.state),
            "groups": [list(g) for g in sess.plan.placement.groups]
            if sess.plan.placement is not None else None,
            "device_counts": list(sess.plan.placement.device_counts)
            if sess.plan.placement is not None else None,
            "full": interop.to_numpy(sess.plan.gather_params(res.params))}


def _shard_map_grads(inputs):
    """One batch's reduced grads through ``make_grad_fn`` on the
    shard_map plan, gathered to the full tree."""
    from repro_torch import interop
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.engine import make_grad_fn
    sess = _session("shard_map", inputs)
    batch = GroupBatcher(inputs["sources"][4], 8, seed=0).next_batch()
    loss, metrics, grads = make_grad_fn(sess.model, sess.plan)(
        sess.state.params, sess.plan.shard_batch(batch))
    heads = sess.plan.gather_heads([grads["heads"]])[0]
    return {"loss": float(loss),
            "per_task": metrics["per_task_loss"].tolist(),
            "grads": interop.to_numpy({"shared": grads["shared"],
                                       "heads": heads})}


def _guarded_step(inputs):
    """One guarded step on the (2, 4) mesh against the plain step from
    the same state: the guard reads the global loss and norm, equal on
    every rank, accepts, and leaves the same bits."""
    from repro_torch import interop
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.engine import GuardState, make_guarded_step, make_step
    from repro_torch.resilience import GuardConfig
    sess = _session("even4-par", inputs)
    plan, tw = sess.plan, _weights(SRC4, "even4-par")
    batch = plan.shard_batch(GroupBatcher(inputs["sources"][4], 8,
                                          seed=0).next_batch())
    plain = plan.compile(make_step(sess.model, sess.optimizer, plan,
                                   task_weights=tw))
    guarded = plan.compile(make_guarded_step(
        sess.model, sess.optimizer, plan, guard=GuardConfig(),
        task_weights=tw))
    a, _ = plain(sess.state, batch)
    b, out = guarded(sess.state._replace(guard=GuardState.init()), batch)
    la, lb = interop.leaves(a.params), interop.leaves(b.params)
    return {"ok": bool(out.metrics["guard_ok"]),
            "equal": all(bool((la[k] == lb[k]).all()) for k in la),
            "gnorm": float(out.metrics["guard_gnorm"])}


def _replace_mid_run(inputs, workdir):
    """ragged5-hier for 2 + 2 steps, the placement swapped in between to
    round robin (heads move), beside the same run that keeps it; the
    swapped session also writes a checkpoint."""
    from repro_torch import interop
    from repro_torch.core import round_robin_placement
    out = {}
    for swap in (False, True):
        ckpt = os.path.join(workdir, "hier8") if swap else None
        sess = _session("ragged5-hier", inputs, steps=2, ckpt=ckpt)
        compiled, hashes = sess.step_fn, []
        _trace(sess, hashes)
        first = sess.run()
        before = list(sess.plan.shard.heads)
        if swap:
            sess.step_fn = compiled
            sess.set_placement(round_robin_placement(5, WORLD))
            _trace(sess, hashes)
        second = sess.run()
        sess.close()
        out["swap" if swap else "keep"] = {
            "per_task": _rows(first, 5) + _rows(second, 5),
            "heads_before": before, "heads": list(sess.plan.shard.heads),
            "held": _held(second.state), "trunk": hashes,
            "cache_size": compiled.cache_size(),
            "full": interop.to_numpy(sess.plan.gather_params(second.params))}
    return out


def _head_eval(seen):
    """An eval_fn that reads every head by its task index, as validation
    per source does; ``seen`` records the head count it was given."""
    from repro_torch import interop

    def eval_fn(params):
        leaf = next(iter(interop.leaves(params["heads"]).values()))
        seen.append(int(leaf.shape[0]))
        return {"val": sum(float((t + 1) * leaf[t].sum())
                           for t in range(5))}
    return eval_fn


def _eval_early_stop(inputs):
    """ragged5-hier with an eval_fn every step and a patience of 1 (no
    gain is ever large enough): every rank logs the same val rows and
    stops at the second eval, and the last row is the eval of the full
    final params."""
    seen = []
    sess = _session("ragged5-hier", inputs, steps=STEPS + 2, eval_every=1,
                    patience=1, min_delta=1e9, val_metric="val")
    sess.eval_fn = _head_eval(seen)
    res = sess.run()
    sess.close()
    full = sess.plan.gather_params(res.params)
    return {"val": [r["val"] for r in res.logger.history],
            "stopped": res.stopped_early, "seen": seen,
            "val_of_final": _head_eval([])(full)["val"]}


def _rank_main(rank, world, workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {name: _run_case(name, inputs) for name in CASES}
    out["shard_map_grads"] = _shard_map_grads(inputs)
    out["guarded"] = _guarded_step(inputs)
    out["replace"] = _replace_mid_run(inputs, workdir)
    out["eval"] = _eval_early_stop(inputs)
    return out


def _failing_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def _main(workdir):
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_rank_main, WORLD, device="cpu", args=(workdir,),
                    timeout=240, rdzv_dir=workdir)
    try:
        run_ranks(_failing_rank, 2, device="cpu", timeout=60,
                  rdzv_dir=workdir)
        failure = None
    except RuntimeError as e:
        failure = str(e)
    with open(os.path.join(workdir, "ranks.pkl"), "wb") as f:
        pickle.dump({"ranks": res, "failure": failure}, f)


# ---------------------------------------------------------------------------
# the references (repro, in this process and in a JAX subprocess)
# ---------------------------------------------------------------------------

def _jax_arch():
    import jax.numpy as jnp

    from repro.configs.base import ArchConfig
    return ArchConfig(name="g", family="gnn", gnn_hidden=24, gnn_layers=2,
                      n_species=64, head_hidden=12, head_layers=2,
                      remat=False, compute_dtype=jnp.float32)


def _sources(names):
    from repro.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(16, max_atoms=10, max_edges=40,
                                     sources=names))


def _repro_session(names, task_weights, steps=STEPS, uncertainty=False,
                   **kw):
    from repro.engine import Session, SessionConfig
    cfg = SessionConfig(model="gfm-mtl", arch=_jax_arch(), steps=steps,
                        batch_per_task=8, lr=1e-3, log_every=1,
                        eval_every=10 ** 9, seed=0, verbose=False,
                        task_weights=task_weights, **kw)
    return Session(cfg, sources=_sources(names),
                   model_kwargs={"uncertainty": uncertainty})


JAX_SCRIPT = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    sys.path.insert(0, {tests!r})
    import test_torch_taskpar as t
    from repro.data.loader import GroupBatcher
    from repro.engine import ShardingPlan, make_grad_fn
    from repro.core import MTPConfig
    from repro.launch.mesh import make_host_mesh
    from repro.engine import Session, SessionConfig
    assert jax.device_count() == 8
    src = t._sources(t.SRC4)
    cfg = SessionConfig(model="gfm-mtl", arch=t._jax_arch(), steps=t.STEPS,
                        batch_per_task=8, lr=1e-3, log_every=1,
                        eval_every=10 ** 9, seed=0, verbose=False,
                        backend="shard_map")
    mesh = make_host_mesh(2, 4)
    sess = Session(cfg, sources=src, mesh=mesh)
    params = jax.device_get(sess.state.params)
    res = sess.run()
    rows = [[r[f"task{{i}}"] for i in range(4)] for r in res.logger.history]
    plan = ShardingPlan(mesh=mesh, mtp=MTPConfig(n_tasks=4, mode="par"),
                        backend="shard_map", donate=False)
    batch = GroupBatcher(src, 8, seed=0).next_batch()
    l, m, g = jax.jit(make_grad_fn(sess.model, plan))(params, batch)
    with open({out!r}, "wb") as f:
        pickle.dump({{"per_task": rows,
                     "losses": [r["loss"] for r in res.logger.history],
                     "loss": float(l),
                     "per_task_loss": np.asarray(m["per_task_loss"]).tolist(),
                     "grads": jax.tree_util.tree_map(np.asarray, g)}}, f)
""")


def _subprocess(cmd, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.core import make_gfm_mtl
    workdir = str(tmp_path_factory.mktemp("taskpar"))
    params, sources, refs = {}, {}, {}
    for names in (SRC4, SRC5):
        for unc in (False, True):
            model = make_gfm_mtl(_jax_arch(), len(names), uncertainty=unc)
            params[len(names), unc] = jax.tree_util.tree_map(
                np.asarray, model.init(jax.random.PRNGKey(0)))
        sources[len(names)] = _sources(names)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"params": params, "sources": sources}, f)
    tests = os.path.dirname(os.path.abspath(__file__))
    jax_out = os.path.join(workdir, "jax_shard_map.pkl")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(tests=tests, out=jax_out)],
        env=dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
                 PYTHONPATH=SRC),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _subprocess([sys.executable, os.path.abspath(__file__), workdir])
        for name in GLOBAL:
            names, both = CASES[name][0], CASES[name][3]
            sess = _repro_session(names, _weights(names, name), **both)
            res = sess.run()
            sess.close()
            refs[name] = {"per_task": _rows(res, len(names)),
                          "losses": [r["loss"] for r in res.logger.history]}
        sess = _repro_session(SRC5, _weights(SRC5, "ragged5-hier"), steps=2)
        first = sess.run()
        second = sess.run()
        refs["replace"] = _rows(first, 5) + _rows(second, 5)
        _, err = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, err[-4000:]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    with open(jax_out, "rb") as f:
        refs["shard_map"] = pickle.load(f)
    with open(os.path.join(workdir, "ranks.pkl"), "rb") as f:
        got = pickle.load(f)
    return {"ranks": got["ranks"], "failure": got["failure"], "refs": refs,
            "params": params, "workdir": workdir}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", GLOBAL)
def test_per_task_losses_match_repro(runs, case):
    want = runs["refs"][case]["per_task"]
    for r in runs["ranks"]:
        _close(r[case]["per_task"], want)


@pytest.mark.parametrize("case", GLOBAL)
def test_total_losses_match_repro(runs, case):
    want = runs["refs"][case]["losses"]
    for r in runs["ranks"]:
        _close(r[case]["losses"], want)


def test_losses_evolve_over_steps(runs):
    """3 steps really train, so the parity is not vacuous."""
    losses = runs["ranks"][0]["ragged5-hier"]["losses"]
    assert len({round(x, 8) for x in losses}) == STEPS


def test_shard_map_losses_match_repro_shard_map(runs):
    want = runs["refs"]["shard_map"]
    for r in runs["ranks"]:
        _close(r["shard_map"]["per_task"], want["per_task"])
        _close(r["shard_map"]["losses"], want["losses"])


def test_shard_map_grads_match_repro_shard_map(runs):
    from repro_torch import interop
    want = runs["refs"]["shard_map"]
    got = runs["ranks"][0]["shard_map_grads"]
    _close(got["per_task"], want["per_task_loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    gl, wl = interop.leaves(got["grads"]), interop.leaves(want["grads"])
    assert set(gl) == set(wl)
    for k, w in wl.items():
        np.testing.assert_allclose(
            gl[k], w, rtol=0, atol=GRAD_TOL * max(1.0, float(np.abs(w).max())),
            err_msg=k)


def test_shard_map_is_per_shard_not_global(runs):
    """shard_map normalises each rank's rows: from the same params on the
    same first batch, its per-task losses depart from the global ones by
    more than the tolerance, so the parity tests tell the two apart."""
    sm = runs["ranks"][0]["shard_map"]["per_task"][0]
    glob = runs["ranks"][0]["even4-par"]["per_task"][0]
    assert not np.allclose(sm, glob, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES) + ["replace"])
def test_trunk_bitwise_equal_across_ranks(runs, case):
    def trunk(r):
        return r[case]["trunk"] if case != "replace" else \
            r[case]["swap"]["trunk"]
    per_rank = [trunk(r) for r in runs["ranks"]]
    assert len(per_rank[0]) == (STEPS if case != "replace" else 4)
    assert all(h == per_rank[0] for h in per_rank)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_heads(runs, case):
    from repro_torch.core.taskpar import hier_shard
    names, kw, shape, _ = CASES[case]
    for rank, r in enumerate(runs["ranks"]):
        got = r[case]
        if kw.get("mode") == "base":
            want = list(range(len(names)))
        elif shape is not None:          # par / shard_map: heads by column
            want = [rank % shape[1]]
        else:
            want = list(hier_shard(_placement(got), rank).heads)
        assert got["heads"] == want
        assert got["held"] == [len(want)]


def _placement(row):
    from repro_torch.core import HeadPlacement
    return HeadPlacement(groups=tuple(map(tuple, row["groups"])),
                         device_counts=tuple(row["device_counts"]))


def test_ragged_placement_is_the_solvers(runs):
    row = runs["ranks"][0]["ragged5-hier"]
    assert row["device_counts"] == [2, 1, 3, 1, 1]
    assert row["groups"] == [[0], [1], [2], [3], [4]]


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_params_equal_on_every_rank(runs, case):
    from repro_torch import interop
    ref = interop.leaves(runs["ranks"][0][case]["full"])
    for r in runs["ranks"][1:]:
        got = interop.leaves(r[case]["full"])
        assert all(np.array_equal(got[k], v) for k, v in ref.items())


def test_set_placement_mid_run_matches_kept_placement(runs):
    for r in runs["ranks"]:
        keep, swap = r["replace"]["keep"], r["replace"]["swap"]
        _close(swap["per_task"], keep["per_task"])
        _close(swap["per_task"], runs["refs"]["replace"])
        assert swap["trunk"][:2] == keep["trunk"][:2]
    from repro_torch import interop
    a = interop.leaves(runs["ranks"][0]["replace"]["keep"]["full"])
    b = interop.leaves(runs["ranks"][0]["replace"]["swap"]["full"])
    for k, v in a.items():
        np.testing.assert_allclose(b[k], v, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(v).max()))


def test_set_placement_moves_heads_and_rebuilds_only_changed_groups(runs):
    """(2, 1, 3, 1, 1) -> round robin's (2, 2, 2, 1, 1): the ranks whose
    (heads, ranks) changed hold their new head with its moments and built
    one more group step; the others reuse theirs."""
    from repro_torch.core import round_robin_placement
    from repro_torch.core.taskpar import hier_shard
    rr = round_robin_placement(5, WORLD)
    old = _placement(runs["ranks"][0]["ragged5-hier"])
    for rank, r in enumerate(runs["ranks"]):
        swap = r["replace"]["swap"]
        assert swap["heads_before"] == list(hier_shard(old, rank).heads)
        assert swap["heads"] == list(hier_shard(rr, rank).heads)
        assert swap["held"] == [len(swap["heads"])]
        moved = hier_shard(rr, rank) != hier_shard(old, rank)
        assert swap["cache_size"] == (2 if moved else 1)
        assert r["replace"]["keep"]["cache_size"] == 1
    assert sum(hier_shard(rr, r) != hier_shard(old, r)
               for r in range(WORLD)) == 4


def test_checkpoint_restores_in_repro(runs):
    import jax

    from repro.core import make_gfm_mtl
    from repro.train import checkpoint as jckpt
    from repro_torch import interop
    path = os.path.join(runs["workdir"], "hier8")
    model = make_gfm_mtl(_jax_arch(), 5)
    template = {"params": model.init(jax.random.PRNGKey(0))}
    back = jckpt.restore(path, template)
    got = interop.leaves(jax.tree_util.tree_map(np.asarray, back["params"]))
    want = interop.leaves(runs["ranks"][0]["replace"]["swap"]["full"])
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], v) for k, v in want.items())
    assert jckpt.load_metadata(path)["step"] == 4


def test_checkpoint_restores_in_one_device_port_session(runs):
    from repro_torch import interop
    from repro_torch.engine import Session, SessionConfig
    from repro_torch.train import checkpoint
    path = os.path.join(runs["workdir"], "hier8")
    sess = Session(SessionConfig(model="gfm-mtl", arch=_arch(), steps=1,
                                 verbose=False),
                   sources=_port_sources(5), device="cpu")
    back = checkpoint.restore(path, {"params": sess.state.params})
    sess.state = sess.state._replace(params=interop.to_torch(back["params"]))
    got = interop.leaves(interop.to_numpy(sess.state.params))
    want = interop.leaves(runs["ranks"][0]["replace"]["swap"]["full"])
    assert all(np.array_equal(got[k], v) for k, v in want.items())
    assert sess.plan.resolved_backend == "jit"


def _port_sources(n):
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(4, max_atoms=10, max_edges=40))[:n]


def test_guarded_step_on_a_mesh_equals_the_plain_step(runs):
    rows = [r["guarded"] for r in runs["ranks"]]
    assert all(r["ok"] and r["equal"] for r in rows)
    assert len({r["gnorm"] for r in rows}) == 1    # the global norm


def test_a_failing_rank_fails_the_job(runs):
    assert runs["failure"] is not None
    assert "rank 1 fails on purpose" in runs["failure"]


def test_eval_sees_full_params_and_ranks_stop_together(runs):
    rows = [r["eval"] for r in runs["ranks"]]
    assert rows[0]["seen"] == [5, 5]          # rank 0 evaluates, whole
    assert all(r["seen"] == [] for r in rows[1:])
    assert all(r["val"] == rows[0]["val"] and len(r["val"]) == 2
               and r["stopped"] for r in rows)
    assert all(r["val"][-1] == r["val_of_final"] for r in rows)


def test_launcher_needs_a_gpu_unless_cpu_is_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None legitimately runs there")
    from repro_torch.core import MTPConfig
    from repro_torch.engine import ShardingPlan
    from repro_torch.launch.mesh import run_ranks
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(_failing_rank, 2, timeout=10)
    plan = ShardingPlan(mtp=MTPConfig(n_tasks=2))
    batch = {"pos": np.zeros((2, 3, 4, 3), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.shard_batch(batch)
    assert plan.shard_batch(batch, device="cpu")["pos"].device.type == "cpu"


def test_placement_with_guard_raises(tmp_path):
    from repro_torch.engine import Session, SessionConfig
    from repro_torch.resilience import GuardConfig, ResilienceConfig
    res = ResilienceConfig(ckpt_dir=str(tmp_path), guard=GuardConfig())
    cfg = SessionConfig(model="gfm-mtl", arch=_arch(), steps=1, placement=8,
                        resilience=res, verbose=False)
    with pytest.raises(NotImplementedError, match="hierarchical"):
        Session(cfg, sources=_port_sources(5), device="cpu")


def test_placement_and_mesh_are_exclusive():
    from repro_torch.engine import Session, SessionConfig
    cfg = SessionConfig(model="gfm-mtl", arch=_arch(), steps=1, placement=8,
                        verbose=False)
    with pytest.raises(ValueError, match="exclusive"):
        Session(cfg, sources=_port_sources(5), mesh=object(), device="cpu")


def _plan_kw():
    from repro_torch.core import HeadPlacement, MTPConfig
    place = HeadPlacement(groups=((0,), (1,)), device_counts=(1, 1))
    mtp = MTPConfig(n_tasks=2)
    return [
        pytest.param(dict(backend="nope"), id="unknown-backend"),
        pytest.param(dict(backend="pjit", mtp=mtp), id="pjit-no-mesh"),
        pytest.param(dict(backend="shard_map", mtp=mtp),
                     id="shard_map-no-mesh"),
        pytest.param(dict(backend="hier"), id="hier-no-placement"),
        pytest.param(dict(placement=place, mesh=object()),
                     id="placement-and-mesh"),
        pytest.param(dict(placement=place, backend="pjit"),
                     id="placement-backend-pjit"),
    ]


@pytest.mark.parametrize("kw", _plan_kw())
def test_sharding_plan_checks(kw):
    from repro_torch.engine import ShardingPlan
    with pytest.raises(ValueError):
        ShardingPlan(**kw)


def test_sharding_plan_resolves_backends():
    from repro_torch.core import HeadPlacement, MTPConfig
    from repro_torch.engine import ShardingPlan
    place = HeadPlacement(groups=((0,), (1,)), device_counts=(1, 1))
    assert ShardingPlan().resolved_backend == "jit"
    assert not ShardingPlan().distributed
    assert ShardingPlan(placement=place).resolved_backend == "hier"
    assert ShardingPlan(mesh=object(), mtp=MTPConfig(2)).resolved_backend \
        == "pjit"


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    import torch

    from repro_torch.launch.mesh import init_distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses"):
        init_distributed(0, 2, backend="nccl", init_method="file:///none",
                         device="cuda")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        init_distributed(0, 1, backend="nccl", init_method="file:///none",
                         device="cpu")


@pytest.mark.parametrize("mode,want", [("par", [(0,), (1,), (0,), (1,)]),
                                       ("base", [(0, 1)] * 4)])
def test_flat_shard_rows(mode, want):
    from repro_torch.core import MTPConfig
    from repro_torch.core.taskpar import flat_shard
    ranks = np.arange(4).reshape(2, 2)
    got = [flat_shard(MTPConfig(n_tasks=2, mode=mode), ranks, r)
           for r in range(4)]
    assert [s.heads for s in got] == want
    if mode == "par":
        assert [s.ranks for s in got] == [(0, 2), (1, 3), (0, 2), (1, 3)]
        assert [s.batch_rows(8) for s in got] == \
            [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    else:
        assert [s.batch_rows(8) for s in got] == \
            [slice(2 * r, 2 * r + 2) for r in range(4)]


if __name__ == "__main__":
    _main(sys.argv[1])
