"""The port's dry run (``launch.dryrun``, ``launch.cost``) against
``repro``'s.

  * ``skip_reason`` equals ``repro``'s for every (arch x shape), and so
    does the skip of every (arch x shape x mesh) entry;
  * FLOPs: ``launch.cost.count`` of a smoke LM train step on one device
    (fake tensors, as the dry run counts) equals ``repro``'s
    ``analyze_hlo`` on a one-device compile of the same step plus one
    product — the embedding's backward, which the port's plain version
    computes as a one-hot product (2 x tokens x padded vocab x d, #1's
    plain version; on the card #1 is a kernel the counter does not see)
    and ``repro``'s ``take`` gradient as a scatter. Remat's recompute is
    counted on both sides (``jax.checkpoint`` keeps it in the HLO,
    ``torch.utils.checkpoint`` runs it again), and so are chunked
    attention's masked blocks (both compute every block of the grid: the
    dense step runs 4 x 2 blocks at 2048 tokens, one of them wholly
    masked). Exact: a dense config with remat, an MoE one without (at
    1024 tokens, 2 x 1 blocks);
  * an entry on a fake world (a smoke config with ``fsdp=True`` on the
    16 x 16 pod, rank 0, 32 x 256 tokens): ``ok``, the rank's params equal
    the sharded count of ``param_bytes_per_device``, its moments twice
    that, its figures tensor-parallel (all-gathers and reduce-scatters
    beside the all-reduces); the counts from one and two block units extrapolated to four
    equal the direct count of four (FLOPs and collectives exactly, op
    bytes to 1e-6); materialised on the CPU, its collectives and peak
    equal the static count's;
  * a blocked attention call counted from 1 x 1, 1 x 2 and 2 x 2 blocks
    (prefill) gives the FLOPs of the full trace exactly and its op bytes
    within 2%; a recurrent-only model's step fitted from 1, 2 and 3
    chunks of its length gives the direct trace's FLOPs and collectives
    exactly, its op bytes to 2% and its peak to 5%;
  * the CLI: ``--no-compile`` builds an entry and prints ``repro``'s done
    line; without ``--device`` it runs on the card and refuses a CPU-only
    host; ``fake_world`` leaves no process group behind.
"""
import os

import numpy as np
import pytest
import torch


def _repro_dryrun():
    """``repro.launch.dryrun``, imported without keeping the 512-device
    ``XLA_FLAGS`` it sets (this worker's later tests keep their devices)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as d
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return d


def test_skip_reasons_match_repro():
    from repro_torch import configs
    from repro_torch.launch import dryrun
    jd = _repro_dryrun()
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            want = jd.skip_reason(arch, shape)
            assert dryrun.skip_reason(arch, shape) == want, (arch, shape)
            for mesh in ("pod", "multipod", "paper", "pod32x8", "hier"):
                got = dryrun.entry_skip(arch, shape, mesh)
                if want is None and mesh == "hier" and \
                        configs.get(arch).family != "gnn":
                    want_m = jd.run_one(arch, shape, mesh)["reason"]
                else:
                    want_m = want
                assert got == want_m, (arch, shape, mesh)


@pytest.mark.parametrize("name,remat,S", [("qwen1.5-0.5b", True, 2048),
                                          ("granite-moe-3b-a800m", False,
                                           1024)])
def test_step_flops_match_repro_hlo(name, remat, S):
    import jax
    import jax.numpy as jnp
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro import configs as jc
    from repro.engine import TrainState as JState
    from repro.engine import build_model as j_build
    from repro.engine import make_step as j_step
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.optim import adamw as j_adamw
    from repro_torch import configs as tc
    from repro_torch.engine import TrainState, build_model, make_step
    from repro_torch.interop import tree_map
    from repro_torch.launch import cost
    from repro_torch.optim import adamw
    B = 1
    jcfg = jc.get_smoke(name).replace(remat=remat)
    tcfg = tc.get_smoke(name).replace(remat=remat)
    jm, jo = j_build("lm", jcfg), j_adamw(1e-3, weight_decay=0.01,
                                          grad_clip=1.0)
    ps = jax.eval_shape(jm.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    st = jax.eval_shape(lambda p: JState.create(p, jo), ps)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    want = analyze_hlo(jax.jit(j_step(jm, jo, None)).lower(
        st, batch).compile().as_text())["flops"]
    tm, to = build_model("lm", tcfg), adamw(1e-3, weight_decay=0.01,
                                            grad_clip=1.0)
    meta = tm.init(0, device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True):
        p = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), meta)
        b = {k: torch.zeros(B, S, dtype=torch.int32)
             for k in ("tokens", "labels")}
        _, c = cost.count(make_step(tm, to), TrainState.create(p, to), b)
    embed_bwd = 2 * B * S * tcfg.padded_vocab * tcfg.d_model
    assert c["flops"] == want + embed_bwd


def _smoke_fsdp(layers):
    from repro_torch import configs
    return configs.get_smoke("qwen1.5-0.5b").replace(
        fsdp=True, n_layers=layers, n_heads=16, n_kv_heads=16, head_dim=8)


@pytest.fixture
def small_train():
    """A train shape of 32 x 256 tokens (2 rows a data rank of the pod)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    dryrun.SHAPES["_train"] = ShapeConfig("_train", 256, 32, "train")
    yield "_train"
    del dryrun.SHAPES["_train"]


def test_entry_on_the_pod_counts_its_blocks_and_extrapolates(small_train):
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.engine import build_model
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    cfg = _smoke_fsdp(4)
    e = dryrun.run_one("qwen1.5-0.5b", small_train, "pod", device="cpu",
                       cfg_override=cfg)
    assert e["status"] == "ok", e.get("trace")
    mem = e["memory"]
    assert mem["param_bytes"] == mem["param_bytes_model"] > 0
    assert mem["moment_bytes"] == 2 * mem["param_bytes"]
    # heads over model (16), the rest over data (FSDP) and model: a rank
    # holds far less than the whole tree
    full = nbytes(build_model("lm", cfg).init(0, device="meta"))
    assert mem["param_bytes"] < full / 16
    assert e["hlo"]["traced"]["depth_units"] == [1, 2]
    # a dense GQA model's spec_fn plan computes tensor-parallel: its
    # figures say so, and its FSDP leaves are gathered a unit at a time
    # and their gradients reduce-scattered
    assert mem["figures"] == e["hlo"]["figures"] == dryrun.TENSOR_PARALLEL
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        assert e["hlo"]["collectives"][kind]["count"] > 0, kind
    # the direct count of four units equals the extrapolation from 1 and 2
    with fake_world(256, 0, "cpu"):
        direct, _ = dryrun._count(dryrun._lm_train, cfg,
                                  dryrun.SHAPES[small_train],
                                  dryrun.make_mesh("pod"), cfg.train_accum,
                                  "cpu", None)
    assert direct["flops"] == e["hlo"]["flops"]
    assert direct["collectives"] == e["hlo"]["collectives"]
    assert abs(direct["traffic_bytes"] - e["hlo"]["traffic_bytes"]) <= \
        1e-6 * direct["traffic_bytes"]


def test_materialised_rank_program_matches_its_static_count(small_train):
    from repro_torch.launch import dryrun
    keep = {}
    e = dryrun.run_one("qwen1.5-0.5b", small_train, "pod", device="cpu",
                       cfg_override=_smoke_fsdp(2), materialize_too=True,
                       keep=keep)
    assert e["status"] == "ok", e.get("trace")
    mat = e["materialized"]
    assert {k: v["count"] for k, v in mat["collectives"].items()} == \
        {k: v["count"] for k, v in e["hlo"]["collectives"].items()}
    assert mat["peak_bytes"] == e["memory"]["peak_bytes"]
    assert np.isfinite(float(keep["out"][1].loss))


def test_blocked_attention_count_matches_the_full_trace():
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = configs.get_smoke("h2o-danube-1.8b").replace(n_layers=2)
    dryrun.SHAPES["_p"] = ShapeConfig("_p", 4096, 32, "prefill")
    try:
        got = dryrun.run_one("h2o-danube-1.8b", "_p", "pod", device="cpu",
                             cfg_override=cfg)
        pairs, dryrun.ATTN_PAIRS = dryrun.ATTN_PAIRS, 10 ** 9
        try:
            want = dryrun.run_one("h2o-danube-1.8b", "_p", "pod",
                                  device="cpu", cfg_override=cfg)
        finally:
            dryrun.ATTN_PAIRS = pairs
    finally:
        del dryrun.SHAPES["_p"]
    assert got["status"] == want["status"] == "ok"
    assert got["hlo"]["flops"] == want["hlo"]["flops"]
    t_got, t_want = got["hlo"]["traffic_bytes"], want["hlo"]["traffic_bytes"]
    assert abs(t_got - t_want) <= 0.02 * t_want


def test_recurrent_length_fit_matches_the_full_trace():
    """xlstm's train step counted at 1, 2 and 3 chunks and fitted at 5:
    the FLOPs and collectives of the direct trace exactly, its op bytes to
    2%, its peak to 5%."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    cfg = configs.get_smoke("xlstm-125m").replace(ssm_chunk=8)
    shape = ShapeConfig("_x", 40, 32, "train")
    dryrun.SHAPES["_x"] = shape
    try:
        e = dryrun.run_one("xlstm-125m", "_x", "pod", device="cpu",
                           cfg_override=cfg)
    finally:
        del dryrun.SHAPES["_x"]
    assert e["status"] == "ok", e.get("trace")
    assert e["hlo"]["traced"]["seq_len"] == [8, 16, 24]
    with fake_world(256, 0, "cpu"):
        direct, _ = dryrun._count(dryrun._lm_train, cfg, shape,
                                  dryrun.make_mesh("pod"), 1, "cpu", None)
    assert direct["flops"] == e["hlo"]["flops"]
    assert direct["collectives"] == e["hlo"]["collectives"]
    assert abs(direct["traffic_bytes"] - e["hlo"]["traffic_bytes"]) <= \
        2e-2 * direct["traffic_bytes"]
    assert abs(direct["peak_bytes"] - e["memory"]["peak_bytes"]) <= \
        0.05 * direct["peak_bytes"]


def test_cli_builds_without_counting_and_refuses_a_cpu_host(capsys):
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--no-compile", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "# dryrun done: ok=1 fail=0 skip=0"
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                         "--no-compile"])


def test_run_one_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``run_one`` without ``device`` is the card's: on a host with no GPU
    the materialised entry raises, and asks for ``device='cpu'``."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_one("xlstm-125m", "decode_32k", "pod", compile_too=False,
                       materialize_too=True)
    assert not dist.is_initialized()
