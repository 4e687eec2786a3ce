"""The port's dry run of a tensor-parallel entry against ``repro``'s
compiled figures, both run live.

qwen1.5-0.5b on the 16 x 16 production pod at ``train_4k`` and
``prefill_32k``: ``repro.launch.dryrun`` in a subprocess (its 512 host
devices; XLA's per-device HLO figures) beside ``repro_torch.launch.
dryrun.run_one`` in this process (rank 0 of a fake world, the rank's
step counted on fake tensors). The port computes in the layout
``repro``'s specs name, which XLA keeps for qwen (no involuntary
rematerialization: ``--dots`` below), so its per-rank figures sit near
XLA's:

  * FLOPs within 0.8-1.25 x ``hlo.flops`` (the port counts its chunked
    attention's masked blocks and the embedding backward's one-hot
    product, #1's plain version; XLA fuses and simplifies);
  * all-reduce bytes within 0.5-2 x ``hlo.collective_bytes`` (the count
    is not held: the port flattens its gradient reductions into one
    buffer a dtype, where XLA combines them its own way);
  * the counted peak within 0.5-2 x argument + temp bytes;
  * the entry's ``figures`` read tensor-parallel.

deepseek-v2-236b's ``train_4k`` on the same pod, counted in the same
process while ``repro``'s compile runs: its experts over ``model`` and
its MLA heads local, the entry reads tensor-parallel, the counted peak a
rank is under one H100's 80 GB (the data-parallel step's read 1,619 GB),
and its FLOPs under a quarter of the data-parallel step's 18,379 TFLOP
(no band against ``repro``'s compiled figures: XLA leaves the specs'
layout for these MoE programs, whose FLOPs are 0.33-1.2 x the
data-parallel count, so the port's count is held by its own arithmetic,
``tests/test_torch_tp_moe.py``). granite-moe's entry on the pod keeps
the data-parallel step, its reason the fractional heads.

Run as a script, ``python tests/test_torch_tp_dryrun.py --dots ARCH
SHAPE`` compiles ``repro``'s step on the pod and prints its dot products
grouped by shape, each weighted by its loop count (the same HLO walk as
``repro.launch.hlo_analysis.analyze_hlo``): where XLA's partitioner left
``repro``'s layout, its stderr says "Involuntary full rematerialization"
and the products show the rows it computes a rank.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARCH = "qwen1.5-0.5b"
SHAPES = ("train_4k", "prefill_32k")
FLOP_BAND = (0.8, 1.25)
BYTE_BAND = (0.5, 2.0)
H100_BYTES = 80e9                # one card's memory
DP_TFLOP = 18379                 # deepseek train_4k on the pod, the
                                 # data-parallel step's count


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    from repro_torch.launch import dryrun
    workdir = tmp_path_factory.mktemp("tp_dryrun")
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    procs = {sh: subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", ARCH,
         "--shape", sh, "--mesh", "pod", "--out",
         str(workdir / f"{sh}.json")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for sh in SHAPES}
    try:
        port = {sh: dryrun.run_one(ARCH, sh, "pod", device="cpu")
                for sh in SHAPES}
        port["deepseek"] = dryrun.run_one("deepseek-v2-236b", "train_4k",
                                          "pod", device="cpu")
        port["granite"] = dryrun.run_one("granite-moe-3b-a800m", "train_4k",
                                         "pod", device="cpu",
                                         compile_too=False)
        for sh, p in procs.items():
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ref = {}
    for sh in SHAPES:
        with open(workdir / f"{sh}.json") as f:
            ref[sh] = json.load(f)[-1]
    return port, ref


def _within(got, want, band):
    return band[0] * want <= got <= band[1] * want


@pytest.mark.parametrize("shape", SHAPES)
def test_tp_dryrun_flops_and_all_reduce_match_repro(entries, shape):
    port, ref = entries[0][shape], entries[1][shape]
    assert port["status"] == ref["status"] == "ok", port.get("trace")
    got, want = port["hlo"]["flops"], ref["hlo"]["flops"]
    assert _within(got, want, FLOP_BAND), (got, want)
    got = port["hlo"]["collectives"]["all-reduce"]["bytes"]
    want = ref["hlo"]["collective_bytes"]
    assert _within(got, want, BYTE_BAND), (got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_tp_dryrun_peak_matches_repro_and_reads_tensor_parallel(entries,
                                                                shape):
    from repro_torch.launch import dryrun
    port, ref = entries[0][shape], entries[1][shape]
    mem = ref["memory"]
    want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    got = port["memory"]["peak_bytes"]
    assert _within(got, want, BYTE_BAND), (got, want)
    assert port["memory"]["figures"] == port["hlo"]["figures"] == \
        dryrun.TENSOR_PARALLEL
    # the rank holds its blocks: the sharded count of the whole tree
    assert port["memory"]["param_bytes"] == port["memory"]["param_bytes_model"]


def test_deepseek_train_computes_in_the_specs_layout(entries):
    from repro_torch.launch import dryrun
    e = entries[0]["deepseek"]
    assert e["status"] == "ok", e.get("trace")
    assert e["memory"]["figures"] == e["hlo"]["figures"] == \
        dryrun.TENSOR_PARALLEL
    assert e["memory"]["param_bytes"] == e["memory"]["param_bytes_model"]
    assert e["memory"]["peak_bytes"] < H100_BYTES, e["memory"]["peak_bytes"]
    assert e["hlo"]["flops"] < DP_TFLOP * 1e12 / 4, e["hlo"]["flops"]
    # FSDP gathers a unit at a time; nothing is gathered whole
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert e["hlo"]["collectives"][kind]["count"] > 0, kind
    g = entries[0]["granite"]
    assert g["status"] == "ok", g.get("trace")
    assert g["memory"]["figures"] == (
        f"{dryrun.DATA_PARALLEL} (naive_tp's fractional heads (24 heads "
        "over model 16))")


def repro_dots(arch: str, shape: str, top: int = 12) -> dict:
    """``repro``'s compiled per-device step on the pod: the total of its
    loop-weighted dot FLOPs and the ``top`` (FLOPs, count, output shape,
    operand shapes) groups. Imports JAX: call it in a process of its own
    (``--dots``)."""
    from collections import defaultdict

    from repro.launch import dryrun as d   # sets the 512 host devices
    from repro.launch import hlo_analysis as h
    lowered, _ = d.build_lowered(arch, shape,
                                 d.make_production_mesh(multi_pod=False),
                                 impl="chunked", accum=1)
    text = lowered.compile().as_text()
    comps = {}
    h.parse_into(comps, text)
    mult = h._multipliers(comps, text)
    flops, count = defaultdict(float), defaultdict(float)
    for cname, comp in comps.items():
        k = mult.get(cname, 0.0)
        for ins in comp.instrs if k else ():
            if ins.op == "dot":
                key = (ins.shape.split("{")[0], tuple(
                    h._operand_shape(comp, n, inl).split("{")[0]
                    for n, inl in h._operands(ins)))
                flops[key] += k * h._dot_flops(comp, ins)
                count[key] += k
    rows = sorted(flops, key=lambda key: -flops[key])[:top]
    return {"flops": sum(flops.values()),
            "top": [(flops[r], count[r], r[0], list(r[1])) for r in rows]}


def test_repro_dots_keep_the_megatron_layout_for_qwen():
    """The ``--dots`` reading on qwen's prefill: XLA keeps the specs'
    layout (no involuntary rematerialization), its dots add up to its
    ``hlo.flops``, and it unembeds every position of the rank's 2 x
    32768 rows over its 9504 of the 152,064 padded ids, as the port's
    prefill step does (the dry run slices ``logits[:, -1:]`` after)."""
    env = dict({k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
               PYTHONPATH=SRC)
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--dots",
                        ARCH, "prefill_32k"], env=env, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "Involuntary full rematerialization" not in p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["flops"] > 1.6e13
    unembed = [f for f, _, out, _ in got["top"] if out == "f32[65536,9504]"]
    assert unembed == [2.0 * 65536 * 1024 * 9504]


if __name__ == "__main__":
    if sys.argv[1:2] != ["--dots"] or len(sys.argv) != 4:
        sys.exit("usage: test_torch_tp_dryrun.py --dots ARCH SHAPE")
    res = repro_dots(sys.argv[2], sys.argv[3])
    for f, n, out, ops in res["top"]:
        print(f"{f / 1e12:10.2f} TFLOP  x{n:7.0f}  {out} <- {' x '.join(ops)}")
    print(f"# total {res['flops'] / 1e12:.2f} TFLOP", file=sys.stderr)
    print(json.dumps(res))
