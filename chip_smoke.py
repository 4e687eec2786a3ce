#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line:

  1. device: the card (``nvidia-smi`` name and power limit) and the time to
     build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, in parallel);
  2. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes, with masked and sentinel (dst == A) edges,
     under the tolerances stated below; each kernel, its plain version and
     a one-call PyTorch yardstick (``library_ms``, never used by the port)
     are timed by device time (``torch.profiler``). The edge kernel's
     forward (#3) is checked at the training path's shape (B=40: 5 sources
     x 8 graphs in one trunk pass), at B=8 (A=64, and a serve bucket of
     M = 128), at B=4 (a task-parallel rank's shard, a serve batch split
     over 2 entries), at B=2 (split over 4), at the training bucket (40,
     32, 128) and at a ragged shape, for
     bits over two calls, per output and scratch (out, Pi, Pj, S, deg) at
     B=40, 8, 4 and 2, and timed there (B=40 its summary row) with its
     kernels a call (at most 4) and ``torch.matmul`` of its three
     products beside it (``gemm_library_ms``). Its backward (#4) is checked per
     output and for bits over two calls at B=40 (pos needing no
     gradient), at B=8 with dpos, at B=4 without and at a ragged shape,
     and timed at B=40 (its summary row), B=8 and B=4 with its kernels a
     call (at most 3 without dpos, 4 with) and
     ``torch.matmul`` of its six products beside it; each graph of a
     batched segment-sum must be bitwise equal to that graph alone, in f32
     and bf16;
  3. serve: ``ServeSession`` serves hydragnn-gfm at full width (4 EGNN
     layers at H=866, 5 branches of 3x889 MLPs, fp32, seeded random
     weights) over a bucket grid planned from synthetic five-source
     structures — once under ``segment_sum_impl="fused"`` and once under
     ``"pallas"``. Every request resolves finite; rows are bitwise equal to
     ``predict_one``; the kernel's launch count, zeroed just before the
     pass, equals 4 x batches; both passes agree with each other and with
     the plain forward;
  3b. serve_scaleout: multi-device serving in one process at the same
     width, one card standing in for a mesh (a device list may name it
     several times: each entry is a stream of its own). (a) 8 replicas
     (``make_replica_meshes(8, devices=["cuda"] * 8)``, 8 param copies, 8
     streams, warmed up concurrently) behind the router serve 160
     mixed-head requests under ``"fused"``: every row bitwise equal to a
     single-device ``predict_one``, ``routed`` 160, nothing outstanding,
     #3 launched 4 x batches; structures/s and p50/p99 beside the serve
     phase's fused pass, as information; (b) two replicas, each crashed
     by an injected ``batcher.add`` fault: the trigger fails, the next
     request fails over bitwise right, with both dead submit raises
     ``ServeClosedError``, ``restart_workers()`` returns 2 and serving is
     bitwise right again; (c) a burst of 40 with ``max_wait_ms=100`` closed
     at once: every future resolves without error, a later submit raises;
     (d) ``ServeSession(mesh=)`` with a batch's rows split over 2 and 4
     entries, under ``"fused"`` and ``"pallas"``: rows bitwise equal to
     the session's own ``predict_one`` and within ``SERVE_TOL`` of one
     device (whether bitwise is recorded), ``max_batch=6`` on 4 entries
     raises, #3 (fused) or #2 (pallas) launched 4 x entries x batches;
  4. train: ``Session`` trains hydragnn-gfm at full width under
     ``"fused"`` for 10 steps (5 synthetic sources, 8 graphs each per step,
     A=64, E=2048, AdamW, a checkpoint). Every loss is finite; the forward
     and backward edge kernels, counted from zero over the run, launch 4
     times per step each (one trunk pass over all 40 graphs, 4 layers);
     one step's gradients match the plain path's (``"jnp"``, autograd,
     no kernel: its species embedding's backward is the one-hot product)
     on the same batch, and #1 on that step's own embedding cotangent
     (B·A ids into the species table, F=866) is bitwise equal to a plain
     token-order sum and within the rounding bound of the one-hot
     product, in f32 and bf16 (``_check_embed``; so too in train_pipeline,
     gnn_bf16, finetune and lm_train); two 3-step runs from one seed
     end with bitwise equal parameters;
     ``ServeSession.from_checkpoint`` serves requests from the written
     checkpoint;
  4b. train_pipeline: the multi-source pre-training path at the same
     width, over the same 5 sources. (a) MTL-All, ``mixing=1.0`` (loss
     weights) and ``bucketing=3``, 10 steps: losses finite, 4 + 4 edge
     kernel launches a step, the bucket shapes met and the pad fraction
     before and after the trim, one bucketed batch's gradients within
     ``GRAD_TOL`` of the plain path and its loss within ``GRAD_TOL`` of
     the untrimmed batch's, two 3-step runs bitwise equal, one step's
     device time and host-clock ms bucketed beside unbucketed, and #3 and
     #4 against their plain versions per output at every bucket shape up
     to (32, 128) at B=40; (b) Baseline-All (``gfm-baseline``, 40 graphs
     a step from the mixture, bucketed): the same launches, replay
     bitwise; (c) ``write_store`` of the sources under
     ``build/chip_smoke/store``: 12 ``PrefetchingBatcher`` batches equal to
     ``GroupBatcher``'s on the card, a 3-step session fed by it bitwise
     equal to the in-memory session; (d) a resilient run hit by every
     fault kind (``SOAK_FAULTS``), then ``resume()`` in a fresh session:
     params, moments and step bitwise equal to a clean 12-step run; the
     report's events and each checkpoint write's ms;
  4c. train_mtp: multi-task parallelism (the paper's method) at the same
     width: ranks spawned by ``launch.mesh.run_ranks`` on the one card over
     gloo (NCCL refuses two ranks on one card), each a ``Session`` of 3
     steps with the paper's source sizes as task weights. (a) ``hier``:
     8 ranks, ``placement=8`` — groups (2, 1, 3, 1, 1), per-rank B of 4 or
     8; (b) ``par``: a (1, 5) mesh, one head a rank; (c) ``base``: a (2, 1)
     mesh, heads whole. Each: per-task and total losses within rtol 5e-5,
     atol 1e-6 of the one-process session on the same batches; trunk
     params bitwise equal across ranks after every step; 4 + 4 edge-kernel
     launches a step a rank; each rank's params and moments equal to the
     §4.3 model (``memory_per_device`` x 3 x 4 B) beside
     ``memory_allocated``. (a) also: two runs bitwise equal, the checkpoint
     rank 0 writes read back by every rank (its own rows) and bitwise into
     a one-process session, and per rank the step's device time and
     host-clock ms and the trunk's and the group's all-reduce ms — ranks
     that time-share one card, not a scaling result;
  4d. gnn_bf16: hydragnn-gfm at full width in bf16 compute (fp32 params,
     ``compute_dtype=torch.bfloat16``) through the bf16 variants of #3 and
     #4. Kernels, in phase 2's turn: #3 in bf16 (``check_egnn_edge``
     with the compute dtype) against ``egnn_edge_agg_ref`` at bf16 within
     ``EDGE_BF16_TOL`` at phase 2's shapes (B=40, 8, 4 and 2 at A=64,
     E=2048, the buckets (8, 16, 512) and (40, 32, 128), a ragged shape),
     bits over two calls, launched on its own counter
     (``egnn_edge_agg.bf16``), the kernel's and the plain version's error
     against a float64 forward, and at B=40/8/4/2 its f32 scratch and
     device time beside the plain version, the f32 #3 and
     ``torch.matmul`` bf16 of its three products; #4 on bf16 g, h and
     weights at B=40 (no dpos) and B=8 (dpos), through the autograd
     Function on a bf16 h leaf within ``BWD_TOL`` of the plain version,
     and its launch bitwise equal to #4's f32 launch on the upcast values,
     timed beside it. Then (b) 80 requests served
     under ``"fused"`` and ``"pallas"``: rows bitwise equal to
     ``predict_one``, within ``EDGE_BF16_TOL`` of the plain (``"jnp"``)
     bf16 forward, the bf16 #3 launched 4 x batches (no f32 launch), the
     distance from phase 3's f32 rows recorded; (c) 10 steps of 5 x 8
     graphs: losses finite, 4 + 4 bf16 edge launches a step, one step's
     gradients within ``EDGE_BF16_TOL`` of the plain bf16 path (x max(1,
     max|ref|)) and each leaf within ``BF16_GRAD_NORM_TOL`` of its own
     size, two 3-step runs bitwise equal, params fp32,
     ``ServeSession.from_checkpoint`` serving in bf16;
  4e. finetune: the paper's downstream fine-tuning at hydragnn-gfm's full
     width, through ``examples/finetune_downstream_torch.py``'s functions:
     a ``Session`` pre-trains 5 steps on 3 sources x 8 graphs, then a
     fresh branch and the trunk (a ``SingleTaskModel`` through
     ``ShardingPlan().compile(make_step(...))``) tune 5 steps on 12
     transition1x graphs from the pre-trained trunk and from a scratch
     one. Every loss finite; #3, #4 and #1 (the species embedding's
     backward), counted from zero, launch 4, 4 and 1 a step; one step's
     gradients within ``GRAD_TOL`` of the plain path; ``accum=2`` on the
     flat batch within ``GRAD_TOL`` of the mean of its halves' gradients
     (its distance from ``accum=1``, whose force term normalises over all
     12 graphs' atoms, recorded); two runs from one seed bitwise equal;
     the trunk's params move; the held-out MAEs (64 graphs) through the
     kernels within ``SERVE_TOL`` of the plain forward's, both MAEs and
     their ratio recorded as information;
  5. lm kernels: flash attention (#5) and flash decode (#6) against their
     plain versions on the card, f32 and bf16, causal with and without a
     window, GQA, ragged lengths, rotated (rolling) positions with pads,
     and for #6 splits with no valid key and splits past the cache end;
     timed beside ``scaled_dot_product_attention`` (``library_ms``, never
     used by the port);
  6. lm_serve: ``greedy_generate(impl="pallas")`` serves h2o-danube-1.8b
     at full width (24 swa layers, d=2560, 32/8 heads, hd 80, window 4096,
     bf16 compute over fp32 weights drawn on the card from a seed) in two
     runs: (a) B=8, a 1024-token prompt from ``lm_data``, 32 new tokens;
     (b) B=1, a 4200-token prompt (past the window: the prefill's window
     mask and the rolling cache), 16 new tokens. Launches counted from
     zero: #5 = 24 per prefill, #6 = 24 per decode step. Checks:
     teacher-forced logits (prefill + 8 decode steps) of the kernel path
     against the plain path, in bf16 and in f32 compute; two runs of (a)
     bitwise equal; one ``task=`` decode step of a 3-head tree. Records
     the device time of one prefill at (a) and the bf16 GEMM reduction
     setting (``repro_torch`` pins it off);
  6b. lm_train: qwen1.5-0.5b at full width (24 layers, d=1024, 16 heads,
     d_ff 2816, padded vocab 152064, tied table, bf16 compute over fp32
     params drawn on the card from a seed, ``impl="chunked"``, per-block
     remat): (a) ``lm``, B=8 x 1024 ``lm_data`` tokens, 5 AdamW steps;
     (b) ``lm-mtl``, 4 tasks x 2 x 1024, 3 steps. Losses finite; #1
     launched once a step (the embedding's backward); #1 on one step's own
     embedding cotangent, in bf16 (the path) and f32, against its plain
     versions on the card (``_check_embed``); two 3-step runs of (a)
     bitwise equal; peak memory, one step's device time, its top kernels
     and host-clock ms. Then the ``segment_sum_2d`` kernel line: #1 at
     the embedding's shape, bitwise equal at the carried plan, timed beside
     it, the f32 one-hot plain version, the bf16 one-hot product the
     backward was before, ``index_add_`` and the byte bound;
  7. the ``kernels`` summary line (#1 ``segment_sum_2d`` apart from #2
     ``segment_sum`` since #1 runs every embedding's backward), the
     ``nvidia-smi`` line, and the final ``{"ok": true, "device": ...}``
     line.

``--profile`` adds device time by kernel (``torch.profiler``) for one
served GNN batch, one training step, one LM prefill and one decode step,
and the attention sweep: the device time of #5 over masks (beside SDPA on
the same inputs), and of #6 at LM decode runs (a) and (b), by kernel
name, over 1 / 2 / 3 / 4 / 9 / 17 / 33 splits and the default plan at
(a), beside SDPA and the bound. ``--sweep`` prints only the sweeps: #4 by
kernel at B=40 (no dpos) and B=8 (dpos); #3 by kernel at both, with a
hash of its outputs and their relative error against a float64 forward
(and, where the checkout's launcher takes them, its time over split
counts and column tiles); one training step's device time and host-clock
ms; #1 and #2 beside ``index_add_`` (and #1 at the LM embedding's
shape by node block, on ``lm_train``'s Zipf ids and on uniform ids),
that attention sweep, and the LM prefill's device time with its
teacher-forced bf16 error under the bf16 GEMM reduction setting in
force. ``--src DIR`` imports the port from another unpacked checkout;
with ``--sweep`` it times that checkout and this one in turns (parent,
change, change, parent), each turn in its own process, and ends with a
summary line of the kernels' times by turn:

    python3 chip_smoke.py --sweep --src build/parent/src

Any failure exits nonzero. Without a GPU, or without the repository around
it, the script exits nonzero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None          # the port must never reach JAX

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32, non-tensor
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
SS_TOL = 1e-5                      # segment-sum: f32 sums of <= ~60 terms
EDGE_TOL = 1e-4                    # egnn_edge: 866/1733-term contractions
                                   # grouped differently (node projections)
BWD_TOL = 1e-4                     # egnn_edge backward, per output and
                                   # relative to its largest entry: the
                                   # same regrouping, weight gradients
                                   # summed over up to B·A nodes
SERVE_TOL = 1e-4                   # full forward, 4 layers + heads
GRAD_TOL = 1e-4                    # train step grads vs the plain path,
                                   # per leaf, relative to its largest entry
ATTN_TOL_F32 = 2e-5                # flash kernels vs plain, x max(1, |ref|):
                                   # online softmax summed in another order
ATTN_RTOL_BF16 = 2.0 ** -7         # bf16, per element: |got - ref| <=
                                   # 2^-7 |ref| + the f32 tolerance; both
                                   # sides compute in f32 from the same
                                   # bf16 inputs and round once to bf16,
                                   # which moves a value by at most 1 ulp,
                                   # and 1 ulp is at most 2^-7 of it
LM_TOL_F32 = (2e-4, 2e-3)          # teacher-forced logits, f32 compute,
                                   # atol/rtol (repro's own test_serve)
LM_TOL_BF16 = 5e-2                 # ... bf16 compute, x max|ref logit|:
                                   # bf16 roundings of attention outputs
                                   # flip where the sums' order differs and
                                   # spread through the residual stream;
                                   # the two plain paths at full width on
                                   # the CPU differ by 0.026/0.046/0.064 at
                                   # 2/4/8 layers (max |logit| ~4.9), ~0.11
                                   # at 24 by sqrt(L); tolerance ~0.25
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
EDGE_BF16_TOL = 4e-2               # bf16 compute, x max(1, |ref|): #3,
                                   # served rows, grads per leaf (and
                                   # the loss, relative); repro's own bf16
                                   # tolerance (tests/test_egnn_paper_
                                   # shape.py): kernel and plain version
                                   # round to bf16 at other points (the
                                   # kernel's z is f32, the plain one's
                                   # bf16 per edge)
BF16_GRAD_NORM_TOL = 0.1           # bf16 compute, each gradient leaf's
                                   # |fused - plain| / |plain| (2-norms), as
                                   # well: a leaf of small gradients is held
                                   # to its own size. Read up to 2.1e-2 on
                                   # an H100 (heads/force/fc2/w); on the
                                   # CPU the port's leaves up to 4.5e-2
                                   # from repro's at bf16, repro's own bf16
                                   # from its f32 up to 3.9e-2 (tests/
                                   # test_torch_bf16.py); a zero or wrong
                                   # leaf reads ~1
N_REQUESTS = 80                    # mixed-head requests per serving pass
TRAIN_STEPS = 10
DEVICE = "cuda"                    # the serve_scaleout, train and lm_serve
                                   # phases' device


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(torch, fn, iters=20, warm=3) -> dict:
    """Device time of one call of ``fn`` (``ms``): the kernels it launches,
    summed from a ``torch.profiler`` trace of ``iters`` calls, also by
    kernel name (``by_kernel``, ms a call), and the kernels a call
    launches (``kernels_per_call``). Unlike CUDA events around the calls,
    it leaves out the device's idle time while the host prepares the next
    launch, which dominates calls of tens of us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    # a trace with no device event at all is the profiler's drop, not the
    # call's (its kernels ran in the warm-up): trace again, three at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel, launches = {}, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.device_time_total:
                name = (ev.key.split("(")[0].split("<")[0].split()
                        or [ev.key])[-1]
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + ev.device_time_total / iters / 1e3)
                launches += ev.count
        if launches:
            break
    return {"ms": sum(by_kernel.values()), "by_kernel": by_kernel,
            "kernels_per_call": launches / iters}


def device_ms(torch, fn, iters=20, warm=3) -> float:
    """``device_profile``'s device time of one call of ``fn``."""
    return device_profile(torch, fn, iters, warm)["ms"]


def scaled_err(torch, got, ref) -> tuple[float, float]:
    err = float((got.float() - ref.float()).abs().max())
    return err, max(1.0, float(ref.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def edge_case(torch, B, E, A, g, dev):
    src = torch.randint(0, A, (B, E), generator=g, device=dev)
    dst = torch.randint(0, A + 1, (B, E), generator=g, device=dev)  # A: pad
    em = (torch.rand((B, E), generator=g, device=dev) < 0.85) & (dst < A)
    return src, dst, em


def _ss_library(torch, msg, routed, em, A):
    """``index_add_`` computing the same sums (masked edges into a spare
    row): the one-call yardstick, never used by the port."""
    B = msg.shape[0] if msg.dim() == 3 else 1
    F = msg.shape[-1]
    b_off = A * torch.arange(B, device=msg.device)
    flat_idx = torch.where(
        em, routed + (b_off[:, None] if routed.dim() == 2 else 0),
        torch.full_like(routed, B * A)).reshape(-1)
    flat_msg = msg.reshape(-1, F)

    def library():
        torch.zeros((B * A + 1, F), device=msg.device).index_add_(
            0, flat_idx, flat_msg)
    return library


def _ss_bound(B, E, A, F, n_valid):
    """Bytes (valid messages, dst, output, f32) over HBM, or f32 adds over
    the FFMA peak, whichever is larger."""
    nbytes = 4 * (n_valid * F + B * E + B * A * F)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_valid * F / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def check_segment_sum(torch, dev, g):
    """#1/#2 against the plain version at the serve path's shape (B=8), a
    ragged E and one graph (2-D); each graph of the B=8 call bitwise equal
    to a call on that graph alone, in f32 and bf16; timed by device time
    (``torch.profiler``) beside ``index_add_``."""
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    cases = [("main", 8, 2048, 64, 866), ("ragged_e", 8, 1000, 64, 866),
             ("b1_2d", 1, 2048, 64, 866)]
    worst, out = 0.0, {}
    for name, B, E, A, F in cases:
        msg = torch.randn((B, E, F), generator=g, device=dev)
        _, dst, em = edge_case(torch, B, E, A, g, dev)
        if name == "b1_2d":
            msg, dst, em = msg[0], dst[0], em[0]
        got = ops.segment_sum(msg, dst, A, edge_mask=em)
        routed = torch.where(em, dst, torch.full_like(dst, A))
        ref = segment_sum_ref(msg, routed, A)
        torch.cuda.synchronize()
        err, scale = scaled_err(torch, got, ref)
        if not err <= SS_TOL * scale:
            fail(f"segment_sum {name}: max_abs_err {err} > {SS_TOL}*{scale}")
        worst = max(worst, err)
        if name == "main":
            # rows independent of the batch: graph b alone, same bits
            for dt in (torch.float32, torch.bfloat16):
                m = msg.to(dt)
                full = ops.segment_sum(m, dst, A, edge_mask=em)
                for b in range(B):
                    one = ops.segment_sum(m[b:b + 1], dst[b:b + 1], A,
                                          edge_mask=em[b:b + 1])
                    if not torch.equal(full[b], one[0]):
                        fail(f"segment_sum {dt}: graph {b} of the B={B} "
                             f"call differs bitwise from the graph alone")
            out["rows_bitwise_vs_b1"] = ["float32", "bfloat16"]
        if name == "ragged_e":
            continue
        d32 = routed.to(torch.int32).contiguous()
        n_valid = int(em.sum())
        ms = device_ms(torch, lambda: ops.segment_sum(msg, d32, A), iters=50)
        wall = time_ms(torch, lambda: ops.segment_sum(msg, d32, A), iters=50)
        plain = device_ms(torch, lambda: segment_sum_ref(msg, routed, A))
        lib = device_ms(torch, _ss_library(torch, msg, routed, em, A),
                        iters=50)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain,
                 "library_ms": lib, "library": "index_add_ (with its zero "
                 "fill)", "shape": [B, E, A, F], "valid_edges": n_valid,
                 **_ss_bound(B, E, A, F, n_valid)}
        if name == "main":
            out.update(timed)
        else:
            out[name] = timed          # segment_sum_2d's shape: one graph
    out["max_abs_err"] = worst
    return out


def _edge_fwd_bound(B, A, E, H, n_valid, bf16=False):
    """#3's least time on the card for these inputs: its three node-level
    products (2·B·A·H² each) on the tensor cores, in f32 compute as three
    TF32 products each (the 3xTF32 split), in bf16 (``bf16``) once each at
    the bf16 rate, plus ~8 operations per valid edge and column at the fp32
    peak (``bound_ms``), the same work all in fp32 FFMA
    (``bound_ffma_ms``), and the bytes (h, pos, src, dst and the weights
    read once; out and the scratch the backward reads, Pi, Pj, S and deg,
    written once; h, the weights and out in the compute dtype, the rest
    4 bytes a value) at HBM speed; each bound the larger of its operations
    time and the bytes time."""
    gemm_ops = 3 * 2 * B * A * H * H
    edge_ops = 8 * n_valid * H
    cd_bytes = 2 if bf16 else 4
    nbytes = cd_bytes * (2 * B * A * H + (2 * H + 1) * H + H * H + 2 * H) \
        + 4 * (B * A * 3 + 2 * B * E + 3 * B * A * H + B * A)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_gemm = gemm_ops / BF16_FLOPS if bf16 else 3 * gemm_ops / TF32_FLOPS
    t_tc = (t_gemm + edge_ops / FP32_FLOPS) * 1e3
    t_ffma = (gemm_ops + edge_ops) / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_ffma_ms": max(t_ffma, t_bytes),
            "operations": gemm_ops + edge_ops, "bytes": nbytes}


def _edge_fwd_inputs(torch, g, dev, B, A, E, H=866):
    """Seeded inputs of one forward call at (B, A, E, H): h, pos, φ_e as
    ``mlp_init`` draws it (biases of 0.1 scale) and edges."""
    import numpy as np

    from repro_torch.models.mlp import mlp_init
    phi = mlp_init(np.random.default_rng(B * 1000 + A), 2 * H + 1, H, H, 1,
                   device=dev)
    phi["fc0"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    phi["fc1"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    h = torch.randn((B, A, H), generator=g, device=dev)
    pos = 2.0 * torch.randn((B, A, 3), generator=g, device=dev)
    return h, pos, *edge_case(torch, B, E, A, g, dev), phi


def _edge_fwd_call(torch, h, pos, src, dst, em, phi, splits=None):
    """A closure that calls #3's launcher (``ops._launch_fwd``) once on
    routed int32 edges, as the autograd Function does, in h's dtype (the
    φ_e leaves already in it, so the call casts nothing), with the
    forward's planned blocks; returns (out, Pi, Pj, S, deg)."""
    from repro_torch.kernels.egnn_edge import ops
    B, A, H = h.shape
    E = src.shape[1]
    sr = torch.where(em, src, A).to(torch.int32).contiguous()
    dr = torch.where(em, dst, A).to(torch.int32).contiguous()
    blocks = ops._resolve_blocks(None, None, A, E, H)
    w = (phi["fc0"]["w"], phi["fc0"]["b"], phi["fc1"]["w"], phi["fc1"]["b"])
    kw = {} if splits is None else {"splits": splits}

    def call():
        return ops._launch_fwd(h, pos, sr, dr, *w, h.dtype, *blocks, **kw)
    return call


def _edge_fwd_plain(torch, h, pos, src, dst, em, phi, dtype=None):
    """The plain forward's outputs and scratch, (out, Pi, Pj, S, deg), from
    the node-projection algebra in plain PyTorch (``dtype``: float32, or
    float64 for an exact yardstick); ``out`` is ``egnn_edge_agg_ref``."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg_ref
    dt = dtype or torch.float32
    H = h.shape[-1]
    A = h.shape[1]
    cast = {k: {n: t.to(dt) for n, t in v.items()} for k, v in phi.items()}
    h, pos = h.to(dt), pos.to(dt)
    out = egnn_edge_agg_ref(h, pos, src, dst, em, cast)
    w0, b0 = cast["fc0"]["w"], cast["fc0"]["b"]
    pi, pj = h @ w0[:H] + b0, h @ w0[H:2 * H]
    valid = em & (dst < A)
    sc, dc = src.clamp(max=A - 1), dst.clamp(max=A - 1)

    def gather(x, i):
        return torch.take_along_dim(x, i[..., None], dim=1)
    d2 = ((gather(pos, sc) - gather(pos, dc)) ** 2).sum(-1, keepdim=True)
    z = gather(pi, sc) + gather(pj, dc) + d2 * w0[2 * H]
    s_e = z * torch.sigmoid(z) * valid[..., None]
    idx = torch.where(valid, dst, 0)
    S = torch.zeros_like(h).scatter_add_(1, idx[..., None].expand_as(s_e),
                                         s_e)
    deg = torch.zeros(h.shape[:2], dtype=dt, device=h.device).scatter_add_(
        1, idx, valid.to(dt))
    return out, pi, pj, S, deg


def _fwd_rel_errs(torch, got, want) -> dict:
    """Each of (out, Pi, Pj, S, deg)'s largest error over its largest
    entry."""
    return {n: float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))
            for n, a, b in zip(("out", "Pi", "Pj", "S", "deg"), got, want)}


def _fwd_gemm_library(torch, B, A, H, g, dev, dtype=None):
    """#3's three node-level products as ``torch.matmul`` calls in
    ``dtype`` (f32 with TF32 off, bf16 with f32 reduction, as
    ``repro_torch`` pins them): a yardstick for the GEMM part only, never
    used by the port."""
    dt = dtype or torch.float32
    hm, sm = (torch.randn((B * A, H), generator=g, device=dev).to(dt)
              for _ in range(2))
    w0i, w0j, w1 = (torch.randn((H, H), generator=g, device=dev).to(dt)
                    for _ in range(3))

    def library():
        hm @ w0i                                # Pi (b0 aside)
        hm @ w0j                                # Pj
        sm @ w1                                 # agg (deg ⊗ b1 aside)
    return library


EDGE_CASES = [("train", 40, 64, 2048), ("b8", 8, 64, 2048),
              ("b4", 4, 64, 2048), ("b2", 2, 64, 2048),
              ("b8_a16", 8, 16, 512), ("bucket", 40, 32, 128),
              ("ragged", 3, 40, 1000)]
EDGE_TIMED = ("train", "b8", "b4", "b2")


def check_egnn_edge(torch, dev, g, cd=None):
    """#3 through ``egnn_edge_agg`` in the compute dtype ``cd`` (None: f32;
    bf16 within ``EDGE_BF16_TOL``) against ``egnn_edge_agg_ref`` in it at
    ``EDGE_CASES``: the training path's shape (B=40: 5 sources x 8 graphs
    in one trunk pass), the serve batch's B=8 (A=64, and the bucket A=16,
    E=512: M = 128), B=4 (a task-parallel rank's, and a serve batch split
    over 2 entries), B=2 (split over 4), the training bucket (40, 32, 128)
    and a ragged shape. Two calls must give the same bits, each launching
    the kernel of its dtype once (``egnn_edge_agg.launches``, or
    ``.bf16``). In bf16 the kernel's and the plain version's error against
    a float64 forward on the same bf16 values are recorded. At
    ``EDGE_TIMED`` the launcher's scratch (Pi, Pj, S, deg: what the
    backward reads) and, in f32, its output are held per output against
    the plain versions (in bf16 that float64 forward) within ``EDGE_TOL``,
    and #3 is timed by device time with its kernels a call (at most 4; 3
    in bf16), beside ``torch.matmul`` of its three products in its dtype
    (``gemm_library_ms``) and, in bf16, the f32 #3 (``f32_ms``)."""
    from repro_torch.kernels.egnn_edge import (egnn_edge_agg,
                                               egnn_edge_agg_ref, gemm_plan)
    H = 866
    bf16 = cd == torch.bfloat16
    tol = EDGE_BF16_TOL if bf16 else EDGE_TOL
    kw = {"compute_dtype": cd} if bf16 else {}
    worst, out = 0.0, {}
    for name, B, A, E in EDGE_CASES:
        h32, pos, src, dst, em, phi = _edge_fwd_inputs(torch, g, dev, B, A, E)
        h = h32.bfloat16() if bf16 else h32
        before = (egnn_edge_agg.launches, egnn_edge_agg.bf16.launches)
        got = egnn_edge_agg(h, pos, src, dst, em, phi, **kw)
        again = egnn_edge_agg(h, pos, src, dst, em, phi, **kw)
        if (egnn_edge_agg.launches - before[0],
                egnn_edge_agg.bf16.launches - before[1]) != \
                ((0, 2) if bf16 else (2, 0)):
            fail(f"egnn_edge {cd} {name}: a call launched another kernel "
                 f"than #3 in its compute dtype")
        ref = egnn_edge_agg_ref(h, pos, src, dst, em, phi, **kw)
        torch.cuda.synchronize()
        if got.dtype != h.dtype or not torch.equal(got, again):
            fail(f"egnn_edge {cd} {name}: out in {got.dtype}, or two calls "
                 f"differ bitwise")
        err, scale = scaled_err(torch, got, ref)
        if not err <= tol * scale:
            fail(f"egnn_edge {cd} {name}: max_abs_err {err} > {tol}*{scale}")
        worst = max(worst, err)
        case = {"shape": [B, A, E, H], "max_abs_err": err}
        # φ_e's leaves in the compute dtype, as the op casts them (so the
        # timed launch casts nothing); in bf16 the float64 forward runs on
        # those values
        cphi = {k: {n: t.to(h.dtype) for n, t in v.items()}
                for k, v in phi.items()}
        if bf16:
            exact = _edge_fwd_plain(torch, h, pos, src, dst, em, cphi,
                                    dtype=torch.float64)
            e64 = float(exact[0].abs().max().clamp_min(1.0))
            case["kernel_vs_f64"] = float(
                (got.double() - exact[0]).abs().max()) / e64
            case["plain_vs_f64"] = float(
                (ref.double() - exact[0]).abs().max()) / e64
        del got, again, ref
        if name not in EDGE_TIMED:
            out[name] = case
            continue
        call = _edge_fwd_call(torch, h, pos, src, dst, em, cphi)
        errs = _fwd_rel_errs(torch, call(), exact if bf16 else
                             _edge_fwd_plain(torch, h, pos, src, dst, em,
                                             phi))
        if bf16:
            del errs["out"]            # bf16: held above within tol
        for n, e in errs.items():
            if not e <= EDGE_TOL:
                fail(f"egnn_edge {cd} {name} {n}: relative error {e} > "
                     f"{EDGE_TOL}")
        prof = device_profile(torch, call)
        most = 3 if bf16 else 4
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge {cd} {name}: {prof['kernels_per_call']} "
                 f"kernels a call, the design has at most {most}")
        n_valid = int(em.sum())
        case.update({
            "ms": prof["ms"], "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "wall_ms": time_ms(torch, call),
            "plain_ms": device_ms(torch, lambda: egnn_edge_agg_ref(
                h, pos, src, dst, em, phi, **kw), iters=3, warm=1),
            "library_ms": None,
            "library_note": "no one PyTorch call computes this forward",
            "gemm_library_ms": device_ms(torch, _fwd_gemm_library(
                torch, B, A, H, g, dev, cd)),
            "valid_edges": n_valid, "rel_err": errs,
            **_edge_fwd_bound(B, A, E, H, n_valid, bf16)})
        if bf16:
            case["f32_ms"] = device_ms(torch, _edge_fwd_call(
                torch, h32, pos, src, dst, em, phi))
        else:
            case["splits"] = list(gemm_plan.fwd_splits(B * A, H))
        if name == "train":
            out.update(case)
        else:
            out[name] = case
    out["max_abs_err"] = worst
    return out


def _edge_bwd_inputs(torch, g, dev, B, A, E, H=866):
    """Seeded leaves (h, pos, fc0 w/b, fc1 w/b), edges and the upstream
    cotangent of one edge-path call at (B, A, E, H)."""
    def t(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)
                ).requires_grad_(True)
    w0, b0 = t(2 * H + 1, H, scale=(2 * H + 1) ** -0.5), t(H, scale=0.1)
    w1, b1 = t(H, H, scale=H ** -0.5), t(H, scale=0.1)
    h, pos = t(B, A, H), t(B, A, 3, scale=2.0)
    src, dst, em = edge_case(torch, B, E, A, g, dev)
    gup = torch.randn((B, A, H), generator=g, device=dev)
    return [h, pos, w0, b0, w1, b1], (src, dst, em), gup


def _edge_bwd_call(torch, leaves, edges, gup, need_dpos):
    """A closure that calls #4's wrapper (``ops.egnn_edge_bwd``) once on the
    forward kernel's scratch for these inputs, as the autograd Function
    does, with the backward's planned blocks; and the routed src/dst."""
    from repro_torch.kernels.egnn_edge import ops
    h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
    src, dst, em = edges
    B, A, H = h.shape
    E = src.shape[1]
    sr = torch.where(em, src, A).to(torch.int32).contiguous()
    dr = torch.where(em, dst, A).to(torch.int32).contiguous()
    fwd = ops._resolve_blocks(None, None, A, E, H)
    _, pi, pj, s, deg = ops._launch_fwd(h, pos, sr, dr, w0, b0, w1, b1,
                                        torch.float32, *fwd)
    be, bh = ops._resolve_blocks(None, None, A, E, H, bwd=True)

    def call():
        return ops.egnn_edge_bwd(gup, h, pos, sr, dr, w0, w1, pi, pj, s, deg,
                                 block_e=be, block_h=bh, need_dpos=need_dpos)
    return call, sr, dr


def _edge_bwd_bounds(B, A, E, H, n_valid, need_dpos, bf16=False):
    """#4's least time on the card for these inputs: its six node-level
    products (2·B·A·H² each) on the tensor cores in the fewest passes that
    give each to the f32 contract, plus ~15 operations per valid edge and
    column at the fp32 peak (``bound_ms``); the same work all in fp32 FFMA
    (``bound_ffma_ms``); and the bytes (inputs g, h, Pi, Pj, S, deg, pos,
    src, dst and the weights read once, g, h and the weights 2 bytes a
    value in bf16, outputs written once, f32) at HBM speed; each bound the
    larger of its operations time and the bytes time. On f32 inputs a
    product takes three TF32 passes (the 3xTF32 split). On bf16 g, h and
    weights (``bf16``) a bf16 value's TF32 lo part is zero: the five
    products that mix an f32 operand with a bf16 one (S·g, h·dPi, h·dPj,
    dPi·w0i, dPj·w0j) need two TF32 passes each, and g·w1ᵀ (bf16 by bf16)
    one pass at the bf16 rate; the kernel runs three TF32 passes of each
    all the same (its bits are the f32 launch's)."""
    prod = 2 * B * A * H * H
    gemm_ops = 6 * prod
    edge_ops = 15 * n_valid * H
    w_bytes = (2 * H + 1) * H + H * H
    dpos = B * A * 3 if need_dpos else 0
    in_bytes = 2 if bf16 else 4
    nbytes = in_bytes * (2 * B * A * H + w_bytes) + 4 * (
        3 * B * A * H + B * A + B * A * 3 + 2 * B * E + B * A * H + dpos
        + w_bytes + 2 * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_gemm = (5 * 2 * prod / TF32_FLOPS + prod / BF16_FLOPS if bf16
              else 3 * gemm_ops / TF32_FLOPS)
    t_tc = (t_gemm + edge_ops / FP32_FLOPS) * 1e3
    t_ffma = (gemm_ops + edge_ops) / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_ffma_ms": max(t_ffma, t_bytes),
            "operations": gemm_ops + edge_ops, "bytes": nbytes}


def _gemm_library(torch, B, A, H, g, dev):
    """The six node-level products of #4 as ``torch.matmul`` calls (TF32
    off, as ``repro_torch`` pins it): a yardstick for the GEMM part only,
    never used by the port."""
    M = B * A
    x = [torch.randn((M, H), generator=g, device=dev) for _ in range(5)]
    gm, sm, hm, dpi, dpj = x
    w0i, w0j, w1 = (torch.randn((H, H), generator=g, device=dev)
                    for _ in range(3))

    def library():
        gm @ w1.T                               # dS
        sm.T @ gm                               # dw1
        dpi @ w0i.T + dpj @ w0j.T               # dh
        hm.T @ dpi                              # dw0i
        hm.T @ dpj                              # dw0j
    return library


def check_egnn_edge_bwd(torch, dev, g):
    """The backward kernel through ``egnn_edge_agg``'s autograd Function
    against ``egnn_edge_bwd_ref``, per output, at the training path's shape
    (B=40: 5 sources x 8 graphs in one trunk pass, pos needing no gradient),
    at the serve batch's B=8 with dpos, at a task-parallel rank's B=4
    without, and at a ragged shape; two backward calls must give the same
    bits. #4 is timed by device time at B=40, B=8 and B=4, with its kernels
    a call (at most 3 without dpos, 4 with)."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg, gemm_plan, ops
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    H = 866
    names = ("dh", "dpos", "dw0", "db0", "dw1", "db1")
    cases = [("train", 40, 64, 2048, False), ("b8", 8, 64, 2048, True),
             ("b4", 4, 64, 2048, False), ("ragged", 3, 40, 1000, True)]
    worst, out = 0.0, {}
    for name, B, A, E, need_dpos in cases:
        leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, A, E, H)
        h, pos, w0, b0, w1, b1 = leaves
        src, dst, em = edges
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        wrt = leaves if need_dpos else [h, w0, b0, w1, b1]
        agg = egnn_edge_agg(h, pos if need_dpos else pos.detach(), src, dst,
                            em, phi)

        def bwd():
            return torch.autograd.grad(agg, wrt, gup, retain_graph=True)
        got = bwd()
        again = bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"egnn_edge_bwd {name}: two calls differ bitwise")
        if not need_dpos:
            got = got[:1] + (None,) + got[1:]
        sr = torch.where(em, src, A)
        dr = torch.where(em, dst, A)
        d = [x.detach() for x in leaves]

        def plain():
            return egnn_edge_bwd_ref(gup, d[0], d[1], sr, dr, d[2][:H],
                                     d[2][H:2 * H], d[2][2 * H:],
                                     d[3][None], d[4])
        dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = plain()
        want = [dh, dpos, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
        errs = {}
        for n, a, b in zip(names, got, want):
            if a is None:
                continue
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            if not err <= BWD_TOL * scale:
                fail(f"egnn_edge_bwd {name} {n}: max_abs_err {err} > "
                     f"{BWD_TOL}*{scale}")
            errs[n] = err / scale
            worst = max(worst, err)
        del want, dh, dpos, dw0i, dw0j
        if name == "ragged":
            out["ragged_rel_err"] = errs
            continue
        call, _, _ = _edge_bwd_call(torch, leaves, edges, gup, need_dpos)
        prof = device_profile(torch, call)
        most = 4 if need_dpos else 3
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge_bwd {name}: {prof['kernels_per_call']} kernels "
                 f"a call, the design has at most {most}")
        n_valid = int(em.sum())
        case = {"ms": prof["ms"], "by_kernel": prof["by_kernel"],
                "kernels_per_call": prof["kernels_per_call"],
                "wall_ms": time_ms(torch, call),
                "plain_ms": time_ms(torch, plain, iters=3, warm=1),
                "library_ms": None,
                "library_note": "no one PyTorch call computes this backward",
                "gemm_library_ms": device_ms(
                    torch, _gemm_library(torch, B, A, H, g, dev)),
                "shape": [B, A, E, H], "dpos": need_dpos,
                "valid_edges": n_valid, "rel_err": errs,
                **_edge_bwd_bounds(B, A, E, H, n_valid, need_dpos)}
        if name == "train":
            case["w1_splits"] = gemm_plan.w1_splits(B * A, H)
            plan = gemm_plan.launches(B, A, H)
            case["gemm_items"] = [gemm_plan.launch_items(x) for x in plan]
            case["gemm_makespan_ksteps"] = [
                gemm_plan.makespan(gemm_plan.launch_ksteps(x)) for x in plan]
            case["gemm_slots"] = (ops.gemm_blocks_per_sm()
                                  * torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
            out.update(case)
        else:
            out[name] = case
        del agg, got, again
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def serve_rel_err(a, b) -> float:
    """The largest difference of served rows ``a`` from ``b``, energies and
    forces, each over max(1, |b|)."""
    e = max(abs(x["energy"] - y["energy"]) /
            max(1.0, abs(y["energy"])) for x, y in zip(a, b))
    f = max(float(abs(x["forces"] - y["forces"]).max()) /
            max(1.0, float(abs(y["forces"]).max())) for x, y in zip(a, b))
    return max(e, f)


def rows_bitwise(a, b) -> bool:
    return all(x["energy"] == y["energy"] and
               x["forces"].shape == y["forces"].shape and
               bool((x["forces"] == y["forces"]).all()) for x, y in zip(a, b))


def serve_pass(torch, impl, params, spec, samples, heads, counters,
               cfg=None):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.serve import ServeSession
    cfg = (cfg or CONFIG).replace(segment_sum_impl=impl)
    with ServeSession(params, cfg, spec=spec, max_batch=8, max_wait_ms=20.0,
                      device="cuda") as srv:
        t0 = time.perf_counter()
        n_shapes = srv.warmup()
        warm_s = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        futs = srv.submit_many(samples, heads)
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        snap = srv.stats()
        for r, s in zip(res, samples):
            n = int(s["node_mask"].sum())
            if not (math.isfinite(r["energy"]) and r["forces"].shape == (n, 3)
                    and bool(torch.isfinite(torch.from_numpy(
                        r["forces"])).all())):
                fail(f"{impl}: non-finite or misshapen result")
        for i in range(0, len(samples), max(1, len(samples) // 4)):
            one = srv.predict_one(samples[i], head=heads[i])
            if not (one["energy"] == res[i]["energy"] and
                    (one["forces"] == res[i]["forces"]).all()):
                fail(f"{impl}: batched row {i} not bitwise equal to "
                     f"predict_one")
    c = snap["counters"]
    return res, {"impl": impl, "requests": len(res),
                 "batches": c["batches"], "launches": launches,
                 "shapes": n_shapes, "warmup_s": warm_s, "wall_s": wall,
                 "requests_per_s": len(res) / wall,
                 "e2e_ms": {k: snap["latency"]["e2e"][k]
                            for k in ("p50_ms", "p99_ms")},
                 "compute_ms": {k: snap["latency"]["compute"][k]
                                for k in ("p50_ms", "p99_ms")}}


def serve_inputs(n_requests):
    """The serving phases' seeded inputs: five synthetic sources, the bucket
    grid planned from them, hydragnn-gfm params (seed 0) and
    ``n_requests`` mixed-head requests, source by source in turn."""
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.data.synthetic_atoms import (generate_mixture,
                                                  source_dicts)
    sources = source_dicts(generate_mixture(200, max_atoms=64,
                                            max_edges=2048, seed=0))
    spec = BucketSpec.from_sources(sources)
    params = gfm_mtl_init(CONFIG, CONFIG.n_tasks, seed=0)
    samples, heads = [], []
    for i in range(n_requests):
        t = i % len(sources)
        s = sources[t]
        j = (i // len(sources)) % s["species"].shape[0]
        samples.append({k: v[j] for k, v in s.items()})
        heads.append(t)
    return spec, params, samples, heads


def serve_phase(torch, n_requests):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.serve import ServeSession

    spec, params, samples, heads = serve_inputs(n_requests)
    counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                "segment_sum": ss_ops.segment_sum}
    res_f, info_f = serve_pass(torch, "fused", params, spec, samples, heads,
                               counters)
    res_p, info_p = serve_pass(torch, "pallas", params, spec, samples, heads,
                               counters)
    if not (info_f["launches"]["egnn_edge"] == 4 * info_f["batches"] > 0
            and info_f["launches"]["segment_sum"] == 0):
        fail(f"fused pass launch counts {info_f['launches']} vs "
             f"{info_f['batches']} batches")
    if not (info_p["launches"]["segment_sum"] == 4 * info_p["batches"] > 0
            and info_p["launches"]["egnn_edge"] == 0):
        fail(f"pallas pass launch counts {info_p['launches']} vs "
             f"{info_p['batches']} batches")

    fused_vs_pallas = serve_rel_err(res_f, res_p)
    if not fused_vs_pallas <= SERVE_TOL:
        fail(f"fused vs pallas serve results differ: {fused_vs_pallas}")
    # the plain forward (one-hot segment-sum, no kernel) on a few requests
    idx = list(range(0, n_requests, max(1, n_requests // 8)))
    with ServeSession(params, CONFIG.replace(segment_sum_impl="jnp"),
                      spec=spec, max_batch=8, device="cuda") as plain:
        res_plain = [plain.predict_one(samples[i], head=heads[i])
                     for i in idx]
    vs_plain = serve_rel_err([res_f[i] for i in idx], res_plain)
    if not vs_plain <= SERVE_TOL:
        fail(f"fused serve results differ from the plain forward: {vs_plain}")
    return {"phase": "serve", "config": "hydragnn-gfm", "heads":
            CONFIG.n_tasks, "bucket_spec": [list(spec.atom_buckets),
                                            list(spec.edge_buckets)],
            "fused": info_f, "pallas": info_p,
            "fused_vs_pallas_rel_err": fused_vs_pallas,
            "fused_vs_plain_rel_err": vs_plain, "tolerance": SERVE_TOL}, \
        res_f


# ---------------------------------------------------------------------------
# phase 3b: serving scale-out at full width
# ---------------------------------------------------------------------------

SCALEOUT_REQUESTS = 160              # mixed-head requests of (a) and (d)
SCALEOUT_REPLICAS = 8                # (a): replicas on the one card
SHARD_WAYS = (2, 4)                  # (d): mesh entries a batch splits over


def _served(futs) -> list:
    return [f.result(timeout=600) for f in futs]


def _crash_replica(rep, r, sample):
    """Crash replica ``r`` as tests/test_serve_scaleout.py does: its next
    ``batcher.add`` raises and the worker's handler closes its queue; the
    trigger request must fail. Waits until the queue is closed."""
    def boom(req):
        raise RuntimeError(f"injected fault in replica {r}")
    rep.replicas[r].batcher.add = boom
    err = rep.submit(sample, head=r % rep.n_heads).exception(timeout=600)
    if not isinstance(err, RuntimeError):
        fail(f"serve_scaleout (b): replica {r}'s trigger gave {err!r}")
    deadline = time.monotonic() + 60.0
    while not rep.replicas[r].queue.closed:
        if time.monotonic() > deadline:
            fail(f"serve_scaleout (b): replica {r}'s queue never closed")
        time.sleep(0.005)


def serve_scaleout_phase(torch, serve, counters):
    """Multi-device serving on the one card at full width: (a) 8 replicas
    (8 streams, 8 param copies) behind the router; (b) failover, every
    replica dead, ``restart_workers``; (c) close under load; (d) rows split
    over 2 and 4 entries under ``"fused"`` and ``"pallas"``. ``counters``
    are zeroed just before (a)'s and each (d) run's requests."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serve import (ReplicaServeSession, ServeClosedError,
                                   ServeSession)
    spec, params, samples, heads = serve_inputs(SCALEOUT_REQUESTS)
    cards = lambda n: [DEVICE] * n                       # noqa: E731
    single = {}
    for impl in ("fused", "pallas"):
        with ServeSession(params, CONFIG.replace(segment_sum_impl=impl),
                          spec=spec, max_batch=8, device=DEVICE) as one:
            single[impl] = [one.predict_one(s, head=h)
                            for s, h in zip(samples, heads)]
    refs = single["fused"]
    cfg = CONFIG.replace(segment_sum_impl="fused")
    out = {"phase": "serve_scaleout", "config": "hydragnn-gfm",
           "requests": SCALEOUT_REQUESTS, "tolerance": SERVE_TOL}

    # (a) replicas
    rep = ReplicaServeSession(
        params, cfg, spec=spec, max_batch=8, max_wait_ms=20.0,
        meshes=make_replica_meshes(SCALEOUT_REPLICAS,
                                   devices=cards(SCALEOUT_REPLICAS)))
    with rep:
        t0 = time.perf_counter()
        shapes = rep.warmup()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        firsts = [next(iter(interop.leaves(s._entries[0].shared).values()))
                  for s in rep.replicas]
        storages = {t.untyped_storage().data_ptr() for t in firsts}
        streams = {s._entries[0].stream for s in rep.replicas}
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = _served(rep.submit_many(samples, heads))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        st = rep.stats()
    c = st["counters"]
    checks = {
        "rows_bitwise_vs_single": rows_bitwise(res, refs),
        "routed": c["routed"] == SCALEOUT_REQUESTS,
        "outstanding_zero": st["scheduler"]["outstanding"]
        == [0] * SCALEOUT_REPLICAS,
        "param_storages": len(storages) == SCALEOUT_REPLICAS,
        "streams": len(streams) == SCALEOUT_REPLICAS,
        "launches": launches["egnn_edge"] == 4 * c["batches"] > 0
        and launches["segment_sum"] == 0,
        "shapes": shapes <= spec.n_shapes * SCALEOUT_REPLICAS}
    if not all(checks.values()):
        fail(f"serve_scaleout (a): {checks}, launches {launches}, "
             f"{c['batches']} batches")
    fused = serve["fused"]
    out["a_replicas"] = {
        "replicas": SCALEOUT_REPLICAS, "impl": "fused", "checks": checks,
        "batches": c["batches"], "launches": launches, "shapes": shapes,
        "warmup_s": warm_s, "wall_s": wall,
        "requests_per_s": SCALEOUT_REQUESTS / wall,
        "e2e_ms": {k: st["latency"]["e2e"][k] for k in ("p50_ms", "p99_ms")},
        "compute_ms": {k: st["latency"]["compute"][k]
                       for k in ("p50_ms", "p99_ms")},
        "plan": st["plan"],
        "serve_fused_pass": {k: fused[k] for k in ("requests", "wall_s",
                                                   "requests_per_s",
                                                   "e2e_ms")}}

    # (b) failover, every replica dead, recovery
    rep = ReplicaServeSession(params, cfg, spec=spec, max_batch=8,
                              max_wait_ms=1.0,
                              meshes=make_replica_meshes(2, devices=cards(2)))
    with rep:
        sm, h = samples[0], heads[0]            # head 0: replica 0's key
        _crash_replica(rep, 0, sm)
        got = rep.submit(sm, head=h).result(timeout=600)
        failover_ok = rows_bitwise([got], [refs[0]]) and \
            0 in rep.scheduler.dead and rep.metrics.counters["failovers"] >= 1
        _crash_replica(rep, 1, sm)
        try:
            rep.submit(sm, head=h)
            all_dead_raises = False
        except ServeClosedError:
            all_dead_raises = True
        restarted = rep.restart_workers()
        after = _served(rep.submit_many(samples[:16], heads[:16]))
        recovered_ok = rows_bitwise(after, refs[:16])
        st = rep.stats()
    checks = {"failover_bitwise": failover_ok,
              "all_dead_raises": all_dead_raises,
              "restarted": restarted == 2,
              "recovered_bitwise": recovered_ok}
    if not all(checks.values()):
        fail(f"serve_scaleout (b): {checks}")
    out["b_failover"] = {"replicas": 2, "checks": checks,
                         "failovers": st["counters"]["failovers"],
                         "worker_failures": st["counters"]["worker_failures"],
                         "worker_restarts": st["counters"]["worker_restarts"]}

    # (c) close under load
    rep = ReplicaServeSession(
        params, cfg, spec=spec, max_batch=8, max_wait_ms=100.0,
        meshes=make_replica_meshes(SCALEOUT_REPLICAS,
                                   devices=cards(SCALEOUT_REPLICAS)))
    burst = rep.submit_many(samples[:40], heads[:40])
    t0 = time.perf_counter()
    rep.close()
    close_s = time.perf_counter() - t0
    try:
        rep.submit(samples[0], head=heads[0])
        after_close = "accepted"
    except ServeClosedError as e:
        after_close = type(e).__name__
    checks = {"all_done": all(f.done() for f in burst),
              "all_ok": all(f.exception() is None for f in burst),
              "rows_bitwise": rows_bitwise([f.result() for f in burst
                                            if f.exception() is None],
                                           refs[:40]),
              "after_close": after_close == "ServeClosedError"}
    if not all(checks.values()):
        fail(f"serve_scaleout (c): {checks}")
    out["c_close"] = {"requests": 40, "checks": checks, "close_s": close_s}

    # (d) a bin's rows split over a mesh of entries on the card
    out["d_sharded"] = []
    for impl, counter in (("fused", "egnn_edge"), ("pallas", "segment_sum")):
        cfg_i = CONFIG.replace(segment_sum_impl=impl)
        for n in SHARD_WAYS:
            mesh = make_replica_meshes(1, devices_per_replica=n,
                                       devices=cards(n))[0]
            with ServeSession(params, cfg_i, spec=spec, max_batch=8,
                              mesh=mesh, max_wait_ms=20.0) as sh:
                sh.warmup()
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                res = _served(sh.submit_many(samples, heads))
                wall = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                st = sh.stats()
                own = [sh.predict_one(s, head=h)
                       for s, h in zip(samples, heads)]
            try:
                ServeSession(params, cfg_i, spec=spec, max_batch=6,
                             mesh=make_replica_meshes(
                                 1, devices_per_replica=4,
                                 devices=cards(4))[0])
                uneven_raises = False
            except ValueError:
                uneven_raises = True
            b = st["counters"]["batches"]
            other = "segment_sum" if counter == "egnn_edge" else "egnn_edge"
            vs_single = serve_rel_err(res, single[impl])
            checks = {"rows_bitwise_vs_own": rows_bitwise(res, own),
                      "within_tol_of_single": vs_single <= SERVE_TOL,
                      "plan": st["plan"]["mode"] == "sharded"
                      and st["plan"]["devices"] == n,
                      "launches": launches[counter] == 4 * n * b > 0
                      and launches[other] == 0,
                      "uneven_raises": uneven_raises}
            if not all(checks.values()):
                fail(f"serve_scaleout (d) {impl} n={n}: {checks}, "
                     f"launches {launches}, {b} batches, vs single "
                     f"{vs_single}")
            out["d_sharded"].append({
                "impl": impl, "entries": n, "rows_a_chunk": 8 // n,
                "checks": checks, "batches": b, "launches": launches,
                "bitwise_vs_single": rows_bitwise(res, single[impl]),
                "rel_err_vs_single": vs_single, "wall_s": wall,
                "requests_per_s": SCALEOUT_REQUESTS / wall,
                "e2e_ms": {k: st["latency"]["e2e"][k]
                           for k in ("p50_ms", "p99_ms")}})
    out["launches"] = {
        "egnn_edge": out["a_replicas"]["launches"]["egnn_edge"] + sum(
            d["launches"]["egnn_edge"] for d in out["d_sharded"]),
        "segment_sum": sum(d["launches"]["segment_sum"]
                           for d in out["d_sharded"])}
    return out


# ---------------------------------------------------------------------------
# phase 4: training at full width
# ---------------------------------------------------------------------------

def _embed_order_sum(torch, g, ids, V):
    """#1's function by plain PyTorch in #1's own order: each row's f32
    sum of its cotangent rows in token order, from 0, rounded once to g's
    dtype (one elementwise add for each rank within an id)."""
    ids = ids.long()
    sid, order = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(sid, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    gf = g.float()
    acc = torch.zeros((uniq.numel(), g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for r in range(int(counts.max())):
        live = counts > r
        acc[live] = acc[live] + gf[order[start[live] + r]]
    out = torch.zeros((V, g.shape[1]), dtype=torch.float32, device=g.device)
    out[uniq] = acc
    return out.to(g.dtype)


def _capture_embed(fn):
    """``fn()`` with every call of ``kernels.segment_sum`` recorded (the
    name the embedding's backward imports when it runs): fn's result and
    each call's (cotangent, ids, rows, output)."""
    from repro_torch.kernels import segment_sum as ss_pkg
    seen, real = [], ss_pkg.segment_sum

    def capture(messages, dst, n_nodes, **kw):
        out = real(messages, dst, n_nodes, **kw)
        seen.append((messages.detach().clone(), dst.clone(), n_nodes,
                     out.clone()))
        return out
    ss_pkg.segment_sum = capture
    try:
        return fn(), seen
    finally:
        ss_pkg.segment_sum = real


def _check_embed(torch, calls, what):
    """#1 on a training step's own embedding cotangent (``_capture_embed``
    of the step: one call), in the step's dtype and launched again on the
    cotangent in the other one (f32 <-> bf16): bitwise equal to
    ``_embed_order_sum``, and within the two orders' rounding bound of
    the one-hot plain version (``segment_sum_ref``): 2 n u sum|g| for an
    id of n rows, u = 2^-24, plus one bf16 rounding (2^-7 |ref|) in
    bf16. ``rel_err`` is the error over the largest |ref|. The extra
    launch is not counted."""
    from repro_torch.kernels.segment_sum import (ops, segment_sum,
                                                 segment_sum_ref)
    if len(calls) != 1:
        fail(f"{what}: the step made {len(calls)} 2-D segment sums, the "
             "design implies one (the embedding's backward)")
    g, ids, V, out = calls[0]
    other = torch.float32 if g.dtype == torch.bfloat16 else torch.bfloat16
    ids64 = ids.long()
    n = ids64.bincount(minlength=V).float()[:, None]
    rec = {"shape": [int(g.shape[0]), V, int(g.shape[1])],
           "dtype": str(g.dtype).replace("torch.", ""),
           "distinct_ids": int(ids64.unique().numel()),
           "top_id_count": int(n.max())}
    launches = ops.segment_sum.two_d.launches
    for gx, got in ((g, out), (g.to(other), segment_sum(g.to(other), ids,
                                                        V))):
        name = str(gx.dtype).replace("torch.", "")
        if not torch.equal(got, _embed_order_sum(torch, gx, ids, V)):
            fail(f"{what} #1 {name}: not bitwise equal to the token-order "
                 "sum")
        ref = segment_sum_ref(gx, ids, V).float()
        bound = 2 * 2.0 ** -24 * n * segment_sum_ref(
            gx.float().abs(), ids, V)
        if gx.dtype == torch.bfloat16:
            bound = bound + ATTN_RTOL_BF16 * ref.abs()
        diff = (got.float() - ref).abs()
        excess = float((diff - bound).max())
        err, top = float(diff.max()), float(ref.abs().max())
        if not excess <= 0:
            fail(f"{what} #1 {name}: |got - one-hot| exceeds the rounding "
                 f"bound by {excess}")
        rec[name] = {"bitwise_vs_token_order": True, "max_abs_err": err,
                     "rel_err": err / max(top, 1e-30), "max_abs_ref": top,
                     "excess_over_bound": excess}
        del ref, bound, diff
    torch.cuda.synchronize()
    ops.segment_sum.two_d.launches = launches
    return rec


def _train_session(torch, sources, steps, ckpt=None, cfg=None):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.engine import Session, SessionConfig
    cfg = (cfg or CONFIG).replace(segment_sum_impl="fused")
    scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=steps,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, ckpt_path=ckpt,
                         verbose=False)
    return Session.from_config(scfg, sources=sources, device=DEVICE)


def _train_sources():
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(32, max_atoms=64, max_edges=2048,
                                     seed=0))


def train_phase(torch, counters):
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.engine import multitask_grad_fn
    from repro_torch.serve import ServeSession

    sources = _train_sources()
    ckpt = str(ROOT / "build" / "chip_smoke" / "gfm_train")
    sess = _train_session(torch, sources, TRAIN_STEPS, ckpt)
    n_params = sess.n_params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        result = sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    rows = result.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train: losses {losses}")
    # one trunk pass a step: 4 layers each way, and one species
    # embedding's backward (#1)
    want = {"egnn_edge": 4 * TRAIN_STEPS, "egnn_edge_bwd": 4 * TRAIN_STEPS,
            "segment_sum": 0, "segment_sum_2d": TRAIN_STEPS}
    if launches != want:
        fail(f"train launch counts {launches}, design implies {want}")
    # steady step time: host clock between the loss reads of steps 1 and
    # the last (every step is logged, so each row ends in a sync)
    step_ms = (rows[-1]["wall"] - rows[1]["wall"]) / (TRAIN_STEPS - 2) * 1e3

    # one step's gradients against the plain path on the same batch
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             GroupBatcher(sources, 8, seed=1).next_batch().items()}
    params = result.params
    grads = {}
    for impl in ("fused", "jnp"):
        model = make_gfm_mtl(CONFIG.replace(segment_sum_impl=impl),
                             len(sources))
        (loss, metrics, g), calls = _capture_embed(
            lambda: multitask_grad_fn(model, len(sources))(params, batch))
        grads[impl] = (float(loss), interop.leaves(g))
        if impl == "fused":
            embed_grad = _check_embed(torch, calls, "train")
        elif calls:
            fail("train: the plain path launched #1")
    torch.cuda.synchronize()
    worst_leaf, worst = None, 0.0
    for k, ref in grads["jnp"][1].items():
        got = grads["fused"][1][k]
        scale = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / max(scale, 1e-30)
        if not rel <= GRAD_TOL:
            fail(f"train grad {k}: relative error {rel} > {GRAD_TOL}")
        if rel >= worst:
            worst_leaf, worst = k, rel
    loss_rel = abs(grads["fused"][0] - grads["jnp"][0]) / abs(grads["jnp"][0])
    if not loss_rel <= GRAD_TOL:
        fail(f"train loss fused vs plain: relative error {loss_rel}")

    # bitwise replay: two 3-step runs from one seed
    ends = []
    for _ in range(2):
        with _train_session(torch, sources, 3) as s:
            ends.append(interop.leaves(s.run().params))
    torch.cuda.synchronize()
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail("train: two 3-step runs from one seed end with different "
             "parameters")

    # serve from the written checkpoint
    cfg = CONFIG.replace(segment_sum_impl="fused")
    samples = [({k: s[k][i] for k in ("species", "pos", "edge_src",
                                      "edge_dst", "node_mask", "edge_mask")},
                t) for t, s in enumerate(sources) for i in range(2)]
    with ServeSession.from_checkpoint(ckpt, cfg, max_batch=8,
                                      device=DEVICE) as srv:
        futs = [srv.submit(x, head=t) for x, t in samples]
        served = [f.result(timeout=600) for f in futs]
    if not all(math.isfinite(r["energy"]) and
               bool(torch.isfinite(torch.from_numpy(r["forces"])).all())
               for r in served):
        fail("serving from the trained checkpoint gave non-finite results")
    return {"phase": "train", "config": "hydragnn-gfm",
            "impl": "fused", "steps": TRAIN_STEPS, "tasks": len(sources),
            "batch_per_task": 8, "graphs_per_step": 8 * len(sources),
            "params": n_params, "losses": losses, "launches": launches,
            "wall_s": wall, "step_ms": step_ms, "peak_mem_bytes": peak,
            "grad_vs_plain": {"worst_leaf": worst_leaf, "rel_err": worst,
                              "loss_rel_err": loss_rel,
                              "tolerance": GRAD_TOL},
            "embed_grad": embed_grad,
            "replay_bitwise": True, "served_from_ckpt": len(served)}


# ---------------------------------------------------------------------------
# phase 4b: the multi-source pre-training path at full width
# ---------------------------------------------------------------------------

PIPE_STEPS = 10                     # steps of runs (a) and (b)
SOAK_STEPS = 12                     # accepted steps of the soak (d)
# the soak's faults, pinned to runner ticks (repro's soak covers the same
# five kinds): a NaN rollback, a spike rollback, a producer kill, a failed
# checkpoint write (retried) and a preemption. The guard is repro's soak's:
# every trip rolls back (max_consecutive_trips=1), so the stream replays,
# and spike_factor=50 keeps the data's own loss spikes (a step of 33 after
# ~7 in phase train) from tripping a clean batch over and over
SOAK_FAULTS = {5: "nan_grad", 8: "corrupt_batch", 10: "kill_producer",
               11: "ckpt_write_fail", 14: "preempt"}


def _pipe_session(torch, sources=None, steps=PIPE_STEPS, *, model="gfm-mtl",
                  batch=8, batcher=None, **kw):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model=model, arch=CONFIG.replace(
        segment_sum_impl="fused"), steps=steps, batch_per_task=batch,
        lr=1e-3, warmup=2, log_every=1, eval_every=10 ** 9, seed=0,
        verbose=False, **kw)
    return Session.from_config(scfg, sources=sources, batcher=batcher,
                               device=DEVICE)


def _counted_run(torch, sess, counters):
    """Run a session with every launch count zeroed just before it; returns
    (result, launches, wall seconds)."""
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        result = sess.run()
    torch.cuda.synchronize()
    return result, {k: c.launches for k, c in counters.items()}, \
        time.perf_counter() - t0


def _check_run(name, result, launches, steps, per_step):
    losses = [r["loss"] for r in result.logger.history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train_pipeline {name}: losses {losses}")
    want = {"egnn_edge": per_step * steps, "egnn_edge_bwd": per_step * steps,
            "segment_sum": 0, "segment_sum_2d": steps}
    if launches != want:
        fail(f"train_pipeline {name}: launch counts {launches}, the design "
             f"implies {want}")
    return losses


def _replays(torch, make, name):
    """Two 3-step runs from one seed must end with bitwise equal params."""
    from repro_torch import interop
    ends = []
    for _ in range(2):
        with make() as s:
            ends.append(interop.leaves(s.run().params))
    torch.cuda.synchronize()
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail(f"train_pipeline {name}: two 3-step runs from one seed end "
             "with different parameters")
    return True


def _state_equal(torch, a, b) -> bool:
    """Params, both moments and both step counters, bit for bit."""
    from repro_torch import interop
    if (a.step, a.opt_state.step) != (b.step, b.opt_state.step):
        return False
    return all(torch.equal(interop.leaves(x)[k], v)
               for x, y in ((a.params, b.params),
                            (a.opt_state.m, b.opt_state.m),
                            (a.opt_state.v, b.opt_state.v))
               for k, v in interop.leaves(y).items())


def _on_card(torch, batch):
    import numpy as np
    dev = torch.device(DEVICE)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _grads_vs_plain(torch, params, batch, n_tasks, task_weights, cfg=None,
                    tol=GRAD_TOL, what="train_pipeline", floor=1e-30,
                    norm_tol=None):
    """One step's gradients, fused kernels against the plain path
    (``"jnp"``, autograd), per leaf relative to max(``floor``, its largest
    entry) within ``tol``, and with ``norm_tol`` also each leaf's
    |fused - plain| / |plain| (2-norms) within it; ``rel_to_max`` is the
    largest error over the leaf's largest entry, ``norm_rel_err`` the
    largest norm ratio; ``embed_grad`` holds #1 on the fused step's own
    species-embedding cotangent (``_check_embed``)."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.engine import multitask_grad_fn
    grads = {}
    for impl in ("fused", "jnp"):
        model = make_gfm_mtl((cfg or CONFIG).replace(segment_sum_impl=impl),
                             n_tasks)
        (loss, _, g), calls = _capture_embed(
            lambda: multitask_grad_fn(model, n_tasks, task_weights)(
                params, batch))
        grads[impl] = (float(loss), interop.leaves(g))
        if impl == "fused":
            embed_grad = _check_embed(torch, calls, what)
        elif calls:
            fail(f"{what}: the plain path launched #1")
    worst_leaf, worst, to_max = None, 0.0, 0.0
    norm_leaf, norm_worst = None, 0.0
    for k, ref in grads["jnp"][1].items():
        got = grads["fused"][1][k]
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        rel = err / max(top, floor)
        if not rel <= tol:
            fail(f"{what} grad {k}: error {rel} > {tol} x max({floor}, "
                 f"max |ref|)")
        if rel >= worst:
            worst_leaf, worst = k, rel
        to_max = max(to_max, err / max(top, 1e-30))
        nrel = float((got.double() - ref.double()).norm()
                     / ref.double().norm().clamp_min(1e-300))
        if norm_tol is not None and not nrel <= norm_tol:
            fail(f"{what} grad {k}: |fused - plain| / |plain| {nrel} > "
                 f"{norm_tol}")
        if nrel >= norm_worst:
            norm_leaf, norm_worst = k, nrel
    loss_rel = abs(grads["fused"][0] - grads["jnp"][0]) / abs(grads["jnp"][0])
    if not loss_rel <= tol:
        fail(f"{what} loss fused vs plain: relative error {loss_rel}")
    return {"worst_leaf": worst_leaf, "rel_err": worst, "rel_to_max": to_max,
            "norm_worst_leaf": norm_leaf, "norm_rel_err": norm_worst,
            "loss_rel_err": loss_rel, "loss": grads["fused"][0],
            "tolerance": tol, "scale_floor": floor, "norm_tol": norm_tol,
            "embed_grad": embed_grad}


def _step_times(torch, step_fn, state, batch, iters=5):
    """One training step on a placed batch: device time (``device_ms``) and
    host-clock ms a step with the loss read back each step, as the
    session's logging does."""
    dev = device_ms(torch, lambda: step_fn(state, batch), iters=iters,
                    warm=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        float(step_fn(state, batch)[1].loss)
    host = (time.perf_counter() - t0) / iters * 1e3
    return {"device_ms": dev, "host_ms": host,
            "shape": list(batch["edge_src"].shape)}


def _edge_kernels_at(torch, g, dev, B, A, E, H=866):
    """#3 and #4 through the autograd Function at a bucket shape against
    their plain versions: the forward per output and scratch (out, Pi, Pj,
    S, deg), the backward per gradient (pos needing none, as in training),
    bits over two calls of each; device time of each call."""
    from repro_torch.kernels.egnn_edge import (egnn_edge_agg,
                                               egnn_edge_agg_ref, gemm_plan)
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    h, pos, src, dst, em, phi = _edge_fwd_inputs(torch, g, dev, B, A, E, H)
    got = egnn_edge_agg(h, pos, src, dst, em, phi)
    if not torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi)):
        fail(f"egnn_edge at bucket {(B, A, E)}: two calls differ bitwise")
    err, scale = scaled_err(torch, got, egnn_edge_agg_ref(h, pos, src, dst,
                                                          em, phi))
    if not err <= EDGE_TOL * scale:
        fail(f"egnn_edge at bucket {(B, A, E)}: max_abs_err {err} > "
             f"{EDGE_TOL}*{scale}")
    call = _edge_fwd_call(torch, h, pos, src, dst, em, phi)
    fwd_errs = _fwd_rel_errs(torch, call(), _edge_fwd_plain(
        torch, h, pos, src, dst, em, phi))
    for n, e in fwd_errs.items():
        if not e <= EDGE_TOL:
            fail(f"egnn_edge at bucket {(B, A, E)} {n}: relative error {e}")
    fwd_ms = device_ms(torch, call)

    leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, A, E, H)
    h, pos, w0, b0, w1, b1 = leaves
    src, dst, em = edges
    agg = egnn_edge_agg(h, pos.detach(), src, dst, em,
                        {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}})
    wrt = [h, w0, b0, w1, b1]
    bwd = [torch.autograd.grad(agg, wrt, gup, retain_graph=True)
           for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*bwd)):
        fail(f"egnn_edge_bwd at bucket {(B, A, E)}: two calls differ")
    d = [x.detach() for x in leaves]
    sr, dr = torch.where(em, src, A), torch.where(em, dst, A)
    dh, _, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
        gup, d[0], d[1], sr, dr, d[2][:H], d[2][H:2 * H], d[2][2 * H:],
        d[3][None], d[4])
    want = [dh, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
    bwd_errs = {}
    for n, a, b in zip(("dh", "dw0", "db0", "dw1", "db1"), bwd[0], want):
        e = float((a - b).abs().max()) / float(b.abs().max())
        if not e <= BWD_TOL:
            fail(f"egnn_edge_bwd at bucket {(B, A, E)} {n}: relative error "
                 f"{e} > {BWD_TOL}")
        bwd_errs[n] = e
    bcall, _, _ = _edge_bwd_call(torch, leaves, edges, gup, False)
    torch.cuda.synchronize()
    n_valid = int(em.sum())
    return {"shape": [B, A, E, H], "fwd_rel_err": fwd_errs,
            "bwd_rel_err": bwd_errs, "fwd_ms": fwd_ms,
            "bwd_ms": device_ms(torch, bcall),
            "fwd_bound_ms": _edge_fwd_bound(B, A, E, H, n_valid)["bound_ms"],
            "bwd_bound_ms": _edge_bwd_bounds(B, A, E, H, n_valid,
                                             False)["bound_ms"],
            "fwd_splits": list(gemm_plan.fwd_splits(B * A, H)),
            "w1_splits": gemm_plan.w1_splits(B * A, H),
            "valid_edges": n_valid}


def _pad_fractions(batchers, n):
    """Mean pad fraction (atoms, edges) of the next ``n`` batches of each
    batcher."""
    from repro_torch.data.bucketing import pad_fraction
    out = []
    for b in batchers:
        fr = [pad_fraction(b.next_batch()) for _ in range(n)]
        out.append({k: sum(f[k] for f in fr) / n for k in ("atoms", "edges")})
    return out


def train_pipeline_phase(torch, counters):
    import shutil

    from repro_torch.data.bucketing import BucketingBatcher
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.data.store import (PrefetchingBatcher, ShardedSource,
                                        write_store)
    from repro_torch.resilience import (CheckpointPolicy, FaultSchedule,
                                        GuardConfig, ResilienceConfig)
    sources = _train_sources()
    T = len(sources)
    out = {"phase": "train_pipeline", "config": "hydragnn-gfm",
           "impl": "fused", "tasks": T}

    # (a) MTL-All, mixing as loss weights, bucketed
    sess = _pipe_session(torch, sources, mixing=1.0, bucketing=3)
    spec, task_weights = sess.batcher.spec, sess.task_weights
    res_a, launches_a, wall_a = _counted_run(torch, sess, counters)
    losses_a = _check_run("mtl_all", res_a, launches_a, PIPE_STEPS, 4)
    shapes = sorted(sess.batcher.shapes_seen)
    before, after = _pad_fractions(
        [GroupBatcher(sources, 8, seed=0),
         BucketingBatcher(GroupBatcher(sources, 8, seed=0), spec)],
        PIPE_STEPS)
    # one batch, bucketed and as stored
    cut = _on_card(torch, BucketingBatcher(GroupBatcher(sources, 8, seed=1),
                                           spec).next_batch())
    full = GroupBatcher(sources, 8, seed=1).next_batch()
    grads = _grads_vs_plain(torch, res_a.params, cut, T, task_weights)
    untrimmed = _grads_vs_plain(torch, res_a.params, _on_card(torch, full), T,
                                task_weights)["loss"]
    trim_rel = abs(grads["loss"] - untrimmed) / abs(untrimmed)
    if not trim_rel <= GRAD_TOL:
        fail(f"train_pipeline: the bucketed batch's loss {grads['loss']} vs "
             f"the untrimmed batch's {untrimmed}")
    times = {"bucketed": _step_times(torch, sess.step_fn, res_a.state, cut),
             "unbucketed": _step_times(torch, sess.step_fn, res_a.state,
                                       _on_card(torch, full))}
    out["mtl_all"] = {
        "steps": PIPE_STEPS, "batch_per_task": 8, "mixing": 1.0,
        "task_weights": list(task_weights), "bucketing": 3,
        "spec": [list(spec.atom_buckets), list(spec.edge_buckets)],
        "losses": losses_a, "launches": launches_a, "wall_s": wall_a,
        "shapes_seen": [list(s) for s in shapes],
        "pad_fraction_before": before, "pad_fraction_after": after,
        "grad_vs_plain": grads, "trim_loss_rel_err": trim_rel,
        "step": times,
        "replay_bitwise": _replays(torch, lambda: _pipe_session(
            torch, sources, 3, mixing=1.0, bucketing=3), "mtl_all")}
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    # every bucket shape of the grid up to (32, 128), one after another at
    # B=40, the run's own shapes among them
    small = {(a, e) for a in spec.atom_buckets for e in spec.edge_buckets
             if a <= 32 and e <= 128}
    out["kernels_at_buckets"] = [
        _edge_kernels_at(torch, g, torch.device(DEVICE), 8 * T, a, e)
        for a, e in sorted(small | set(shapes))]
    del sess, res_a, cut

    # (b) Baseline-All: one branch, 40 graphs a step from the mixture
    sess = _pipe_session(torch, sources, model="gfm-baseline", batch=8 * T,
                         mixing=1.0, bucketing=3)
    res_b, launches_b, wall_b = _counted_run(torch, sess, counters)
    out["baseline_all"] = {
        "steps": PIPE_STEPS, "batch": 8 * T, "mixing": 1.0,
        "losses": _check_run("baseline_all", res_b, launches_b, PIPE_STEPS,
                             4),
        "launches": launches_b, "wall_s": wall_b,
        "shapes_seen": sorted(list(s) for s in sess.batcher.shapes_seen),
        "replay_bitwise": _replays(torch, lambda: _pipe_session(
            torch, sources, 3, model="gfm-baseline", batch=8 * T,
            mixing=1.0, bucketing=3), "baseline_all")}
    del sess, res_b

    # (c) the sharded store under build/ (which .gitignore covers)
    store = ROOT / "build" / "chip_smoke" / "store"
    shutil.rmtree(store, ignore_errors=True)
    for i, s in enumerate(sources):
        write_store(str(store / f"s{i}"), s, shard_size=8)
    readers = [ShardedSource(str(store / f"s{i}")) for i in range(T)]
    ref = GroupBatcher(sources, 8, seed=0)
    with PrefetchingBatcher(readers, 8, seed=0, depth=2,
                            device=DEVICE) as pb:
        for i in range(12):
            got, want = pb.next_batch(), _on_card(torch, ref.next_batch())
            if sorted(got) != sorted(want) or not all(
                    got[k].device == want[k].device
                    and torch.equal(got[k], want[k])
                    for k in want):
                fail(f"train_pipeline store: batch {i} differs from the "
                     "in-memory GroupBatcher's")
    with _pipe_session(torch, sources, 3, bucketing=3) as mem:
        want = mem.run().state
    with PrefetchingBatcher([ShardedSource(str(store / f"s{i}"))
                             for i in range(T)], 8, seed=0, depth=2,
                            device=DEVICE) as pb, \
            _pipe_session(torch, steps=3, batcher=pb, bucketing=3) as st:
        got = st.run().state
    if not _state_equal(torch, got, want):
        fail("train_pipeline store: a session fed by the store ends "
             "differently from the in-memory session")
    out["store"] = {"batches_equal": 12, "session_bitwise": True,
                    "fetches": sum(r.fetches for r in readers)}

    # (d) the soak: every fault class, a preemption, resume(), then bitwise
    # against a clean run of the same steps
    soak = ROOT / "build" / "chip_smoke" / "soak"
    shutil.rmtree(soak, ignore_errors=True)

    def res(faults=None):
        return ResilienceConfig(
            ckpt_dir=str(soak), faults=faults, retry_base_delay=0.0,
            guard=GuardConfig(warmup_steps=2, spike_factor=50.0,
                              max_consecutive_trips=1),
            policy=CheckpointPolicy(every_steps=4, keep_last=2),
            max_ticks=4 * SOAK_STEPS)
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0, bucketing=3,
                       resilience=res(FaultSchedule.from_dict(SOAK_FAULTS))
                       ) as s:
        faulted = s.run()
    rep = faulted.resilience
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0, bucketing=3,
                       resilience=res()) as s:
        resumed_at = s.resume()
        resumed = s.run()
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0,
                       bucketing=3) as s:
        clean = s.run()
    kinds = {e["kind"] for e in rep["events"]}
    if not (faulted.preempted and rep["faults_fired"] == len(SOAK_FAULTS)
            and rep["rollbacks"] >= 2 and rep["io_retries"] >= 1
            and {"rollback", "pipeline_recovery", "preempt_flush"} <= kinds):
        fail(f"train_pipeline soak: the faults did not all take effect: "
             f"{rep}")
    if not _state_equal(torch, resumed.state, clean.state):
        fail("train_pipeline soak: the faulted run does not end bitwise "
             "equal to the clean run")
    out["soak"] = {"steps": SOAK_STEPS, "faults": SOAK_FAULTS,
                   "events": rep["events"], "trips": rep["trips"],
                   "rollbacks": rep["rollbacks"],
                   "pipeline_recoveries": rep["pipeline_recoveries"],
                   "io_retries": rep["io_retries"],
                   "save_ms": rep["save_ms"] + resumed.resilience["save_ms"],
                   "resumed_at": resumed_at,
                   "final_step": resumed.state.step,
                   "bitwise_vs_clean": True}
    shutil.rmtree(soak, ignore_errors=True)
    out["launches"] = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return out


# ---------------------------------------------------------------------------
# phase 4c: multi-task parallelism (the paper's method), ranks on one card
# ---------------------------------------------------------------------------

MTP_STEPS = 3                       # steps of each rank's run
MTP_RTOL, MTP_ATOL = 5e-5, 1e-6     # repro's cross-plan parity tolerance
                                    # (tests/test_parallel_parity.py)
MTP_ITERS = 3                       # steps a rank times
MTP_TIMEOUT_S = 600                 # one job of ranks, spawn to exit
MTP_RUNS = (("hier", 8, True), ("par", 5, False), ("base", 2, False))


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mtp_session(arch, sources, device, *, mesh=None, ckpt=None, **kw):
    """MTL-All at ``arch``, task weights (and so the placement's load
    model) from the paper's source sizes."""
    from repro_torch.data.synthetic_atoms import PAPER_REL_SIZES
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model="gfm-mtl", arch=arch, steps=MTP_STEPS,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False,
                         task_weights=tuple(PAPER_REL_SIZES.values()),
                         ckpt_path=ckpt, **kw)
    return Session.from_config(scfg, sources=sources, mesh=mesh,
                               device=device)


def _per_task(result, T):
    return [[r[f"task{t}"] for t in range(T)]
            for r in result.logger.history]


def _rank_device_ms(torch, fn, iters):
    """This rank's device time of one ``fn`` call from one
    ``torch.profiler`` trace (no retry: every rank runs the same steps);
    None when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total else None


def _collective_ms(torch, dist, n, device, group=None, size=2, reps=3):
    """Host-clock ms of one SUM all-reduce of ``n`` floats over ``group``
    (the world by default), mean of ``reps`` after one warm-up."""
    if size < 2:
        return 0.0
    buf = torch.zeros(n, device=device)
    dist.all_reduce(buf, group=group)
    _sync(torch, device)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf, group=group)
    _sync(torch, device)
    return (time.perf_counter() - t0) / reps * 1e3


def _mtp_rank(rank, world, kind, arch, sources, device, ckpt, full):
    """One rank of phase train_mtp: a ``Session`` under ``kind`` ("hier":
    ``placement=world``; "par": a (1, world) mesh; "base": a (world, 1)
    mesh, heads whole) for ``MTP_STEPS`` steps with its launch counts
    zeroed just before, the trunk's hash after every step, and the bytes
    of its params and moments. ``full`` adds the step's time, the
    all-reduces' time, a second run from the seed and the checkpoint the
    run wrote, read back."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import interop
    from repro_torch.core import memory_per_device
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.train import checkpoint
    counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                "segment_sum": ss_ops.segment_sum,
                "segment_sum_2d": ss_ops.segment_sum.two_d}
    T = len(sources)
    mesh = None if kind == "hier" else (
        make_host_mesh(1, world) if kind == "par" else
        make_host_mesh(world, 1))
    kw = {"placement": world} if kind == "hier" else \
        {"mode": "par" if kind == "par" else "base"}

    def session(ckpt_path=None):
        return _mtp_session(arch, sources, device, mesh=mesh,
                            ckpt=ckpt_path, **kw)

    entered = time.monotonic()
    sess = session(ckpt if full else None)
    plan, dev = sess.plan, rank_device()
    hashes, inner = [], sess.step_fn

    def traced(state, batch):
        state, out = inner(state, batch)
        hashes.append(_sha(interop.leaves(state.params["shared"]).values()))
        return state, out
    sess.step_fn = traced
    _sync(torch, dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        res = sess.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    template = sess.model.init(0, device="meta")
    p_s = sum(x.numel() for x in interop.leaves(template["shared"]).values())
    p_h = sum(x.numel() for x in
              interop.leaves(template["heads"]).values()) // T
    k = len(plan.shard.heads)
    want = 12 * (memory_per_device(p_s, p_h, T, "base") if kind == "base"
                 else memory_per_device(p_s, p_h * k, k, "par"))
    held = sum(x.numel() * x.element_size() for tree in
               (res.state.params, res.state.opt_state.m,
                res.state.opt_state.v) for x in interop.leaves(tree).values())
    out = {"rank": rank, "heads": list(plan.shard.heads),
           "group": list(plan.shard.ranks),
           "losses": [r["loss"] for r in res.logger.history],
           "per_task": _per_task(res, T), "trunk_sha": hashes,
           "launches": launches, "wall_s": wall, "p_shared": p_s,
           "p_head": p_h, "state_bytes": held, "state_bytes_model": want}
    if plan.placement is not None:
        out["device_counts"] = list(plan.placement.device_counts)
        out["groups"] = [list(g) for g in plan.placement.groups]
    if dev.type == "cuda":
        out["memory_allocated"] = torch.cuda.memory_allocated(dev)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["t_enter"] = entered
    if not full:
        out["t_exit"] = time.monotonic()
        return out

    batch = plan.shard_batch(GroupBatcher(sources, 8, seed=1).next_batch())
    state = res.state
    dist.barrier()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(MTP_ITERS):
        float(inner(state, batch)[1].loss)
    out["step_host_ms"] = (time.perf_counter() - t0) / MTP_ITERS * 1e3
    out["step_device_ms"] = _rank_device_ms(
        torch, lambda: inner(state, batch), MTP_ITERS) \
        if dev.type == "cuda" else None
    out["batch_shape"] = list(batch["edge_src"].shape)
    out["allreduce_trunk_ms"] = _collective_ms(torch, dist, p_s, dev,
                                               size=world)
    out["allreduce_heads_ms"] = _collective_ms(
        torch, dist, p_h * k, dev, group=plan.head_group,
        size=plan.shard.size)

    again = session()
    with again:
        res2 = again.run()
    a, b = interop.leaves(res.params), interop.leaves(res2.params)
    out["replay_bitwise"] = all(torch.equal(a[n], b[n]) for n in a)
    back = interop.leaves(checkpoint.restore_sharded(
        ckpt, {"params": res.params}, plan)["params"])
    out["restore_own_rows"] = all(
        np.array_equal(back[n], a[n].cpu().numpy()) for n in a)
    whole = interop.leaves(plan.gather_params(res.params))
    if rank == 0:
        out["full_sha"] = _sha(v for _, v in sorted(whole.items()))
    out["t_exit"] = time.monotonic()
    return out


def _close_rows(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|); fails above 1."""
    worst = 0.0
    for g_row, w_row in zip(got, want, strict=True):
        for g, w in zip(g_row, w_row, strict=True):
            worst = max(worst, abs(g - w) / (MTP_ATOL + MTP_RTOL * abs(w)))
    return worst


def train_mtp_phase(torch, device=DEVICE, arch=None):
    """Phase train_mtp (see the module docstring)."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import checkpoint
    arch = arch or CONFIG.replace(segment_sum_impl="fused")
    sources = _train_sources()
    T = len(sources)
    ref_sess = _mtp_session(arch, sources, device)
    with ref_sess:
        ref = ref_sess.run()
    ref_rows = _per_task(ref, T)
    ref_losses = [r["loss"] for r in ref.logger.history]
    if device == "cuda":
        torch.cuda.empty_cache()
    ckpt = str(ROOT / "build" / "chip_smoke" / "mtp_hier")
    out = {"phase": "train_mtp", "config": "hydragnn-gfm", "impl": "fused",
           "backend": "gloo", "steps": MTP_STEPS, "batch_per_task": 8,
           "tolerance": {"rtol": MTP_RTOL, "atol": MTP_ATOL},
           "note": "ranks time-share one card over gloo: times are not a "
                   "scaling result, and NCCL is not exercised",
           "reference": {"losses": ref_losses, "per_task": ref_rows}}
    launches = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
                "segment_sum_2d": 0}
    # one trunk pass a step, one launch a layer each way and one species
    # embedding's backward (none off the card: the CPU rehearsal runs the
    # plain versions)
    per = arch.gnn_layers * MTP_STEPS if device == "cuda" else 0
    want = {"egnn_edge": per, "egnn_edge_bwd": per, "segment_sum": 0,
            "segment_sum_2d": MTP_STEPS if device == "cuda" else 0}
    rdzv = ROOT / "build" / "chip_smoke"
    rdzv.mkdir(parents=True, exist_ok=True)
    for kind, world, full in MTP_RUNS:
        t0, spawned = time.perf_counter(), time.monotonic()
        try:
            ranks = run_ranks(_mtp_rank, world, backend="gloo", device=device,
                              args=(kind, arch, sources, device, ckpt, full),
                              timeout=MTP_TIMEOUT_S, rdzv_dir=str(rdzv))
        except Exception as e:                        # noqa: BLE001
            fail(f"train_mtp {kind}: {e}")
        wall, back = time.perf_counter() - t0, time.monotonic()
        name = f"train_mtp {kind}"
        worst = max(_close_rows(r["per_task"], ref_rows) for r in ranks)
        if not worst <= 1.0:
            fail(f"{name}: per-task losses off the single-process "
                 f"session's by {worst} x the tolerance")
        worst_total = max(_close_rows([r["losses"]], [ref_losses])
                          for r in ranks)
        if not worst_total <= 1.0:
            fail(f"{name}: total losses off by {worst_total} x tolerance")
        for i in range(MTP_STEPS):
            if len({r["trunk_sha"][i] for r in ranks}) != 1:
                fail(f"{name}: trunk params differ across ranks after step "
                     f"{i}")
        for r in ranks:
            if r["launches"] != want:
                fail(f"{name} rank {r['rank']}: launch counts "
                     f"{r['launches']}, the design implies {want}")
            if r["state_bytes"] != r["state_bytes_model"]:
                fail(f"{name} rank {r['rank']}: {r['state_bytes']} bytes of "
                     f"params and moments, the §4.3 model "
                     f"{r['state_bytes_model']}")
            for k_ in launches:
                launches[k_] += r["launches"][k_]
        heads = [r["heads"] for r in ranks]
        if kind == "hier" and ranks[0]["device_counts"] != [2, 1, 3, 1, 1]:
            fail(f"{name}: groups {ranks[0]['device_counts']}, the solver "
                 "gives (2, 1, 3, 1, 1) for the paper's sizes on 8")
        if kind == "par" and heads != [[t] for t in range(T)]:
            fail(f"{name}: heads by rank {heads}, one each expected")
        if kind == "base" and heads != [list(range(T))] * world:
            fail(f"{name}: heads by rank {heads}, all on each expected")
        keep = ("rank", "heads", "group", "state_bytes", "state_bytes_model",
                "memory_allocated", "max_memory_allocated", "wall_s",
                "step_host_ms", "step_device_ms", "batch_shape",
                "allreduce_trunk_ms", "allreduce_heads_ms")
        # where a job's wall time goes: spawn to the last rank's entry
        # (interpreters, torch, CUDA contexts, gloo), the ranks' work, and
        # the last rank's exit to the results (teardown)
        row = {"world": world, "wall_s": wall,
               "startup_s": max(r["t_enter"] for r in ranks) - spawned,
               "ranks_s": max(r["t_exit"] for r in ranks)
               - max(r["t_enter"] for r in ranks),
               "teardown_s": back - max(r["t_exit"] for r in ranks),
               "per_task_err_vs_tol": worst,
               "loss_err_vs_tol": worst_total,
               "per_task": ranks[0]["per_task"], "losses": ranks[0]["losses"],
               "launches_per_rank": want,
               "p_shared": ranks[0]["p_shared"],
               "p_head": ranks[0]["p_head"],
               "ranks": [{k_: r[k_] for k_ in keep if k_ in r}
                         for r in ranks]}
        if kind == "hier":
            row["device_counts"] = ranks[0]["device_counts"]
        if full:
            if not all(r["replay_bitwise"] for r in ranks):
                fail(f"{name}: two runs from one seed differ bitwise")
            if not all(r["restore_own_rows"] for r in ranks):
                fail(f"{name}: restore_sharded gave a rank other rows than "
                     "its own")
            back = checkpoint.restore(ckpt, {"params": ref.params})
            one = _mtp_session(arch, sources, device)
            one.state = one.state._replace(
                params=interop.to_torch(back["params"], device))
            sha = _sha(v for _, v in
                       sorted(interop.leaves(one.state.params).items()))
            if sha != ranks[0]["full_sha"]:
                fail(f"{name}: the checkpoint rank 0 wrote does not restore "
                     "bitwise into a one-process session")
            row.update(replay_bitwise=True, ckpt_restored_bitwise=True)
        out[kind] = row
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 4d: the bf16 GNN path at full width
# ---------------------------------------------------------------------------

def check_egnn_edge_bwd_bf16(torch, dev, g):
    """#4 on bf16 g, h and weights, at B=40 without dpos (training) and B=8
    with. Through ``egnn_edge_agg(compute_dtype=bf16)``'s autograd Function
    on a bf16 h leaf and f32 φ_e leaves, as the trunk calls it: one launch
    counted on ``egnn_edge_bwd.bf16``, dh in bf16 and the rest in f32, each
    per output within ``BWD_TOL`` of its largest entry against the plain
    version on the same bf16 values (dh also within the half ulp of its
    rounding to bf16), two calls bitwise. The wrapper's own launch
    (``ops.egnn_edge_bwd``) on those values is bitwise equal to #4's f32
    launch on their f32 copies and gives the autograd cotangents' bits;
    device time of both launches beside the plain version and
    ``torch.matmul`` (fp32) of its six products."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg, ops
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    H, bf16 = 866, torch.bfloat16
    names = ("dh", "dpos", "dw0", "db0", "dw1", "db1")
    worst, out = 0.0, {}
    for name, B, A, E, need_dpos in (("train", 40, 64, 2048, False),
                                     ("b8", 8, 64, 2048, True)):
        leaves, (src, dst, em), gup = _edge_bwd_inputs(torch, g, dev, B, A, E,
                                                       H)
        h = leaves[0].detach().bfloat16().requires_grad_(True)
        pos, w0, b0, w1, b1 = leaves[1:]
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        wrt = [h, pos, w0, b0, w1, b1] if need_dpos else [h, w0, b0, w1, b1]
        agg = egnn_edge_agg(h, pos if need_dpos else pos.detach(), src, dst,
                            em, phi, compute_dtype=bf16)
        gb = gup.bfloat16()

        def bwd():
            return torch.autograd.grad(agg, wrt, gb, retain_graph=True)
        before = (ops.egnn_edge_bwd.launches, ops.egnn_edge_bwd.bf16.launches)
        got, again = bwd(), bwd()
        if (ops.egnn_edge_bwd.launches,
                ops.egnn_edge_bwd.bf16.launches) != (before[0], before[1] + 2):
            fail(f"egnn_edge_bwd_bf16 {name}: a bf16 call launched another "
                 f"kernel than the bf16 backward")
        torch.cuda.synchronize()
        if agg.dtype != bf16 or [x.dtype for x in got] != \
                [x.dtype for x in wrt]:
            fail(f"egnn_edge_bwd_bf16 {name}: out in {agg.dtype}, "
                 f"cotangents in {[x.dtype for x in got]}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"egnn_edge_bwd_bf16 {name}: two calls differ bitwise")
        if not need_dpos:
            got = got[:1] + (None,) + got[1:]
        # the plain version and the wrapper's own launch on the values the
        # autograd Function passes: bf16 g, h and weights, the forward's
        # f32 scratch
        hd, w0b, b0b, w1b, b1b = (x.detach().bfloat16()
                                  for x in (h, w0, b0, w1, b1))
        pos = pos.detach()
        sr = torch.where(em, src, A).to(torch.int32).contiguous()
        dr = torch.where(em, dst, A).to(torch.int32).contiguous()
        _, pi, pj, s, deg = ops._launch_fwd(
            hd, pos, sr, dr, w0b, b0b, w1b, b1b, bf16,
            *ops._resolve_blocks(None, None, A, E, H))

        def plain():
            return egnn_edge_bwd_ref(gb, hd, pos, sr, dr, w0b[:H],
                                     w0b[H:2 * H], w0b[2 * H:], b0b[None],
                                     w1b)
        dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = plain()
        errs = {}
        for n, a, b in zip(names, got, (dh, dpos, torch.cat(
                [dw0i, dw0j, dw0d]), db0[0], dw1, db1[0])):
            if a is None:
                continue
            b = b.float()
            diff = (a.float() - b).abs()
            scale = float(b.abs().max())
            lim = BWD_TOL * scale
            # dh comes back in its primal's dtype: its rounding to bf16
            # moves it by at most 2^-8 of itself
            over = diff > (lim * (1 + 2.0 ** -8) + 2.0 ** -8 * b.abs()
                           if n == "dh" else lim)
            if bool(over.any()):
                fail(f"egnn_edge_bwd_bf16 {name} {n}: max_abs_err "
                     f"{float(diff.max())} > {BWD_TOL}*{scale}"
                     + (" + its bf16 rounding" if n == "dh" else ""))
            errs[n] = float(diff.max()) / scale
            worst = max(worst, float(diff.max()))
        del dh, dpos, dw0i, dw0j
        kw = {"need_dpos": need_dpos, **dict(zip(
            ("block_e", "block_h"),
            ops._resolve_blocks(None, None, A, E, H, bwd=True)))}

        def call():
            return ops.egnn_edge_bwd(gb, hd, pos, sr, dr, w0b, w1b, pi, pj, s,
                                     deg, **kw)
        up = [x.float() for x in (gb, hd, w0b, w1b)]

        def call32():
            return ops.egnn_edge_bwd(up[0], up[1], pos, sr, dr, up[2], up[3],
                                     pi, pj, s, deg, **kw)
        direct, want = call(), call32()
        torch.cuda.synchronize()
        bitwise = {n: a is None or torch.equal(a, b)
                   for n, a, b in zip(names, direct, want)}
        if not all(bitwise.values()):
            diff = {n: float((a - b).abs().max()) for n, a, b in
                    zip(names, direct, want) if a is not None}
            fail(f"egnn_edge_bwd_bf16 {name}: not bitwise equal to the f32 "
                 f"launch on the upcast values: {bitwise}, max |diff| "
                 f"{diff}")
        if not all(a is None or torch.equal(a, b.to(a.dtype))
                   for a, b in zip(got, direct)):
            fail(f"egnn_edge_bwd_bf16 {name}: the autograd cotangents are "
                 f"not the wrapper's launch's bits (dh rounded to bf16)")
        prof = device_profile(torch, call)
        most = 4 if need_dpos else 3
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge_bwd_bf16 {name}: {prof['kernels_per_call']} "
                 f"kernels a call, the design has at most {most}")
        n_valid = int(em.sum())
        case = {"ms": prof["ms"], "by_kernel": prof["by_kernel"],
                "kernels_per_call": prof["kernels_per_call"],
                "wall_ms": time_ms(torch, call),
                "f32_ms": device_ms(torch, call32),
                "plain_ms": time_ms(torch, plain, iters=3, warm=1),
                "library_ms": None,
                "library_note": "no one PyTorch call computes this backward",
                "gemm_library_ms": device_ms(
                    torch, _gemm_library(torch, B, A, H, g, dev)),
                "shape": [B, A, E, H], "dpos": need_dpos,
                "valid_edges": n_valid, "bitwise_vs_f32_upcast": True,
                "rel_err": errs,
                **_edge_bwd_bounds(B, A, E, H, n_valid, need_dpos,
                                   bf16=True)}
        if name == "train":
            out.update(case)
        else:
            out[name] = case
        del agg, got, again, direct, want
    out["max_abs_err"] = worst
    return out


def gnn_bf16_phase(torch, serve_rows, counters):
    """Phase gnn_bf16 (the module docstring): hydragnn-gfm at full width in
    bf16 compute, (b) served under ``"fused"`` and ``"pallas"``, (c)
    trained under ``"fused"``; the kernel checks (a) are
    ``check_egnn_edge(cd=bf16)`` and ``check_egnn_edge_bwd_bf16``.
    ``counters`` are zeroed just before each pass and run."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.serve import ServeSession
    cfg = CONFIG.replace(compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()

    # (b) serving
    spec, params, samples, heads = serve_inputs(N_REQUESTS)
    res, info = {}, {}
    for impl in ("fused", "pallas"):
        res[impl], info[impl] = serve_pass(torch, impl, params, spec, samples,
                                           heads, counters, cfg=cfg)
    lf, lp = info["fused"]["launches"], info["pallas"]["launches"]
    if not (lf["egnn_edge_bf16"] == 4 * info["fused"]["batches"] > 0
            and lf["egnn_edge"] == lf["segment_sum"] == 0):
        fail(f"gnn_bf16 fused serve launch counts {lf} vs "
             f"{info['fused']['batches']} batches")
    if not (lp["segment_sum"] == 4 * info["pallas"]["batches"] > 0
            and lp["egnn_edge"] == lp["egnn_edge_bf16"] == 0):
        fail(f"gnn_bf16 pallas serve launch counts {lp} vs "
             f"{info['pallas']['batches']} batches")
    idx = list(range(0, N_REQUESTS, max(1, N_REQUESTS // 8)))
    with ServeSession(params, cfg.replace(segment_sum_impl="jnp"), spec=spec,
                      max_batch=8, device=DEVICE) as plain:
        res_plain = [plain.predict_one(samples[i], head=heads[i])
                     for i in idx]
    vs_plain = {impl: serve_rel_err([res[impl][i] for i in idx], res_plain)
                for impl in res}
    for impl, e in vs_plain.items():
        if not e <= EDGE_BF16_TOL:
            fail(f"gnn_bf16 {impl} serve rows differ from the plain bf16 "
                 f"forward: {e} > {EDGE_BF16_TOL}")
    serve = {"fused": info["fused"], "pallas": info["pallas"],
             "vs_plain_rel_err": vs_plain,
             "fused_vs_pallas_rel_err": serve_rel_err(res["fused"],
                                                      res["pallas"]),
             "vs_f32_serve_rel_err": serve_rel_err(res["fused"], serve_rows),
             "rows_bitwise_vs_predict_one": True}
    torch.cuda.empty_cache()

    # (c) training
    sources = _train_sources()
    ckpt = str(ROOT / "build" / "chip_smoke" / "gfm_train_bf16")
    result, launches, wall = _counted_run(
        torch, _train_session(torch, sources, TRAIN_STEPS, ckpt, cfg=cfg),
        counters)
    losses = [r["loss"] for r in result.logger.history]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"gnn_bf16 train: losses {losses}")
    want = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
            "segment_sum_2d": TRAIN_STEPS,
            "egnn_edge_bf16": 4 * TRAIN_STEPS,
            "egnn_edge_bwd_bf16": 4 * TRAIN_STEPS}
    if launches != want:
        fail(f"gnn_bf16 train launch counts {launches}, design implies "
             f"{want}")
    batch = _on_card(torch, GroupBatcher(sources, 8, seed=1).next_batch())
    grads = _grads_vs_plain(torch, result.params, batch, len(sources), None,
                            cfg=cfg, tol=EDGE_BF16_TOL, what="gnn_bf16",
                            floor=1.0, norm_tol=BF16_GRAD_NORM_TOL)
    ends = []
    for _ in range(2):
        with _train_session(torch, sources, 3, cfg=cfg) as s:
            ends.append(interop.leaves(s.run().params))
    torch.cuda.synchronize()
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail("gnn_bf16 train: two 3-step runs from one seed end with "
             "different parameters")
    if not all(v.dtype == torch.float32 for v in ends[0].values()):
        fail("gnn_bf16 train: parameters left fp32")
    jobs = [({k: s[k][i] for k in ("species", "pos", "edge_src", "edge_dst",
                                   "node_mask", "edge_mask")}, t)
            for t, s in enumerate(sources) for i in range(2)]
    counters["egnn_edge_bf16"].launches = 0
    with ServeSession.from_checkpoint(ckpt, cfg.replace(
            segment_sum_impl="fused"), max_batch=8, device=DEVICE) as srv:
        served = [f.result(timeout=600) for f in
                  [srv.submit(x, head=t) for x, t in jobs]]
    if not (all(math.isfinite(r["energy"]) and
                bool(torch.isfinite(torch.from_numpy(r["forces"])).all())
                for r in served)
            and counters["egnn_edge_bf16"].launches > 0):
        fail("gnn_bf16: serving the trained checkpoint in bf16 gave "
             "non-finite results or launched no bf16 kernel")
    train = {"steps": TRAIN_STEPS, "graphs_per_step": 8 * len(sources),
             "losses": losses, "launches": launches, "wall_s": wall,
             "grad_vs_plain": grads, "replay_bitwise": True,
             "served_from_ckpt": len(served)}
    return {"phase": "gnn_bf16", "config": "hydragnn-gfm",
            "compute_dtype": "bfloat16", "param_dtype": "float32",
            "tolerance": EDGE_BF16_TOL, "serve": serve, "train": train,
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4e: downstream fine-tuning at full width
# ---------------------------------------------------------------------------

FT_STEPS = 5                        # pre-training and each fine-tuning run
FT_LR = 3e-4                        # fine-tuning at full width: the
                                    # example's smoke-width 3e-3 diverged
                                    # here (loss 23 -> 6.7e8 in 5 steps)
FT_SOURCES = ("ani1x", "qm7x", "mptrj")


def _example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zeroed(torch, counters):
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0


def _counts(torch, counters):
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def _rel_leaves(torch, got, ref, what, tol=GRAD_TOL):
    """Each leaf of ``got`` within ``tol`` x its largest entry of ``ref``;
    returns (worst leaf, worst error)."""
    from repro_torch import interop
    worst_leaf, worst = None, 0.0
    ref = interop.leaves(ref)
    for k, g in interop.leaves(got).items():
        rel = float((g - ref[k]).abs().max()) / max(
            float(ref[k].abs().max()), 1e-30)
        if not rel <= tol:
            fail(f"{what} {k}: relative error {rel} > {tol}")
        if rel >= worst:
            worst_leaf, worst = k, rel
    return worst_leaf, worst


def finetune_phase(torch, counters):
    """The paper's downstream fine-tuning (``examples/
    finetune_downstream_torch.py``'s functions) at hydragnn-gfm's full
    width: pre-train a ``Session`` 5 steps on 3 sources x 8 graphs, then
    fine-tune a fresh branch and the trunk 5 steps on 12 transition1x
    graphs (a ``SingleTaskModel`` through ``ShardingPlan().compile(
    make_step(...))``), from the pre-trained trunk and from a scratch one,
    and evaluate both on 64 held-out graphs."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core import gfm_eval_fn
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    from repro_torch.engine import (Session, SessionConfig, make_grad_fn,
                                    with_grad_accum)
    from repro_torch.models import gnn
    ft = _example("finetune_downstream_torch")
    cfg = CONFIG.replace(segment_sum_impl="fused")
    plain = CONFIG.replace(segment_sum_impl="jnp")
    dev = torch.device(DEVICE)
    per_step = {"egnn_edge": cfg.gnn_layers, "egnn_edge_bwd": cfg.gnn_layers,
                "segment_sum": 0, "segment_sum_2d": 1}

    def want(steps, micro=1):
        return {k: v * steps * micro for k, v in per_step.items()}

    data = source_dicts(generate_all(16, max_atoms=CONFIG.max_atoms,
                                     max_edges=CONFIG.max_edges,
                                     sources=list(FT_SOURCES)))
    scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=FT_STEPS,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False)
    pre, pre_launches, pre_wall = _counted_run(
        torch, Session.from_config(scfg, sources=data,
                                   task_names=list(FT_SOURCES),
                                   device=DEVICE), counters)
    pre_losses = [r["loss"] for r in pre.logger.history]
    if len(pre_losses) != FT_STEPS or not all(map(math.isfinite,
                                                  pre_losses)):
        fail(f"finetune pre-training: losses {pre_losses}")
    if pre_launches != want(FT_STEPS):
        fail(f"finetune pre-training: launches {pre_launches}, the design "
             f"implies {want(FT_STEPS)}")
    ds_train, ds_test = ft.downstream(cfg, dev)
    trunks = {"pretrained": pre.params["shared"],
              "scratch": gnn.egnn_init(cfg, seed=7, device=dev)}
    ev, ev_plain = gfm_eval_fn(cfg), gfm_eval_fn(plain)
    runs, ends = {}, {}
    for name, shared in trunks.items():
        _zeroed(torch, counters)
        t0 = time.perf_counter()
        state, losses = ft.finetune(cfg, shared, ds_train, FT_STEPS,
                                    lr=FT_LR, device=dev)
        launches = _counts(torch, counters)
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        if not all(map(math.isfinite, losses)):
            fail(f"finetune {name}: losses {losses}")
        if launches != want(FT_STEPS):
            fail(f"finetune {name}: launches {launches}, the design implies "
                 f"{want(FT_STEPS)} (one trunk pass a step: 4 layers each "
                 "way, one species embedding's backward)")
        moved = sum(not torch.equal(a, b) for a, b in zip(
            interop.leaves(state.params["shared"]).values(),
            interop.leaves(shared).values()))
        if not moved:
            fail(f"finetune {name}: the trunk's params did not move")
        mae = [float(x) for x in ev(state.params["shared"],
                                    state.params["branch"], ds_test)]
        mae_plain = [float(x) for x in ev_plain(state.params["shared"],
                                                state.params["branch"],
                                                ds_test)]
        mae_err = max(abs(a - b) / abs(b) for a, b in zip(mae, mae_plain))
        if not mae_err <= SERVE_TOL:
            fail(f"finetune {name}: held-out MAEs {mae} through the kernels "
                 f"vs {mae_plain} plain: relative error {mae_err}")
        ends[name] = interop.leaves(state.params)
        runs[name] = {"losses": losses, "launches": launches, "wall_s": wall,
                      "trunk_leaves_moved": moved,
                      "energy_mae": mae[0], "force_mae": mae[1],
                      "plain_energy_mae": mae_plain[0],
                      "plain_force_mae": mae_plain[1],
                      "mae_rel_err_vs_plain": mae_err}
    # replay: the pre-trained run again, bitwise
    state, _ = ft.finetune(cfg, trunks["pretrained"], ds_train, FT_STEPS,
                           lr=FT_LR, device=dev)
    again = interop.leaves(state.params)
    if not all(torch.equal(again[k], v)
               for k, v in ends["pretrained"].items()):
        fail("finetune: two runs from one seed end with different params")
    del state, again

    # one fine-tuning step's gradients, kernels against the plain path
    model = ft.finetune_model(cfg, trunks["pretrained"])
    p0 = model.init(None, dev)
    (loss, _, grads), calls = _capture_embed(
        lambda: make_grad_fn(model)(p0, ds_train))
    embed_grad = _check_embed(torch, calls, "finetune")
    (ploss, _, pgrads), calls = _capture_embed(
        lambda: make_grad_fn(ft.finetune_model(
            plain, trunks["pretrained"]))(p0, ds_train))
    if calls:
        fail("finetune: the plain path launched #1")
    worst_leaf, worst = _rel_leaves(torch, grads, pgrads, "finetune grad")
    loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    if not loss_rel <= GRAD_TOL:
        fail(f"finetune loss fused vs plain: relative error {loss_rel}")
    # accum=2 on the flat batch: the mean of its two halves' gradients,
    # through the kernels; accum=1 normalises the forces over all 12
    # graphs' atoms, each half over its own, so it is a neighbour, not
    # the same function (recorded, not held)
    grad_fn = make_grad_fn(model)
    _zeroed(torch, counters)
    aloss, _, agrads = with_grad_accum(grad_fn, 2, axis=0)(p0, ds_train)
    acc_launches = _counts(torch, counters)
    if acc_launches != want(1, micro=2):
        fail(f"finetune accum=2: launches {acc_launches}, the design "
             f"implies {want(1, micro=2)}")
    halves = [grad_fn(p0, {k: v[i * 6:(i + 1) * 6]
                           for k, v in ds_train.items()}) for i in range(2)]
    mean = interop.tree_map(lambda a, b: (a + b) / 2, halves[0][2],
                            halves[1][2])
    acc_leaf, acc_err = _rel_leaves(torch, agrads, mean, "finetune accum=2")
    ref = interop.leaves(grads)
    vs_accum1 = max(float((g - ref[k]).abs().max())
                    / max(float(ref[k].abs().max()), 1e-30)
                    for k, g in interop.leaves(agrads).items())
    pt, sc = runs["pretrained"], runs["scratch"]
    return {"phase": "finetune", "config": "hydragnn-gfm", "impl": "fused",
            "pretrain": {"sources": list(FT_SOURCES), "steps": FT_STEPS,
                         "batch_per_task": 8, "losses": pre_losses,
                         "launches": pre_launches, "wall_s": pre_wall},
            "downstream": {"source": "transition1x", "lr": FT_LR,
                           "train_graphs": int(ds_train["species"].shape[0]),
                           "held_out_graphs":
                           int(ds_test["species"].shape[0]),
                           "steps": FT_STEPS},
            "runs": runs,
            "launches": {k: pt["launches"][k] + sc["launches"][k]
                         + acc_launches[k] for k in per_step},
            "replay_bitwise": True,
            "grad_vs_plain": {"worst_leaf": worst_leaf, "rel_err": worst,
                              "loss_rel_err": loss_rel,
                              "tolerance": GRAD_TOL},
            "embed_grad": embed_grad,
            "accum2": {"vs_halves_worst_leaf": acc_leaf,
                       "vs_halves_rel_err": acc_err, "tolerance": GRAD_TOL,
                       "launches": acc_launches,
                       "loss": float(aloss),
                       "vs_accum1_rel_err": vs_accum1},
            "mae_ratio_scratch_over_pretrained": {
                "energy": sc["energy_mae"] / pt["energy_mae"],
                "force": sc["force_mae"] / pt["force_mae"]}}


# ---------------------------------------------------------------------------
# phase 4f: LM training at full width
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS = 5                  # run (a)
LM_MTL_STEPS = 3                    # run (b)
LM_REPLAY_STEPS = 3
LM_B, LM_S = 8, 1024                # (a): 8 x 1024 tokens a step
LM_TASKS, LM_TASK_B = 4, 2          # (b): 4 tasks x 2 x 1024
SS_CARRY_PLAN = (384, 32, 4, 32, 8)  # #1's plan at the embedding's
                                    # shape with a carried window (32-id
                                    # windows, 32 lanes): the one before
                                    # the whole-list window (block_n,
                                    # block_e, vec, lanes, chunks)


def _lm_session(cfg, model, sources, steps, batch):
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model=model, arch=cfg, steps=steps,
                         batch_per_task=batch, lr=3e-4, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False)
    return Session.from_config(scfg, sources=sources, device=DEVICE)


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _embed_grad_check(torch, sess, batch):
    """One step's gradients with the embedding's backward recorded: the
    cotangent (g, ids) the step gives #1, checked against the step's
    tokens, and #1 on it against its plain versions (``_check_embed``)."""
    from repro_torch.engine import single_grad_fn
    (loss, _, grads), calls = _capture_embed(
        lambda: single_grad_fn(sess.model)(sess.state.params, batch))
    del grads
    check = _check_embed(torch, calls, "lm_train")
    g, ids, V, _ = calls[0]
    # the step's token embedding: its ids, one cotangent row each (the
    # tied table's gradient adds the unembedding's to #1's result)
    toks = batch["tokens"]
    if not (torch.equal(ids, toks.reshape(-1).long()) and tuple(g.shape)
            == (toks.numel(), sess.cfg.arch.d_model)):
        fail(f"lm_train: #1 saw ids/cotangent {tuple(ids.shape)} / "
             f"{tuple(g.shape)}, not the step's tokens")
    return float(loss), g, ids, V, check


def _embed_kernel_times(torch, g, ids, V):
    """#1 at the embedding's shape: its time at the default plan and at
    the carried one (``SS_CARRY_PLAN``, the same bits), the plain version
    (an f32 one-hot product), the bf16 one-hot product the embedding's
    backward would be without #1, ``index_add_`` and the byte bound.
    Timed by CUDA events over back-to-back calls (each call takes 0.08 ms
    or more, far above its launch cost): after the LM step's trace,
    ``torch.profiler`` read about half of these kernels' time on an
    H100."""
    import torch.nn.functional as F
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    E, D = g.shape
    p = ops.plan(V, E, D, itemsize=g.element_size())
    old = ops.Plan(*SS_CARRY_PLAN)
    out = ops.segment_sum(g, ids, V)
    if not torch.equal(out, ops._launch(g, ids, V, old)):
        fail("lm_train #1: the carried plan gives other bits than this "
             "plan")
    ids64 = ids.long()
    nbytes = E * D * g.element_size() + 4 * E + V * D * g.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = E * D / FP32_FLOPS * 1e3

    def onehot_bf16():
        return F.one_hot(ids64, V).to(g.dtype).T @ g
    ids32 = ids.to(torch.int32)
    return {
        "plan": dict(p._asdict()), "carry_plan": dict(old._asdict()),
        "timer": "cuda events",
        "ms": time_ms(torch, lambda: ops.segment_sum(g, ids32, V), iters=20),
        "carry_plan_ms": time_ms(torch, lambda: ops._launch(g, ids32, V, old),
                                iters=2, warm=1),
        "plain_ms": time_ms(torch, lambda: segment_sum_ref(g, ids, V),
                            iters=3, warm=1),
        "onehot_bf16_ms": time_ms(torch, onehot_bf16, iters=3, warm=1),
        "library_ms": time_ms(torch, lambda: torch.zeros(
            (V, D), dtype=g.dtype, device=g.device).index_add_(0, ids64, g),
            iters=20),
        "library": "index_add_ (bf16, with its zero fill)",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes}


def _lm_step_times(torch, sess, batch, iters=2):
    """One LM training step on a placed batch: device time (its kernels,
    ``torch.profiler``), the kernels that take most of it, its launches,
    and host-clock ms with the loss read back."""
    step, state = sess.step_fn, sess.state
    prof = device_profile(torch, lambda: step(state, batch), iters=iters,
                          warm=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        float(step(state, batch)[1].loss)
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": prof["ms"],
            "host_ms": (time.perf_counter() - t0) / iters * 1e3,
            "kernels_per_step": prof["kernels_per_call"],
            "top_kernels_ms": dict(top)}


def lm_train_phase(torch, counters):
    """qwen1.5-0.5b at full width (24 layers, d=1024, 16 heads, d_ff 2816,
    padded vocab 152064, tied table; bf16 compute over fp32 params drawn on
    the card from a seed; ``impl="chunked"``, per-block remat): (a) ``lm``,
    B=8 x S=1024, 5 AdamW steps; (b) ``lm-mtl``, 4 tasks x 2 x 1024, 3
    steps. #1 takes the embedding's backward, once a step."""
    from repro_torch import interop
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.data.lm_data import make_lm_sources
    cfg = qwen1_5_0_5b.CONFIG
    out = {"phase": "lm_train", "config": cfg.name, "impl": "chunked",
           "remat": cfg.remat, "compute_dtype": "bfloat16",
           "param_dtype": "float32", "seq": LM_S,
           "tolerance": {"embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product"}}
    others = {k: 0 for k in counters if k != "segment_sum_2d"}

    # (a) lm
    B = LM_B
    source = make_lm_sources(1, 64, LM_S, cfg.vocab)[0]
    sess = _lm_session(cfg, "lm", source, LM_TRAIN_STEPS, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = _counted_run(torch, sess, counters)
    peak = torch.cuda.max_memory_allocated()
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != LM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"lm_train lm: losses {losses}")
    want = {"segment_sum_2d": LM_TRAIN_STEPS, **others}
    if launches != want:
        fail(f"lm_train lm: launches {launches}, the design implies {want} "
             "(one embedding backward a step)")
    batch = {k: torch.from_numpy(v[:B]).to(DEVICE) for k, v in
             source.items()}
    loss1, g, ids, V, check = _embed_grad_check(torch, sess, batch)
    times = _lm_step_times(torch, sess, batch)
    out["lm"] = {"batch": B, "tokens_per_step": B * LM_S,
                 "params": sess.n_params(), "steps": LM_TRAIN_STEPS,
                 "losses": losses, "launches": launches,
                 "launches_per_step": {"segment_sum_2d":
                                       launches["segment_sum_2d"]
                                       / LM_TRAIN_STEPS},
                 "wall_s": wall, "peak_mem_bytes": peak,
                 "step_host_ms_in_run": (rows[-1]["wall"] - rows[1]["wall"])
                 / (LM_TRAIN_STEPS - 2) * 1e3,
                 "step": times, "embed_grad": check}
    del sess, res
    _free(torch)
    kern = _embed_kernel_times(torch, g, ids, V)
    kern.update(max_abs_err=check["bfloat16"]["max_abs_err"],
                shape=check["shape"])
    out["segment_sum_2d"] = kern
    del g, ids
    _free(torch)

    # two 3-step runs from one seed end bitwise equal
    ends = []
    for _ in range(2):
        with _lm_session(cfg, "lm", source, LM_REPLAY_STEPS, B) as s:
            ends.append(interop.leaves(s.run().params))
        _free(torch)
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail("lm_train: two 3-step runs from one seed end with different "
             "params")
    out["replay_bitwise"] = True
    del ends
    _free(torch)

    # (b) lm-mtl
    mcfg = cfg.replace(n_tasks=LM_TASKS)
    sources = make_lm_sources(LM_TASKS, 16, LM_S, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = _counted_run(
        torch, _lm_session(mcfg, "lm-mtl", sources, LM_MTL_STEPS,
                           LM_TASK_B), counters)
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    per_task = [[r[f"task{t}"] for t in range(LM_TASKS)] for r in rows]
    if len(losses) != LM_MTL_STEPS or not all(
            map(math.isfinite, losses + sum(per_task, []))):
        fail(f"lm_train lm-mtl: losses {losses}, per task {per_task}")
    want = {"segment_sum_2d": LM_MTL_STEPS, **others}
    if launches != want:
        fail(f"lm_train lm-mtl: launches {launches}, the design implies "
             f"{want} (one trunk pass, one embedding backward a step)")
    out["lm_mtl"] = {"tasks": LM_TASKS, "batch_per_task": LM_TASK_B,
                     "steps": LM_MTL_STEPS, "losses": losses,
                     "per_task": per_task, "launches": launches,
                     "wall_s": wall,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del res
    _free(torch)
    out["launches"] = {k: out["lm"]["launches"][k]
                       + out["lm_mtl"]["launches"][k] for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 5: the LM attention kernels against their plain versions
# ---------------------------------------------------------------------------

PAD_POS = -(10 ** 9)
# the LM prefill shapes of runs (a) and (b), then edge cases
FA_CASES = [  # name, dtype, B, Sq, Sk, H, K, D, causal, window, rolled
    ("prefill_a", "bfloat16", 8, 1024, 1024, 32, 8, 80, True, 4096,
     False),
    ("prefill_b", "bfloat16", 1, 4200, 4200, 32, 8, 80, True, 4096,
     False),
    ("f32_prefill_a", "float32", 8, 1024, 1024, 32, 8, 80, True, 4096,
     False),
    ("f32_window_ragged", "float32", 2, 1000, 1000, 32, 8, 80, True,
     300, False),
    ("f32_no_window", "float32", 2, 333, 333, 32, 8, 80, True, 0,
     False),
    ("f32_rolled_pads", "float32", 1, 300, 300, 8, 2, 80, True, 128,
     True),
    ("bf16_rolled_pads", "bfloat16", 1, 300, 300, 8, 2, 80, True,
     128, True),
    ("f32_noncausal_mha", "float32", 1, 200, 200, 4, 4, 64, False,
     0, False),
    # the bf16 kernel's ring and skip: windows that skip tiles on both
    # sides of the diagonal, every head dim, G = 1..8, lengths ragged
    # against the 64-row query tile and the 64-key tile, rows that see no
    # key at all (Sq > Sk)
    ("bf16_window_ragged", "bfloat16", 2, 1000, 1000, 32, 8, 80, True,
     300, False),
    ("bf16_no_window", "bfloat16", 2, 333, 333, 32, 8, 80, True, 0,
     False),
    ("bf16_noncausal_mha_d64", "bfloat16", 1, 200, 200, 4, 4, 64, False,
     0, False),
    ("bf16_d16_g1_window", "bfloat16", 3, 65, 129, 4, 4, 16, True, 7,
     False),
    ("bf16_d32_g2", "bfloat16", 2, 63, 63, 8, 4, 32, True, 0, False),
    ("bf16_d96_g4", "bfloat16", 1, 129, 129, 8, 2, 96, True, 0, False),
    ("bf16_d128_g8_rows_without_keys", "bfloat16", 1, 129, 65, 8, 1, 128,
     True, 0, False),
    ("bf16_one_key", "bfloat16", 2, 1, 1, 8, 2, 80, True, 0, False),
]
# the LM decode shapes of runs (a) and (b), then edge cases
FD_CASES = [  # name, dtype, B, C, H, K, D, pos, window, n_splits, block_k
    ("decode_a", "bfloat16", 8, 1056, 32, 8, 80, 1040, 4096, None,
     None),
    ("decode_b_rolling", "bfloat16", 1, 4200, 32, 8, 80, 4210, 4096,
     None, None),
    ("f32_repro_plan", "float32", 3, 1000, 32, 8, 80, 700, 0, 8, 512),
    ("f32_dead_and_empty_splits", "float32", 2, 640, 8, 2, 64, 639,
     0, 12, 64),
    ("f32_rolling_window", "float32", 2, 300, 8, 8, 32, 777, 50, 5,
     None),
    # several splits a CTA (33 splits, 11 CTAs of 3); the largest
    # instantiation (f32, G = 16, D = 128)
    ("bf16_33_splits", "bfloat16", 2, 1056, 32, 8, 80, 1040, 4096, 33,
     None),
    ("f32_d128_g16", "float32", 2, 700, 16, 1, 128, 699, 0, None, None),
]


def _attn_err(torch, got, ref, name):
    """Max abs error of ``got`` against ``ref``, held per element to
    ATTN_TOL_F32 x max(1, max|ref|), plus ATTN_RTOL_BF16 x |ref| for bf16;
    also the worst element's share of its tolerance."""
    err, scale = scaled_err(torch, got, ref)
    diff = (got.float() - ref.float()).abs()
    tol = ATTN_TOL_F32 * scale
    if ref.dtype == torch.bfloat16:
        tol = tol + ATTN_RTOL_BF16 * ref.float().abs()
    share = float((diff / tol).max())
    if not share <= 1.0:
        fail(f"{name}: an element is off by {share:.3g} x its tolerance "
             f"(max_abs_err {err}, max|ref| {scale})")
    return err, share


def _bound(torch, n_ops, n_bytes, dtype):
    """The least time for this work: bytes over HBM, operations over the
    peak of the inputs' type (bf16 tensor cores, fp32 FFMA)."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = n_ops / peak * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations": n_ops, "bytes": n_bytes,
            "ops_rate": "bf16 tensor cores 989 TFLOP/s"
            if dtype == torch.bfloat16 else "fp32 FFMA 67 TFLOP/s",
            "fp32_ffma_bound_ms": n_ops / FP32_FLOPS * 1e3}


def check_flash_attention(torch, dev, g):
    """#5 against ``flash_attention_ref`` (f32 scores, full softmax) at the
    LM prefill shapes and edge cases; timed at runs (a) and (b)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import keep_mask
    worst, out = 0.0, {"cases": {}}
    for name, dt, B, Sq, Sk, H, K, D, causal, window, rolled in FA_CASES:
        dt = getattr(torch, dt)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = t(B, Sq, H, D), t(B, Sk, K, D), t(B, Sk, K, D)
        kp = torch.arange(Sk, device=dev, dtype=torch.int32)
        if rolled:
            kp = torch.remainder(kp - Sk // 3, Sk)
            kp[::11] = PAD_POS
        qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.int32)
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)
        ref = flash_attention_ref(q, k, v, qp, kp, **kw)
        again = flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)
        torch.cuda.synchronize()
        err, share = _attn_err(torch, got, ref, f"flash_attention {name}")
        if not torch.equal(got, again):
            fail(f"flash_attention {name}: two calls differ bitwise")
        worst = max(worst, err)
        out["cases"][name] = {"max_abs_err": err, "tol_share": share}
        if not name.startswith("prefill"):
            continue
        keep = keep_mask(qp.long(), kp.long(), **kw)
        pairs = int(keep.sum()) * B * H

        def kernel():
            flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)

        def plain():
            flash_attention_ref(q, k, v, qp, kp, **kw)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                           enable_gqa=True)
        ms = device_ms(torch, kernel, iters=10)
        wall = time_ms(torch, kernel, iters=10)
        plain_ms = device_ms(torch, plain, iters=5)
        lib = device_ms(torch, library, iters=10)
        isz = q.element_size()
        nbytes = isz * (2 * B * Sq * H * D + 2 * B * Sk * K * D) \
            + 4 * (Sq + Sk)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                 "library_ms": lib,
                 "library": "scaled_dot_product_attention(enable_gqa, "
                            "bool mask)",
                 "shape": [B, Sq, Sk, H, K, D], "window": window,
                 "kept_pairs": pairs,
                 **_bound(torch, 4 * D * pairs, nbytes, dt)}
        if name == "prefill_a":
            out.update(timed)
        else:
            out[name] = timed
    out["max_abs_err"] = worst
    return out


def _cache_positions(torch, dev, C, pos, window):
    """k_pos of a (rolling) cache of C slots after position ``pos`` was
    written, the window folded in — what the decode path hands #6."""
    j = torch.arange(C, device=dev)
    slot_pos = pos - torch.remainder(pos - j, C)
    valid = slot_pos >= 0
    if window:
        valid &= slot_pos > pos - window
    return torch.where(valid, slot_pos, PAD_POS).to(torch.int32)


def check_flash_decode(torch, dev, g):
    """#6 against the plain split partials + combine with the same plan,
    and against ``decode_ref``, at the LM decode shapes and edge cases;
    each case's plan and kernels a call (from a profiler trace: more than
    one fails the run); timed at runs (a) and (b)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  decode_partials_ref,
                                                  decode_ref, flash_decode,
                                                  plan_call)
    worst, out = 0.0, {"cases": {}}
    for name, dt, B, C, H, K, D, pos, window, n_splits, block_k in FD_CASES:
        dt = getattr(torch, dt)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = t(B, 1, H, D), t(B, C, K, D), t(B, C, K, D)
        kp = _cache_positions(torch, dev, C, pos, window)[None].expand(B, C)
        if name.startswith("f32_dead"):
            kp = kp.clone()
            kp[:, 128:192] = PAD_POS             # split 2: pads only
            kp[:, 320:384] = 10 ** 6             # split 5: future keys only
        qp = torch.full((B,), pos, device=dev, dtype=torch.int32)
        kw = dict(n_splits=n_splits, block_k=block_k)
        got = flash_decode(q, k, v, q_pos=qp, k_pos=kp, **kw)
        again = flash_decode(q, k, v, q_pos=qp, k_pos=kp, **kw)
        plan = plan_call(q, k, n_splits, block_k)

        def plain():
            m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp,
                                            n_splits=plan.n_splits,
                                            per_split=plan.per_split)
            return combine_partials(m, l, acc).reshape(B, 1, H, D).to(dt)
        ref = plain()
        oracle = decode_ref(q, k, v, q_pos=qp, k_pos=kp)
        torch.cuda.synchronize()
        err, share = _attn_err(torch, got, ref, f"flash_decode {name}")
        _attn_err(torch, got, oracle, f"flash_decode {name} vs decode_ref")
        if not torch.equal(got, again):
            fail(f"flash_decode {name}: two calls differ bitwise")
        # the profiler drops an event now and then (never adds one): a
        # count under 1 is traced again, three times at most
        for _ in range(3):
            n_kernels = device_profile(torch, lambda: flash_decode(
                q, k, v, q_pos=qp, k_pos=kp, **kw),
                iters=5)["kernels_per_call"]
            if n_kernels >= 1:
                break
        if n_kernels != 1:
            fail(f"flash_decode {name}: {n_kernels} kernels a call, not 1")
        worst = max(worst, err)
        out["cases"][name] = {"max_abs_err": err, "tol_share": share,
                              "kernels_per_call": n_kernels,
                              "plan": plan._asdict()}
        if not name.startswith("decode"):
            continue
        # the decode path reads each layer's cache once, after the layer
        # before streamed its weights through L2: time over copies of the
        # cache that together exceed the 50 MB L2, taken in turn
        n_copy = 1 + (100 << 20) // (2 * B * C * K * D * q.element_size())
        copies = itertools.cycle([(k.clone(), v.clone())
                                  for _ in range(n_copy)])
        mask = (kp > -(10 ** 8))[:, None, None, :]

        def kernel():
            kc, vc = next(copies)
            flash_decode(q, kc, vc, q_pos=qp, k_pos=kp, **kw)

        def library():
            kc, vc = next(copies)
            F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        ms = device_ms(torch, kernel, iters=50)
        wall = time_ms(torch, kernel, iters=50)
        plain_ms = device_ms(torch, plain, iters=10)
        lib = device_ms(torch, library, iters=50)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                 "library_ms": lib,
                 "library": "scaled_dot_product_attention(enable_gqa, "
                            "bool mask), one query token",
                 "l2_cold_copies": n_copy,
                 "shape": [B, C, H, K, D], "pos": pos,
                 **_fd_bound(torch, q, kp, K)}
        if name == "decode_a":
            out.update(timed)
        else:
            out[name] = timed
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 6: LM serving at full width
# ---------------------------------------------------------------------------

def _lm_prompts(cfg, B, S, extra=0, seed=0):
    import torch

    from repro_torch.data.lm_data import make_lm_source
    src = make_lm_source(seed, B, S + extra, cfg.vocab)
    return torch.from_numpy(src["tokens"])


def _teacher_forced(torch, params, cfg, toks, S, impl):
    """Prefill ``toks[:, :S]`` and decode the rest fed the true tokens:
    the last prefill logits and each decode step's over the real vocab,
    (steps, B, vocab), and the caches (one slot to spare for a follow-on
    step)."""
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    dev = params["embed"]["table"].device
    toks = toks.to(dev)
    logits, caches = make_prefill_step(cfg, impl)(params, toks[:, :S])
    caches = extend_caches(caches, cfg, toks.shape[1] + 1)
    steps = [logits[:, -1]]
    decode = make_decode_step(cfg, impl)
    for t in range(S, toks.shape[1]):
        lg, caches = decode(params, toks[:, t:t + 1], caches, t)
        steps.append(lg[:, 0])
    return torch.stack(steps)[..., :cfg.vocab], caches


def _prefill_device_ms(torch, params, cfg, prompt):
    """Device time of one kernel-path prefill of ``prompt`` (all its
    kernels, ``torch.profiler``), after a warm-up."""
    from repro_torch.train.serve import make_prefill_step
    prefill = make_prefill_step(cfg, "pallas")
    toks = prompt.to(params["embed"]["table"].device)
    return device_ms(torch, lambda: prefill(params, toks), iters=3, warm=1)


def _gen_run(torch, params, cfg, prompt, n_new, counters):
    from repro_torch.train.serve import greedy_generate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    timings = {}
    toks, logits = greedy_generate(params, cfg, prompt, n_new,
                                   impl="pallas", device=DEVICE,
                                   return_logits=True, timings=timings)
    launches = {k: c.launches for k, c in counters.items()}
    B, S = prompt.shape
    if not (toks.shape == (B, n_new) and bool(torch.isfinite(logits).all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        fail(f"lm_serve B={B} S={S}: bad tokens or non-finite logits")
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * (n_new - 1)}
    if launches != want:
        fail(f"lm_serve B={B} S={S}: launches {launches}, design implies "
             f"{want} (one per layer per prefill / decode step)")
    info = {"batch": B, "prompt": S, "new": n_new, "launches": launches,
            "prefill_s": timings["prefill_s"],
            "prefill_tok_per_s": B * S / timings["prefill_s"],
            "decode_s": timings["decode_s"],
            "decode_tok_per_s": B * (n_new - 1) / timings["decode_s"],
            "decode_ms_per_step": timings["decode_s"] / (n_new - 1) * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return toks, logits, info


def lm_serve_phase(torch, counters):
    from repro_torch import interop
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    from repro_torch.models.common import normal_init
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in interop.leaves(params).values())

    # (a) B=8, prompt 1024, 32 new; twice, bitwise
    prompt_a = _lm_prompts(cfg, 8, 1024, seed=1)
    toks_a, logits_a, run_a = _gen_run(torch, params, cfg, prompt_a, 32,
                                       counters)
    toks_a2, logits_a2, run_a2 = _gen_run(torch, params, cfg, prompt_a, 32,
                                          counters)
    if not (torch.equal(toks_a, toks_a2) and torch.equal(logits_a,
                                                         logits_a2)):
        fail("lm_serve (a): two kernel-path runs differ bitwise")
    # (b) B=1, prompt 4200 (past the 4096 window), 16 new
    prompt_b = _lm_prompts(cfg, 1, 4200, seed=2)
    _, logits_b, run_b = _gen_run(torch, params, cfg, prompt_b, 16,
                                  counters)
    del logits_b

    # teacher-forced logits, kernel path vs plain path, bf16 compute
    tf_toks = _lm_prompts(cfg, 8, 1024, extra=8, seed=1)
    S = tf_toks.shape[1] - 8
    prefill_ms = _prefill_device_ms(torch, params, cfg, tf_toks[:, :S])
    got, caches = _teacher_forced(torch, params, cfg, tf_toks, S, "pallas")
    want, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "chunked")
    scale = float(want.abs().max())
    tf_err = float((got - want).abs().max())
    per_step = (got - want).abs().amax(dim=(1, 2)).tolist()
    if not tf_err <= LM_TOL_BF16 * scale:
        fail(f"lm_serve teacher-forced bf16 logits: max_abs_err {tf_err} > "
             f"{LM_TOL_BF16}*{scale} (per step {per_step})")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    del got, want

    # task heads: one task= decode step of a 3-head tree from the kernel
    # path's caches (each path writes its slot into its own copy)
    from repro_torch.train.serve import make_decode_step
    cfg3 = cfg.replace(n_tasks=3)
    params3 = dict(params, task_heads={"w": normal_init(
        gen, (3, cfg.d_model, cfg.padded_vocab), cfg.param_dtype, 0.02,
        dev)})
    nxt = tf_toks[:, -1:].to(dev)
    task_out = {}
    for impl in ("pallas", "chunked"):
        c = interop.tree_map(torch.clone, caches)
        lg, _ = make_decode_step(cfg3, impl, task=1)(params3, nxt, c,
                                                     tf_toks.shape[1])
        task_out[impl] = lg[:, 0, :cfg.vocab]
    task_err = float((task_out["pallas"] - task_out["chunked"]).abs().max())
    task_scale = float(task_out["chunked"].abs().max())
    if not task_err <= LM_TOL_BF16 * task_scale:
        fail(f"lm_serve task head: max_abs_err {task_err} > "
             f"{LM_TOL_BF16}*{task_scale}")
    del params3, caches, task_out

    # the same check in f32 compute: the kernels' arithmetic, no bf16 flips
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    tf32 = _lm_prompts(cfg, 2, 256, extra=4, seed=3)
    S32 = tf32.shape[1] - 4
    got32, _ = _teacher_forced(torch, params, cfg32, tf32, S32, "pallas")
    want32, _ = _teacher_forced(torch, params, cfg32, tf32, S32, "chunked")
    atol, rtol = LM_TOL_F32
    f32_err = float((got32 - want32).abs().max())
    if not torch.allclose(got32, want32, atol=atol, rtol=rtol):
        fail(f"lm_serve teacher-forced f32 logits: max_abs_err {f32_err} "
             f"beyond atol {atol} / rtol {rtol}")
    return {"phase": "lm_serve", "config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.hd, "window": cfg.window, "params": n_params,
            "init_s": init_s, "compute_dtype": "bfloat16", "impl": "pallas",
            "run_a": run_a, "run_a_replay": run_a2, "run_b": run_b,
            "replay_bitwise": True, "prefill_device_ms": prefill_ms,
            "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
            "teacher_forced": {
                "steps": len(per_step), "bf16_max_abs_err": tf_err,
                "bf16_max_abs_logit": scale, "bf16_per_step": per_step,
                "bf16_tolerance": LM_TOL_BF16 * scale,
                "argmax_agreement": agree, "f32_max_abs_err": f32_err,
                "f32_tolerance": list(LM_TOL_F32)},
            "task_head": {"n_tasks": 3, "task": 1, "max_abs_err": task_err,
                          "tolerance": LM_TOL_BF16 * task_scale}}


def lm_profile(torch):
    """Device time by kernel for one full-width prefill (B=8, S=1024) and
    one decode step (B=8, cache 1056), kernel path, after a warm-up of
    each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.lm_init(gen, cfg, device=dev)
    toks = _lm_prompts(cfg, 8, 1024, extra=3, seed=1).to(dev)
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        return out, _device_time_by_kernel(torch, prof, wall_us)
    prefill(params, toks[:, :1024])                         # warm-up
    (_, caches), pre = traced(lambda: prefill(params, toks[:, :1024]))
    caches = extend_caches(caches, cfg, 1056)
    decode(params, toks[:, 1024:1025], caches, 1024)        # warm-up
    _, dec = traced(lambda: decode(params, toks[:, 1025:1026], caches, 1025))
    # wall times under the profiler, which slows the host side: the idle
    # shares read from them are upper estimates
    return {"phase": "profile_lm", "config": cfg.name,
            "batch": "prefill B=8 S=1024; decode B=8 cache 1056",
            "prefill": pre, "decode_step": dec}


def _fd_plan(fd_ops, q, k, n_splits=None, block_k=None) -> dict:
    """The split plan #6 takes for these inputs (an earlier checkout's
    ``plan_splits`` gives only its split count and length)."""
    if hasattr(fd_ops, "plan_call"):
        return fd_ops.plan_call(q, k, n_splits, block_k)._asdict()
    n, per = fd_ops.plan_splits(k.shape[0], k.shape[2], k.shape[1],
                                n_splits, block_k)[:2]
    return {"n_splits": n, "per_split": per}


def _fd_bound(torch, q, kp, K) -> dict:
    """#6's bound: q in and the output out, the k/v rows of the valid keys
    only (pads and slots past the window are not needed), k_pos and
    q_pos; 4·D FLOP a (head, valid key)."""
    B, _, H, D = q.shape
    valid = int((kp > -(10 ** 8)).sum())
    nbytes = q.element_size() * (2 * B * H * D + 2 * valid * K * D) \
        + 4 * (kp.numel() + B)
    return {"valid_keys": valid,
            **_bound(torch, 4 * D * H * valid, nbytes, q.dtype)}


# the LM decode shapes of runs (a) and (b): name, B, cache slots, position
FD_SWEEP = (("decode_a", 8, 1056, 1040), ("decode_b_rolling", 1, 4200, 4210))
FD_SWEEP_SPLITS = (1, 2, 3, 4, 9, 17, 33, None)   # run (a); None: default


def attn_sweep(torch):
    """Device time per call of #5 over masks, each beside
    ``scaled_dot_product_attention`` on the same inputs (the bool keep mask,
    as ``library_ms`` takes it, and SDPA's own causal / unmasked form where
    the mask has one), at the LM prefill shape (B=8, S=1024, bf16); and of
    #6 at the LM decode shapes of runs (a) and (b) (window 4096 folded into
    k_pos, as the decode path passes it), over split counts and the default
    plan at (a), the default plan at (b), each with its device time by
    kernel name, kernels a call, its time with the host's share (CUDA
    events, ``wall_ms``), its plan and the waves the card takes for it,
    beside SDPA and the bound. Inputs are L2-warm: the measurements behind
    the kernels' redesign notes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import keep_mask
    from repro_torch.kernels.flash_decode import ops as fd_ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    B, S, H, K, D = 8, 1024, 32, 8, 80
    fa_shape = [B, S, H, K, D]
    q, k, v = t(B, S, H, D), t(B, S, K, D), t(B, S, K, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    fa = {}
    for mask, kw, native in (
            ("causal", dict(causal=True), dict(is_causal=True)),
            ("causal_window_64", dict(causal=True, window=64), None),
            ("none", dict(causal=False), {})):
        keep = keep_mask(pos.long(), pos.long(), causal=kw["causal"],
                         window=kw.get("window", 0))
        got = flash_attention(q, k, v, q_pos=pos, k_pos=pos, **kw)
        row = {"kernel": device_ms(torch, lambda: flash_attention(
            q, k, v, q_pos=pos, k_pos=pos, **kw), iters=10),
            # the output's bits, to hold two versions to the same result
            "sha256": hashlib.sha256(
                got.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "sdpa_bool_mask": device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True), iters=10)}
        if native is not None:
            row["sdpa_native"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **native), iters=10)
        fa[mask] = row
    fd = {}
    for name, B, C, p in FD_SWEEP:
        q1, kc, vc = t(B, 1, H, D), t(B, C, K, D), t(B, C, K, D)
        kp = _cache_positions(torch, dev, C, p, 4096)[None].expand(B, C)
        qp = torch.full((B,), p, device=dev, dtype=torch.int32)
        mask = (kp > -(10 ** 8))[:, None, None, :]
        row = {"shape": [B, C, H, K, D], "pos": p,
               "sdpa_ms": device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q1.transpose(1, 2), kc.transpose(1, 2),
                       vc.transpose(1, 2), attn_mask=mask, enable_gqa=True),
                   iters=50),
               **_fd_bound(torch, q1, kp, K)}
        if hasattr(fd_ops, "max_active_clusters"):
            # the card's occupancy of this instantiation: clusters of
            # 1..16 CTAs (one split each) that one wave holds, by ring depth
            row["max_active_clusters"] = {
                f"stages_{st}": [fd_ops.max_active_clusters(
                    dev.index or 0, q1.dtype, H // K, D, c, st, 1)
                    for c in range(1, fd_ops.MAX_CLUSTER + 1)]
                for st in fd_ops.STAGES}
        for n in FD_SWEEP_SPLITS if name == "decode_a" else (None,):
            def call():
                fd_ops.flash_decode(q1, kc, vc, q_pos=qp, k_pos=kp,
                                    n_splits=n)
            plan = _fd_plan(fd_ops, q1, kc, n)
            cell = {**device_profile(torch, call, iters=50),
                    # CUDA events around back-to-back calls: the host's
                    # share of a call included
                    "wall_ms": time_ms(torch, call, iters=200),
                    "plan": plan}
            if "cluster" in plan:
                # the card's clusters a wave at this plan, and the waves
                # the B·K clusters take
                per_wave = fd_ops.max_active_clusters(
                    dev.index or 0, q1.dtype, H // K, D, plan["cluster"],
                    plan["stages"], plan["splits_per_cta"])
                cell.update(clusters_a_wave=per_wave,
                            waves=-(-B * K // per_wave))
            row[f"splits_{n or 'default'}"] = cell
        fd[name] = row
    return {"phase": "attn_sweep", "flash_attention_shape": fa_shape,
            "flash_attention_ms_by_mask": fa, "flash_decode": fd}


def ss_sweep(torch):
    """Device time per call of #1 (one graph, 2-D) and #2 (B=8) at the
    serve path's graph shape (E=2048, A=64, F=866, f32, 85% of edges
    valid), each beside ``index_add_`` on the same inputs and its byte
    bound; the inputs come from their own seed, so two versions (``--src``)
    see the same data."""
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    B, E, A, F = 8, 2048, 64, 866
    msg = torch.randn((B, E, F), generator=g, device=dev)
    _, dst, em = edge_case(torch, B, E, A, g, dev)
    routed = torch.where(em, dst, torch.full_like(dst, A))
    out = {}
    for name, m, d, e in (("1_segment_sum_2d", msg[0], routed[0], em[0]),
                          ("2_segment_sum_batched", msg, routed, em)):
        d32 = d.to(torch.int32).contiguous()
        got = ops.segment_sum(m, d32, A)
        err, scale = scaled_err(torch, got, segment_sum_ref(m, d, A))
        if not err <= SS_TOL * scale:
            fail(f"ss_sweep {name}: max_abs_err {err} > {SS_TOL}*{scale}")
        b = m.shape[0] if m.dim() == 3 else 1
        n_valid = int(e.sum())
        out[name] = {
            "shape": [b, E, A, F], "valid_edges": n_valid,
            "ms": device_ms(torch, lambda: ops.segment_sum(m, d32, A),
                            iters=50),
            "wall_ms": time_ms(torch, lambda: ops.segment_sum(m, d32, A),
                               iters=50),
            "library_ms": device_ms(torch, _ss_library(torch, m, d, e, A),
                                    iters=50),
            # every edge routed to the sentinel: the dst walk, the zero
            # writes and the launch, no message loaded
            "walk_only_ms": device_ms(torch, lambda: ops.segment_sum(
                m, torch.full_like(d32, A), A), iters=50),
            "max_abs_err": err, **_ss_bound(b, E, A, F, n_valid)}
    out["1_embedding"] = _embed_sweep(torch, g)
    return {"phase": "ss_sweep", **out}


EMBED_BLOCK_N = (24, 48, 96, 192, 384, 768, 1536)


def _embed_sweep(torch, g):
    """#1 at the embedding's backward (phase ``lm_train``'s batch: 8 x
    1024 qwen1.5-0.5b tokens from ``lm_data``, bf16 rows of 1024 into
    152064): device time by node block at the whole-list window (the
    default plan's 384 among them, every block the same bits), beside
    ``index_add_``, and the same over ids drawn uniformly from the vocab:
    the Zipf draw puts most ids in the first node block, whose CTA sums
    them one after another."""
    import numpy as np
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.kernels.segment_sum import ops
    cfg = qwen1_5_0_5b.CONFIG
    V, D = cfg.padded_vocab, cfg.d_model
    dev = torch.device("cuda")
    toks = make_lm_sources(1, 64, LM_S, cfg.vocab)[0]["tokens"][:LM_B]
    zipf = torch.from_numpy(toks.reshape(-1).astype(np.int32)).to(dev)
    uniform = torch.randint(0, cfg.vocab, zipf.shape, generator=g,
                            device=dev, dtype=torch.int32)
    msg = (torch.randn((zipf.numel(), D), generator=g, device=dev)
           * 1e-3).to(torch.bfloat16)
    out = {"shape": [zipf.numel(), V, D], "dtype": "bfloat16",
           "default_plan": dict(ops.plan(V, zipf.numel(), D,
                                         itemsize=2)._asdict())}
    for name, ids in (("zipf", zipf), ("uniform", uniform)):
        want = ops.segment_sum(msg, ids, V)
        by_block = {}
        for bn in EMBED_BLOCK_N:
            if not torch.equal(ops.segment_sum(msg, ids, V, block_n=bn,
                                               block_e=ids.numel()), want):
                fail(f"ss_sweep embedding {name}: block_n={bn} changes the "
                     "bits")
            by_block[bn] = device_ms(torch, lambda: ops.segment_sum(
                msg, ids, V, block_n=bn, block_e=ids.numel()), iters=10)
        ids64 = ids.long()
        out[name] = {
            "ms_by_block_n": by_block,
            "first_block_ids": int((ids < 384).sum()),
            "top_id_count": int(ids.bincount().max()),
            "library_ms": device_ms(torch, lambda: torch.zeros(
                (V, D), dtype=msg.dtype, device=dev).index_add_(
                    0, ids64, msg), iters=10)}
    return out


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def edge_sweep(torch):
    """#4 by device time and kernel name at the training path's shape
    (B=40, no dpos) and at B=8 with dpos, with a hash of its outputs; #3
    at both shapes by kernel, with a hash of its outputs (and scratch) and
    the relative error of its output against a float64 forward on the same
    inputs; where the checkout's #3 takes a plan override, its device time
    over split counts (proj, fc1) and column tiles; one full-width training
    step's device time by kernel (``torch.profiler``) and its host-clock ms
    a step over 5 steps. Inputs from their own seed, so two versions
    (``--src``) see the same data."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.egnn_edge import egnn_edge_agg, ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    out = {"phase": "edge_sweep"}
    plans = "splits" in inspect.signature(ops._launch_fwd).parameters
    for name, B, need_dpos in (("b40", 40, False), ("b8", 8, True)):
        leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, 64, 2048)
        call, sr, dr = _edge_bwd_call(torch, leaves, edges, gup, need_dpos)
        prof = device_profile(torch, call)
        out[f"bwd_{name}"] = {
            "dpos": need_dpos, "ms": prof["ms"],
            "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "sha256": _sha(x for x in call() if x is not None)}
        h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        fwd = _edge_fwd_call(torch, h, pos, *edges, phi)
        prof = device_profile(torch, fwd)
        n_valid = int(edges[2].sum())
        with torch.no_grad():
            got = egnn_edge_agg(h, pos, *edges, phi)
            exact = _edge_fwd_plain(torch, h, pos, *edges, phi,
                                    torch.float64)[0]
        out[f"fwd_{name}"] = {
            "ms": prof["ms"], "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "sha256": _sha(fwd()), "valid_edges": n_valid,
            "rel_err_vs_f64": float((got.double() - exact).abs().max()
                                    / exact.abs().max()),
            **_edge_fwd_bound(B, 64, 2048, 866, n_valid)}
        del got, exact
        if plans:
            by_plan = {}
            for sp in ((1, 1), (1, 2), (2, 2), (2, 4), (4, 4)):
                by_plan[f"splits_{sp[0]}_{sp[1]}"] = device_profile(
                    torch, _edge_fwd_call(torch, h, pos, *edges, phi,
                                          splits=sp))["by_kernel"]
            for bh in (32, 64, 128):
                by_plan[f"block_h_{bh}"] = device_profile(
                    torch, lambda: egnn_edge_agg(
                        h, pos, *edges, phi, block_h=bh))["by_kernel"]
            out[f"fwd_{name}"]["by_plan"] = by_plan
        out[f"bwd_{name}"].update(
            valid_edges=n_valid,
            **_edge_bwd_bounds(B, 64, 2048, 866, n_valid, need_dpos))
    with _train_session(torch, _train_sources(), 3) as sess:
        batches = sess._batches()
        state = sess.state
        for _ in range(2):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sess.step_fn(state, batches())
            torch.cuda.synchronize()
        step = _device_time_by_kernel(torch, prof)
        t0 = time.perf_counter()
        for _ in range(5):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
    out["train_step"] = {"device_ms": step["device_us_total"] / 1e3,
                         "launches": step["launches"], "top": step["top"],
                         "ms_per_step": step_ms}
    return out


def lm_bf16_probe(torch):
    """The bf16 GEMM reduction setting in force, the device time of one
    kernel-path prefill at run (a) (B=8, S=1024), the teacher-forced bf16
    error of the lm_serve phase (prefill + 8 decode steps, kernel path
    against the plain path, the same seeds) and run (a)'s decode time a
    step on the host's clock, so that two versions (``--src``) can be
    compared in one call."""
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.lm_init(gen, cfg, device=dev)
    tf_toks = _lm_prompts(cfg, 8, 1024, extra=8, seed=1)
    S = tf_toks.shape[1] - 8
    prefill_ms = _prefill_device_ms(torch, params, cfg, tf_toks[:, :S])
    got, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "pallas")
    want, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "chunked")
    # run (a)'s generation (B=8, prompt 1024, 32 new) on the host's clock,
    # after one run to warm up
    from repro_torch.train.serve import greedy_generate
    prompt = _lm_prompts(cfg, 8, 1024, seed=1)
    for _ in range(2):
        timings = {}
        greedy_generate(params, cfg, prompt, 32, impl="pallas", device=dev,
                        timings=timings)
    return {"phase": "lm_bf16",
            "decode_ms_per_step": timings["decode_s"] / 31 * 1e3,
            "decode_tok_per_s": 8 * 31 / timings["decode_s"],
            "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
            "prefill_device_ms": prefill_ms,
            "teacher_forced_bf16_max_abs_err":
                float((got - want).abs().max()),
            "bf16_max_abs_logit": float(want.abs().max()),
            "bf16_tolerance": LM_TOL_BF16 * float(want.abs().max())}


def _device_time_by_kernel(torch, prof, wall_us=None):
    """Device time by kernel: only events that ran on the device, so the
    host ops and autograd nodes that launched a kernel (which the profiler
    also credits with its time) do not count it again."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = ev.device_time_total
        if dt:
            rows.append((dt, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"device_us_total": busy, "kernels": len(rows),
           "launches": sum(r[2] for r in rows),
           "top": [{"kernel": k, "us": t, "calls": c}
                   for t, k, c in rows[:12]]}
    if wall_us is not None:
        out.update(wall_us=wall_us, device_idle_share=1 - busy / wall_us)
    return out


def profile_phase(torch):
    """Device time by kernel name (``torch.profiler``) for the forward of
    one full-width served batch (8 rows of A=64, E=2048), per impl."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.synthetic_atoms import generate_source
    from repro_torch.models import gnn, heads
    dev = torch.device("cuda")
    params = interop.to_torch(gfm_mtl_init(CONFIG, 1, seed=0), dev)
    hp = {br: {fc: {p: t[0] for p, t in layer.items()}
               for fc, layer in mlp.items()}
          for br, mlp in params["heads"].items()}
    s = generate_source("mptrj", 8, max_atoms=64, max_edges=2048, seed=0)
    batch = {k: torch.from_numpy(getattr(s, k)).to(dev) for k in
             ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask")}
    out = {}
    for impl in ("fused", "pallas"):
        cfg = CONFIG.replace(segment_sum_impl=impl)

        def fwd():
            with torch.inference_mode():
                f = gnn.egnn_apply(params["shared"], batch, cfg=cfg)
                return heads.branch_apply(hp, f, batch["node_mask"], cfg=cfg)
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        out[impl] = _device_time_by_kernel(torch, prof)
    # one full-width training step (5 tasks x 8 graphs, fused), after two
    # warm-up steps
    with _train_session(torch, _train_sources(), 3) as sess:
        batches = sess._batches()
        state = sess.state
        for _ in range(2):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = sess.step_fn(state, batches())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # the step's wall time is taken under the profiler, which slows the
    # host side: the idle share read from it is an upper estimate
    out["train_step"] = _device_time_by_kernel(torch, prof, wall_us)
    return {"phase": "profile", "batch": "mptrj B=8 A=64 E=2048; train "
            "step 5 tasks x 8 graphs", **out}


def sweep_in_turns(other: Path):
    """``--sweep`` for ``other`` (an earlier checkout's src/) and this
    checkout in turns, parent, change, change, parent, each in its own
    process; every line tagged with its turn, then a summary of the
    kernels' device times by turn."""
    turns = [("parent", other), ("change", SRC), ("change", SRC),
             ("parent", other)]
    summary = []
    for i, (version, src) in enumerate(turns):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--sweep", "--once", "--src", str(src)],
                           stdout=subprocess.PIPE, text=True)
        row = {"turn": i, "version": version}
        for line in r.stdout.splitlines():
            if not line.startswith("{"):
                print(line, flush=True)
                continue
            rec = json.loads(line)
            emit({"turn": i, "version": version, **rec})
            if rec.get("phase") == "ss_sweep":
                row.update({k: rec[k]["ms"] for k in rec if k != "phase"})
            elif rec.get("phase") == "attn_sweep":
                fa = rec["flash_attention_ms_by_mask"]
                row["flash_attention_causal"] = fa["causal"]["kernel"]
                row["flash_attention_sha256"] = {
                    k: v["sha256"][:16] for k, v in fa.items()}
                for k, v in rec["flash_decode"].items():
                    row[f"flash_{k}_default"] = v["splits_default"]["ms"]
                    row[f"flash_{k}_default_wall"] = \
                        v["splits_default"]["wall_ms"]
                row["flash_decode_a_ms_by_splits"] = {
                    k[len("splits_"):]: v["ms"]
                    for k, v in rec["flash_decode"]["decode_a"].items()
                    if k.startswith("splits_")}
            elif rec.get("phase") == "lm_bf16":
                row["decode_ms_per_step"] = rec["decode_ms_per_step"]
            elif rec.get("phase") == "edge_sweep":
                for k in ("bwd_b40", "bwd_b8", "fwd_b40", "fwd_b8"):
                    row[f"egnn_edge_{k}"] = {
                        x: rec[k][x] for x in ("ms", "by_kernel",
                                               "kernels_per_call", "sha256",
                                               "rel_err_vs_f64", "bound_ms",
                                               "bound_ffma_ms")
                        if x in rec[k]}
                row["train_step_device_ms"] = rec["train_step"]["device_ms"]
                row["train_step_launches"] = rec["train_step"]["launches"]
                row["train_step_ms"] = rec["train_step"]["ms_per_step"]
        if r.returncode != 0:
            fail(f"--sweep for {src} exited {r.returncode}")
        summary.append(row)
    emit({"phase": "sweep_summary", "ms_by_turn": summary,
          "flash_attention_bits_equal": len({json.dumps(
              r["flash_attention_sha256"]) for r in summary}) == 1,
          "egnn_edge_fwd_bits_equal_by_version": {
              v: len({(r["egnn_edge_fwd_b40"]["sha256"],
                       r["egnn_edge_fwd_b8"]["sha256"])
                      for r in summary if r["version"] == v}) == 1
              for v in ("parent", "change")},
          "egnn_edge_bwd_bits_equal_by_version": {
              v: len({(r["egnn_edge_bwd_b40"]["sha256"],
                       r["egnn_edge_bwd_b8"]["sha256"])
                      for r in summary if r["version"] == v}) == 1
              for v in ("parent", "change")}})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one served "
                         "batch, one train step, one LM prefill and one "
                         "decode step, and of #5 over masks and #6 over "
                         "split counts")
    ap.add_argument("--sweep", action="store_true",
                    help="only build the kernels and print the sweeps (#4 "
                         "and #3 at B=40 and B=8, a training step; #1 and "
                         "#2 beside index_add_; #5 beside SDPA over masks, "
                         "#6 over split counts; the LM prefill's device time "
                         "and bf16 error), then exit; no contract line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to import "
                         "(default: this checkout's), e.g. an unpacked "
                         "earlier commit's; with --sweep, the sweeps run "
                         "for it and for this checkout in turns: it, this, "
                         "this, it")
    ap.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    src = args.src.resolve()
    if args.sweep and not args.once and src != SRC.resolve():
        return sweep_in_turns(src)
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.kernels import _build
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops

    smi = nvidia_smi()
    build = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build["seconds"],
          "built": build["built"], "src": str(src)})
    if args.sweep:
        emit(edge_sweep(torch))
        emit(ss_sweep(torch))
        emit(attn_sweep(torch))
        emit(lm_bf16_probe(torch))
        return

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ss = check_segment_sum(torch, dev, g)
    emit({"phase": "kernel", "name": "segment_sum", "tolerance": SS_TOL, **ss})
    eg = check_egnn_edge(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused", "tolerance": EDGE_TOL,
          **eg})
    eb = check_egnn_edge_bwd(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bwd",
          "tolerance": BWD_TOL, **eb})
    eg16 = check_egnn_edge(torch, dev, g, torch.bfloat16)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bf16",
          "tolerance": EDGE_BF16_TOL, **eg16})
    eb16 = check_egnn_edge_bwd_bf16(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bwd_bf16",
          "tolerance": {"vs_plain": BWD_TOL,
                        "vs_f32_launch_on_upcast": "bitwise"}, **eb16})
    fa = check_flash_attention(torch, dev, g)
    emit({"phase": "kernel", "name": "flash_attention",
          "tolerance": {"f32": ATTN_TOL_F32, "bf16_rtol": ATTN_RTOL_BF16},
          **fa})
    fd = check_flash_decode(torch, dev, g)
    emit({"phase": "kernel", "name": "flash_decode",
          "tolerance": {"f32": ATTN_TOL_F32, "bf16_rtol": ATTN_RTOL_BF16},
          **fd})

    if args.profile:
        emit(attn_sweep(torch))
        emit(profile_phase(torch))
    serve, serve_rows = serve_phase(torch, N_REQUESTS)
    emit(serve)
    gnn_counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                    "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                    "segment_sum": ss_ops.segment_sum,
                    "segment_sum_2d": ss_ops.segment_sum.two_d}
    scaleout = serve_scaleout_phase(torch, serve, gnn_counters)
    emit(scaleout)
    train = train_phase(torch, gnn_counters)
    emit(train)
    bf16_counters = {**gnn_counters,
                     "egnn_edge_bf16": edge_ops.egnn_edge_agg.bf16,
                     "egnn_edge_bwd_bf16": edge_ops.egnn_edge_bwd.bf16}
    gnn16 = gnn_bf16_phase(torch, serve_rows, bf16_counters)
    emit(gnn16)
    del serve_rows
    pipe = train_pipeline_phase(torch, gnn_counters)
    emit(pipe)
    mtp = train_mtp_phase(torch)
    emit(mtp)
    fine = finetune_phase(torch, gnn_counters)
    emit(fine)
    lm = lm_serve_phase(torch, {"flash_attention": fa_ops.flash_attention,
                                "flash_decode": fd_ops.flash_decode})
    emit(lm)
    if args.profile:
        emit(lm_profile(torch))
    lmt = lm_train_phase(torch, {
        "segment_sum_2d": ss_ops.segment_sum.two_d,
        "segment_sum": ss_ops.segment_sum,
        "flash_attention": fa_ops.flash_attention,
        "flash_decode": fd_ops.flash_decode})
    emit(lmt)
    # #1 on each training path's own embedding cotangent, at its shape
    ss2 = lmt.pop("segment_sum_2d")
    ss2["checks_by_path"] = {
        "train": train["embed_grad"],
        "train_pipeline": pipe["mtl_all"]["grad_vs_plain"]["embed_grad"],
        "gnn_bf16": gnn16["train"]["grad_vs_plain"]["embed_grad"],
        "finetune": fine["embed_grad"],
        "lm_train": lmt["lm"]["embed_grad"]}
    ss2["max_abs_err"] = max(c[c["dtype"]]["max_abs_err"]
                             for c in ss2["checks_by_path"].values())
    emit({"phase": "kernel", "name": "segment_sum_2d", "tolerance": {
        "vs_token_order_sum": "bitwise", "vs_one_hot": "2 n u sum|g| "
        "(+ 2^-7 |ref| in bf16)"}, **ss2})
    # each path's counts, zeroed just before it: serving (fused and pallas
    # passes), serving scale-out (runs (a) and (d)), training, the
    # pre-training pipeline (runs (a) and (b)), the task-parallel runs
    # (every rank of (a)-(c)), the bf16 GNN path (its serving passes and
    # its training run), fine-tuning (pre-training, both fine-tuning runs
    # and the accum=2 step), LM serving (runs (a) and (b)) and LM training
    # (runs (a) and (b)). #1 takes every embedding's backward: the species
    # embedding's on the GNN training paths, the token embedding's on
    # lm_train
    lm_runs = (lm["run_a"]["launches"], lm["run_b"]["launches"])
    s16, t16 = gnn16["serve"], gnn16["train"]["launches"]
    by_path = {
        "segment_sum": {"serve": serve["pallas"]["launches"]["segment_sum"],
                        "serve_scaleout":
                        scaleout["launches"]["segment_sum"],
                        "gnn_bf16": s16["pallas"]["launches"]["segment_sum"]},
        "egnn_edge_fused": {"serve": serve["fused"]["launches"]["egnn_edge"],
                            "serve_scaleout":
                            scaleout["launches"]["egnn_edge"],
                            "train": train["launches"]["egnn_edge"],
                            "train_pipeline": pipe["launches"]["egnn_edge"],
                            "train_mtp": mtp["launches"]["egnn_edge"],
                            "finetune":
                            fine["pretrain"]["launches"]["egnn_edge"]
                            + fine["launches"]["egnn_edge"]},
        "egnn_edge_fused_bwd": {
            "train": train["launches"]["egnn_edge_bwd"],
            "train_pipeline": pipe["launches"]["egnn_edge_bwd"],
            "train_mtp": mtp["launches"]["egnn_edge_bwd"],
            "finetune": fine["pretrain"]["launches"]["egnn_edge_bwd"]
            + fine["launches"]["egnn_edge_bwd"]},
        "egnn_edge_fused_bf16": {
            "gnn_bf16": s16["fused"]["launches"]["egnn_edge_bf16"]
            + t16["egnn_edge_bf16"]},
        "egnn_edge_fused_bwd_bf16": {"gnn_bf16": t16["egnn_edge_bwd_bf16"]},
        "segment_sum_2d": {
            "train": train["launches"]["segment_sum_2d"],
            "train_pipeline": pipe["launches"]["segment_sum_2d"],
            "train_mtp": mtp["launches"]["segment_sum_2d"],
            "gnn_bf16": t16["segment_sum_2d"],
            "finetune": fine["pretrain"]["launches"]["segment_sum_2d"]
            + fine["launches"]["segment_sum_2d"],
            "lm_train": lmt["launches"]["segment_sum_2d"]},
        "flash_attention": {"lm_serve": sum(r["flash_attention"]
                                            for r in lm_runs)},
        "flash_decode": {"lm_serve": sum(r["flash_decode"]
                                         for r in lm_runs)}}
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [
        {"name": "segment_sum_2d", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum/kernel.py:136",
         "launches": launches["segment_sum_2d"], **ss2},
        {"name": "segment_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum/kernel.py:183",
         "launches": launches["segment_sum"], **ss},
        {"name": "egnn_edge_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:156",
         "launches": launches["egnn_edge_fused"], **eg},
        {"name": "egnn_edge_fused_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge_bwd.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:319",
         "launches": launches["egnn_edge_fused_bwd"], **eb},
        {"name": "egnn_edge_fused_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:156",
         "launches": launches["egnn_edge_fused_bf16"], **eg16},
        {"name": "egnn_edge_fused_bwd_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge_bwd.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:319",
         "launches": launches["egnn_edge_fused_bwd_bf16"], **eb16},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:102",
         "launches": launches["flash_attention"], **fa},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:113",
         "launches": launches["flash_decode"], **fd},
    ]
    emit({"kernels": [dict({k: kern[k] for k in
                            ("name", "route", "source", "replaces") + keys},
                           launches_by_path=by_path[kern["name"]])
                      for kern in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
