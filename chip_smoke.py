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
     are timed (device time for #1, #2, #5, #6; CUDA events for #3, #4).
     The edge kernel's backward is checked per output, and two calls must
     give the same bits; each graph of a batched segment-sum must be
     bitwise equal to that graph alone, in f32 and bf16;
  3. serve: ``ServeSession`` serves hydragnn-gfm at full width (4 EGNN
     layers at H=866, 5 branches of 3x889 MLPs, fp32, seeded random
     weights) over a bucket grid planned from synthetic five-source
     structures — once under ``segment_sum_impl="fused"`` and once under
     ``"pallas"``. Every request resolves finite; rows are bitwise equal to
     ``predict_one``; the kernel's launch count, zeroed just before the
     pass, equals 4 x batches; both passes agree with each other and with
     the plain forward;
  4. train: ``Session`` trains hydragnn-gfm at full width under
     ``"fused"`` for 10 steps (5 synthetic sources, 8 graphs each per step,
     A=64, E=2048, AdamW, a checkpoint). Every loss is finite; the forward
     and backward edge kernels, counted from zero over the run, launch 4
     times per step each (one trunk pass over all 40 graphs, 4 layers);
     one step's gradients match the plain path's (``"jnp"``, autograd)
     on the same batch; two 3-step runs from one seed end with bitwise
     equal parameters; ``ServeSession.from_checkpoint`` serves requests
     from the written checkpoint;
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
  7. the ``kernels`` summary line, the ``nvidia-smi`` line, and the final
     ``{"ok": true, "device": ...}`` line.

``--profile`` adds device time by kernel (``torch.profiler``) for one
served GNN batch, one training step, one LM prefill and one decode step,
and the device time of #5 over masks (beside SDPA on the same inputs) and
of #6 over split counts. ``--sweep`` prints only the sweeps: #1 and #2
beside ``index_add_``, that attention sweep, and the LM prefill's device
time with its teacher-forced bf16 error under the bf16 GEMM reduction
setting in force. ``--src DIR`` imports the port from another unpacked
checkout, so that two versions are timed in one run (parent, change,
change, parent):

    python3 chip_smoke.py --sweep --src build/parent/src

Any failure exits nonzero. Without a GPU, or without the repository around
it, the script exits nonzero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
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
N_REQUESTS = 80                    # mixed-head requests per serving pass
TRAIN_STEPS = 10
DEVICE = "cuda"                    # the train and lm_serve phases' device


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


def device_ms(torch, fn, iters=20, warm=3) -> float:
    """Device time of one call of ``fn``: the kernels it launches, summed
    from a ``torch.profiler`` trace of ``iters`` calls. Unlike CUDA events
    around the calls, it leaves out the device's idle time while the host
    prepares the next launch, which dominates calls of tens of us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    return us / iters / 1e3


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


def check_egnn_edge(torch, dev, g):
    import numpy as np

    from repro_torch.kernels.egnn_edge import egnn_edge_agg, egnn_edge_agg_ref
    from repro_torch.models.mlp import mlp_init
    H = 866
    rng = np.random.default_rng(1)
    phi = mlp_init(rng, 2 * H + 1, H, H, 1, device=dev)
    phi["fc0"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    phi["fc1"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    cases = [("main", 8, 64, 2048), ("ragged", 3, 40, 1000)]
    worst, out = 0.0, {}
    for name, B, A, E in cases:
        h = torch.randn((B, A, H), generator=g, device=dev)
        pos = 2.0 * torch.randn((B, A, 3), generator=g, device=dev)
        src, dst, em = edge_case(torch, B, E, A, g, dev)
        got = egnn_edge_agg(h, pos, src, dst, em, phi)
        ref = egnn_edge_agg_ref(h, pos, src, dst, em, phi)
        torch.cuda.synchronize()
        err, scale = scaled_err(torch, got, ref)
        if not err <= EDGE_TOL * scale:
            fail(f"egnn_edge {name}: max_abs_err {err} > {EDGE_TOL}*{scale}")
        worst = max(worst, err)
        if name != "main":
            continue
        n_valid = int(em.sum())
        ms = time_ms(torch, lambda: egnn_edge_agg(h, pos, src, dst, em, phi))
        plain = time_ms(torch, lambda: egnn_edge_agg_ref(h, pos, src, dst, em,
                                                         phi), iters=5)
        # the kernel's work on these inputs: three node-level GEMMs
        # (2·B·A·H² each) and ~8 operations per valid edge and column
        ops_count = 3 * 2 * B * A * H * H + 8 * n_valid * H
        nbytes = 4 * (2 * B * A * H + B * A * 3 + 2 * B * E
                      + (2 * H + 1) * H + H * H + 2 * H)
        t_ops = ops_count / FP32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out = {"ms": ms, "plain_ms": plain, "library_ms": None,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "shape": [B, A, E, H], "valid_edges": n_valid,
               "operations": ops_count, "bytes": nbytes,
               "per_edge_form_bound_ms":
                   2 * B * E * 3 * H * H / FP32_FLOPS * 1e3}
    out["max_abs_err"] = worst
    return out


def check_egnn_edge_bwd(torch, dev, g):
    """The backward kernel through ``egnn_edge_agg``'s autograd Function
    against ``egnn_edge_bwd_ref``, per output, at the training path's graph
    shape and a ragged one; two backward calls must give the same bits."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    H = 866
    names = ("dh", "dpos", "dw0", "db0", "dw1", "db1")
    cases = [("main", 8, 64, 2048), ("ragged", 3, 40, 1000)]
    worst, out = 0.0, {}
    for name, B, A, E in cases:
        def t(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g, device=dev)
                    ).requires_grad_(True)
        w0, b0 = t(2 * H + 1, H, scale=(2 * H + 1) ** -0.5), t(H, scale=0.1)
        w1, b1 = t(H, H, scale=H ** -0.5), t(H, scale=0.1)
        h, pos = t(B, A, H), t(B, A, 3, scale=2.0)
        leaves = [h, pos, w0, b0, w1, b1]
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        src, dst, em = edge_case(torch, B, E, A, g, dev)
        gup = torch.randn((B, A, H), generator=g, device=dev)
        agg = egnn_edge_agg(h, pos, src, dst, em, phi)

        def bwd():
            return torch.autograd.grad(agg, leaves, gup, retain_graph=True)
        got = bwd()
        again = bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"egnn_edge_bwd {name}: two calls differ bitwise")
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
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            if not err <= BWD_TOL * scale:
                fail(f"egnn_edge_bwd {name} {n}: max_abs_err {err} > "
                     f"{BWD_TOL}*{scale}")
            errs[n] = err / scale
            worst = max(worst, err)
        if name != "main":
            out["ragged_rel_err"] = errs
            continue
        n_valid = int(em.sum())
        ms = time_ms(torch, bwd)
        agg_np = egnn_edge_agg(h, pos.detach(), src, dst, em, phi)
        ms_no_dpos = time_ms(torch, lambda: torch.autograd.grad(
            agg_np, [h, w0, b0, w1, b1], gup, retain_graph=True))
        plain_ms = time_ms(torch, plain, iters=5)
        # six node-level products (2·B·A·H² each) and ~15 operations per
        # valid edge and column; bytes: inputs (g, h, Pi, Pj, S, deg, pos,
        # src, dst, weights) read once, outputs written once
        ops_count = 6 * 2 * B * A * H * H + 15 * n_valid * H
        w_bytes = (2 * H + 1) * H + H * H
        nbytes = 4 * (5 * B * A * H + B * A + B * A * 3 + 2 * B * E
                      + w_bytes                                # inputs
                      + B * A * H + B * A * 3 + w_bytes + 2 * H)  # outputs
        t_ops = ops_count / FP32_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out.update({"ms": ms, "ms_no_dpos": ms_no_dpos, "plain_ms": plain_ms,
                    "library_ms": None,
                    "library_note": "no one PyTorch call computes this "
                                    "backward",
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "shape": [B, A, E, H], "valid_edges": n_valid,
                    "operations": ops_count, "bytes": nbytes,
                    "rel_err": errs,
                    "per_edge_form_bound_ms":
                        8 * 2 * B * E * H * H / FP32_FLOPS * 1e3})
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def serve_pass(torch, impl, params, spec, samples, heads, counters):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.serve import ServeSession
    cfg = CONFIG.replace(segment_sum_impl=impl)
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


def serve_phase(torch, n_requests):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.data.synthetic_atoms import (generate_mixture,
                                                  source_dicts)
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.serve import ServeSession

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

    def worst(a, b):
        e = max(abs(x["energy"] - y["energy"]) /
                max(1.0, abs(y["energy"])) for x, y in zip(a, b))
        f = max(float(abs(x["forces"] - y["forces"]).max()) /
                max(1.0, float(abs(y["forces"]).max())) for x, y in zip(a, b))
        return max(e, f)

    fused_vs_pallas = worst(res_f, res_p)
    if not fused_vs_pallas <= SERVE_TOL:
        fail(f"fused vs pallas serve results differ: {fused_vs_pallas}")
    # the plain forward (one-hot segment-sum, no kernel) on a few requests
    idx = list(range(0, n_requests, max(1, n_requests // 8)))
    with ServeSession(params, CONFIG.replace(segment_sum_impl="jnp"),
                      spec=spec, max_batch=8, device="cuda") as plain:
        res_plain = [plain.predict_one(samples[i], head=heads[i])
                     for i in idx]
    vs_plain = worst([res_f[i] for i in idx], res_plain)
    if not vs_plain <= SERVE_TOL:
        fail(f"fused serve results differ from the plain forward: {vs_plain}")
    return {"phase": "serve", "config": "hydragnn-gfm", "heads":
            CONFIG.n_tasks, "bucket_spec": [list(spec.atom_buckets),
                                            list(spec.edge_buckets)],
            "fused": info_f, "pallas": info_p,
            "fused_vs_pallas_rel_err": fused_vs_pallas,
            "fused_vs_plain_rel_err": vs_plain, "tolerance": SERVE_TOL}


# ---------------------------------------------------------------------------
# phase 4: training at full width
# ---------------------------------------------------------------------------

def _train_session(torch, sources, steps, ckpt=None):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.engine import Session, SessionConfig
    cfg = CONFIG.replace(segment_sum_impl="fused")
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
    want = {"egnn_edge": 4 * TRAIN_STEPS, "egnn_edge_bwd": 4 * TRAIN_STEPS,
            "segment_sum": 0}
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
        loss, metrics, g = multitask_grad_fn(model, len(sources))(params,
                                                                  batch)
        grads[impl] = (float(loss), interop.leaves(g))
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
            "replay_bitwise": True, "served_from_ckpt": len(served)}


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
    timed at runs (a) and (b)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  decode_partials_ref,
                                                  decode_ref, flash_decode,
                                                  plan_splits)
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
        n, per = plan_splits(B, K, C, n_splits, block_k)

        def plain():
            m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp,
                                            n_splits=n, per_split=per)
            return combine_partials(m, l, acc).reshape(B, 1, H, D).to(dt)
        ref = plain()
        oracle = decode_ref(q, k, v, q_pos=qp, k_pos=kp)
        torch.cuda.synchronize()
        err, share = _attn_err(torch, got, ref, f"flash_decode {name}")
        _attn_err(torch, got, oracle, f"flash_decode {name} vs decode_ref")
        if not torch.equal(got, again):
            fail(f"flash_decode {name}: two calls differ bitwise")
        worst = max(worst, err)
        out["cases"][name] = {"max_abs_err": err, "tol_share": share,
                              "n_splits": n, "per_split": per}
        if not name.startswith("decode"):
            continue
        valid = int((kp > -(10 ** 8)).sum())
        # the decode path reads each layer's cache once, after the layer
        # before streamed its weights through L2: time over copies of the
        # cache that together exceed the 50 MB L2, taken in turn
        isz = q.element_size()
        n_copy = 1 + (100 << 20) // (2 * B * C * K * D * isz)
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
        # q in and the output out, the k/v rows of the valid keys only
        # (pads and slots past the window are not needed), k_pos and q_pos
        nbytes = isz * (2 * B * H * D + 2 * valid * K * D) + 4 * (B * C + B)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                 "library_ms": lib,
                 "library": "scaled_dot_product_attention(enable_gqa, "
                            "bool mask), one query token",
                 "l2_cold_copies": n_copy,
                 "shape": [B, C, H, K, D], "pos": pos, "valid_keys": valid,
                 "n_splits": n, "per_split": per,
                 **_bound(torch, 4 * D * H * valid, nbytes, dt)}
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


def attn_sweep(torch):
    """Device time per call of #5 over masks, each beside
    ``scaled_dot_product_attention`` on the same inputs (the bool keep mask,
    as ``library_ms`` takes it, and SDPA's own causal / unmasked form where
    the mask has one), and of #6 over split counts, at the LM path's shapes
    (prefill B=8, S=1024; decode B=8, cache 1056; bf16) on L2-warm inputs:
    the measurements behind the kernels' redesign notes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import keep_mask
    from repro_torch.kernels.flash_decode import flash_decode
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    B, S, H, K, D, C = 8, 1024, 32, 8, 80, 1056
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
        row = {"kernel": device_ms(torch, lambda: flash_attention(
            q, k, v, q_pos=pos, k_pos=pos, **kw), iters=10),
            "sdpa_bool_mask": device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True), iters=10)}
        if native is not None:
            row["sdpa_native"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **native), iters=10)
        fa[mask] = row
    q1, kc, vc = t(B, 1, H, D), t(B, C, K, D), t(B, C, K, D)
    kp = torch.arange(C, device=dev, dtype=torch.int32)
    fd = {}
    for n_splits in (1, 3, 9, 17):
        fd[n_splits] = device_ms(torch, lambda: flash_decode(
            q1, kc, vc, q_pos=C - 1, k_pos=kp, n_splits=n_splits))
    return {"phase": "attn_sweep", "flash_attention_shape": [B, S, H, K, D],
            "flash_attention_ms_by_mask": fa,
            "flash_decode_shape": [B, C, H, K, D],
            "flash_decode_ms_by_splits": fd}


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
    return {"phase": "ss_sweep", **out}


def lm_bf16_probe(torch):
    """The bf16 GEMM reduction setting in force, the device time of one
    kernel-path prefill at run (a) (B=8, S=1024) and the teacher-forced
    bf16 error of the lm_serve phase (prefill + 8 decode steps, kernel path
    against the plain path, the same seeds), so that two versions
    (``--src``) can be compared in one call."""
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
    return {"phase": "lm_bf16",
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one served "
                         "batch, one train step, one LM prefill and one "
                         "decode step, and of #5 over masks and #6 over "
                         "split counts")
    ap.add_argument("--sweep", action="store_true",
                    help="only build the kernels and print the sweeps (#1 "
                         "and #2 beside index_add_; #5 beside SDPA over "
                         "masks, #6 over split counts; the LM prefill's "
                         "device time and bf16 error), then exit; no "
                         "contract line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to import "
                         "(default: this checkout's), e.g. an unpacked "
                         "earlier commit's, to time two versions in one run")
    args = ap.parse_args()
    src = args.src.resolve()
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
    serve = serve_phase(torch, N_REQUESTS)
    emit(serve)
    train = train_phase(torch, {"egnn_edge": edge_ops.egnn_edge_agg,
                                "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                                "segment_sum": ss_ops.segment_sum})
    emit(train)
    lm = lm_serve_phase(torch, {"flash_attention": fa_ops.flash_attention,
                                "flash_decode": fd_ops.flash_decode})
    emit(lm)
    if args.profile:
        emit(lm_profile(torch))
    # each path's counts, zeroed just before it: serving (fused and pallas
    # passes), training, and LM serving (runs (a) and (b))
    lm_runs = (lm["run_a"]["launches"], lm["run_b"]["launches"])
    by_path = {
        "segment_sum": {"serve": serve["pallas"]["launches"]["segment_sum"]},
        "egnn_edge_fused": {"serve": serve["fused"]["launches"]["egnn_edge"],
                            "train": train["launches"]["egnn_edge"]},
        "egnn_edge_fused_bwd": {"train": train["launches"]["egnn_edge_bwd"]},
        "flash_attention": {"lm_serve": sum(r["flash_attention"]
                                            for r in lm_runs)},
        "flash_decode": {"lm_serve": sum(r["flash_decode"]
                                         for r in lm_runs)}}
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [
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
