#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line:

  1. device: the card (``nvidia-smi`` name and power limit) and the time to
     build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, in parallel);
  2. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes, with masked and sentinel (dst == A) edges,
     under the tolerances stated below; each kernel, its plain version and
     a one-call PyTorch yardstick (``library_ms``, never used by the port)
     are timed with CUDA events;
  3. serve: ``ServeSession`` serves hydragnn-gfm at full width (4 EGNN
     layers at H=866, 5 branches of 3x889 MLPs, fp32, seeded random
     weights) over a bucket grid planned from synthetic five-source
     structures — once under ``segment_sum_impl="fused"`` and once under
     ``"pallas"``. Every request resolves finite; rows are bitwise equal to
     ``predict_one``; the kernel's launch count, zeroed just before the
     pass, equals 4 x batches; both passes agree with each other and with
     the plain forward;
  4. the ``kernels`` summary line, the ``nvidia-smi`` line, and the final
     ``{"ok": true, "device": ...}`` line.

Any failure exits nonzero. Without a GPU, or without the repository around
it, the script exits nonzero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
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
SERVE_TOL = 1e-4                   # full forward, 4 layers + heads
N_REQUESTS = 80                    # mixed-head requests per serving pass


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


def check_segment_sum(torch, dev, g):
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
        if name == "ragged_e":
            continue
        d32 = routed.to(torch.int32).contiguous()
        n_valid = int(em.sum())
        ms = time_ms(torch, lambda: ops.segment_sum(msg, d32, A))
        plain = time_ms(torch, lambda: segment_sum_ref(msg, routed, A))
        b_off = A * torch.arange(B, device=dev)
        flat_idx = torch.where(
            em, routed + (b_off[:, None] if routed.dim() == 2 else 0),
            torch.full_like(routed, B * A)).reshape(-1)
        flat_msg = msg.reshape(-1, F)

        def library():
            torch.zeros((B * A + 1, F), device=dev).index_add_(
                0, flat_idx, flat_msg)
        lib = time_ms(torch, library)
        nbytes = 4 * (n_valid * F + B * E + B * A * F)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_valid * F / FP32_FLOPS * 1e3
        timed = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "shape": [B, E, A, F], "valid_edges": n_valid,
                 "bytes": nbytes}
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
        rows = []
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None)
            if dt is None:
                dt = getattr(ev, "cuda_time_total", 0.0)
            if dt and ev.key and not ev.key.startswith(("aten::", "cuda")):
                rows.append((dt, ev.key[:60], ev.count))
        rows.sort(reverse=True)
        out[impl] = {"device_us_total": sum(r[0] for r in rows),
                     "top": [{"kernel": k, "us": t, "calls": c}
                             for t, k, c in rows[:10]]}
    return {"phase": "profile", "batch": "mptrj B=8 A=64 E=2048", **out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one batch")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.kernels import _build
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops

    smi = nvidia_smi()
    build = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build["seconds"],
          "built": build["built"]})

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ss = check_segment_sum(torch, dev, g)
    emit({"phase": "kernel", "name": "segment_sum", "tolerance": SS_TOL, **ss})
    eg = check_egnn_edge(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused", "tolerance": EDGE_TOL,
          **eg})

    if args.profile:
        emit(profile_phase(torch))
    serve = serve_phase(torch, N_REQUESTS)
    emit(serve)
    launches = {"segment_sum": serve["pallas"]["launches"]["segment_sum"],
                "egnn_edge_fused": serve["fused"]["launches"]["egnn_edge"]}
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
    ]
    emit({"kernels": [{k: kern[k] for k in
                       ("name", "route", "source", "replaces") + keys}
                      for kern in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
