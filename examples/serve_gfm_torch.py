"""Serving example on the PyTorch port: a pre-trained GFM behind
continuous size-binned batching (the counterpart of
``examples/serve_gfm.py``).

The request lifecycle at smoke scale: save a checkpoint, restore it into a
``ServeSession``, stream mixed-source property requests (each asking its
own source's head) through the async queue, and read the engine's
latency/occupancy report. On the card the edge messages go through the
fused kernel (#3), on the CPU through its plain version.

  PYTHONPATH=src python examples/serve_gfm_torch.py --requests 40
  PYTHONPATH=src python examples/serve_gfm_torch.py --device cpu
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mtl import make_gfm_mtl
from repro_torch.data.bucketing import BucketSpec
from repro_torch.data.synthetic_atoms import generate_mixture, source_dicts
from repro_torch.serve import ServeSession
from repro_torch.train import checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a tiny five-source GFM standing in for a trained checkpoint
    data = generate_mixture(80, max_atoms=16, max_edges=96, seed=0)
    sources, names = source_dicts(data), list(data.keys())
    arch = ArchConfig(name="serve-example", family="gnn", gnn_hidden=32,
                      gnn_layers=2, n_species=64, head_hidden=16,
                      head_layers=2, remat=False,
                      compute_dtype=torch.float32,
                      segment_sum_impl="fused")
    model = make_gfm_mtl(arch, len(sources))
    with tempfile.TemporaryDirectory(prefix="serve_gfm_") as tmp:
        ckpt_dir = os.path.join(tmp, "ck")
        checkpoint.save(ckpt_dir, {"params": model.init(0, "cpu")})

        # restore into a serving session; the bucket grid doubles as the
        # admission rule AND the compiled-shape universe
        spec = BucketSpec.from_sources(sources, n_atom_buckets=2,
                                       n_edge_buckets=2)
        srv = ServeSession.from_checkpoint(
            ckpt_dir, arch, n_heads=len(sources), spec=spec,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            device=dev)
    print(f"grid atoms={list(spec.atom_buckets)} "
          f"edges={list(spec.edge_buckets)} -> recompile budget "
          f"{spec.n_shapes} shapes ({spec.n_shapes * len(sources)} cache "
          "entries)")

    with srv:
        srv.warmup()
        rng = np.random.default_rng(0)
        keys = ("species", "pos", "edge_src", "edge_dst", "node_mask",
                "edge_mask")
        t0 = time.perf_counter()
        futs = []
        for _ in range(args.requests):
            t = int(rng.integers(len(sources)))
            i = int(rng.integers(sources[t]["species"].shape[0]))
            sample = {k: sources[t][k][i] for k in keys}
            futs.append((names[t], srv.submit(sample, head=t)))
        for name, fut in futs[:4]:
            out = fut.result(timeout=60)
            print(f"  {name:>10}: energy={out['energy']:+.4f}  "
                  f"forces {out['forces'].shape}")
        for _, fut in futs:
            fut.result(timeout=60)
        wall = time.perf_counter() - t0
        stats = srv.stats()

    c, lat = stats["counters"], stats["latency"]["e2e"]
    print(f"{c['completed']}/{c['submitted']} requests in {wall:.2f}s "
          f"({c['completed'] / wall:.0f} req/s) over {c['batches']} "
          f"batches, occupancy {stats['batch_occupancy']:.2f}")
    print(f"e2e latency p50={lat['p50_ms']:.1f}ms "
          f"p99={lat['p99_ms']:.1f}ms; {c['compilations']} compilations "
          f"(budget {stats['executable_cache']['budget']})")
    print(json.dumps(stats["counters"]))
    return stats


if __name__ == "__main__":
    main()
