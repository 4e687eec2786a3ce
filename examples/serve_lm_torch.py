"""Serving example on the PyTorch port: batched prefill + greedy decode on
a ported arch (the counterpart of ``examples/serve_lm.py``).

Exercises the serve path (prefill -> rolling / full decode) at smoke
scale; on the card the attention runs through the flash-attention
(prefill) and flash-decode kernels (``impl="pallas"``), on the CPU through
their plain versions.

  PYTHONPATH=src python examples/serve_lm_torch.py --arch h2o-danube-1.8b --new 24
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --new 4
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
      --arch seamless-m4t-medium --new 4

An enc-dec arch decodes against zeros of (B, 32, d_model) as its encoder
memory, as ``examples/serve_lm.py`` does.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.models import transformer
from repro_torch.train.serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke(args.arch)
    if cfg.family == "gnn":
        raise SystemExit(f"{args.arch} has no decode path")
    params = transformer.lm_init(transformer.init_generator(0, dev), cfg,
                                 dev)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)

    memory = (torch.zeros((args.batch, 32, cfg.d_model),
                          dtype=cfg.compute_dtype, device=dev)
              if cfg.n_enc_layers else None)

    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, torch.from_numpy(prompt), args.new,
                          impl="pallas", memory=memory, device=dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new}  wall={dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s on {dev.type})")
    print("sampled continuations (token ids):")
    for row in out[:2].tolist():
        print(" ", row)
    return out


if __name__ == "__main__":
    main()
