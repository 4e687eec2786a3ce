"""LM serving CLI: batched prefill + greedy decode on a ported arch (the
counterpart of ``examples/serve_lm.py``).

  # smoke width on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu

  # h2o-danube-1.8b at its published width on the card, through the
  # flash-attention (prefill) and flash-decode kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --width full \\
      --batch 8 --prompt-len 1024 --new 32

Weights are random, drawn from ``--seed`` (on the card, by a seeded CUDA
generator: no host copy of the 7 GB tree); prompts come from
``data.lm_data``. It runs ``impl="pallas"``: the kernels on the card, their
plain PyTorch versions on the CPU. It prints prefill and decode tokens per
second separately, with the device's name.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import get, get_smoke
from repro_torch.data.lm_data import make_lm_source
from repro_torch.models import transformer
from repro_torch.train.serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--width", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get(args.arch) if args.width == "full" else get_smoke(args.arch)
    if cfg.family == "gnn":
        raise SystemExit(f"{args.arch} is not a language model")
    params = transformer.lm_init(transformer.init_generator(args.seed, dev),
                                 cfg, device=dev)
    prompt = make_lm_source(args.seed + 1, args.batch, args.prompt_len,
                            cfg.vocab)["tokens"]
    timings = {}
    out = greedy_generate(params, cfg, torch.from_numpy(prompt), args.new,
                          impl="pallas", device=dev, timings=timings)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    row = {"arch": cfg.name, "width": args.width, "impl": "pallas",
           "device": name, "batch": args.batch,
           "prompt_len": args.prompt_len, "new": args.new,
           "prefill_s": timings["prefill_s"],
           "prefill_tok_per_s": args.batch * args.prompt_len /
           timings["prefill_s"],
           "decode_s": timings["decode_s"],
           "decode_tok_per_s": (args.batch * (args.new - 1) /
                                timings["decode_s"]
                                if args.new > 1 else None),
           "sample": out[0, :8].tolist()}
    print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
