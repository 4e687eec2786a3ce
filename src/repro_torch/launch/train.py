"""Trainer CLI — a thin argparse front end over ``repro_torch.engine``
(port of ``repro.launch.train``). The GFM trains through the fused edge
kernels (``segment_sum_impl="fused"``: forward and backward kernels on the
card, their plain versions on the CPU); the LM modes train with
``impl="chunked"`` attention, as ``repro`` does, the embedding's backward
through the segment-sum kernel.

  # smoke width on the card (the default device is cuda):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --steps 20

  # hydragnn-gfm at its published width (A=64, E=2048):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --width full \\
      --batch 8 --steps 10

  # an LM arch, single-task and multi-task (one head per source):
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch qwen1.5-0.5b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm-mtl \\
      --arch qwen1.5-0.5b --width full --tasks 4 --batch 2 --seq 1024

  # on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --device cpu

``--width full`` takes the arch's published config; LM weights are drawn
from ``--seed`` (on the card, by a seeded CUDA generator).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs import hydragnn_gfm
from repro_torch.data.lm_data import make_lm_sources
from repro_torch.data.synthetic_atoms import generate_all, source_dicts
from repro_torch.engine import Session, SessionConfig


def session_for(args) -> Session:
    if args.mode == "gfm":
        cfg = hydragnn_gfm.CONFIG if args.width == "full" else \
            hydragnn_gfm.smoke()
        cfg = cfg.replace(segment_sum_impl="fused")
        data = list(generate_all(args.samples, max_atoms=cfg.max_atoms,
                                 max_edges=cfg.max_edges,
                                 seed=args.seed).items())[:cfg.n_tasks]
        sources = source_dicts(dict(data))
        # paper: AdamW, lr 1e-3, warmup-cosine, early stopping
        scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=args.steps,
                             batch_per_task=args.batch, lr=args.lr,
                             warmup=min(20, args.steps), accum=args.accum,
                             seed=args.seed, log_every=args.log_every,
                             eval_every=args.log_every, patience=20,
                             ckpt_path=args.ckpt)
        return Session.from_config(scfg, sources=sources,
                                   task_names=[k for k, _ in data],
                                   device=args.device)

    cfg = configs.get(args.arch) if args.width == "full" else \
        configs.get_smoke(args.arch)
    if cfg.family == "gnn":
        raise SystemExit(f"{args.arch} is not a language model")
    if args.mode == "lm-mtl":
        cfg = cfg.replace(n_tasks=args.tasks)
        sources = make_lm_sources(cfg.n_tasks, 64, args.seq, cfg.vocab)
        scfg = SessionConfig(model="lm-mtl", arch=cfg, steps=args.steps,
                             batch_per_task=args.batch, lr=args.lr,
                             accum=args.accum, seed=args.seed,
                             log_every=args.log_every, ckpt_path=args.ckpt)
        return Session.from_config(scfg, sources=sources, device=args.device)

    source = make_lm_sources(1, 256, args.seq, cfg.vocab)[0]
    scfg = SessionConfig(model="lm", arch=cfg, steps=args.steps,
                         batch_per_task=args.batch, lr=args.lr,
                         accum=args.accum, seed=args.seed,
                         log_every=args.log_every, ckpt_path=args.ckpt)
    return Session.from_config(scfg, sources=source, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="gfm", choices=["gfm", "lm", "lm-mtl"])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="the LM modes' architecture")
    ap.add_argument("--tasks", type=int, default=4,
                    help="lm-mtl: sources, one head each")
    ap.add_argument("--width", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64,
                    help="the LM modes' sequence length")
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    with session_for(args) as session:
        result = session.run()
    return result.final_loss


if __name__ == "__main__":
    main()
