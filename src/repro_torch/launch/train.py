"""Trainer CLI — a thin argparse front end over ``repro_torch.engine``
(port of ``repro.launch.train``, GFM only; the LM modes come with the LM
slice). It trains through the fused edge kernels (``segment_sum_impl=
"fused"``: forward and backward kernels on the card, their plain versions
on the CPU).

  # smoke width on the card (the default device is cuda):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --steps 20

  # hydragnn-gfm at its published width (A=64, E=2048):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --width full \\
      --batch 8 --steps 10

  # on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --mode gfm --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import hydragnn_gfm
from repro_torch.data.synthetic_atoms import generate_all, source_dicts
from repro_torch.engine import Session, SessionConfig


def session_for(args) -> Session:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="gfm", choices=["gfm"])
    ap.add_argument("--width", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
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
