"""The paper's technique carried onto an LLM, on the PyTorch port (the
counterpart of ``examples/multitask_lm.py``): shared transformer trunk +
per-source LM heads, trained on 4 synthetic corpora with different token
statistics — one engine ``Session``.

Per-source heads absorb per-corpus distribution shifts the way the GFM's
per-dataset branches absorb fidelity offsets: per-task losses converge
together even though the corpora conflict. The embedding's backward runs
on the segment-sum kernel on the card (its plain version on the CPU).

  PYTHONPATH=src python examples/multitask_lm_torch.py
  PYTHONPATH=src python examples/multitask_lm_torch.py --device cpu \\
      --steps 4 --seq 16 --batch 2
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.data.lm_data import make_lm_sources
from repro_torch.engine import Session, SessionConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke(args.arch).replace(n_tasks=args.tasks)
    sources = make_lm_sources(args.tasks, n_seqs=128, seq_len=args.seq,
                              vocab=cfg.vocab)
    with Session.from_config(
            SessionConfig(model="lm-mtl", arch=cfg, steps=args.steps,
                          batch_per_task=args.batch, lr=2e-3, log_every=20),
            sources=sources,
            task_names=[f"corpus{t}" for t in range(args.tasks)],
            device=dev) as session:
        result = session.run()

    pt = np.asarray(result.last_metrics["per_task_loss"])
    print(f"# spread across {args.tasks} conflicting corpora: "
          f"max/min = {pt.max() / pt.min():.2f} (heads absorb per-source "
          "shift)")
    return pt


if __name__ == "__main__":
    main()
