"""End-to-end run on the PyTorch port: pre-train the GFM for a few
hundred steps (the counterpart of ``examples/pretrain_gfm.py``).

The full-width paper model (4-layer EGNN x 866 hidden + 5 branches of
3x889 FC heads) on the 5 synthetic multi-fidelity sources with energy
alignment, early stopping, checkpointing — the paper's §5.1 protocol end to
end, expressed as one engine ``Session``, through the fused edge kernels
(their plain versions on the CPU). Reduce --width for a quick run.

  PYTHONPATH=src python examples/pretrain_gfm_torch.py --steps 300 --width 256
  PYTHONPATH=src python examples/pretrain_gfm_torch.py --device cpu \\
      --steps 4 --width 32 --samples 16 --batch 4 --ckpt /tmp/gfm_ck
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get
from repro_torch.core.balancing import align_sources
from repro_torch.data.synthetic_atoms import N_SPECIES, SOURCES, generate_all
from repro_torch.engine import Session, SessionConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=866,
                    help="EGNN hidden (paper: 866)")
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1,
                    help="grad-accum microbatches")
    ap.add_argument("--ckpt", default="results/gfm_pretrained.npz")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get("hydragnn-gfm").replace(
        gnn_hidden=args.width, head_hidden=min(889, args.width + 23),
        max_atoms=24, max_edges=256, remat=False, segment_sum_impl="fused")
    names = list(SOURCES)

    data = generate_all(args.samples, max_atoms=cfg.max_atoms,
                        max_edges=cfg.max_edges)
    # paper §4: align energy-per-atom across fidelities before pre-training
    n_atoms = {k: np.maximum(s.node_mask.sum(1), 1) for k, s in data.items()}
    aligned = align_sources(
        [{"species": s.species, "energy": s.energy * n_atoms[k]}
         for k, s in data.items()], N_SPECIES)
    sources = []
    for (k, s), al in zip(data.items(), aligned):
        sources.append(dict(species=s.species, pos=s.pos,
                            edge_src=s.edge_src, edge_dst=s.edge_dst,
                            node_mask=s.node_mask, edge_mask=s.edge_mask,
                            energy=al["energy"].astype(np.float32),
                            forces=s.forces))

    # paper §5.1: AdamW + warmup-cosine, early stopping, checkpoint at the
    # end
    with Session.from_config(
            SessionConfig(model="gfm-mtl", arch=cfg, steps=args.steps,
                          batch_per_task=args.batch, lr=1e-3, warmup=30,
                          grad_clip=1.0, accum=args.accum, log_every=10,
                          eval_every=10, patience=25, ckpt_path=args.ckpt),
            sources=sources, task_names=names, device=dev) as session:
        print(f"# model: EGNN {cfg.gnn_layers}x{cfg.gnn_hidden} + "
              f"{len(names)} branches -> {session.n_params()/1e6:.1f}M "
              "params")
        result = session.run()
    print(f"# final loss {result.final_loss:.4f} "
          f"(early stop: {result.stopped_early})")
    print(f"# checkpoint -> {args.ckpt}")
    return result


if __name__ == "__main__":
    main()
