"""Quickstart on the PyTorch port: the paper's two-level MTL GFM through
the engine API (the counterpart of ``examples/quickstart.py``).

One declarative ``Session`` builds the HydraGNN-style EGNN + per-source
{energy, force} branches, trains on 3 synthetic multi-fidelity sources
through the fused edge kernels (their plain versions on the CPU), and
prints per-source MAEs — a miniature of the paper's Tables 1-2 protocol.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 20
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.core import gfm_eval_fn
from repro_torch.data.synthetic_atoms import generate_all, to_batch_dict
from repro_torch.engine import Session, SessionConfig
from repro_torch.interop import tree_map

SOURCES = ["ani1x", "qm7x", "mptrj"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke("hydragnn-gfm").replace(segment_sum_impl="fused")
    data = generate_all(256, max_atoms=cfg.max_atoms,
                        max_edges=cfg.max_edges, sources=SOURCES)
    keys = ("species", "pos", "edge_src", "edge_dst", "node_mask",
            "edge_mask", "energy", "forces")
    train = [{k: getattr(s, k)[:192] for k in keys} for s in data.values()]

    # paper: AdamW (lr 1e-3 at full scale; 3e-3 at this smoke scale)
    with Session.from_config(
            SessionConfig(model="gfm-mtl", arch=cfg, steps=args.steps,
                          batch_per_task=16, lr=3e-3, log_every=25),
            sources=train, task_names=SOURCES, device=dev) as session:
        params = session.run().params

    ev = gfm_eval_fn(cfg)
    maes = {}
    print("\nheld-out per-source MAE (energy/atom, force):")
    for t, name in enumerate(SOURCES):
        tb = to_batch_dict(data[name], np.arange(192, 256), dev)
        head_t = tree_map(lambda x: x[t], params["heads"])
        e_mae, f_mae = ev(params["shared"], head_t, tb)
        maes[name] = (float(e_mae), float(f_mae))
        print(f"  {name:14s} E {maes[name][0]:.4f}   F {maes[name][1]:.4f}")
    return maes


if __name__ == "__main__":
    main()
