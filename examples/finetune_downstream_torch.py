"""Downstream fine-tuning — the paper's reason for pre-training — on the
PyTorch port (the counterpart of ``examples/finetune_downstream.py``).

Pre-trains the two-level MTL GFM on 3 sources through an engine
``Session``, then adapts to an UNSEEN high-fidelity downstream source
(transition1x: same ground truth, other offsets, 12 samples) by attaching
a FRESH branch to the pre-trained trunk, as a ``SingleTaskModel`` through
``ShardingPlan().compile(make_step(...))`` — and compares against the same
fine-tuning from a scratch trunk, by ``gfm_eval_fn`` on 64 held-out
samples. Both paths tune the trunk; only its initialisation differs. The
edge messages go through the fused kernels (#3 forward, #4 backward) on
the card, their plain versions on the CPU.

  PYTHONPATH=src python examples/finetune_downstream_torch.py
  PYTHONPATH=src python examples/finetune_downstream_torch.py \\
      --device cpu --steps 20 --ft-steps 10
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.core import gfm_eval_fn
from repro_torch.core.mtl import gfm_loss_terms
from repro_torch.data.synthetic_atoms import (generate_all, generate_source,
                                              source_dicts, to_batch_dict)
from repro_torch.engine import (Session, SessionConfig, ShardingPlan,
                                SingleTaskModel, TrainState, make_step)
from repro_torch.models import gnn, heads
from repro_torch.optim import adamw

PRETRAIN_SOURCES = ["ani1x", "qm7x", "mptrj"]
N_DOWNSTREAM = 12          # low-data downstream regime
N_HELD_OUT = 64


def finetune_model(cfg, shared, seed=1) -> SingleTaskModel:
    """A fresh branch (drawn from ``seed``) on ``shared``, the trunk to
    tune: params ``{"branch", "shared"}``, the loss of one source's flat
    batch (``gfm_loss_terms``)."""
    def init(_seed=None, device="cpu"):
        return {"branch": heads.branch_init(
                    cfg, rng=np.random.default_rng(seed), device=device),
                "shared": shared}

    def loss_fn(fp, batch):
        feats = gnn.egnn_apply(fp["shared"], batch, cfg=cfg)
        e, f = heads.branch_apply(fp["branch"], feats, batch["node_mask"],
                                  cfg=cfg)
        return gfm_loss_terms(e, f, batch)[0]

    return SingleTaskModel(init=init, loss_fn=loss_fn, name="gfm-finetune")


def finetune(cfg, shared, batch, steps, *, lr=3e-3, seed=1, device="cpu",
             accum=1):
    """``steps`` AdamW steps of a fresh branch + the trunk on ``batch``;
    returns the final ``TrainState`` and each step's loss tensor."""
    model = finetune_model(cfg, shared, seed)
    opt = adamw(lr)
    plan = ShardingPlan()
    step = plan.compile(make_step(model, opt, plan, accum=accum))
    state = TrainState.create(model.init(None, device), opt)
    losses = []
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(out.loss)
    return state, losses


def downstream(cfg, device, n_train=N_DOWNSTREAM, n_test=N_HELD_OUT):
    """transition1x, unseen in pre-training: (train batch, held-out batch)
    on ``device``."""
    ds = generate_source("transition1x", n_train + n_test,
                         max_atoms=cfg.max_atoms, max_edges=cfg.max_edges,
                         seed=99)
    return (to_batch_dict(ds, np.arange(n_train), device),
            to_batch_dict(ds, np.arange(n_train, n_train + n_test), device))


def pretrain(cfg, steps, device, n_samples=192, batch=16, seed=0):
    """One engine Session over the 3 pre-training sources; returns its
    result."""
    data = generate_all(n_samples, max_atoms=cfg.max_atoms,
                        max_edges=cfg.max_edges, sources=PRETRAIN_SOURCES)
    # the with-block stops the session's prefetcher thread before the
    # fine-tuning phase takes over the process
    with Session.from_config(
            SessionConfig(model="gfm-mtl", arch=cfg, steps=steps,
                          batch_per_task=batch, lr=3e-3, log_every=100,
                          seed=seed, verbose=False),
            sources=source_dicts(data), task_names=PRETRAIN_SOURCES,
            device=device) as sess:
        return sess.run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400,
                    help="pre-training steps")
    ap.add_argument("--ft-steps", type=int, default=200,
                    help="fine-tuning steps, each path")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke("hydragnn-gfm").replace(gnn_hidden=64, head_hidden=48,
                                            segment_sum_impl="fused")

    result = pretrain(cfg, args.steps, dev)
    print(f"pre-trained on {PRETRAIN_SOURCES}: final loss "
          f"{result.final_loss:.4f}")
    ds_train, ds_test = downstream(cfg, dev)
    ev = gfm_eval_fn(cfg)

    def tuned_mae(shared):
        state, _ = finetune(cfg, shared, ds_train, args.ft_steps,
                            device=dev)
        return ev(state.params["shared"], state.params["branch"], ds_test)

    e_ft, f_ft = tuned_mae(result.params["shared"])
    e_sc, f_sc = tuned_mae(gnn.egnn_init(cfg, seed=7, device=dev))
    print(f"\ndownstream ({N_DOWNSTREAM} samples), held-out MAE:")
    print(f"  fine-tuned pre-trained encoder : E {float(e_ft):.4f}  "
          f"F {float(f_ft):.4f}")
    print(f"  trained from scratch           : E {float(e_sc):.4f}  "
          f"F {float(f_sc):.4f}")
    print(f"  energy-MAE improvement: "
          f"{float(e_sc) / max(float(e_ft), 1e-9):.2f}x")
    return {"pretrained": (float(e_ft), float(f_ft)),
            "scratch": (float(e_sc), float(f_sc))}


if __name__ == "__main__":
    main()
