"""Two-level hierarchical MTL models (port of ``repro.core.mtl``).

Level 1: one branch per data source; level 2: each branch = {energy head,
force head}. ``make_gfm_mtl`` is GFM-MTL-All (shared EGNN + per-source
branches); with n_tasks=1 it is GFM-Baseline-All's single branch.
``make_lm_multitask`` carries the technique onto the LM architectures: a
shared transformer trunk + per-source LM heads.

The trunk is shared, so ``loss_fn`` runs it ONCE over all T·B rows of a
task-major batch and applies each task's branch or head to its own rows
(batched over tasks), where ``repro`` vmaps the whole model over tasks.
Every kernel on the path is row-independent, so the two forms compute the
same function; one trunk pass makes each kernel launch once per layer and
step.
"""
from __future__ import annotations

import torch

from repro_torch.models import gnn, heads, transformer

from .taskpar import MultiTaskModel

GRAPH_KEYS = ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask")


def gfm_mtl_init(cfg, n_tasks: int, *, seed: int = 0, device="cpu",
                 uncertainty: bool = False) -> dict:
    """``{"shared": egnn params, "heads": stacked branch params}``, the
    layout of ``repro``'s ``make_gfm_mtl(cfg, n_tasks).init``. The trunk and
    the heads draw from two numpy streams derived from ``seed``;
    ``device="meta"`` gives a shape-only template."""
    hp = heads.stacked_branches_init(cfg, n_tasks, seed=seed + 1,
                                     device=device)
    if uncertainty:
        hp["log_sigma2"] = torch.zeros((n_tasks, 2), dtype=torch.float32,
                                       device=device)
    return {"shared": gnn.egnn_init(cfg, seed=seed, device=device),
            "heads": hp}


def gfm_loss_terms(e_pred, f_pred, batch_t, force_weight=1.0, norm=None):
    """Masked MSE on energy-per-atom + forces for one task's sub-batch. The
    batch dims are reduced from the right, so task-major inputs (leading T)
    give one term per task. ``norm`` (``MultiTaskModel``'s contract): the
    squared errors are summed and divided by the counts given — the graphs
    and atoms of the task's whole batch when this is one shard of it."""
    nm = batch_t["node_mask"]
    f_sq = (((f_pred - batch_t["forces"]) ** 2) * nm[..., None]).sum(
        (-3, -2, -1))
    if norm is None:
        e_err = ((e_pred - batch_t["energy"]) ** 2).mean(-1)
        f_err = f_sq / torch.clamp(nm.sum((-2, -1)) * 3.0, min=1.0)
    else:
        e_err = ((e_pred - batch_t["energy"]) ** 2).sum(-1) / norm["graphs"]
        f_err = f_sq / torch.clamp(norm["atoms"] * 3.0, min=1.0)
    return e_err + force_weight * f_err, e_err, f_err


def gfm_batch_counts(batch):
    """(T, 2) loss denominators of a task-major batch: graphs and atoms per
    task row."""
    nm = batch["node_mask"]
    graphs = torch.full(nm.shape[:1], float(nm.shape[1]), device=nm.device)
    return torch.stack([graphs, nm.sum((-2, -1)).float()], dim=1)


def trunk_features(shared, batch, *, cfg):
    """EGNN features of a task-major batch, (T, B, A, hid), from one trunk
    pass over its T·B graphs."""
    T, B = batch["species"].shape[:2]
    flat = {k: batch[k].reshape(T * B, *batch[k].shape[2:])
            for k in GRAPH_KEYS}
    feats = gnn.egnn_apply(shared, flat, cfg=cfg)
    return feats.reshape(T, B, *feats.shape[1:])


def make_gfm_mtl(cfg, n_tasks: int, force_weight: float = 1.0,
                 uncertainty: bool = False) -> MultiTaskModel:
    """uncertainty=True adds Kendall homoscedastic weighting: each branch
    owns learnable log sigma^2 for its (energy, force) pair."""
    def init(seed: int = 0, device="cpu"):
        return gfm_mtl_init(cfg, n_tasks, seed=seed, device=device,
                            uncertainty=uncertainty)

    def loss_fn(shared, hp, batch, norm=None):
        # batch leaves are task-major: (T, B, ...)
        feats = trunk_features(shared, batch, cfg=cfg)
        nm = batch["node_mask"]
        e, f = heads.stacked_branches_apply(
            {k: v for k, v in hp.items() if k != "log_sigma2"}, feats, nm,
            cfg=cfg)
        _, e_err, f_err = gfm_loss_terms(e, f, batch, force_weight, norm)
        if uncertainty:
            s = hp["log_sigma2"]
            if norm is None:
                ls = (torch.exp(-s[:, 0]) * e_err + s[:, 0]
                      + torch.exp(-s[:, 1]) * force_weight * f_err + s[:, 1])
            else:        # a shard's part: the constant terms by its share
                ls = (torch.exp(-s[:, 0]) * e_err
                      + torch.exp(-s[:, 1]) * force_weight * f_err
                      + (s[:, 0] + s[:, 1]) * norm["share"])
        else:
            ls = e_err + force_weight * f_err
        return ls, {"energy_mse": e_err, "force_mse": f_err}

    return MultiTaskModel(init=init, loss_fn=loss_fn,
                          name=f"gfm-mtl-{n_tasks}", n_tasks=n_tasks,
                          batch_counts=gfm_batch_counts)


def gfm_eval_fn(cfg):
    """Returns eval(shared, head_t, batch_single_task) -> (energy MAE, force
    MAE), without gradients."""
    @torch.no_grad()
    def ev(shared, hp_t, batch_t):
        feats = gnn.egnn_apply(shared, batch_t, cfg=cfg)
        e, f = heads.branch_apply(hp_t, feats, batch_t["node_mask"], cfg=cfg)
        nm = batch_t["node_mask"]
        e_mae = (e - batch_t["energy"]).abs().mean()
        f_mae = ((f - batch_t["forces"]).abs() * nm[..., None]).sum() / \
            torch.clamp(nm.sum() * 3.0, min=1.0)
        return e_mae, f_mae
    return ev


# ---------------------------------------------------------------------------
# LM multi-task: shared transformer trunk + per-source vocab heads
# ---------------------------------------------------------------------------

def _xent(logits, labels):
    """Per-position ``logsumexp - gold`` of f32 logits (..., V)."""
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, -1) - gold


def softmax_xent(logits, labels):
    """logits: (..., V) f32; labels: (...) int. Mean over all positions."""
    return _xent(logits, labels).mean()


def make_lm_multitask(cfg, impl="chunked") -> MultiTaskModel:
    """``init(seed, device)`` -> ``{"shared": lm params, "heads": {"w":
    (T, d, V)}}`` (``lm_init``'s tree with its ``task_heads`` as the
    heads). ``loss_fn`` over ``{"tokens", "labels": (T, B, S)}``: each
    task's mean cross-entropy of its own head's logits, the head cast to
    the hidden dtype and the products summed in f32 (the padded vocab
    slots unmasked, as ``repro`` computes them)."""
    if cfg.n_tasks <= 1:
        raise ValueError(f"lm-mtl needs cfg.n_tasks > 1, got {cfg.n_tasks}")

    def init(seed=0, device="cpu"):
        p = transformer.lm_init(transformer.init_generator(seed, device),
                                cfg, device)
        return {"shared": p, "heads": {"w": p.pop("task_heads")["w"]}}

    def loss_fn(shared, hp, batch, norm=None):
        if norm is not None:
            raise NotImplementedError(
                "lm-mtl on a global-semantics task-parallel plan (loss "
                "denominators over a task's ranks) is not ported: "
                "ROADMAP.md, queue 1, item 9b")
        toks = batch["tokens"]
        T, B, S = toks.shape
        x = transformer.embed_inputs(shared, toks.reshape(T * B, S), cfg)
        h, _, _ = transformer.run_trunk(
            shared, x, cfg=cfg, positions=torch.arange(S, device=x.device),
            mode="train", impl=impl)
        h = h.reshape(T, B, S, h.shape[-1])
        logits = torch.einsum("tbsd,tdv->tbsv", h.float(),
                              hp["w"].to(h.dtype).float())
        return _xent(logits, batch["labels"]).mean((1, 2)), {}

    return MultiTaskModel(init=init, loss_fn=loss_fn,
                          name=f"lm-mtl-{cfg.name}", n_tasks=cfg.n_tasks)
