"""Training-loop utilities (port of ``repro.train.loop``):

  * ``make_lm_loss`` — the single-task LM loss of the ``"lm"`` registry
    model;
  * ``EarlyStopping`` — paper §5.1 stopping criterion; watches the
    validation metric when an eval_fn provides one (``val_metric`` row key)
    and the training loss otherwise;
  * ``MetricLogger`` — wall-clock-stamped metric rows;
  * ``train_loop`` — the generic loop over a unified TrainStep, used by
    ``engine.Session.run`` and usable standalone.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


def make_lm_loss(cfg, impl="chunked"):
    """loss_fn(params, batch, norm=None) -> the mean next-token
    cross-entropy of ``{"tokens", "labels": (B, S)}`` over the padded
    vocab's f32 logits, plus ``cfg.router_aux_coef`` x the trunk's MoE
    balance term with experts (``repro``'s loss). An enc-dec batch without
    ``memory`` is encoded from its ``src_embed`` frames (a batch with
    neither raises, naming ``src_embed``); with ``media`` the media
    positions' logits are dropped before the cross-entropy, so the labels
    are the text's. ``norm`` (``SingleTaskModel``'s contract, this rank's
    rows of a batch split over ranks): the cross-entropy is summed and
    divided by ``norm["counts"][0]``, the text tokens of the whole batch
    (``core.mtl.lm_batch_counts`` summed over the ranks), and the balance
    term is the rank's share (``norm["balance"]``); ``norm["tp"]``, where
    present, is the rank's tensor-parallel context
    (``models.common.TensorParallel``: ``params`` are its blocks, the
    encoder, the logits and the cross-entropy computed on them, the last
    two vocab-parallel)."""
    from repro_torch.core.mtl import _xent, softmax_xent
    from repro_torch.models import transformer

    def loss_fn(params, batch, norm=None):
        tp = None if norm is None else norm.get("tp")
        memory, media = batch.get("memory"), batch.get("media")
        if cfg.n_enc_layers and memory is None:
            if batch.get("src_embed") is None:
                raise ValueError(
                    f"{cfg.name or 'the enc-dec model'}: the batch has "
                    f"neither 'memory' nor 'src_embed' (B, S_src, "
                    f"d_frontend) frames for the encoder")
            memory = transformer.encode(params, batch["src_embed"], cfg,
                                        impl, tp)
        logits, _, aux = transformer.lm_apply(
            params, batch["tokens"], cfg=cfg, media=media, memory=memory,
            mode="train", impl=impl,
            balance=None if norm is None else norm["balance"], tp=tp)
        if media is not None:
            logits = logits[:, media.shape[1]:]
        if norm is None:
            loss = softmax_xent(logits, batch["labels"])
        else:
            loss = _xent(logits, batch["labels"], tp).sum() / \
                norm["counts"][0]
        if cfg.n_experts:
            loss = loss + cfg.router_aux_coef * aux
        return loss
    return loss_fn


@dataclass
class EarlyStopping:
    """Paper §5.1: early stopping to avoid redundant computation."""
    patience: int = 10
    min_delta: float = 1e-4
    best: float = float("inf")
    bad: int = 0

    def update(self, val: float) -> bool:
        """Returns True if training should stop."""
        if val < self.best - self.min_delta:
            self.best, self.bad = val, 0
        else:
            self.bad += 1
        return self.bad >= self.patience


@dataclass
class MetricLogger:
    history: list = field(default_factory=list)
    t0: float = field(default_factory=time.perf_counter)

    def log(self, step: int, **metrics):
        row = {"step": step, "wall": time.perf_counter() - self.t0}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)
        return row


def train_loop(step_fn, state, batches, *, steps: int, eval_fn=None,
               eval_every: int = 50, log_every: int | None = None,
               early_stop: EarlyStopping | None = None,
               logger: MetricLogger | None = None,
               val_metric: str = "val_loss", metric_fn=None,
               should_stop=None, verbose: bool = False):
    """Run a unified TrainStep for ``steps`` iterations.

    step_fn: ``step(state, batch) -> (state, StepOutput)``.
    batches: zero-arg callable or iterator yielding batches.
    eval_fn: ``eval_fn(params) -> dict`` merged into eval rows; if the dict
    contains ``val_metric``, EarlyStopping watches THAT, otherwise the
    training loss.
    metric_fn: ``metric_fn(out: StepOutput) -> dict`` of extra scalars to
    log (e.g. named per-task losses).
    logger: the ``MetricLogger`` to append rows to (a new one if None).
    should_stop: zero-arg cooperative stop hook polled before every step —
    True ends the loop cleanly with the state as it is (e.g. a
    ``repro_torch.resilience.PreemptionHandler``'s ``triggered``).

    Only logged steps read the loss back to the host; the others leave the
    device queue running. Returns (state, logger, last StepOutput).
    """
    logger = logger or MetricLogger()
    log_every = log_every or eval_every
    out = None
    for i in range(steps):
        if should_stop is not None and should_stop():
            break
        batch = batches() if callable(batches) else next(batches)
        state, out = step_fn(state, batch)
        is_eval = (i + 1) % eval_every == 0 or i == 0 or i == steps - 1
        is_log = (i + 1) % log_every == 0 or i == 0 or i == steps - 1
        if not (is_eval or is_log):
            continue
        extras = metric_fn(out) if metric_fn is not None else {}
        row = logger.log(i, loss=out.loss, **extras)
        if eval_fn is not None and is_eval:
            row.update({k: float(v) for k, v in eval_fn(state.params).items()})
        if verbose:
            print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                              for k, v in row.items()}))
        if early_stop is not None and is_eval:
            criterion = row.get(val_metric, row["loss"])
            if early_stop.update(float(criterion)):
                if verbose:
                    print(f"# early stopping (paper §5.1) at step {i}: "
                          f"best {val_metric if val_metric in row else 'loss'}"
                          f"={early_stop.best:.5f}")
                break
    return state, logger, out
