"""Transformer assembly: the decoder-only LM, ``attn`` and ``swa`` blocks.

``repro`` stacks the parameters of each repetition of the config's
``block_pattern`` unit on a leading ``reps`` axis and drives them with
``lax.scan``; the port keeps that stacked layout (so ``interop`` is a copy)
and loops over ``reps`` in Python. Prefill caches come out stacked the same
way: ``caches["scan"]`` is a tuple (one entry per unit position) of dicts
whose ``k``/``v`` are (reps, B, S, K, hd) and whose ``pos`` is (reps,).
Remainder layers (n_layers not a multiple of the unit) are unrolled under
``params["rem"]``.

Other block types (mla, mamba2, mlstm, slstm, shared_attn, enc-dec,
frontends) raise ``NotImplementedError``: ROADMAP.md, queue 1.
"""
from __future__ import annotations

import torch

from ..interop import tree_map
from .attention import gqa_apply, gqa_cache_init, gqa_init
from .common import (Params, dense, dense_init, embed, embedding_init,
                     layernorm, normal_init, ones_init, rmsnorm, unembed,
                     zeros_init)
from .mlp import swiglu_apply, swiglu_init

PORTED_BLOCKS = ("attn", "swa")


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (the port's LM blocks are "
        f"{PORTED_BLOCKS}): ROADMAP.md, queue 1, item 11")


def _check_block(btype: str):
    if btype not in PORTED_BLOCKS:
        raise _unported(f"block type {btype!r}")


def _norm(cfg):
    return rmsnorm if cfg.norm == "rmsnorm" else layernorm


def _norm_init(cfg, d=None, device="cpu"):
    d = d or cfg.d_model
    p = {"scale": ones_init((d,), cfg.param_dtype, device)}
    if cfg.norm != "rmsnorm":
        p["bias"] = zeros_init((d,), cfg.param_dtype, device)
    return p


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def block_init(rng, cfg, btype: str, device="cpu") -> Params:
    _check_block(btype)
    return {"ln1": _norm_init(cfg, device=device),
            "attn": gqa_init(rng, cfg, device),
            "ln2": _norm_init(cfg, device=device),
            "ffn": swiglu_init(rng, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                               cfg.n_layers or 2, device)}


def block_apply(bp: Params, x, *, btype, cfg, positions, cache=None,
                mode="train", impl="chunked"):
    """Returns (x, new_cache, aux). mode=="train": no cache; "prefill":
    returns the block's new cache; "decode": consumes and updates the cache
    (its k/v slot in place). aux is the MoE balance term, 0.0 for these
    blocks."""
    _check_block(btype)
    nrm = _norm(cfg)
    h = nrm(bp["ln1"], x)
    window = cfg.window if btype == "swa" else 0
    new_cache = None
    if mode == "decode":
        o, new_cache = gqa_apply(bp["attn"], h, cfg=cfg, positions=positions,
                                 window=window, cache=cache, impl=impl)
    elif mode == "prefill":
        o, new_cache = gqa_apply(bp["attn"], h, cfg=cfg, positions=positions,
                                 window=window, cache="init", impl=impl)
    else:
        o = gqa_apply(bp["attn"], h, cfg=cfg, positions=positions,
                      window=window, impl=impl)
    x = x + o
    h2 = nrm(bp["ln2"], x)
    x = x + swiglu_apply(bp["ffn"], h2, cfg.act, cfg.compute_dtype)
    return x, new_cache, 0.0


def block_cache_init(cfg, btype, batch, cache_len, device="cpu"):
    _check_block(btype)
    if btype == "swa":
        w = cfg.window or cache_len
        return gqa_cache_init(cfg, batch, min(w, cache_len), device=device)
    return gqa_cache_init(cfg, batch, cache_len, device=device)


# ---------------------------------------------------------------------------
# LM (decoder-only) — trunk + head split for multi-task parallelism
# ---------------------------------------------------------------------------

def _pattern_split(cfg):
    unit = tuple(cfg.block_pattern)
    reps = cfg.n_layers // len(unit)
    rem = cfg.pattern[reps * len(unit):]
    return unit, reps, rem


def lm_init(rng, cfg, device="cpu") -> Params:
    """``repro``'s parameter tree. ``rng`` is a ``np.random.Generator`` or
    a seeded ``torch.Generator`` (which draws on its own device: the way to
    make full-width random weights on the card without a host copy)."""
    unit, reps, rem = _pattern_split(cfg)
    for bt in cfg.pattern:
        _check_block(bt)
    p: Params = {"embed": embedding_init(rng, cfg.padded_vocab, cfg.d_model,
                                         cfg.param_dtype, device)}
    if reps > 0:
        p["scan"] = {}
        for u, btype in enumerate(unit):
            blocks = [block_init(rng, cfg, btype, device) for _ in range(reps)]
            p["scan"][f"u{u}"] = tree_map(lambda *xs: torch.stack(xs),
                                           *blocks)
            del blocks
    p["rem"] = {f"r{i}": block_init(rng, cfg, bt, device)
                for i, bt in enumerate(rem)}
    p["ln_f"] = _norm_init(cfg, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(rng, cfg.d_model, cfg.padded_vocab,
                                  cfg.param_dtype, device=device)
    if cfg.n_tasks > 1:
        # the paper's technique: per-source decoding heads
        p["task_heads"] = {
            "w": normal_init(rng, (cfg.n_tasks, cfg.d_model,
                                   cfg.padded_vocab), cfg.param_dtype, 0.02,
                             device)}
    return p


def _restack(per_rep: list, views: list, stacked: dict) -> dict:
    """Stack per-repetition caches back onto the leading reps axis. A leaf
    a decode step wrote in place is still the view of ``stacked`` it was
    given, and is returned as the stacked tensor, not copied."""
    out = {}
    for key in per_rep[0]:
        if views is not None and all(c[key] is w[key]
                                     for c, w in zip(per_rep, views)):
            out[key] = stacked[key]
        else:
            out[key] = torch.stack([c[key] for c in per_rep])
    return out


def run_trunk(params: Params, x, *, cfg, positions, mode="train",
              caches=None, impl="chunked"):
    """x: (B,S,d) embedded inputs -> (hidden, new_caches, aux). aux (the
    MoE balance term) is 0 for the ported blocks."""
    unit, reps, rem = _pattern_split(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Params = {}
    if reps > 0:
        per_unit = [[] for _ in unit]
        views = [[] for _ in unit] if mode == "decode" else None
        for r in range(reps):
            for u, btype in enumerate(unit):
                bp = tree_map(lambda a: a[r], params["scan"][f"u{u}"])
                c = None
                if mode == "decode":
                    c = {k: a[r] for k, a in caches["scan"][u].items()}
                    views[u].append(dict(c))
                x, nc, _ = block_apply(bp, x, btype=btype, cfg=cfg,
                                       positions=positions, cache=c,
                                       mode=mode, impl=impl)
                per_unit[u].append(nc)
        if mode in ("prefill", "decode"):
            new_caches["scan"] = tuple(
                _restack(per_unit[u], views[u] if views else None,
                         caches["scan"][u] if views else None)
                for u in range(len(unit)))
    for i, btype in enumerate(rem):
        c = caches["rem"][f"r{i}"] if (caches and "rem" in caches) else None
        x, nc, _ = block_apply(params["rem"][f"r{i}"], x, btype=btype,
                               cfg=cfg, positions=positions, cache=c,
                               mode=mode, impl=impl)
        if nc is not None:
            new_caches.setdefault("rem", {})[f"r{i}"] = nc
    x = _norm(cfg)(params["ln_f"], x)
    return x, (new_caches if new_caches else None), aux


def embed_inputs(params, tokens, cfg, media=None):
    """tokens: (B, S) int -> (B, S, d_model). Text only: the modality
    frontends (``media``) are not ported yet."""
    if media is not None:
        raise _unported("media frontends (vision/audio projector)")
    return embed(params["embed"], tokens, cfg.compute_dtype)


def _mask_pad_vocab(logits, cfg):
    """Padded vocab slots get -1e30 so softmax/argmax ignore them."""
    if cfg.padded_vocab > cfg.vocab:
        vid = torch.arange(cfg.padded_vocab, device=logits.device)
        return torch.where(vid < cfg.vocab, logits,
                           torch.full_like(logits, -1e30))
    return logits


def lm_logits(params, hidden, cfg, task: int | None = None):
    """f32 logits over the padded vocab. With ``cfg.n_tasks > 1`` the
    per-source heads ``task_heads`` decode: ``task`` picks one head for
    hidden (..., d); without it hidden is the task-major (T, B, S, d)
    layout and every head decodes its own rows. Weights are cast to the
    hidden dtype and the products summed in f32."""
    if cfg.n_tasks > 1:
        w = params["task_heads"]["w"]
        if task is not None:
            out = hidden.float() @ w[task].to(hidden.dtype).float()
        else:
            out = torch.einsum("tbsd,tdv->tbsv", hidden.float(),
                               w.to(hidden.dtype).float())
    elif "lm_head" in params:
        out = dense(params["lm_head"], hidden, cfg.compute_dtype).float()
    else:
        out = unembed(params["embed"], hidden)
    return _mask_pad_vocab(out, cfg)


def lm_apply(params: Params, tokens, *, cfg, media=None, memory=None,
             mode="train", caches=None, positions=None, impl="chunked",
             task=None):
    """Full LM forward. Returns (logits, new_caches, aux)."""
    if memory is not None:
        raise _unported("encoder-decoder memory (cross-attention)")
    if mode == "decode":
        x = embed(params["embed"], tokens, cfg.compute_dtype)  # (B,1,d)
    else:
        x = embed_inputs(params, tokens, cfg, media)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    h, ncaches, aux = run_trunk(params, x, cfg=cfg, positions=positions,
                                mode=mode, caches=caches, impl=impl)
    return lm_logits(params, h, cfg, task=task), ncaches, aux


def lm_cache_init(params, cfg, batch: int, cache_len: int) -> Params:
    """Zero caches on the parameters' device, stacked like prefill's."""
    device = params["embed"]["table"].device
    unit, reps, rem = _pattern_split(cfg)
    caches: Params = {}
    if reps > 0:
        caches["scan"] = tuple(
            tree_map(lambda a: a.expand((reps,) + a.shape).clone(),
                      block_cache_init(cfg, bt, batch, cache_len, device))
            for bt in unit)
    if rem:
        caches["rem"] = {f"r{i}": block_cache_init(cfg, bt, batch, cache_len,
                                                   device)
                         for i, bt in enumerate(rem)}
    return caches
