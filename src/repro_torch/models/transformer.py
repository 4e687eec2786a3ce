"""Transformer assembly: decoder-only LMs and encoder-decoder models;
``attn``, ``swa`` and ``mla`` blocks, each with a SwiGLU or
(``cfg.n_experts``) a MoE feed-forward; the recurrent ``mamba2``, ``mlstm``
and ``slstm`` blocks (``models.ssm``) and zamba's ``shared_attn`` (one GQA
weight set, ``params["shared_attn"]``, applied at each such layer through
the layer's own LoRA adapters), which have no feed-forward; the encoder's
bidirectional ``enc_attn`` and the decoder's ``dec_attn`` (causal
self-attention, then cross-attention to the encoder's memory, then the
feed-forward), whose caches are ``{"self": <a GQA cache>}``.

Modality frontends (``models.frontends``): a ``vision_embed`` model's
projected media embeddings come before the text tokens (text positions
start at ``n_media``); an ``audio_embed`` model projects its source frames
in ``encode``, whose output is the decoder's ``memory``.

``repro`` stacks the parameters of each repetition of the config's
``block_pattern`` unit on a leading ``reps`` axis and drives them with
``lax.scan``; the port keeps that stacked layout (so ``interop`` is a copy)
and loops over ``reps`` in Python. Prefill caches come out stacked the same
way: ``caches["scan"]`` is a tuple (one entry per unit position) of dicts
whose ``k``/``v`` are (reps, B, S, K, hd) (MLA: ``ckv`` (reps, B, S, r) and
``krope`` (reps, B, S, dr); a recurrent block: its fixed-size state, e.g.
Mamba2's ``ssm`` (reps, B, H, P, N) and ``conv``) and whose ``pos`` is
(reps,). Remainder layers (n_layers not a multiple of the unit) are
unrolled under ``params["rem"]``. The MoE balance terms of the blocks are
summed into the trunk's aux.

``tp`` (``models.common.TensorParallel``, a transformer LM on a
``spec_fn`` plan): ``params`` are this rank's blocks. Each block unit's
FSDP-cut leaves are gathered inside its remat checkpoint (the recompute
gathers them again, so the peak holds one gathered unit; the embedding
and ``lm_head`` once a forward, ``outer_units``; an encoder block just
before it runs), the blocks run on their local heads (GQA's, the
encoder's and each cross-attention's too, or MLA's after the latent)
and ``d_ff`` columns, or a MoE's local experts or ``d_ff_expert``
columns, the embedding and the logits are vocab-parallel, and the caches
hold the local kv heads (MLA's latent cache whole). The encoder's memory
is whole on every ``model`` rank; each cross-attention takes it through
Megatron's f.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..interop import leaves, tree_map, unflatten
from .attention import (gqa_apply, gqa_cache_init, gqa_init, local_out,
                        local_qkv, mla_apply, mla_cache_init, mla_init, sdpa)
from .common import (Params, apply_rope, dense, dense_init, embed,
                     embedding_init, layernorm, normal_init, ones_init,
                     rmsnorm, unembed, zeros_init)
from .frontends import projector_apply, projector_init
from .mlp import swiglu_apply, swiglu_init
from .moe import moe_apply, moe_init
from .ssm import (mamba2_apply, mamba2_init, mamba2_state_init, mamba2_step,
                  mlstm_apply, mlstm_init, mlstm_state_init, mlstm_step,
                  slstm_apply, slstm_init, slstm_state_init, slstm_step)

PORTED_BLOCKS = ("attn", "swa", "mla", "mamba2", "mlstm", "slstm",
                 "shared_attn", "enc_attn", "dec_attn")
LORA_RANK = 64  # zamba2-style per-application adapters on the shared block
# a recurrent block's (init, apply, step, state init)
_MIXERS = {"mamba2": (mamba2_init, mamba2_apply, mamba2_step,
                      mamba2_state_init),
           "mlstm": (mlstm_init, mlstm_apply, mlstm_step, mlstm_state_init),
           "slstm": (slstm_init, slstm_apply, slstm_step, slstm_state_init)}


def _check_block(btype: str):
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"unknown block type {btype!r}: {PORTED_BLOCKS}")


def _norm(cfg):
    return rmsnorm if cfg.norm == "rmsnorm" else layernorm


def _has_ffn(btype: str) -> bool:
    return btype in ("attn", "swa", "mla", "enc_attn", "dec_attn")


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
    p = {"ln1": _norm_init(cfg, device=device)}
    if btype == "mla":
        p["attn"] = mla_init(rng, cfg, device)
    elif btype in ("attn", "swa", "enc_attn", "dec_attn"):
        p["attn"] = gqa_init(rng, cfg, device)
        if btype == "dec_attn":
            p["ln_x"] = _norm_init(cfg, device=device)
            p["xattn"] = gqa_init(rng, cfg, device)
    elif btype == "shared_attn":
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for nm, dout in (("q", H * hd), ("k", K * hd), ("v", K * hd)):
            p[f"lora_{nm}_a"] = normal_init(rng, (d, LORA_RANK),
                                            cfg.param_dtype, 0.02, device)
            p[f"lora_{nm}_b"] = zeros_init((LORA_RANK, dout),
                                           cfg.param_dtype, device)
    else:
        p["mixer"] = _MIXERS[btype][0](rng, cfg, device)
    if not _has_ffn(btype):
        return p
    p["ln2"] = _norm_init(cfg, device=device)
    if cfg.n_experts and btype != "enc_attn":
        p["ffn"] = moe_init(rng, cfg, device)
    else:
        p["ffn"] = swiglu_init(rng, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                               cfg.n_layers or 2, device)
    return p


def _shared_attn_params(shared: Params, bp: Params, cfg):
    """The shared base weights merged with this application's LoRA deltas,
    in compute dtype (``dense`` then leaves them as they are); ``wo`` has
    no adapter."""
    cd = cfg.compute_dtype
    out = {}
    for nm, key in (("q", "wq"), ("k", "wk"), ("v", "wv")):
        w = shared[key]["w"].to(cd) + (
            bp[f"lora_{nm}_a"].to(cd) @ bp[f"lora_{nm}_b"].to(cd))
        out[key] = {"w": w}
    out["wo"] = {"w": shared["wo"]["w"].to(cd)}
    return out


def block_apply(bp: Params, x, *, btype, cfg, positions, cache=None,
                mode="train", impl="chunked", segments=1, shared=None,
                memory=None, balance=None, tp=None):
    """Returns (x, new_cache, aux). mode=="train": no cache; "prefill":
    returns the block's new cache; "decode": consumes and updates the cache
    (an attention cache's slot in place; a recurrent state comes back as
    new tensors). aux is the MoE balance term (per segment with
    ``segments`` > 1, see ``moe_apply``), 0.0 for other blocks. ``shared``
    is ``params["shared_attn"]``, which a ``shared_attn`` block applies;
    ``memory`` (B, M, d) the encoder's output, which a ``dec_attn`` block
    cross-attends in every mode. An ``enc_attn`` block trains
    bidirectionally (prefill and decode are causal, as ``repro``'s).
    ``balance``: the ranks that split the rows (``moe.Balance``); ``tp``
    the tensor-parallel context (``models.common.TensorParallel``) of an
    ``attn`` / ``swa`` / ``enc_attn`` block (local heads), a ``dec_attn``
    block (local heads in its self- and its cross-attention) or an
    ``mla`` block (local heads after the latent), each with a SwiGLU
    (``d_ff`` columns) or a MoE (local experts or ``d_ff_expert`` columns,
    the shared experts' ``d_ff``)."""
    _check_block(btype)
    nrm = _norm(cfg)
    h = nrm(bp["ln1"], x)
    new_cache = None
    if btype in _MIXERS:
        _, apply, step, _ = _MIXERS[btype]
        if mode == "decode":
            o, new_cache = step(bp["mixer"], h, cache, cfg=cfg)
        elif mode == "prefill":
            o, new_cache = apply(bp["mixer"], h, cfg=cfg, return_state=True)
        else:
            o = apply(bp["mixer"], h, cfg=cfg)
        return x + o, new_cache, 0.0
    if btype == "mla":
        attend, ap, kw = mla_apply, bp["attn"], {"tp": tp}
    elif btype == "shared_attn":
        attend, ap = gqa_apply, _shared_attn_params(shared, bp, cfg)
        kw = {"window": cfg.window}
    else:
        attend, ap = gqa_apply, bp["attn"]
        kw = {"window": cfg.window if btype == "swa" else 0, "tp": tp}
    if mode == "decode":
        o, new_cache = attend(ap, h, cfg=cfg, positions=positions,
                              cache=cache["self"] if btype == "dec_attn"
                              else cache, impl=impl, **kw)
    elif mode == "prefill":
        o, new_cache = attend(ap, h, cfg=cfg, positions=positions,
                              cache="init", impl=impl, **kw)
    elif btype == "enc_attn":
        o = _bidir_attn(ap, h, cfg, positions, impl, tp)
    else:
        o = attend(ap, h, cfg=cfg, positions=positions, impl=impl, **kw)
    x = x + o
    if btype == "dec_attn":
        x = x + _cross_attn(bp["xattn"], nrm(bp["ln_x"], x), memory, cfg,
                            impl, tp)
        if new_cache is not None:
            new_cache = {"self": new_cache}
    if not _has_ffn(btype):
        return x, new_cache, 0.0
    h2 = nrm(bp["ln2"], x)
    aux = 0.0
    if cfg.n_experts and btype != "enc_attn":
        f, aux = moe_apply(bp["ffn"], h2, cfg=cfg, segments=segments,
                           balance=balance, tp=tp)
    else:
        f = swiglu_apply(bp["ffn"], h2, cfg.act, cfg.compute_dtype, tp)
    return x + f, new_cache, aux


def _bidir_attn(ap, h, cfg, positions, impl, tp=None):
    """The encoder's self-attention: RoPE at ``positions``, no mask. With
    ``tp`` on the rank's heads (``attention.local_qkv``), ``wo``
    row-parallel and summed over ``model``."""
    q, k, v = local_qkv(ap, h, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = sdpa(q, k, v, q_pos=positions, k_pos=positions, causal=False,
             impl=impl)
    return local_out(ap, o, cfg, tp)


def _cross_attn(ap, h, memory, cfg, impl, tp=None):
    """Decoder cross-attention to the encoder's memory (B, M, d): no RoPE,
    every query and key at position 0, no mask. The memory's k and v are
    projected at every call, a decode step's included (``repro``'s). With
    ``tp`` q, k and v are the rank's heads (the memory, whole on every
    ``model`` rank, enters through Megatron's f, so its gradient is summed
    over ``model``) and ``wo`` is row-parallel, summed over ``model``."""
    S, M = h.shape[1], memory.shape[1]
    q, k, v = local_qkv(ap, h, cfg, tp, kv_x=memory)
    zeros = functools.partial(torch.zeros, dtype=torch.int32,
                              device=h.device)
    o = sdpa(q, k, v, q_pos=zeros((S,)), k_pos=zeros((M,)), causal=False,
             impl=impl)
    return local_out(ap, o, cfg, tp)


def block_cache_init(cfg, btype, batch, cache_len, device="cpu"):
    _check_block(btype)
    if btype == "dec_attn":
        return {"self": gqa_cache_init(cfg, batch, cache_len, device=device)}
    if btype in _MIXERS:
        return _MIXERS[btype][3](cfg, batch, device=device)
    if btype == "mla":
        return mla_cache_init(cfg, batch, cache_len, device=device)
    if btype in ("swa", "shared_attn"):
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


def init_generator(seed, device="cpu"):
    """The draws of an LM init from ``seed``: a seeded CUDA generator on
    the card (full-width weights drawn there, no host copy), a numpy
    generator elsewhere. A generator passed as ``seed`` is returned as it
    is."""
    if not isinstance(seed, (int, np.integer)):
        return seed
    if torch.device(device).type == "cuda":
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return np.random.default_rng(int(seed))


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
            tree = blocks[0]
            # stacked a leaf at a time, each rep's copy dropped as its leaf
            # is stacked: the unit's weights are held twice for one leaf
            # only (full-width MoE units are tens of GB)
            flat = [leaves(b) for b in blocks]
            del blocks
            p["scan"][f"u{u}"] = unflatten(tree, {
                k: torch.stack([f.pop(k) for f in flat])
                for k in list(flat[0])})
            del tree, flat
    p["rem"] = {f"r{i}": block_init(rng, cfg, bt, device)
                for i, bt in enumerate(rem)}
    if "shared_attn" in cfg.pattern:
        p["shared_attn"] = gqa_init(rng, cfg, device)
    if cfg.modality in ("vision_embed", "audio_embed"):
        p["projector"] = projector_init(rng, cfg, device)
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
    if cfg.n_enc_layers:
        p["enc"] = {"blocks": {f"e{i}": block_init(rng, cfg, "enc_attn",
                                                   device)
                               for i in range(cfg.n_enc_layers)},
                    "ln_f": _norm_init(cfg, device=device)}
    return p


def _restack(per_rep: list, views: list, stacked: dict) -> dict:
    """Stack per-repetition caches (nested dicts: a ``dec_attn`` cache is
    ``{"self": {...}}``) back onto the leading reps axis, leaf by leaf. A
    leaf a decode step wrote in place is still the view of ``stacked`` it
    was given (``views`` holds each repetition's flattened views), and is
    returned as the stacked tensor, not copied."""
    flat = [leaves(c) for c in per_rep]
    whole = leaves(stacked) if views is not None else None
    out = {}
    for key in flat[0]:
        if views is not None and all(c[key] is w[key]
                                     for c, w in zip(flat, views)):
            out[key] = whole[key]
        else:
            out[key] = torch.stack([c[key] for c in flat])
    return unflatten(per_rep[0], out)


def _remat(cfg, mode):
    """Whether a block's activations are recomputed in the backward
    (``repro``'s ``_maybe_remat``): ``cfg.remat`` in training, when a
    backward will run."""
    return cfg.remat and mode == "train" and torch.is_grad_enabled()


def _unit_apply(bp, x, *, path=None, tp=None, **kw):
    """``block_apply`` on the unit at ``path`` with its FSDP-cut leaves
    gathered first (``tp.unit``)."""
    if tp is not None:
        bp = tp.unit(bp, path)
    return block_apply(bp, x, tp=tp, **kw)


def _block(bp, x, *, remat, shared=None, **kw):
    """One block, recomputed in the backward with ``remat``. ``shared``
    (zamba's shared attention weights) goes to the checkpoint as an input
    beside the block's own tree: its gradient sums over every
    application. A tensor-parallel block's FSDP gather runs inside the
    checkpoint: the recompute gathers again, every rank in one order."""
    if not remat:
        return _unit_apply(bp, x, shared=shared, **kw)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(_unit_apply, bp, x, use_reentrant=False,
                      shared=shared, **kw)


def _unstack(tree: Params, reps: int) -> list:
    """A stacked block tree -> one tree a repetition."""
    flat = {k: v.unbind(0) for k, v in leaves(tree).items()}
    return [unflatten(tree, {k: v[r] for k, v in flat.items()})
            for r in range(reps)]


def run_trunk(params: Params, x, *, cfg, positions, mode="train",
              caches=None, impl="chunked", segments=1, memory=None,
              balance=None, tp=None):
    """x: (B,S,d) embedded inputs -> (hidden, new_caches, aux). aux is the
    sum over blocks of the MoE balance terms (0 without experts); with
    ``segments`` > 1 one per equal slice of the batch, each routed as if
    alone (``moe_apply``). With ``cfg.remat`` a training pass keeps only
    each block's input and recomputes the block in the backward.
    ``memory`` is the encoder's output, handed to every block (a
    ``dec_attn`` block cross-attends it). ``balance``: ``x`` holds this
    rank's share of rows split over several ranks, and aux is its share of
    the balance terms (``moe.Balance``). ``tp``: see the module
    docstring."""
    unit, reps, rem = _pattern_split(cfg)
    remat = _remat(cfg, mode)
    shared = params.get("shared_attn")
    aux = torch.zeros((segments,) if segments > 1 else (),
                      dtype=torch.float32, device=x.device)
    new_caches: Params = {}
    if reps > 0:
        per_unit = [[] for _ in unit]
        views = [[] for _ in unit] if mode == "decode" else None
        # one unbind a stacked leaf: its backward stacks the reps' grads
        # once, where indexing would add a zeroed full-size grad per rep
        per_rep = [_unstack(params["scan"][f"u{u}"], reps)
                   for u in range(len(unit))]
        for r in range(reps):
            for u, btype in enumerate(unit):
                bp = per_rep[u][r]
                c = None
                if mode == "decode":
                    c = tree_map(lambda a: a[r], caches["scan"][u])
                    views[u].append(leaves(c))
                x, nc, a = _block(bp, x, remat=remat, shared=shared,
                                  btype=btype, cfg=cfg, positions=positions,
                                  cache=c, mode=mode, impl=impl,
                                  segments=segments, memory=memory,
                                  balance=balance, tp=tp,
                                  path=f"scan/u{u}")
                aux = aux + a
                per_unit[u].append(nc)
        if mode in ("prefill", "decode"):
            new_caches["scan"] = tuple(
                _restack(per_unit[u], views[u] if views else None,
                         caches["scan"][u] if views else None)
                for u in range(len(unit)))
    for i, btype in enumerate(rem):
        c = caches["rem"][f"r{i}"] if (caches and "rem" in caches) else None
        x, nc, a = _block(params["rem"][f"r{i}"], x, remat=remat,
                          shared=shared, btype=btype, cfg=cfg,
                          positions=positions, cache=c, mode=mode, impl=impl,
                          segments=segments, memory=memory, balance=balance,
                          tp=tp, path=f"rem/r{i}")
        aux = aux + a
        if nc is not None:
            new_caches.setdefault("rem", {})[f"r{i}"] = nc
    x = _norm(cfg)(params["ln_f"], x)
    return x, (new_caches if new_caches else None), aux


def embed_inputs(params, tokens, cfg, media=None, tp=None):
    """tokens: (B, S_text) int; media: raw frontend embeddings
    (B, n_media, d_frontend) or None -> (B, n_media + S_text, d_model),
    the projected media first. ``tp``: the embedding is vocab-parallel
    (``models.common.embed``)."""
    x = embed(params["embed"], tokens, cfg.compute_dtype, tp=tp)
    if media is not None:
        media = projector_apply(params["projector"], media, cfg)
        x = torch.cat([media.to(x.dtype), x], dim=1)
    return x


def _mask_pad_vocab(logits, cfg, first: int = 0):
    """Padded vocab slots get -1e30 so softmax/argmax ignore them;
    ``logits`` cover the vocab ids from ``first`` on (a rank's block).
    In place: ``logits`` is the unembedding's own product (no backward
    reads it), and a copy would hold the (..., V) f32 logits twice."""
    if cfg.padded_vocab > cfg.vocab:
        vid = torch.arange(first, first + logits.shape[-1],
                           device=logits.device)
        return logits.masked_fill_(vid >= cfg.vocab, -1e30)
    return logits


def lm_logits(params, hidden, cfg, task: int | None = None, tp=None):
    """f32 logits over the padded vocab. With ``cfg.n_tasks > 1`` the
    per-source heads ``task_heads`` decode: ``task`` picks one head for
    hidden (..., d); without it hidden is the task-major (T, B, S, d)
    layout and every head decodes its own rows. Weights are cast to the
    hidden dtype and the products summed in f32. With a vocab-parallel
    ``tp`` the logits are the rank's block of the vocab, (..., V /
    model), from the rank's rows of the table or columns of ``lm_head``
    (FSDP-cut dims gathered: ``outer_units``)."""
    vocab = tp is not None and tp.vocab
    if cfg.n_tasks > 1:
        w = params["task_heads"]["w"]
        if task is not None:
            out = hidden.float() @ w[task].to(hidden.dtype).float()
        else:
            out = torch.einsum("tbsd,tdv->tbsv", hidden.float(),
                               w.to(hidden.dtype).float())
    elif "lm_head" in params:
        out = dense(params["lm_head"], tp.copy(hidden) if vocab else hidden,
                    cfg.compute_dtype).float()
    else:
        out = unembed(params["embed"], hidden, tp)
    return _mask_pad_vocab(out, cfg, tp.index * out.shape[-1] if vocab
                           else 0)


def encode(params, src_embed, cfg, impl="chunked", tp=None):
    """The encoder of an enc-dec model. src_embed: raw frontend frames
    (B, S_src, d_frontend) -> memory (B, S_src, d_model): the projector
    (a modality model's), then ``n_enc_layers`` bidirectional blocks at
    positions ``arange(S_src)``, then the encoder's final norm. No remat,
    as ``repro``'s. ``tp``: ``params`` are the rank's blocks; each block
    runs on its local heads and ``d_ff`` columns, its FSDP-cut leaves
    gathered first (``tp.unit``), and the projector and the norms are
    replicated compute: the memory is whole on every ``model`` rank."""
    if cfg.modality in ("vision_embed", "audio_embed"):
        src_embed = projector_apply(params["projector"], src_embed, cfg)
    x = src_embed.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_enc_layers):
        x, _, _ = _unit_apply(params["enc"]["blocks"][f"e{i}"], x,
                              path=f"enc/blocks/e{i}", tp=tp,
                              btype="enc_attn", cfg=cfg, positions=positions,
                              mode="train", impl=impl)
    return _norm(cfg)(params["enc"]["ln_f"], x)


def outer_units(params: Params, tp) -> Params:
    """``params`` with the embedding and ``lm_head`` units' FSDP-cut
    leaves gathered (``tp.unit``), once for a forward: a tied table
    serves the embedding and the unembedding from one gather, whose
    backward reduce-scatters both gradients."""
    if tp is None or tp.gather is None:
        return params
    out = dict(params, embed=tp.unit(params["embed"], "embed"))
    if "lm_head" in params:
        out["lm_head"] = tp.unit(params["lm_head"], "lm_head")
    return out


def lm_apply(params: Params, tokens, *, cfg, media=None, memory=None,
             mode="train", caches=None, positions=None, impl="chunked",
             task=None, balance=None, tp=None):
    """Full LM forward. Returns (logits, new_caches, aux). ``media``
    (prefill and train) is prepended through the projector; ``memory``
    (B, M, d_model), the encoder's output, is needed by an enc-dec model
    in every mode. ``balance`` as ``run_trunk``'s; ``tp``: this rank's
    blocks, computed tensor-parallel (the module docstring), the logits
    the rank's vocab block."""
    params = outer_units(params, tp)
    if mode == "decode":
        x = embed(params["embed"], tokens, cfg.compute_dtype,
                  tp=tp)                                         # (B,1,d)
    else:
        x = embed_inputs(params, tokens, cfg, media, tp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    if cfg.n_enc_layers and memory is None and mode != "decode":
        raise ValueError("enc-dec model needs encoder memory")
    h, ncaches, aux = run_trunk(params, x, cfg=cfg, positions=positions,
                                mode=mode, caches=caches, impl=impl,
                                memory=memory, balance=balance, tp=tp)
    return lm_logits(params, h, cfg, task=task, tp=tp), ncaches, aux


def local_caches(caches: Params, cfg, tp) -> Params:
    """Whole decode caches -> this rank's under ``tp``: each GQA
    ``k``/``v`` leaf (..., K, hd) keeps the kv heads the rank's q heads
    read (``attention.local_kv_heads``), the other leaves — MLA's latent
    ``ckv`` / ``krope``, replicated over ``model`` — as they are."""
    from .attention import local_kv_heads
    _, (k0, k1), owner = local_kv_heads(cfg, tp)
    heads = [k0 + i for i in owner] if owner is not None else None

    def cut(tree):
        if isinstance(tree, tuple):
            return tuple(cut(t) for t in tree)
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, tuple)):
                out[k] = cut(v)
            elif k in ("k", "v"):
                out[k] = v[..., k0:k1, :] if heads is None else \
                    v[..., heads, :]
            else:
                out[k] = v
        return out
    return cut(caches)


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
