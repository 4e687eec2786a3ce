"""Serving: prefill / decode step factories and batched greedy generation
(the port of ``repro.train.serve``).

``greedy_generate`` chains prefill -> cache extension -> decode. Under
``impl="pallas"`` prefill runs the flash-attention kernel and every decode
step the flash-decode kernel (one launch per layer each; an enc-dec
decoder's cross-attention to the encoder's ``memory`` runs #5 in prefill
and in every decode step); ``"chunked"`` and ``"naive"`` are the plain
PyTorch paths. A vision model's media go through
``make_prefill_step(media=)``, and its decode steps start at
``n_media + S_text``. A decode step writes its token's slot of each
layer's cache (k/v, or MLA's ckv/krope) in place (see
``models.attention``), so the caches handed to it are updated; the values
are ``repro``'s.

On a ``spec_fn`` plan (``plan=``) a transformer LM (GQA or MLA, dense
or MoE, or the encoder-decoder) is served tensor-parallel from the rank's
blocks (``serving_tp``): its ``model`` ranks share the rows they are
given, each computes its local heads and experts (or ``d_ff_expert``
columns) — the encoder's (``make_encode_step``), the decoder's causal
self-attention and each cross-attention to the memory, which is whole on
every ``model`` rank —, its caches hold its kv heads (MLA's latent cache
whole), and the logits are its vocab block;
greedy decoding takes the argmax over the ``model`` ranks (the lowest
index on a tie, as ``torch.argmax`` and ``jnp.argmax`` take it).
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import transformer


def extend_caches(caches, cfg, capacity: int):
    """Pad prefill-produced attention caches (length S) to ``capacity``
    along their sequence axis (the (reps,) stack leads where present):
    GQA's ``k``/``v`` (..., S, K, hd), MLA's ``ckv``/``krope`` (..., S, r).
    A sliding-window ``k``/``v`` cache already at or past the window keeps
    its length: it is a rolling cache from the next token on."""
    def fix(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in ("k", "v", "ckv", "krope") and isinstance(
                        v, torch.Tensor):
                    seq_ax = v.dim() - (3 if k in ("k", "v") else 2)
                    cur = v.shape[seq_ax]
                    cap = capacity
                    if k in ("k", "v") and cfg.window and cur >= cfg.window:
                        cap = cur
                    if cap > cur:
                        pad = [0, 0] * (v.dim() - seq_ax - 1) + [0, cap - cur]
                        v = F.pad(v, pad)
                    out[k] = v
                elif isinstance(v, (dict, tuple)):
                    out[k] = fix(v)
                else:
                    out[k] = v
            return out
        if isinstance(tree, tuple):
            return tuple(fix(t) for t in tree)
        return tree

    return fix(caches)


def serving_tp(cfg, plan):
    """The ``models.common.TensorParallel`` a rank serves ``cfg`` with on
    ``plan`` (None without a sharded plan). A model outside
    ``configs.sharding.tensor_parallel_family`` raises: its ranks would
    have to gather every cut leaf whole (``plan.gather``) and serve the
    whole tree."""
    if plan is None or not plan.sharded:
        return None
    from ..configs.sharding import MODEL, mesh_shape, tensor_parallel_reason
    why = tensor_parallel_reason(cfg, mesh_shape(plan.mesh)[MODEL])
    if why is None and cfg.n_tasks > 1:
        why = "per-source LM heads are not served: repro's greedy " \
              "decoding takes no task"
    if why is not None:
        raise ValueError(f"{cfg.name}: no tensor-parallel serving ({why}); "
                         "gather the params whole (plan.gather) and serve "
                         "without a plan")
    import numpy as np
    meta = transformer.lm_init(np.random.default_rng(0), cfg, "meta")
    return plan.tensor_parallel(plan.layout(meta))


def greedy_tokens(logits, tp=None):
    """(..., V) or a rank's vocab block (..., V / model) -> the argmax
    ids, int32: under a vocab-parallel ``tp`` the local max and its
    index, then the largest value over ``model`` (MAX) and the lowest
    index that holds it (MIN), the index ``argmax`` of the whole row
    gives."""
    if tp is None or not tp.vocab or tp.size == 1:
        return logits.argmax(-1).to(torch.int32)
    from ..launch.mesh import all_reduce
    idx = logits.argmax(-1)
    val = logits.gather(-1, idx[..., None])[..., 0]
    top = all_reduce(val.clone(), tp.group, "max")
    ids = idx + tp.index * logits.shape[-1]
    ids = torch.where(val == top, ids, torch.full_like(ids, 2 ** 62))
    return all_reduce(ids, tp.group, "min").to(torch.int32)


def make_encode_step(cfg, impl="chunked", plan=None):
    """An enc-dec model's encoder as a serving step: ``encode(params,
    src_embed)`` -> the memory (B, S_src, d_model) that prefill and every
    decode step cross-attend. On a tensor-parallel plan ``params`` are the
    rank's blocks (each encoder block on its local heads and ``d_ff``
    columns) and the memory is whole on every ``model`` rank."""
    tp = serving_tp(cfg, plan)

    @torch.no_grad()
    def encode(params, src_embed):
        return transformer.encode(params, src_embed, cfg, impl, tp)
    return encode


def make_prefill_step(cfg, impl="chunked", plan=None):
    tp = serving_tp(cfg, plan)

    @torch.no_grad()
    def prefill(params, tokens, media=None, memory=None):
        """tokens: (B, S_text) ints; ``media`` (B, n_media, d_frontend)
        frames projected and put first; ``memory`` (B, M, d_model) the
        encoder's output for an enc-dec model. On a tensor-parallel plan
        ``params`` are the rank's blocks, the caches its kv heads and the
        logits its vocab block."""
        logits, caches, _ = transformer.lm_apply(
            params, tokens, cfg=cfg, media=media, memory=memory,
            mode="prefill", impl=impl, tp=tp)
        return logits, caches
    return prefill


def make_decode_step(cfg, impl="chunked", task=None, plan=None):
    tp = serving_tp(cfg, plan)

    @torch.no_grad()
    def decode(params, token, caches, pos, memory=None):
        """token: (B,1) int; pos: the absolute position (an int or a 0-d
        tensor; a device tensor keeps the step free of host syncs);
        ``memory`` the encoder's output for an enc-dec model. Writes the
        token's k/v slot of each layer's cache in place and returns
        (logits, caches). With ``task``, the logits come from that
        source's LM head."""
        positions = torch.as_tensor(pos, device=token.device).reshape(1)
        logits, caches, _ = transformer.lm_apply(
            params, token, cfg=cfg, mode="decode", caches=caches,
            positions=positions, memory=memory, impl=impl, task=task, tp=tp)
        return logits, caches
    return decode


def greedy_generate(params, cfg, prompt_tokens, n_new: int, *,
                    impl="chunked", capacity: int | None = None,
                    memory=None, device=None, return_logits=False,
                    timings=None, plan=None):
    """prompt_tokens: (B, S) ints; ``memory`` (B, M, d_model) the
    encoder's output for an enc-dec model, cross-attended at prefill and at
    every step. Returns the (B, n_new) int32 greedy continuation on
    ``device`` — and, with ``return_logits``, the f32 logits each token was
    taken from, (B, n_new, padded vocab).

    ``device`` None means ``cuda`` (raises without a GPU); ``params`` must
    already live there (``interop.to_torch(tree, device)``). A
    ``timings`` dict receives ``prefill_s`` and ``decode_s``, host clock
    around device-synchronised phases. ``plan``: a ``spec_fn`` plan whose
    rank serves these rows tensor-parallel from its blocks (the module
    docstring); the tokens, and the logits gathered over the vocab, are
    the same on its ``model`` ranks (a collective: each calls it)."""
    dev = resolve_device(device)
    table = params["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"params are on {table.device}, generating on "
                         f"{dev}: move them with interop.to_torch")
    tokens = torch.as_tensor(prompt_tokens).to(dev)
    if memory is not None:
        memory = torch.as_tensor(memory).to(dev)
    B, S = tokens.shape
    capacity = capacity or (S + n_new)
    tp = serving_tp(cfg, plan)
    prefill = make_prefill_step(cfg, impl, plan)
    decode = make_decode_step(cfg, impl, plan=plan)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, caches = prefill(params, tokens, memory=memory)
    caches = extend_caches(caches, cfg, capacity)
    last = logits[:, -1:]
    tok = greedy_tokens(last, tp)
    out, outs_logits = [tok], [last]
    sync()
    t1 = time.perf_counter()
    pos = torch.tensor(S, dtype=torch.int64, device=dev)
    for _ in range(n_new - 1):
        logits, caches = decode(params, tok, caches, pos, memory=memory)
        tok = greedy_tokens(logits[:, -1:], tp)
        out.append(tok)
        outs_logits.append(logits[:, -1:])
        pos = pos + 1
    sync()
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1)
    toks = torch.cat(out, dim=1)
    if return_logits:
        lg = torch.cat(outs_logits, dim=1)
        return toks, (lg if tp is None else tp.gather_vocab(lg))
    return toks
