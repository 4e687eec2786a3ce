"""Mixture-of-Experts layer, capacity-based (port of ``repro.models.moe``).

Tokens are cut into groups of ``gs = min(group_size, T)``; each token picks
its top-k experts from an f32 softmax router, gates renormalised. A token's
place in an expert's per-group queue is the token-major cumsum of the
choices; choices past the capacity ``C`` go to a dump slot ``E·C`` and
drop. The dispatched buffer is ``(groups, E, C, d)``, the experts' SwiGLU is
one batched product over the expert axis in ``compute_dtype``, and the
combine gathers each choice's row back and sums it gated. Optional
DeepSeek-style shared experts; the Switch load-balance term as aux.

Across ranks (``Balance``: the ranks that split a segment's rows between
them) each rank routes its own tokens in ``repro``'s groups and returns its
share of the balance term, so that the shares sum to ``repro``'s term over
the whole segment and to its gradient.

Tensor-parallel (``moe_apply(tp=)``, ``models.common.TensorParallel`` of a
``spec_fn`` plan): the ``model`` ranks of a row share its tokens, and each
routes all of them alike — the same router, cumsum, positions and capacity
over all E experts, so slots, keeps and drops are one process's. With
experts over ``model`` (``tp.experts``) a rank's dispatch buffer holds the
slots of its E/m experts only (a choice of another rank's expert goes to
the dump row) and the batched products run on them; with ``d_ff_expert``
cut (``tp.expert_ffn``) every expert runs on the rank's columns of
``w_gate``/``w_up`` and rows of ``w_down``. Either way the combine gives
the rank's partial output, the shared experts' row-parallel partial is
added to it, and one SUM over ``model`` a layer makes it whole: T·d values
a layer, where an all-to-all of the capacity buffer would move about
k·cf·T·d each way, and no token crosses ranks. The router's logits reach
the loss through the balance term (whole on every rank) and through the
gates (partial): Megatron's f (``tp.copy``) on the gates and on the
dispatched rows, not on the block's input, leaves the router's gradient
whole and equal on every ``model`` rank.

Every kept slot holds exactly one token's row, so the dispatch writes rows
with an indexed copy (no accumulation) and the combine's backward writes
each kept slot's cotangent with an indexed copy (``_Gather``): no float
atomics on CUDA, the same bits on every run. ``repro`` scatters with
``.at[slot].add``, which on a kept slot adds one row to zeros: the same
values.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .common import ACT, Params, normal_init
from .mlp import swiglu_apply, swiglu_init


def moe_init(rng, cfg, device="cpu") -> Params:
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    dt = cfg.param_dtype
    p = {
        "router": normal_init(rng, (d, E), dt, 0.02, device),
        "w_gate": normal_init(rng, (E, d, dff), dt, 1 / math.sqrt(d),
                              device),
        "w_up": normal_init(rng, (E, d, dff), dt, 1 / math.sqrt(d), device),
        "w_down": normal_init(rng, (E, dff, d), dt,
                              0.02 / math.sqrt(2 * cfg.n_layers), device),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(rng, d, dff * cfg.n_shared_experts, dt,
                                  cfg.n_layers, device)
    return p


class Balance(NamedTuple):
    """The ``size`` ranks of process group ``group`` that split each
    segment's rows evenly between them (a data-parallel group, or a task's
    head group). The Switch term ``E·Σ_e frac_e·mp_e`` is bilinear over the
    whole segment, so a sum of per-rank terms is not its value; ``frac``
    comes from the choices and carries no gradient, so the ranks all-reduce
    their per-expert counts (one small SUM a layer) and keep the
    probability sums local, scaled by the segment's global token count:
    the ranks' terms sum to the whole segment's, and so do their
    gradients."""
    group: Any
    size: int


def _capacity(gs: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(gs * top_k / n_experts * factor))
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8 lanes


class _Gather(torch.autograd.Function):
    """``flat[g, slot[g, i]]`` for (G, N, d) ``flat`` and (G, M) ``slot``.
    Its backward writes each row's cotangent to its slot with an indexed
    copy: a kept slot is read by one choice, so that is its whole
    cotangent; the rows read many times (the zero dump row) get one of
    theirs, and their cotangent is not used."""

    @staticmethod
    def forward(ctx, flat, gi, slot):
        ctx.save_for_backward(gi, slot)
        ctx.shape = flat.shape
        return flat[gi, slot]

    @staticmethod
    def backward(ctx, g):
        gi, slot = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return out.index_put_((gi, slot), g), None, None


def route(params: Params, xf, cfg):
    """xf: (G, gs, d) -> the f32 router probabilities (G, gs, E), the
    renormalised gates and the choices (G, gs, k), ``lax.top_k``'s order
    (descending, the lower expert first on a tie)."""
    logits = torch.einsum("gsd,de->gse", xf.float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[..., :cfg.top_k], choice[..., :cfg.top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, choice


def moe_apply(params: Params, x, *, cfg, group_size: int = 512,
              segments: int = 1, balance: Balance | None = None, tp=None):
    """x: (B, S, d) -> (y, aux). Token order is preserved.

    ``segments`` > 1 routes each of that many equal slices of the batch
    (rows ``B / segments`` each) as ``repro`` routes it alone — its own
    groups, capacity and balance term — and returns aux per slice,
    (segments,): the multi-task LM loss runs every task's rows through one
    trunk pass, where ``repro`` maps the trunk over the tasks.

    ``balance``: ``x`` is this rank's share of rows that ``balance.size``
    ranks split evenly; ``repro`` routes a segment's ``size·T`` tokens in
    groups of ``min(group_size, size·T)``, so the rank's ``T`` tokens must
    be a whole number of those groups (it raises otherwise, rather than
    route in other groups), and aux is the rank's share of the segment's
    term (``Balance``).

    ``tp``: ``params`` are this rank's blocks, computed tensor-parallel
    (the module docstring); y is whole and aux the same on every ``model``
    rank."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cd = cfg.compute_dtype
    if B % segments:
        raise ValueError(f"batch {B} not divisible into {segments} segments")
    T = B * S // segments
    ranks = balance.size if balance is not None else 1
    gs = min(group_size, T * ranks)
    if T % gs:
        if balance is not None:
            raise ValueError(
                f"a rank's {T} tokens of a segment are not a whole number "
                f"of routing groups: repro routes the segment's {T * ranks} "
                f"tokens over {ranks} ranks in groups of {gs} "
                f"(min(group_size, tokens)); give each rank a multiple of "
                f"{gs} tokens a segment")
        raise ValueError(f"tokens {T} not divisible by group {gs}")
    per = T // gs                             # groups a segment
    G = per * segments
    C = _capacity(gs, k, E, cfg.capacity_factor)
    e0, e1 = tp.experts if tp is not None and tp.experts else (0, E)
    split = tp is not None and (tp.experts is not None or tp.expert_ffn)

    xf = x.reshape(G, gs, d)
    probs, gate, choice = route(params, xf, cfg)

    # ---- positions in each expert's per-group queue ----------------------
    cf = choice.reshape(G, gs * k)                              # token-major
    oh = torch.nn.functional.one_hot(cf, E).to(torch.int32)     # (G,gs*k,E)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1            # (G,gs*k)
    keep = pos < C
    if e1 - e0 < E:                   # this rank's experts' slots only
        keep = keep & (cf >= e0) & (cf < e1)
    El = e1 - e0
    slot = torch.where(keep, (cf - e0) * C + pos,
                       torch.full_like(cf, El * C))
    gi = torch.arange(G, device=x.device)[:, None]

    # ---- dispatch: one token's row to each kept slot ---------------------
    xd = tp.copy(xf) if split else xf
    xr = xd[:, :, None, :].expand(G, gs, k, d).reshape(G, gs * k, d)
    buf = torch.zeros((G, El * C + 1, d), dtype=cd, device=x.device)
    buf = buf.index_put((gi, slot), xr.to(cd))
    ein = buf[:, :El * C].reshape(G, El, C, d)

    # ---- expert FFN, batched over the expert axis ------------------------
    wg = params["w_gate"].to(cd)
    wu = params["w_up"].to(cd)
    wd = params["w_down"].to(cd)
    h = ACT[cfg.act](torch.einsum("gecd,edf->gecf", ein, wg)) * \
        torch.einsum("gecd,edf->gecf", ein, wu)
    eout = torch.einsum("gecf,efd->gecd", h, wd)                # (G,El,C,d)

    # ---- combine (gather) -------------------------------------------------
    flat = torch.cat([eout.reshape(G, El * C, d),
                      torch.zeros((G, 1, d), dtype=cd, device=x.device)], 1)
    yk = _Gather.apply(flat, gi, slot)                          # (G,gs*k,d)
    gk = tp.copy(gate) if split else gate
    yk = yk * (gk.reshape(G, gs * k, 1).to(cd) * keep[..., None])
    y = yk.reshape(G, gs, k, d).sum(2).reshape(B, S, d)

    # ---- shared experts; the partial sums made whole ---------------------
    ys = None
    if "shared" in params:
        stp = None if tp is None else tp._replace(ffn=tp.shared)
        joint = split and tp.shared       # both partial: one SUM for both
        ys = swiglu_apply(params["shared"], x, cfg.act, cd, stp,
                          reduce=not joint)
        if joint:
            y, ys = y + ys, None
    if split:
        y = tp.reduce(y)
    if ys is not None:
        y = y + ys

    # ---- aux loss ----------------------------------------------------------
    # Switch-style load balance: E * sum_e fraction_e * mean_prob_e
    counts = torch.nn.functional.one_hot(choice, E).float()
    if balance is None:
        frac = counts.reshape(segments, -1, E).mean(1) * k
        mp = probs.reshape(segments, -1, E).mean(1)
    else:
        # the segment's choices of each expert, summed over its ranks;
        # the probabilities stay local: this rank's share of the mean
        total = float(T * ranks)
        chosen = counts.reshape(segments, -1, E).sum(1).contiguous()
        if ranks > 1:
            import torch.distributed as dist
            dist.all_reduce(chosen, op=dist.ReduceOp.SUM,
                            group=balance.group)
        frac = chosen / total
        mp = probs.reshape(segments, -1, E).sum(1) / total
    aux = E * (frac * mp).sum(-1)
    return y, (aux[0] if segments == 1 else aux)
