"""Dry run: one rank's program for every (arch x input shape x mesh), with
no job around it (port of ``repro.launch.dryrun``).

``repro`` lowers and compiles the SPMD step for 512 placeholder devices
and reads ``memory_analysis`` and the HLO. Here one process opens a
``fake_world`` of the mesh's ranks as rank 0 (collectives complete and
move nothing), builds the rank's state from ``meta`` templates
(``plan.state_template``: its block of every leaf ``spec_fn`` cuts, its
heads, both AdamW moments) and runs its step on fake tensors
(``FakeTensorMode``: shapes only) under ``launch.cost.count``, which
reports its FLOPs, the bytes its ops move, its collectives and its peak:

  * train: the ``lm`` step on ``ShardingPlan(mesh, spec_fn=make_spec_fn)``
    with ``cfg.train_accum`` microbatches of the rank's rows;
  * prefill: the rank's rows through ``train.serve.make_prefill_step``
    (every position unembedded, as the port serves), then
    ``logits[:, -1:]``, as ``repro``'s dry run slices its ``lm_apply``;
  * decode: one step over ``cache_specs`` (a cache split over its length
    is gathered over the data axes first; one split over the batch keeps
    the rank's rows);
  * the GFM: the task-parallel step on the paper mesh (``"par"`` when the
    ``model`` axis takes the tasks, else ``"base"``), ``repro``'s batch
    rule, with the edge path the port trains (``"fused"``); ``hier``:
    the bottleneck group's rank of the solved placement, with
    ``hier_group_memory``.

The static count runs the plain versions of the hand kernels (fake
tensors are CPU tensors, for which every wrapper takes its plain
version); ``--materialize`` runs the same rank program on ``--device``
with real seeded tensors — the kernels on the card — and reports its
measured peak beside the static one. A stack of identical block units is
traced at one and two units and extrapolated to the full depth (an
encoder's layers likewise, at one and two of them beside the decoder's
units, each count linear in both), and
accumulation at one and two microbatches, and a model of recurrent blocks
only at one, two and three chunks of its length (``cost.extrapolate``); the
entry says so (``hlo.traced``). A blocked attention call outside autograd
(prefill, decode) over more than ``ATTN_PAIRS`` block pairs is counted
from the same call at 1 x 1, 1 x 2 and 2 x 2 blocks, extrapolated as a +
nq b + nq nk c (the per-pair body and the per-query-block work repeat
exactly; the call's prologue, which converts q, k and v whole, is counted
at the traced sizes, and its blocks' temporaries are not in the peak).

The step computes what the port computes (``figures`` in an entry's
``memory`` and ``hlo`` says which, entry by entry): a transformer LM of
GQA or MLA attention with a dense or a MoE feed-forward
(``configs.sharding.tensor_parallel_family`` at the mesh's ``model``
size) runs its products on the rank's blocks — local heads (MLA's after
the replicated latent; the encoder-decoder's encoder, decoder and
cross-attention), column- and row-parallel SwiGLU, a MoE's local
experts or ``d_ff_expert`` columns with one SUM over ``model`` a layer, a
vocab-parallel embedding, logits and loss, each unit's FSDP leaves
gathered before use and reduce-scattered after — and its caches hold the
rank's kv heads (MLA's latent cache whole), the layout ``repro``'s specs
name; every other model gathers every cut leaf whole and runs its rows
through the whole tree (data-parallel compute), and its entry says why.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.configs.sharding import make_spec_fn, rank_slices
from repro_torch.configs.specs import (batch_spec, cache_leaf_spec,
                                       cache_specs, input_specs, materialize)
from repro_torch.launch.memory import param_bytes_per_device as nbytes
from repro_torch.launch import cost

ATTN_PAIRS = 16          # block pairs above which an attention call is
                         # counted from 1x1 / 1x2 / 2x2 blocks
WORLD = {"pod": 256, "multipod": 512, "pod32x8": 256, "paper": 500,
         "hier": 512}
NOTES = ("static count: fake CPU tensors, so every hand kernel runs its "
         "plain version (impl 'chunked' attention, the fused edge path's "
         "plain version, the one-hot segment sum)")
# what a spec_fn plan's figures are (``figures`` in ``memory`` and ``hlo``)
TENSOR_PARALLEL = ("tensor-parallel: the products run on the rank's blocks "
                   "(local heads, MLA's after the replicated latent, an "
                   "encoder's and each cross-attention's; "
                   "column/row-parallel SwiGLU; a MoE's local experts or "
                   "d_ff_expert columns, its routing replicated, one SUM "
                   "over model a layer; a vocab-parallel embedding, logits "
                   "and loss), FSDP leaves gathered a unit before use and "
                   "reduce-scattered: the layout repro's specs name")
DATA_PARALLEL = ("data-parallel: every cut leaf is gathered whole before "
                 "the forward and the gradients are all-reduced whole, the "
                 "rank keeping its blocks between steps; peak_bytes and "
                 "collective_bytes are this plan's, not those of repro's "
                 "tensor-parallel layout")


def figures(cfg, model_size: int) -> str:
    """What a ``spec_fn`` plan's figures for ``cfg`` are on a mesh whose
    ``model`` axis has ``model_size`` ranks."""
    from repro_torch.configs.sharding import tensor_parallel_reason
    why = tensor_parallel_reason(cfg, model_size)
    return TENSOR_PARALLEL if why is None else f"{DATA_PARALLEL} ({why})"


def _model_size(mesh) -> int:
    from repro_torch.configs.sharding import MODEL, mesh_shape
    return mesh_shape(mesh).get(MODEL, 1)


def skip_reason(arch: str, shape_name: str) -> str | None:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    if cfg.family == "gnn" and shape.kind != "train":
        return "gnn: no LM serving shapes (paper arch trains only)"
    if shape.kind == "decode" and not cfg.supports_decode:
        return "no decode step for this arch"
    if shape_name == "long_500k":
        if arch == "seamless-m4t-medium":
            return "enc-dec speech model: 500k-token decode out of family scope (DESIGN.md)"
        if not cfg.long_context_ok and not cfg.swa_variant_window:
            return "pure full attention, no SWA variant configured"
    return None


def entry_skip(arch: str, shape_name: str, mesh_kind: str,
               cfg=None) -> str | None:
    """Why an (arch, shape, mesh) entry is skipped, or None: ``skip_reason``,
    then the ``hier`` mesh for a model without per-task heads."""
    reason = skip_reason(arch, shape_name)
    if reason is None and mesh_kind == "hier" and \
            (cfg or configs.get(arch)).family != "gnn":
        reason = "hier placement shards per-task heads (gnn only)"
    return reason


def make_mesh(kind: str):
    """The mesh of ``kind`` in the current (fake) world."""
    from repro_torch.launch import mesh as m
    if kind == "paper":
        return m.make_gfm_paper_mesh(dp=100)
    if kind.startswith("pod32x8"):
        return m.make_alt_mesh(8)
    return m.make_production_mesh(multi_pod=(kind == "multipod"))


# ---------------------------------------------------------------------------
# tensors: meta templates -> fake (static) or seeded (materialised)
# ---------------------------------------------------------------------------

def _tensors(tree, device, seed, vocab=0, fake=True):
    """A tree of ``meta`` tensors as fake CPU tensors (inside a
    ``FakeTensorMode``) or as real ones on ``device`` from ``seed``."""
    if not fake:
        return materialize(tree, device, seed, vocab=vocab)

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(one(v) for v in t)
        return torch.empty(tuple(t.shape), dtype=t.dtype)
    return one(tree)


def _rank_rows(batch, mesh, coords, B):
    """The rank's rows of a flat batch of ``meta`` tensors (whole when the
    data axes do not divide ``B``)."""
    out = {}
    for k, v in batch.items():
        if v.dim() == 0:
            out[k] = v
            continue
        spec = batch_spec(mesh, B, v.dim() - 1)
        out[k] = v[rank_slices(tuple(v.shape), spec, mesh, coords)]
    return out


def _accum_run(b_local: int, accum: int) -> int:
    """The microbatches the rank's ``b_local`` rows take: ``accum``, or
    the largest count <= it that divides them."""
    return max(a for a in range(1, max(accum, 1) + 1) if b_local % a == 0)


def _depth_cfg(cfg, reps: int):
    unit = len(cfg.block_pattern)
    return cfg.replace(n_layers=unit * reps + cfg.n_layers % unit)


# ---------------------------------------------------------------------------
# rank programs: build(cfg, shape, mesh, accum, device, micro) -> (fn,
# make, info); make(fake) -> (args, tensors alive before the call), fake
# (inside a FakeTensorMode) or seeded on the device
# ---------------------------------------------------------------------------

def _lm_train(cfg, shape, mesh, accum, device, micro, seed=0):
    from repro_torch.engine import ShardingPlan, build_model, make_step
    from repro_torch.optim import adamw
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    model = build_model("lm", cfg, impl="chunked")
    opt = adamw(1e-3, weight_decay=0.01, grad_clip=1.0,
                moment_dtype=cfg.moment_dtype, donate=True)
    tmpl = plan.state_template(model.init, opt)
    rows = _rank_rows(input_specs(cfg, shape), mesh, plan.coords,
                      shape.global_batch)
    b_local = rows["tokens"].shape[0]
    a_run = _accum_run(b_local, accum)
    if micro is not None:              # a traced count of `micro` of them
        n = b_local // a_run * micro
        rows = {k: v[:n] for k, v in rows.items()}
        a_run = micro
    step = make_step(model, opt, plan, accum=a_run)

    def make(fake):
        state = _state(tmpl, device, seed, fake)
        batch = _tensors(rows, device, seed + 1, cfg.vocab, fake)
        return (state, batch), (state.params, state.opt_state, batch)

    return step, make, {"kind": "train", "plan": plan, "template": tmpl,
                        "batch": rows, "accum_run": _accum_run(b_local,
                                                               accum)}


def _state(tmpl, device, seed, fake):
    """A state template's tensors, fake or seeded."""
    return tmpl._replace(
        params=_tensors(tmpl.params, device, seed, fake=fake),
        opt_state=tmpl.opt_state._replace(
            m=_tensors(tmpl.opt_state.m, device, seed, fake=fake),
            v=_tensors(tmpl.opt_state.v, device, seed, fake=fake)))


def _cut_params(cfg, mesh):
    """(plan, layout, the rank's params as ``meta``) of a serving step."""
    from repro_torch.engine import ShardingPlan, build_model
    plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
    full = build_model("lm", cfg).init(0, device="meta")
    layout = plan.layout(full)
    return plan, layout, plan.cut(full, layout)


def _lm_prefill(cfg, shape, mesh, accum, device, micro, seed=0):
    from repro_torch.configs.sharding import tensor_parallel_family
    from repro_torch.train.serve import make_encode_step, make_prefill_step
    plan, layout, local = _cut_params(cfg, mesh)
    rows = _rank_rows(input_specs(cfg, shape), mesh, plan.coords,
                      shape.global_batch)
    tp = tensor_parallel_family(cfg, _model_size(mesh))
    step = make_prefill_step(cfg, "chunked", plan=plan if tp else None)
    encode = make_encode_step(cfg, "chunked", plan=plan if tp else None)

    @torch.no_grad()
    def prefill(params, batch):
        full = params if tp else plan.gather(params, layout)
        memory = None
        if cfg.n_enc_layers:
            memory = encode(full, batch["src_embed"])
        logits, caches = step(full, batch["tokens"], media=batch.get("media"),
                              memory=memory)
        return logits[:, -1:], caches

    def make(fake):
        params = _tensors(local, device, seed, fake=fake)
        batch = _tensors(rows, device, seed + 1, cfg.vocab, fake)
        return (params, batch), (params, batch)

    return prefill, make, {"kind": "prefill", "plan": plan, "params": local,
                           "batch": rows}


def _lm_decode(cfg, shape, mesh, accum, device, micro, seed=0):
    import torch.distributed as dist

    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs.sharding import (local_shard,
                                             tensor_parallel_family)
    from repro_torch.models.transformer import local_caches
    from repro_torch.train.serve import make_decode_step, serving_tp
    caches_meta, eff = cache_specs(cfg, shape)
    plan, layout, local = _cut_params(eff, mesh)
    B = shape.global_batch
    coords = plan.coords
    tp = tensor_parallel_family(eff, _model_size(mesh))
    specs = [cache_leaf_spec(v, mesh, B)
             for v in tree_flatten(caches_meta)[0]]
    if tp:      # the rank's kv heads; the data axes' split as cache_specs
        caches_meta = local_caches(caches_meta, eff, serving_tp(eff, plan))
    flat, tree = tree_flatten(caches_meta)
    c_local = tree_unflatten([local_shard(v, s, mesh, coords)
                              for v, s in zip(flat, specs)], tree)
    rows = _rank_rows(input_specs(eff, shape), mesh, coords, B)
    mem = None
    if cfg.n_enc_layers:
        mem = torch.empty((rows["token"].shape[0], cfg.enc_memory_len,
                           cfg.d_model), dtype=cfg.compute_dtype,
                          device="meta")
    dec = make_decode_step(eff, impl="chunked", plan=plan if tp else None)
    # a cache split over its length is gathered over the data axes (the
    # step attends to all of it); one split over the batch holds the
    # rank's rows already
    bdim = [0 if v.dim() and v.shape[0] == B else 1 for v in flat]
    gather = [i for i, s in enumerate(specs)
              if any(e is not None for d, e in enumerate(s) if d != bdim[i])]

    def decode(params, token, caches, pos, memory):
        full = params if tp else plan.gather(params, layout)
        cl = tree_flatten(caches)[0]
        for i in gather:
            shape_, s, x = tuple(flat[i].shape), specs[i], cl[i]
            buf = torch.full(shape_, -0.0 if x.is_floating_point() else 0,
                             dtype=x.dtype, device=x.device)
            buf[rank_slices(shape_, s, mesh, coords)] = x
            dist.all_reduce(buf, group=plan.gather_group(s))
            cl[i] = buf
        return dec(full, token, tree_unflatten(cl, tree), pos, memory=memory)

    def make(fake):
        params = _tensors(local, device, seed, fake=fake)
        io = _tensors(rows, device, seed + 1, eff.vocab, fake)
        caches = _tensors(c_local, device, seed + 2, fake=fake)
        memory = None if mem is None else _tensors(mem, device, seed + 3,
                                                   fake=fake)
        return (params, io["token"], caches, io["pos"], memory), (
            params, caches, io, memory)

    return decode, make, {"kind": "decode", "plan": plan, "params": local,
                          "batch": rows, "caches": c_local,
                          "swa_variant": eff is not cfg and
                          bool(cfg.swa_variant_window)}


def gfm_batch_shapes(cfg, n_req: int = 1) -> dict:
    """``repro``'s task-major GFM batch as ``meta`` tensors: 128 graphs a
    task where 128 divides ``n_req`` (the product of the axes its dim is
    sharded over; the paper's local batch), else ``n_req``."""
    B = 128 if 128 % n_req == 0 else n_req
    T, A, E = cfg.n_tasks, cfg.max_atoms, cfg.max_edges

    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return {"species": m((T, B, A), torch.int32),
            "pos": m((T, B, A, 3), torch.float32),
            "edge_src": m((T, B, E), torch.int32),
            "edge_dst": m((T, B, E), torch.int32),
            "node_mask": m((T, B, A), torch.bool),
            "edge_mask": m((T, B, E), torch.bool),
            "energy": m((T, B), torch.float32),
            "forces": m((T, B, A, 3), torch.float32)}


def _gfm_tensors(batch, device, seed, cfg, fake):
    """A GFM batch: fake, or seeded on ``device`` — species in [1,
    n_species), positions normal, edges a ring over the atoms."""
    if fake:
        return _tensors(batch, device, seed)
    out = materialize(batch, device, seed, vocab=cfg.max_atoms)
    out["species"] = out["species"] % (cfg.n_species - 1) + 1
    out["pos"] = out["pos"] * 50.0
    A = cfg.max_atoms
    e = torch.arange(out["edge_src"].shape[-1], device=device)
    out["edge_src"] = (e % A).to(torch.int32).expand_as(out["edge_src"])\
        .contiguous()
    out["edge_dst"] = ((e + 1 + e // A) % A).to(torch.int32)\
        .expand_as(out["edge_dst"]).contiguous()
    return out


def _gfm(cfg, shape, mesh, accum, device, micro, seed=0):
    from repro_torch.configs.specs import data_axes
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.core.taskpar import MTPConfig
    from repro_torch.engine import ShardingPlan, make_step
    from repro_torch.configs.sharding import mesh_shape
    from repro_torch.optim import adamw
    model = make_gfm_mtl(cfg, cfg.n_tasks)
    dims = mesh_shape(mesh)
    m_ax = dims.get("model", 0)
    mode = "par" if m_ax and m_ax % cfg.n_tasks == 0 else "base"
    plan = ShardingPlan(mesh=mesh, mtp=MTPConfig(n_tasks=cfg.n_tasks,
                                                 mode=mode))
    opt = adamw(1e-3, donate=True)
    tmpl = plan.state_template(model.init, opt)
    n_req = 1
    for a in data_axes(dims) + (() if mode == "par" else ("model",)):
        n_req *= dims.get(a, 1)
    rows = plan.slice_batch(gfm_batch_shapes(cfg, n_req))
    step = make_step(model, opt, plan)
    return step, _gfm_make(tmpl, rows, device, seed, cfg), {
        "kind": "gfm-train", "plan": plan, "template": tmpl, "batch": rows,
        "n_tasks": cfg.n_tasks, "mtp_mode": mode}


def _gfm_make(tmpl, rows, device, seed, cfg):
    def make(fake):
        state = _state(tmpl, device, seed, fake)
        batch = _gfm_tensors(rows, device, seed + 1, cfg, fake)
        return (state, batch), (state.params, state.opt_state, batch)
    return make


def _placement(cfg, n_devices: int):
    """The imbalance-aware placement of ``cfg``'s heads over ``n_devices``
    at the paper's source mix (``repro``'s hier dry run)."""
    from repro_torch.core import solve_placement
    from repro_torch.data.synthetic_atoms import PAPER_REL_SIZES
    mix = list(PAPER_REL_SIZES.values())
    return solve_placement(n_devices, [mix[t % len(mix)]
                                       for t in range(cfg.n_tasks)])


def _gfm_hier(cfg, shape, mesh, accum, device, micro, seed=0):
    import torch.distributed as dist

    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.engine import ShardingPlan, TrainState, make_step
    from repro_torch.launch.memory import hier_group_memory
    from repro_torch.optim import adamw
    model = make_gfm_mtl(cfg, cfg.n_tasks)
    placement = _placement(cfg, dist.get_world_size())
    plan = ShardingPlan(placement=placement)
    opt = adamw(1e-3, donate=True)
    full = model.init(0, device="meta")
    local = plan.shard_params(full)
    tmpl = TrainState(params=local, opt_state=opt.init(local), step=0)
    rows = plan.slice_batch(gfm_batch_shapes(cfg))
    step = plan.compile(make_step(model, opt, plan))
    shared = nbytes(full["shared"])
    head = nbytes(full["heads"]) // cfg.n_tasks
    gl = placement.group_loads()
    return step, _gfm_make(tmpl, rows, device, seed, cfg), {
        "kind": "gfm-hier-train", "plan": plan, "template": tmpl,
        "batch": rows, "n_tasks": cfg.n_tasks,
        "placement": {"groups": [list(g) for g in placement.groups],
                      "device_counts": list(placement.device_counts),
                      "loads": list(placement.loads or ())},
        "group_memory": hier_group_memory(placement, shared, head),
        "bottleneck_group": gl.index(max(gl))}


def _builder(cfg, shape, mesh_kind):
    if cfg.family == "gnn":
        return _gfm_hier if mesh_kind == "hier" else _gfm
    return {"train": _lm_train, "prefill": _lm_prefill,
            "decode": _lm_decode}[shape.kind]


def _rank_of(cfg, mesh_kind) -> int:
    """The rank whose program the entry reports: 0, or on ``hier`` the
    first rank of the bottleneck group (its step is the critical path)."""
    if mesh_kind != "hier":
        return 0
    from repro_torch.core.taskpar import group_ranks
    p = _placement(cfg, WORLD["hier"])
    gl = p.group_loads()
    return group_ranks(p)[gl.index(max(gl))][0]


# ---------------------------------------------------------------------------
# one entry
# ---------------------------------------------------------------------------

def _state_bytes(info) -> dict:
    """The rank's bytes: params, moments, batch (and caches), and the
    sharded count of ``param_bytes_per_device`` over the full tree
    (``param_bytes_model``), which the params must equal."""
    plan = info["plan"]
    out = {"batch_bytes": nbytes(info["batch"])}
    if "template" in info:
        t = info["template"]
        out["param_bytes"] = nbytes(t.params)
        out["moment_bytes"] = nbytes(t.opt_state.m) + \
            nbytes(t.opt_state.v)
    else:
        out["param_bytes"] = nbytes(info["params"])
    if "caches" in info:
        out["cache_bytes"] = nbytes(info["caches"])
    if info.get("full") is not None:
        out["param_bytes_model"] = nbytes(
            info["full"], specs=info["specs"], mesh=plan.mesh)
    return out


def _blocked_attention(real):
    """``sdpa_chunked`` for the static count: a call outside autograd
    over more than ``ATTN_PAIRS`` block pairs is counted apart at 1 x 1,
    1 x 2 and 2 x 2 blocks, extrapolated to its grid (``cost.add``), and
    returns an output of its shape."""
    from torch.utils._python_dispatch import _disable_current_modes

    def fn(q, k, v, *, q_pos, k_pos, causal=True, window=0, scale=None,
           q_chunk=512, k_chunk=1024):
        Sq, Sk = q.shape[1], k.shape[1]
        qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
        nq, nk = -(-Sq // qc), -(-Sk // kc)
        kw = dict(causal=causal, window=window, scale=scale, q_chunk=qc,
                  k_chunk=kc)
        if nq * nk <= ATTN_PAIRS or torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            return real(q, k, v, q_pos=q_pos, k_pos=k_pos, **kw)
        c = {}
        with _disable_current_modes():
            for a, b in ((1, 1), (1, 2), (2, 2)):
                a_, b_ = min(a, nq), min(b, nk)
                c[a, b] = cost.count(functools.partial(
                    real, q_pos=q_pos[:a_ * qc], k_pos=k_pos[:b_ * kc],
                    **kw), q[:, :a_ * qc], k[:, :b_ * kc],
                    v[:, :b_ * kc])[1]
        # c(nq, nk) = a + nq b + nq nk c through the three grids
        cost.add(cost.combine([(c[1, 1], 2 * nq - nq * nk),
                               (c[1, 2], 2 - 3 * nq + nq * nk),
                               (c[2, 2], nq - 1)]))
        return q.new_empty(q.shape)

    return fn


def _count(build, cfg, shape, mesh, accum, device, micro):
    """The rank program's counts on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import attention
    fn, make, info = build(cfg, shape, mesh, accum, device, micro)
    real = attention.sdpa_chunked
    attention.sdpa_chunked = _blocked_attention(real)
    try:
        # host constants the step builds in (task weights, head indices)
        # become fake where they meet fake tensors
        with FakeTensorMode(allow_non_fake_inputs=True):
            args, track = make(True)
            _, c = cost.count(fn, *args, track=track)
    finally:
        attention.sdpa_chunked = real
    return c, info


RECURRENT = ("mlstm", "slstm", "mamba2")   # blocks linear in the length


def static_count(arch_cfg, shape, mesh, mesh_kind, accum, device):
    """-> (counts at full depth, length and accumulation, info, how
    traced, the collectives of one unit and one microbatch — each
    distinct collective once, as ``repro``'s ``collective_stats`` counts a
    loop body once). A model of recurrent blocks only (xlstm: its sLSTM is a loop a token) is
    traced for its train and prefill steps at one, two and three chunks of
    ``ssm_chunk`` tokens, and the counts' parabola through them taken at
    the shape's length (the FLOPs are linear in it; the scan's autograd
    copies make its op bytes grow faster), the peak on the line through
    the last two."""
    if shape.kind != "decode" and arch_cfg.family != "gnn" and all(
            b in RECURRENT for b in arch_cfg.block_pattern):
        q = arch_cfg.ssm_chunk or 64
        pts = [(n * q, _static_at(arch_cfg, dataclasses.replace(
            shape, seq_len=n * q), mesh, mesh_kind, accum, device))
            for n in (1, 2, 3)]
        info0 = _builder(arch_cfg, shape, mesh_kind)(
            arch_cfg, shape, mesh, accum, device, None)[2]
        return (cost.extrapolate([(n, r[0]) for n, r in pts], shape.seq_len,
                                 peak="line"),
                info0, dict(pts[0][1][2], seq_len=[n for n, _ in pts]),
                pts[0][1][3])
    return _static_at(arch_cfg, shape, mesh, mesh_kind, accum, device)


def _static_at(arch_cfg, shape, mesh, mesh_kind, accum, device):
    from repro_torch.models.transformer import _pattern_split
    build = _builder(arch_cfg, shape, mesh_kind)
    reps = _pattern_split(arch_cfg)[1] if arch_cfg.family != "gnn" else 0
    # a decode cache's batch axis is found by its size (``repro``'s rule):
    # at one unit a (reps, B, ...) leaf with B = 1 would read as batch-major,
    # so decode traces two and three units; so does prefill, whose first
    # unit's peak holds the embedding's transients, off the line the
    # later units' caches follow
    depths = [2, 3] if shape.kind in ("decode", "prefill") else [1, 2]
    if reps <= depths[-1]:
        depths = [None]
    info0 = build(arch_cfg, shape, mesh, accum, device, None)[2]
    a_run = info0.get("accum_run", 1) if shape.kind == "train" else 1
    micros = [1, 2] if a_run > 2 else [None]
    # an encoder (train and prefill run it) is traced at one and two of
    # its layers beside the decoder's units, every count linear in each
    enc = arch_cfg.n_enc_layers if shape.kind != "decode" and \
        depths != [None] and arch_cfg.n_enc_layers > 2 else 0
    grid = [(r, 1 if enc else None) for r in depths] + \
        ([(depths[0], 2)] if enc else [])
    by_depth, once = [], None
    for r, e in grid:
        cfg_r = arch_cfg if r is None else _depth_cfg(arch_cfg, r)
        if e is not None:
            cfg_r = cfg_r.replace(n_enc_layers=e)
        runs = [_count(build, cfg_r, shape, mesh, accum, device, m)[0]
                for m in micros]
        if once is None:               # one unit, one microbatch
            once = runs[0]["collectives"]
        by_depth.append(runs[0] if len(runs) == 1 else cost.extrapolate(
            list(zip(micros, runs)), a_run, peak="last"))
    total = by_depth[0] if len(by_depth) == 1 else cost.extrapolate(
        list(zip(depths, by_depth[:len(depths)])), reps)
    if enc:             # + (enc - 1) x an encoder layer's counts and peak
        layer = [(by_depth[2], enc - 1), (by_depth[0], 1 - enc)]
        total = dict(cost.combine([(total, 1.0)] + layer), peak_bytes=int(
            total["peak_bytes"] + sum(w * c["peak_bytes"] for c, w in layer)))
    traced = {"depth_units": "full" if depths == [None] else depths,
              "units": reps, "microbatches": micros if a_run > 2 else
              "all", "accum_run": a_run}
    if enc:
        traced.update(enc_layers=[1, 2], enc_units=enc)
    return total, info0, traced, once


def _materialized(build, cfg, shape, mesh, accum, device):
    """The full rank program on ``device`` with seeded tensors, counted
    (its collectives) and its peak read from the allocator."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    fn, make, info = build(cfg, shape, mesh, accum, device, None)
    args, track = make(False)
    t0 = time.perf_counter()
    out, c = cost.count(fn, *args, track=track)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res = {"device": str(dev), "step_s": time.perf_counter() - t0,
           "collectives": c["collectives"],
           "flops_visible": c["flops"],
           "flops_note": "the ATen ops' FLOPs; the hand kernels' launches "
                         "(ctypes) are not seen by the counter",
           "peak_bytes_tracked": c["peak_bytes"]}
    # the allocator's peak on the card; elsewhere the tracked one
    res["peak_bytes"] = torch.cuda.max_memory_allocated() - base \
        if dev.type == "cuda" else c["peak_bytes"]
    res["state_bytes"] = _state_bytes(info)
    return res, out, args, info


def run_one(arch: str, shape_name: str, mesh_kind: str, *, accum: int = 1,
            compile_too: bool = True, cfg_override=None, baseline=False,
            device=None, materialize_too: bool = False,
            keep: dict | None = None) -> dict:
    """One entry: ``repro``'s fields where they mean something (``memory``,
    ``cost`` / ``hlo``, ``collectives_once``, ``top_ops``). ``device``: the
    rank's device (None: ``cuda``, raising without a GPU; the CPU must be
    asked for). ``keep``: a dict that receives the materialised run's
    outputs and arguments."""
    from repro_torch import resolve_device
    from repro_torch.launch.mesh import fake_world
    device = str(resolve_device(device))
    entry = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if baseline and cfg_override is None and arch in configs.ARCHS:
        cfg_override = configs.get(arch).replace(mlstm_chunked=False,
                                                 naive_tp=True)
    cfg = cfg_override or configs.get(arch)
    reason = entry_skip(arch, shape_name, mesh_kind, cfg)
    if reason:
        entry["status"] = "skip"
        entry["reason"] = reason
        return entry
    if cfg.family == "gnn":
        cfg = cfg.replace(segment_sum_impl="fused")
    shape = SHAPES[shape_name]
    if accum == 1:
        accum = cfg.train_accum
    t0 = time.perf_counter()
    try:
        with fake_world(WORLD[mesh_kind], _rank_of(cfg, mesh_kind), device):
            mesh = None if mesh_kind == "hier" else make_mesh(mesh_kind)
            build = _builder(cfg, shape, mesh_kind)
            if compile_too:
                total, info, traced, once = static_count(
                    cfg, shape, mesh, mesh_kind, accum, device)
            else:
                info = build(cfg, shape, mesh, accum, device, None)[2]
            meta = {k: v for k, v in info.items() if k in (
                "kind", "n_tasks", "mtp_mode", "placement", "group_memory",
                "bottleneck_group", "swa_variant", "accum_run")}
            entry.update(meta)
            if shape.kind == "train" and cfg.family != "gnn":
                entry["accum"] = accum
            info["full"], info["specs"] = _full_tree(cfg, shape, info)
            entry["memory"] = _state_bytes(info)
            if info["plan"].sharded:
                entry["memory"]["figures"] = figures(cfg, _model_size(mesh))
            if compile_too:
                entry["memory"]["peak_bytes"] = total["peak_bytes"]
                entry["cost"] = {"flops": total["flops"],
                                 "bytes accessed": total["traffic_bytes"]}
                entry["hlo"] = {k: total[k] for k in (
                    "flops", "traffic_bytes", "collective_bytes",
                    "collectives")}
                entry["hlo"]["traced"] = traced
                entry["hlo"]["notes"] = NOTES
                if info["plan"].sharded:
                    entry["hlo"]["figures"] = entry["memory"]["figures"]
                entry["collectives_once"] = once
                entry["top_ops"] = total["top_ops"]
            else:
                entry["hlo"] = {"skipped": "no-compile: the rank's program "
                                "built, not run"}
            if materialize_too:
                res, out, args, _ = _materialized(build, cfg, shape, mesh,
                                                  accum, device)
                entry["materialized"] = res
                if keep is not None:
                    keep.update(out=out, args=args)
        entry["status"] = "ok"
    except Exception as e:
        entry["status"] = "fail"
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["trace"] = traceback.format_exc()[-2000:]
    entry["total_s"] = round(time.perf_counter() - t0, 2)
    return entry


def _full_tree(cfg, shape, info):
    """(the full params tree as ``meta``, ``{path: spec}``) of the leaves a
    rank holds a block of: the cut leaves of a ``spec_fn`` plan, a
    ``"par"`` plan's heads over ``model``; (None, None) when every leaf
    is whole."""
    plan = info["plan"]
    if plan.sharded:
        from repro_torch.configs.specs import serve_variant
        from repro_torch.engine import build_model
        full = build_model("lm", serve_variant(cfg, shape)).init(
            0, device="meta")
        return full, {p: s for p, (_, s) in plan.layout(full).items()}
    if info.get("mtp_mode") == "par":
        from repro_torch.core.mtl import make_gfm_mtl
        from repro_torch.interop import leaves
        full = make_gfm_mtl(cfg, cfg.n_tasks).init(0, device="meta")
        return full, {f"heads/{p}": ("model",) + (None,) * (v.dim() - 1)
                      for p, v in leaves(full["heads"]).items()}
    return None, None


def _entry(job):
    (arch, shape, mk), kw = job
    return run_one(arch, shape, mk, **kw)


def _entries(todo, kw, jobs):
    """``run_one`` over ``todo`` in order; with ``jobs`` > 1 in a pool of
    spawned processes, one entry at a time each."""
    if jobs <= 1:
        for t in todo:
            yield _entry((t, kw))
        return
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(jobs, maxtasksperchild=1) as pool:
        yield from pool.imap(_entry, [(t, kw) for t in todo])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "paper", "pod32x8",
                             "hier"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--baseline", action="store_true",
                    help="pre-perf-iteration system (naive TP, scan mLSTM)")
    ap.add_argument("--no-compile", action="store_true",
                    help="build the rank's program without the cost trace")
    ap.add_argument("--materialize", action="store_true",
                    help="also run the rank's program on --device with "
                         "seeded tensors and report its measured peak")
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: cuda, raising "
                         "without a GPU)")
    ap.add_argument("--out", default=None, help="JSON output path (appends)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="entries run at once, each in a process of its own "
                         "(a fake world is one per process)")
    args = ap.parse_args(argv)
    from repro_torch import resolve_device
    device = resolve_device(args.device)

    archs = list(configs.ASSIGNED) if args.all or not args.arch \
        else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}
    todo = [(arch, shape, mk) for arch in archs for shape in shapes
            for mk in meshes if (arch, shape, mk) not in done]
    kw = dict(accum=args.accum, compile_too=not args.no_compile,
              baseline=args.baseline, device=str(device),
              materialize_too=args.materialize)
    for r in _entries(todo, kw, args.jobs):
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("trace", "top_ops")}), flush=True)
        results.append(r)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_fail = sum(1 for r in results if r["status"] == "fail")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    print(f"# dryrun done: ok={n_ok} fail={n_fail} skip={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
