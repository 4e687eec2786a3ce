"""Parameter sharding rules: leaf path -> spec (port of
``repro.configs.sharding``).

The mesh contract (``launch.mesh``): axes ``("data", "model")`` on one pod
or ``("pod", "data", "model")`` across pods. ``"model"`` carries the
tensor-parallel, expert-parallel and task-parallel dims; ``"data"``
carries the batch and FSDP; ``"pod"`` is pure data parallelism.

The port has no ``PartitionSpec``: a spec is a tuple with one entry per
dimension of the leaf, each ``None`` (whole), an axis name, or a tuple of
axis names (the dim split over their product, the first axis major). The
rules are ``repro``'s, in its order — the first pattern that matches the
``/``-joined path wins. A stacked block leaf carries a leading ``reps``
dim, which the rule does not name: it is detected and left whole. A mesh
is a ``DeviceMesh``, a ``{axis: size}`` mapping, or None (the rules'
default ``model`` axis of 16, nothing fitted).

``rank_slices`` / ``local_shard`` give the part of a leaf one rank of a
mesh holds (the counterpart of ``tree_shardings``); a dim whose axes a
spec names is cut into equal blocks, the block index the rank's
coordinates on those axes, row-major.

``read_spec`` reads a spec for compute, in the layout it names: a dim
cut over ``model`` stays local (the product runs on the block), a dim cut
over ``data`` is FSDP's (gathered just before use, freed after), and a
leaf that names no axis is replicated compute. ``tensor_parallel_family``
says which configs a ``spec_fn`` plan computes so on a mesh's ``model``
axis (``engine.plan``); ``make_spec_fn`` leaves its config on the function
it returns (``spec_fn.cfg``), which is how a plan knows.
"""
from __future__ import annotations

import re
from typing import NamedTuple

MODEL = "model"
FSDP = "data"                      # the axis FSDP cuts params over
TP_BLOCKS = ("attn", "swa", "mla", "enc_attn", "dec_attn")  # the blocks
                                     # tensor-parallel compute covers


def _rules(cfg, model_size: int = 16):
    F = "data" if cfg.fsdp else None  # FSDP axis
    E_div = cfg.n_experts and cfg.n_experts % model_size == 0  # EP if divisible
    # head-ALIGNED tensor parallelism only: a head count the model axis does
    # not divide keeps its heads whole (naive_tp: the reference's earlier
    # head-fractional rule)
    QH = MODEL if cfg.n_heads and cfg.n_heads % model_size == 0 else None
    KH = MODEL if cfg.n_kv_heads and cfg.n_kv_heads % model_size == 0 else None
    if cfg.naive_tp:
        QH = KH = MODEL
    r = []
    # embeddings / heads
    r.append((r"embed/table$", lambda: (MODEL, F)))
    r.append((r"lm_head/w$", lambda: (F, MODEL)))
    r.append((r"task_heads/w$", lambda: (MODEL, None, None)))
    # attention (gqa + mla)
    r.append((r"attn/wq/w$", lambda: (F, QH)))
    r.append((r"attn/w[kv]/w$", lambda: (F, KH)))
    r.append((r"attn/wq/b$", lambda: (QH,)))
    r.append((r"attn/w[kv]/b$", lambda: (KH,)))
    r.append((r"attn/wo/w$", lambda: (QH, F)))
    r.append((r"attn/wq_a/w$", lambda: (F, None)))
    r.append((r"attn/wq_b/w$", lambda: (None, MODEL)))
    r.append((r"attn/wkv_a/w$", lambda: (F, None)))
    r.append((r"attn/w[kv]_b/w$", lambda: (None, MODEL)))
    # xattn (enc-dec) same as attn
    r.append((r"xattn/wq/w$", lambda: (F, QH)))
    r.append((r"xattn/w[kv]/w$", lambda: (F, KH)))
    r.append((r"xattn/wo/w$", lambda: (QH, F)))
    # dense mlp
    r.append((r"ffn/w_gate/w$", lambda: (F, MODEL)))
    r.append((r"ffn/w_up/w$", lambda: (F, MODEL)))
    r.append((r"ffn/w_down/w$", lambda: (MODEL, F)))
    # moe: expert-parallel if E divides the axis, else TP over expert hidden
    if E_div:
        r.append((r"ffn/w_gate$", lambda: (MODEL, F, None)))
        r.append((r"ffn/w_up$", lambda: (MODEL, F, None)))
        r.append((r"ffn/w_down$", lambda: (MODEL, None, F)))
    else:
        r.append((r"ffn/w_gate$", lambda: (None, F, MODEL)))
        r.append((r"ffn/w_up$", lambda: (None, F, MODEL)))
        r.append((r"ffn/w_down$", lambda: (None, MODEL, F)))
    r.append((r"ffn/router$", lambda: (F, None)))
    r.append((r"ffn/shared/w_gate/w$", lambda: (F, MODEL)))
    r.append((r"ffn/shared/w_up/w$", lambda: (F, MODEL)))
    r.append((r"ffn/shared/w_down/w$", lambda: (MODEL, F)))
    # mamba2
    r.append((r"mixer/w_in/w$", lambda: (F, MODEL)))
    r.append((r"mixer/w_out/w$", lambda: (MODEL, F)))
    r.append((r"mixer/conv_w$", lambda: (None, MODEL)))
    r.append((r"mixer/conv_b$", lambda: (MODEL,)))
    # xlstm
    r.append((r"mixer/w_up/w$", lambda: (F, MODEL)))
    r.append((r"mixer/w[qkv]/w$", lambda: (F, MODEL)))
    r.append((r"mixer/w_down/w$", lambda: (MODEL, F)))
    r.append((r"mixer/w_ff_up/w$", lambda: (F, MODEL)))
    r.append((r"mixer/w_ff_down/w$", lambda: (MODEL, F)))
    return r


def path_str(path) -> str:
    """A leaf path (a sequence of keys / indices, or already a string) ->
    ``"a/b/c"``."""
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh``, a mapping, or None (``{}``)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def make_spec_fn(cfg, mesh=None):
    """``spec_fn(path, leaf) -> spec`` for ``cfg``'s parameter tree on
    ``mesh`` (``repro``'s rules, first match wins; unmatched leaves whole).
    """
    axsize = mesh_shape(mesh)
    rules = _rules(cfg, model_size=axsize.get(MODEL, 16))

    def _fit(spec, shape) -> tuple:
        """Drop mesh axes from dims they do not evenly divide (e.g. odd
        vocabs): every rank holds an equal block."""
        out = []
        for dim, entry in zip(shape, spec):
            n = 1
            for a in _axes(entry):
                n *= axsize.get(a, 1)
            out.append(entry if entry is not None and n and dim % n == 0
                       else None)
        return tuple(out)

    def spec_fn(path, leaf) -> tuple:
        ps = path_str(path)
        nd = len(leaf.shape)
        for pat, build in rules:
            if re.search(pat, ps):
                spec = build()
                k = len(spec)
                if nd == k:
                    return _fit(spec, leaf.shape)
                if nd == k + 1:          # stacked block: leading reps dim
                    return _fit((None,) + spec, leaf.shape)
                # mismatch (e.g. a bias matched a weight rule): whole
                return (None,) * nd
        return (None,) * nd

    spec_fn.cfg = cfg      # what a plan computes tensor-parallel
    return spec_fn


def tree_specs(tree, spec_fn, prefix: str = "") -> dict:
    """``{path: spec}`` for every leaf of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_specs(v, spec_fn, p))
        else:
            out[p] = spec_fn(p, v)
    return out


def shard_count(spec, mesh) -> int:
    """How many blocks a leaf with ``spec`` is cut into on ``mesh``: the
    product of the sizes of the axes the spec names."""
    axsize = mesh_shape(mesh)
    n = 1
    for entry in spec:
        for a in _axes(entry):
            n *= axsize.get(a, 1)
    return n


def rank_slices(shape, spec, mesh, coords: dict) -> tuple:
    """The slices of a leaf of ``shape`` that the rank at ``coords``
    (``{axis: index}``) holds under ``spec``."""
    axsize = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        n, idx = 1, 0
        for a in axes:
            n *= axsize.get(a, 1)
            idx = idx * axsize.get(a, 1) + coords.get(a, 0)
        if dim % n:
            raise ValueError(f"dim {dim} does not split evenly over {axes}")
        size = dim // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shard(leaf, spec, mesh, coords: dict):
    """The rank's block of ``leaf`` (a contiguous copy; a ``meta`` leaf
    gives a ``meta`` block)."""
    return leaf[rank_slices(leaf.shape, spec, mesh, coords)].contiguous()


def spec_axes(spec) -> set:
    """The mesh axes ``spec`` names, in any of its dims."""
    return {a for entry in spec for a in _axes(entry)}


def holds_first_copy(spec, mesh, coords: dict) -> bool:
    """Whether the rank at ``coords`` is the first holder of its block:
    its coordinate on every mesh axis the spec does not name is 0. Each
    block has exactly one first holder."""
    named = spec_axes(spec)
    return all(i == 0 for a, i in coords.items() if a not in named)


def check_divisibility(cfg, mesh) -> list[str]:
    """Which sharded dims the ``model`` axis does not divide (``repro``
    reports these for its roofline notes)."""
    issues = []
    m = mesh_shape(mesh).get(MODEL, 1)
    for nm, dim in (("n_heads", cfg.n_heads), ("vocab", cfg.vocab),
                    ("d_ff", cfg.d_ff)):
        if dim and dim % m:
            issues.append(f"{nm}={dim} % model={m} != 0")
    return issues


class LeafCut(NamedTuple):
    """A spec read for compute: the dims cut over ``model`` (local: the
    product runs on the rank's block) and those cut over ``data`` (FSDP:
    gathered over ``plan.gather_group`` of the data axes just before use,
    and the gradient reduce-scattered back into the block). A leaf with
    neither is whole on every rank: replicated compute, as ``repro``'s
    GSPMD repeats it."""
    model: tuple
    fsdp: tuple


def read_spec(spec) -> LeafCut:
    """``spec``'s ``model``-local and FSDP-gathered dims."""
    spec = tuple(spec)
    return LeafCut(
        model=tuple(i for i, e in enumerate(spec) if MODEL in _axes(e)),
        fsdp=tuple(i for i, e in enumerate(spec) if FSDP in _axes(e)))


def tensor_parallel_reason(cfg, model_size: int) -> str | None:
    """Why a ``spec_fn`` / ``shared_spec_fn`` plan whose ``model`` axis has
    ``model_size`` ranks does NOT compute ``cfg`` tensor-parallel (None:
    it does). Tensor-parallel compute covers the transformer LMs of
    ``attn`` / ``swa`` / ``mla`` blocks, each with a dense SwiGLU or a MoE
    (experts over ``model``, or every expert's ``d_ff_expert`` cut over
    it), and the encoder-decoder's ``enc_attn`` / ``dec_attn`` blocks
    (its audio projector names no axis: replicated compute, as GSPMD
    repeats it), every head whole on a rank; with per-source heads
    (lm-mtl) the trunk so and the heads over ``model`` by task. The
    others keep the data-parallel step (every cut leaf gathered whole):
    the vision frontend, the recurrent blocks (their specs cut fused
    columns, not heads) and fractional heads."""
    m = model_size
    if cfg.family == "gnn" or not cfg.n_layers:
        return "not a transformer LM"
    if cfg.naive_tp:
        for what, n in (("heads", cfg.n_heads), ("kv heads", cfg.n_kv_heads)):
            if n % m:
                return (f"naive_tp's fractional heads ({n} {what} over "
                        f"model {m})")
    if "mla" in cfg.block_pattern and cfg.n_heads % m:
        return (f"MLA's heads would split ({cfg.n_heads} heads over model "
                f"{m}: wq_b's columns are cut by columns, not heads)")
    if cfg.modality not in ("text", "audio_embed"):
        return f"{cfg.modality} frontend"
    other = sorted({b for b in cfg.block_pattern if b not in TP_BLOCKS})
    if other:
        return f"blocks {other} (only {list(TP_BLOCKS)} are tensor-parallel)"
    return None


def tensor_parallel_family(cfg, model_size: int) -> bool:
    """Whether a ``spec_fn`` plan with ``model_size`` ``model`` ranks
    computes ``cfg`` on local blocks."""
    return tensor_parallel_reason(cfg, model_size) is None
