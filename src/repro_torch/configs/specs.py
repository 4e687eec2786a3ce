"""Stand-ins for every model input and decode cache (port of
``repro.configs.specs``).

``input_specs`` and ``cache_specs`` return ``meta`` tensors: shapes and
dtypes, nothing allocated — what ``launch.dryrun`` builds a rank's
program from. A spec (``configs.sharding``'s tuples) says how the batch
dims split over the data axes (``batch_spec``, ``cache_leaf_spec``).
``materialize`` makes real tensors of the same shapes from a seed, on a
device, for the tests and the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.frontends import AUDIO_EMBED_DIM, VISION_EMBED_DIM

from .base import ArchConfig, ShapeConfig
from .sharding import mesh_shape


def data_axes(mesh) -> tuple:
    """The mesh's data-parallel axes, ``pod`` before ``data``."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _dp_entry(mesh):
    """The data axes as one spec entry: a lone axis by its name (as
    ``repro``'s ``PartitionSpec`` prints it), several as a tuple."""
    dp = data_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def _n_data(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= shape[a]
    return n


def batch_spec(mesh, B: int, extra_dims: int):
    """The batch dim over the data axes if they divide it; else whole. None
    without a mesh."""
    if mesh is None:
        return None
    n = _n_data(mesh)
    if B % n == 0 and B >= n:
        return (_dp_entry(mesh),) + (None,) * extra_dims
    return (None,) * (extra_dims + 1)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                reduced: bool = False) -> dict:
    """The batch of ``meta`` tensors for (arch, shape):

    train / prefill: ``{"tokens", "labels"?, "media"?, "src_embed"?}``
    decode:          ``{"token", "pos"}`` (the caches: ``cache_specs``)

    ``reduced``: at most 4 sequences of 128 tokens (8 media tokens, 32
    source frames). ``mesh`` is accepted for ``repro``'s signature; the
    batch dims' split is ``batch_spec``'s."""
    del mesh
    B, S = shape.global_batch, shape.seq_len
    if reduced:
        B, S = min(B, 4), min(S, 128)
    i32 = torch.int32
    if shape.kind == "decode":
        return {"token": _meta((B, 1), i32), "pos": _meta((), i32)}
    out = {}
    s_text = S
    if cfg.modality == "vision_embed" and cfg.n_media_tokens:
        nm = cfg.n_media_tokens if not reduced else 8
        s_text = S - nm
        out["media"] = _meta((B, nm, VISION_EMBED_DIM), torch.float32)
    if cfg.modality == "audio_embed":
        M = cfg.enc_memory_len if not reduced else 32
        out["src_embed"] = _meta((B, M, AUDIO_EMBED_DIM), torch.float32)
    out["tokens"] = _meta((B, s_text), i32)
    if shape.kind == "train":
        out["labels"] = _meta((B, s_text), i32)
    return out


def serve_variant(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """The config a decode at ``shape`` runs: on ``long_500k`` a pure
    full-attention arch with a configured SWA variant serves it with
    every ``attn`` block a window of ``swa_variant_window``."""
    if shape.name == "long_500k" and not cfg.long_context_ok \
            and cfg.swa_variant_window:
        return cfg.replace(window=cfg.swa_variant_window,
                           block_pattern=tuple(
                               "swa" if b == "attn" else b
                               for b in cfg.block_pattern))
    return cfg


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                reduced: bool = False):
    """-> (caches, eff_cfg): the decode caches at full capacity as ``meta``
    tensors, stacked as prefill's, and the config that decodes them
    (``serve_variant``)."""
    from repro_torch.models.transformer import lm_cache_init
    del mesh
    B = shape.global_batch if not reduced else min(shape.global_batch, 4)
    C = shape.seq_len if not reduced else min(shape.seq_len, 128)
    eff_cfg = serve_variant(cfg, shape)
    stub = {"embed": {"table": _meta((0,), torch.float32)}}
    return lm_cache_init(stub, eff_cfg, B, C), eff_cfg


def cache_leaf_spec(leaf, mesh, B: int) -> tuple:
    """How a cache leaf splits over the data axes (``repro``'s rule): the
    batch axis (the first axis equal to B, after an optional reps axis)
    when the data axes divide B; else a cache length over 1024 that they
    divide."""
    nd = leaf.dim()
    s = [None] * nd
    if mesh is None:
        return tuple(s)
    dp, n_dp = _dp_entry(mesh), _n_data(mesh)
    shard_batch = B % n_dp == 0 and B >= n_dp
    shp = tuple(leaf.shape)
    bax = 0 if shp and shp[0] == B else (1 if nd > 1 and shp[1] == B
                                         else None)
    if bax is not None and shard_batch:
        s[bax] = dp
    elif bax is not None and bax + 1 < nd and shp[bax + 1] >= n_dp and \
            shp[bax + 1] % max(n_dp, 1) == 0 and shp[bax + 1] > 1024:
        s[bax + 1] = dp
    return tuple(s)


def materialize(tree, device, seed: int = 0, *, vocab: int = 0,
                positions: int = 0):
    """Real tensors of a tree of ``meta`` (or any) tensors, on ``device``,
    from ``seed``: integer leaves uniform in ``[0, vocab)`` (a 0-dim
    integer leaf is ``positions``, the decode position), floating leaves
    standard normal x 0.02, bool leaves True. Drawn with a generator on
    ``device``, so nothing is copied from the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(one(v) for v in t)
        shape, dt = tuple(t.shape), t.dtype
        if dt == torch.bool:
            return torch.ones(shape, dtype=dt, device=dev)
        if not dt.is_floating_point:
            if not shape:
                return torch.tensor(positions, dtype=dt, device=dev)
            return torch.randint(0, max(vocab, 1), shape, generator=g,
                                 device=dev).to(dt)
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(dt)

    return one(tree)
