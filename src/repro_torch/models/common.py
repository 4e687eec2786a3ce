"""Common building blocks: initializers, norms, RoPE, dense, embedding,
activations, and the tensor-parallel context (``TensorParallel``).

Parameters are plain nested dicts of tensors with ``repro``'s layout —
dense weights are ``(d_in, d_out)`` and ``dense`` computes ``x @ w`` — so a
tree converted from JAX is a copy, never a transpose (``repro_torch.interop``).

Initializers draw from an explicit ``np.random.Generator`` (the port's seed
discipline; JAX's key stream is not reproduced — parity tests convert JAX
parameters instead), or from a seeded ``torch.Generator``, which draws where
it lives: a CUDA generator fills full-width random weights on the card with
no host copy. ``device="meta"`` builds a shape-only tree without drawing,
which is what checkpoint templates use.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Params = dict  # nested {str: Params | torch.Tensor}


def _leaf(arr_fn, shape, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.as_tensor(arr_fn(), dtype=dtype, device=device)


def normal_init(rng, shape, dtype=torch.float32, stddev=0.02,
                device="cpu") -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        x = torch.randn(shape, generator=rng, device=rng.device)
        return x.mul_(stddev).to(device=device, dtype=dtype)
    return _leaf(lambda: (stddev * rng.standard_normal(shape))
                 .astype(np.float32), shape, dtype, device)


def zeros_init(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _leaf(lambda: np.zeros(shape, np.float32), shape, dtype, device)


def ones_init(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _leaf(lambda: np.ones(shape, np.float32), shape, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6,
            upcast: bool = True) -> torch.Tensor:
    dt = x.dtype
    if upcast:
        x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].to(y.dtype)).to(dt)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, f32 angles)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * inv            # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense layers as param dicts
# ---------------------------------------------------------------------------

def dense_init(rng, d_in: int, d_out: int, dtype=torch.float32,
               bias: bool = False, stddev: float | None = None,
               device="cpu") -> Params:
    std = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(rng, (d_in, d_out), dtype, std, device)}
    if bias:
        p["b"] = zeros_init((d_out,), dtype, device)
    return p


def dense(params: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = params["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding_init(rng, vocab: int, d: int, dtype=torch.float32,
                   device="cpu") -> Params:
    return {"table": normal_init(rng, (vocab, d), dtype, 0.02, device)}


class _Embed(torch.autograd.Function):
    """``table[ids]`` whose backward sums the rows of g into the table by
    id with kernel #1 (``kernels.segment_sum``: f32 sums in token order,
    no atomics; its plain one-hot product on the CPU), the same order on
    every run; with ``plain`` it takes the one-hot product on any device.
    Indexing's own backward accumulates with ``index_put_``, which on CUDA
    adds with float atomics in no fixed order — training would not replay
    bitwise. With ``masked`` an id at or past the table's rows (a token
    of another rank's vocab block) looks up a zero row and adds nothing
    in the backward (#1's ``>= n`` sentinel)."""

    @staticmethod
    def forward(ctx, table, ids, plain, masked=False):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.plain = table.shape[0], plain
        if not masked:
            return table[ids]
        out = table[ids.clamp(max=table.shape[0] - 1)]
        return out.masked_fill((ids >= table.shape[0])[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        from ..kernels.segment_sum import segment_sum, segment_sum_ref
        (ids,) = ctx.saved_tensors
        fn = segment_sum_ref if ctx.plain else segment_sum
        return fn(g.reshape(-1, g.shape[-1]), ids.reshape(-1),
                  ctx.vocab), None, None, None


def embed(params: Params, ids: torch.Tensor, compute_dtype=None, *,
          plain: bool = False, tp: "TensorParallel | None" = None):
    """``table[ids]`` in ``compute_dtype``; ``plain`` keeps kernel #1 out
    of its backward (the parity oracle's path). With a vocab-parallel
    ``tp`` (``tp.vocab``) the table is the rank's rows ``[index * V_l,
    (index + 1) * V_l)`` (FSDP-cut dims gathered by the caller,
    ``transformer.outer_units``): the ids in its block are looked up, zero
    rows elsewhere, summed over ``model``; its backward is #1 over the
    block, the other ids masked."""
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    if tp is None or not tp.vocab:
        return _Embed.apply(t, ids.long(), plain)
    rows = t.shape[0]
    local = ids.long() - tp.index * rows
    local = local.masked_fill((local < 0) | (local >= rows), rows)
    return tp.reduce(_Embed.apply(t, local, plain, True))


def unembed(params: Params, x: torch.Tensor,
            tp: "TensorParallel | None" = None) -> torch.Tensor:
    """Tied unembedding ``x @ table.T``: the table cast to x's dtype, the
    products summed in f32 (both operands widened exactly to f32, so the
    result is the f32-accumulated product of the x-dtype values). With a
    vocab-parallel ``tp`` the table is the rank's rows, the logits its
    vocab block (..., V / model) and ``x``'s gradient is summed over
    ``model``."""
    if tp is not None and tp.vocab:
        x = tp.copy(x)
    t = params["table"].to(x.dtype)
    return x.float() @ t.float().T


# ---------------------------------------------------------------------------
# Tensor parallelism over the mesh's ``model`` axis (Megatron's f and g)
# ---------------------------------------------------------------------------

def _sum_over(x, group):
    """``x`` summed over ``group``'s ranks in f32 (a bf16 partial sum is
    widened first and the sum rounded once, as ``repro``'s compiled
    program sums its partial products), in ``x``'s dtype."""
    from repro_torch.launch.mesh import all_reduce
    return all_reduce(x.float().contiguous().clone(), group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the
    ``model`` ranks backward (the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial sums of a row-parallel product summed
    over the ``model`` ranks forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel(NamedTuple):
    """A rank's share of the forward of a ``spec_fn`` plan that computes
    tensor-parallel (``engine.plan.ShardingPlan.tensor_parallel``): the
    ``model`` axis's group, its size and this rank's index on it; which
    products are cut over it (the q heads — ``wq``'s columns and ``wo``'s
    rows —, the kv heads, SwiGLU's ``d_ff``, the padded vocab; a MoE's
    experts — ``experts``, this rank's range [e0, e1) of them — or each
    expert's ``d_ff_expert`` columns (``expert_ffn``), its shared experts'
    ``d_ff`` (``shared``); MLA's heads after the latent, ``wq_b``'s
    columns by whole heads (``mla``)); and ``gather(tree, path)``, which
    gives a unit of the rank's params with its FSDP-cut dims whole (None:
    nothing is cut over ``data``). A product that is not cut runs whole on
    every rank, as ``repro``'s GSPMD repeats it."""
    group: Any
    size: int
    index: int
    heads: bool
    kv: bool
    ffn: bool
    vocab: bool
    gather: Callable | None = None
    experts: tuple | None = None
    expert_ffn: bool = False
    shared: bool = False
    mla: bool = False

    def unit(self, tree, path: str):
        """``tree`` (the params at ``path``, a rep of a stacked unit
        included) with its FSDP-cut leaves gathered."""
        return tree if self.gather is None else self.gather(tree, path)

    def copy(self, x):
        """Megatron's f (identity forward, SUM over ``model`` backward)."""
        return x if self.size == 1 else _CopyToModel.apply(x, self.group)

    def reduce(self, x):
        """Megatron's g (SUM over ``model`` forward, identity backward)."""
        return x if self.size == 1 else _ReduceFromModel.apply(x, self.group)

    def gather_vocab(self, x):
        """Vocab-parallel logits (..., V_l) -> the whole vocab (..., V)
        on every rank (one all-gather; no gradient)."""
        from repro_torch.launch.mesh import all_gather_flat
        if not self.vocab or self.size == 1:
            return x
        parts = all_gather_flat(x.detach().contiguous().reshape(-1),
                                self.group, self.size)
        parts = parts.reshape((self.size,) + tuple(x.shape))
        return parts.movedim(0, -2).reshape(x.shape[:-1] + (-1,))


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACT: dict[str, Callable] = {"gelu": gelu, "silu": F.silu, "relu": F.relu,
                            "tanh": torch.tanh}
