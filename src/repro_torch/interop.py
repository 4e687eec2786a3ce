"""Move a ``repro`` parameter tree into the port and back, through numpy.

Trees are the MultiTaskModel layout ``{"shared": egnn params, "heads":
stacked branch params}`` (``repro.core.mtl.make_gfm_mtl``) and the LM tree
of ``repro.models.transformer.lm_init`` (``embed``, the ``(reps, ...)``
stacked ``scan`` units, ``rem``, ``ln_f``, ``task_heads``). The port keeps
``repro``'s layout leaf for leaf — ``(d_in, d_out)`` dense weights, heads
stacked ``(T, ...)``, layers stacked ``(reps, ...)`` — so conversion is a
copy, never a transpose or a reshape. ``log_sigma2`` (uncertainty
weighting) is carried along and ignored by serving. LM caches are trees
too: tuples of per-unit dicts whose ``pos`` leaves may be 0-d, which every
function here takes.

Any leaf ``np.asarray`` accepts (a numpy array, a JAX array) goes in; this
module imports neither ``jax`` nor ``repro``.

bf16 crosses as its 16-bit pattern, bit for bit. numpy has no bf16 of its
own: JAX hands out ``ml_dtypes.bfloat16`` arrays, and an ``.npz`` written
from one holds raw 2-byte voids (``|V2``). ``to_torch`` takes either and
gives a ``torch.bfloat16`` tensor. ``to_numpy`` gives an
``ml_dtypes.bfloat16`` array where ``ml_dtypes`` is installed (it comes
with jax); where it is not, it gives the same bits as a ``uint16`` array,
which ``bf16_from_numpy`` turns back into a bf16 tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dicts/tuples of array-likes -> the same of tensors on
    ``device`` (dtype kept; each leaf is a copy, 0-d leaves included)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    arr = np.array(tree, copy=True)
    if is_bf16(arr.dtype):
        return bf16_from_numpy(arr).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(tree):
    """Nested dicts/tuples of tensors -> the same of numpy arrays on the
    host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return bf16_to_numpy(tree)
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def is_bf16(dtype: np.dtype) -> bool:
    """A numpy dtype that holds bf16: ``ml_dtypes.bfloat16``, or the raw
    2-byte void (``|V2``) an ``.npz`` stores it as."""
    return dtype.name == "bfloat16" or (dtype.kind == "V" and
                                        dtype.itemsize == 2 and
                                        dtype.fields is None)


def bf16_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A bf16 (or ``|V2``, or ``uint16`` bit-pattern) array -> a CPU
    ``torch.bfloat16`` tensor with the same bits."""
    bits = np.asarray(arr, order="C").view(np.uint16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def bf16_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A ``torch.bfloat16`` tensor -> an ``ml_dtypes.bfloat16`` array with
    the same bits, or, without ``ml_dtypes``, those bits as ``uint16``."""
    bits = t.detach().cpu().contiguous().view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return bits.view(np.uint16)
    return bits.view(ml_dtypes.bfloat16)


def leaves(tree, prefix=""):
    """``{"/"-joined path: leaf}`` of a nested dict (the checkpoint keys)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(template, flat: dict, prefix=""):
    """Inverse of ``leaves``: the template's dict structure with each leaf
    taken from ``flat`` by its path."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    return flat[prefix[:-1]]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts/tuples of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)
