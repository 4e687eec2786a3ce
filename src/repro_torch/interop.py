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
    return torch.from_numpy(arr).to(device)


def to_numpy(tree):
    """Nested dicts/tuples of tensors -> the same of numpy arrays on the
    host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


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
