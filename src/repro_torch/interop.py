"""Move a ``repro`` parameter tree into the port and back, through numpy.

The tree is the MultiTaskModel layout ``{"shared": egnn params, "heads":
stacked branch params}`` (``repro.core.mtl.make_gfm_mtl``). The port keeps
``repro``'s layout leaf for leaf — ``(d_in, d_out)`` dense weights, heads
stacked ``(T, ...)`` — so conversion is a copy, never a transpose or a
reshape. ``log_sigma2`` (uncertainty weighting) is carried along and
ignored by serving.

Any leaf ``np.asarray`` accepts (a numpy array, a JAX array) goes in; this
module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (dtype kept; each leaf is a copy)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    arr = np.array(tree, copy=True)
    return torch.from_numpy(arr).to(device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
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
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)
