"""The numpy side of ``repro``'s checkpoint layout.

One ``.npz`` whose keys are the ``"/"``-joined tree paths (lists/tuples as
``__i``), plus an optional ``.meta.json`` sidecar — the files
``repro.train.checkpoint.save`` writes. A checkpoint saved by ``repro``
loads here, and one saved here loads there. Leaves come back as numpy
arrays; ``repro_torch.interop.to_torch`` puts them on a device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-len(".npz")] if path.endswith(".npz") else path
    return base + ".meta.json"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save(path: str, tree, metadata: dict | None = None):
    """Write ``tree`` (nested dicts/lists of tensors or arrays) as one .npz,
    atomically (same-directory temp file + ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {k: _as_numpy(v) for k, v in _flatten(tree).items()}
    npz = _npz_path(path)
    tmp = npz + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, npz)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if metadata is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(metadata, f, indent=2)


def restore(path: str, template):
    """Load the leaves named by ``template`` (a tree whose leaves have a
    ``shape`` and a dtype: tensors, meta tensors or arrays). Returns the
    template's structure with numpy arrays in its dtypes; raises on a
    missing key or a shape mismatch."""
    with np.load(_npz_path(path)) as data:
        flat = {}
        for k, t in _flatten(template).items():
            if k not in data.files:
                raise KeyError(f"checkpoint {path} has no leaf '{k}'")
            arr = np.asarray(data[k], dtype=_np_dtype(t))
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape {arr.shape} vs "
                                 f"template {tuple(t.shape)}")
            flat[k] = arr
    return _unflatten_like(template, flat, "")


def _unflatten_like(tree, flat, prefix):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [_unflatten_like(v, flat, f"{prefix}__{i}/")
                for i, v in enumerate(tree)]
        return type(tree)(vals)
    if tree is None:
        return None
    return flat[prefix[:-1]]


def load_metadata(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)
