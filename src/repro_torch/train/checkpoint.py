"""The numpy side of ``repro``'s checkpoint layout.

One ``.npz`` whose keys are the ``"/"``-joined tree paths (lists/tuples as
``__i``), plus optional ``.meta.json`` and ``.datapipe.json`` sidecars —
the files ``repro.train.checkpoint.save`` writes. A checkpoint saved by
``repro`` loads here, and one saved here loads there, sidecars included.
Leaves come back as numpy arrays; ``repro_torch.interop.to_torch`` puts
them on a device.

bf16 leaves are stored as ``repro`` stores them, the raw 16-bit patterns
(``|V2`` in the archive), and restore bit for bit into a bf16 template
leaf: as ``ml_dtypes.bfloat16`` where that is installed, else as the
``uint16`` patterns (``interop.bf16_to_numpy``'s contract).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import interop


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar(path: str, suffix: str) -> str:
    """The sidecar next to the .npz (only a trailing ``.npz`` is
    stripped)."""
    base = path[:-len(".npz")] if path.endswith(".npz") else path
    return base + suffix


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
        arr = interop.to_numpy(leaf)
        if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            return arr.view("V2")          # no ml_dtypes: repro's layout
        return arr
    return np.asarray(leaf)


def _is_bf16(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.bfloat16
    return interop.is_bf16(_np_dtype(leaf))


def _np_dtype(leaf):
    """The numpy dtype of a non-bf16 template leaf."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    dtype = getattr(leaf, "dtype", None)
    return np.dtype(dtype) if dtype is not None else np.asarray(leaf).dtype


def _restore_leaf(arr: np.ndarray, template) -> np.ndarray:
    """The stored array in the template leaf's dtype; bf16 by its bits."""
    if not _is_bf16(template):
        return np.asarray(arr, dtype=_np_dtype(template))
    if not (interop.is_bf16(arr.dtype) or arr.dtype == np.uint16):
        raise ValueError(f"a bf16 template leaf needs bf16 bits in the "
                         f"checkpoint, found {arr.dtype}")
    return interop.bf16_to_numpy(interop.bf16_from_numpy(arr))


def _write_json_atomic(path: str, obj, **dump_kw):
    """Same-directory temp file + ``os.replace``: an interrupted writer
    leaves the previous sidecar (or none), never a truncated one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, **dump_kw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree, metadata: dict | None = None,
         datapipe: dict | None = None):
    """Write ``tree`` (nested dicts/lists of tensors or arrays) as one .npz,
    atomically (same-directory temp file + ``os.replace``).
    datapipe: a batcher/prefetcher ``state()`` dict, written to the
    ``.datapipe.json`` sidecar stamped with ``metadata["step"]`` (the npz
    and the sidecar are two files; the stamp lets a resume detect a crash
    between the two writes)."""
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
        _write_json_atomic(_sidecar(path, ".meta.json"), metadata, indent=2)
    if datapipe is not None:
        _write_json_atomic(_sidecar(path, ".datapipe.json"),
                           {"step": (metadata or {}).get("step"),
                            "state": datapipe})


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
            arr = _restore_leaf(data[k], t)
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
    with open(_sidecar(path, ".meta.json")) as f:
        return json.load(f)


def _datapipe_payload(path: str):
    with open(_sidecar(path, ".datapipe.json")) as f:
        payload = json.load(f)
    stamped = isinstance(payload, dict) and set(payload) == {"step", "state"}
    return payload, stamped


def load_datapipe(path: str) -> dict:
    """The input-pipeline state from the ``.datapipe.json`` sidecar (a
    stamped ``{"step", "state"}`` envelope or a raw state dict)."""
    payload, stamped = _datapipe_payload(path)
    return payload["state"] if stamped else payload


def load_datapipe_step(path: str):
    """The ``metadata["step"]`` stamp the sidecar was written with (None if
    unstamped)."""
    payload, stamped = _datapipe_payload(path)
    return payload["step"] if stamped else None


def has_datapipe(path: str) -> bool:
    return os.path.exists(_sidecar(path, ".datapipe.json"))
