"""The memory model of multi-task parallelism (the counterpart of the memory
half of ``repro.launch.hlo_stats``; nothing here reads HLO, hence the name).

The paper's §4.3 residency: every group of a hierarchical placement holds
the trunk, and a head's params live only in its group, so a device of
group g holds ``P_s + Σ_{t∈g} P_h(t)`` parameters (one head a group gives
``P_s + P_h``), and AdamW's two moments triple it. A flat plan is the
same model with its groups read off the mesh (``plan_placement``).

``param_bytes_per_device`` sums the tree it is given — a rank's own tree
— or, given the specs of a full tree and a mesh, counts what one rank of
that mesh holds of it (``repro``'s estimate from a sharded template's
``PartitionSpec`` s); the two agree on a rank's real blocks.
"""
from __future__ import annotations

from repro_torch.configs.sharding import shard_count
from repro_torch.core.taskpar import HeadPlacement


def _leaf_bytes(leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    size = getattr(leaf, "itemsize", None)       # numpy
    if size is None:
        size = leaf.element_size()               # torch
    return n * int(size)


def param_bytes_per_device(tree, specs: dict | None = None, mesh=None,
                           _prefix: str = "") -> int:
    """Bytes of a tree (nested dicts, tuples or lists of tensors, ``meta``
    tensors or numpy arrays: params, moments, caches, a batch): each
    leaf's elements times its item size.
    With ``specs`` (``{path: spec}``, ``configs.sharding``'s tuples) and
    ``mesh``, ``tree`` is the full tree and a leaf with a spec counts its
    bytes over the product of the sizes of the mesh axes the spec names,
    rounded up — one rank's share."""
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return sum(param_bytes_per_device(
            v, specs, mesh, f"{_prefix}/{k}" if _prefix else str(k))
            for k, v in items)
    size = _leaf_bytes(tree)
    if specs and _prefix in specs:
        size = -(-size // shard_count(specs[_prefix], mesh))
    return size


def hier_group_memory(placement, shared_bytes: int, head_bytes,
                      *, opt_factor: float = 3.0) -> list[dict]:
    """Modeled per-device memory of each group in a hierarchical
    placement: the trunk is replicated into every group while a head's
    params live ONLY in its group — the paper's §4.3 ``P_s + Σ_{t∈g} P_h``
    residency (one head per group reproduces ``P_s + P_h`` exactly).

    head_bytes: one int (uniform heads) or a per-head byte sequence.
    opt_factor: bytes per resident param byte across train state (3.0 =
    params + AdamW m/v moments of the params' dtype). Returns one dict per
    group with the modeled ``param_bytes`` / ``hbm_bytes`` and the group's
    shape (``repro``'s dicts, key for key)."""
    n_heads = placement.n_heads
    hb = [int(head_bytes)] * n_heads if isinstance(head_bytes, (int, float)) \
        else [int(b) for b in head_bytes]
    if len(hb) != n_heads:
        raise ValueError(f"{len(hb)} head_bytes for {n_heads} heads")
    out = []
    for g, (heads, n_dev) in enumerate(zip(placement.groups,
                                           placement.device_counts)):
        pb = int(shared_bytes) + sum(hb[t] for t in heads)
        out.append({"group": g, "heads": list(heads), "devices": int(n_dev),
                    "param_bytes": pb,
                    "hbm_bytes": int(round(opt_factor * pb))})
    return out


def plan_placement(plan) -> HeadPlacement:
    """The ``HeadPlacement`` a ``ShardingPlan`` holds its heads by: a
    hierarchical plan's own; a flat plan's head groups as its ranks hold
    them (``"par"``: one group a ``model`` column, ``"base"``: every head
    in one group), each with the ranks that hold it; one device's whole
    model on one device."""
    if plan.placement is not None:
        return plan.placement
    if not plan.distributed:
        return HeadPlacement(groups=(tuple(range(plan.n_tasks)),),
                             device_counts=(1,))
    groups: dict[tuple, int] = {}
    for heads in plan.all_heads():
        groups[tuple(heads)] = groups.get(tuple(heads), 0) + 1
    return HeadPlacement(groups=tuple(groups),
                         device_counts=tuple(groups.values()))
