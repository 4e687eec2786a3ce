"""The memory model of multi-task parallelism (the counterpart of the memory
half of ``repro.launch.hlo_stats``; nothing here reads HLO, hence the name).

The paper's §4.3 residency: every group of a hierarchical placement holds
the trunk, and a head's params live only in its group, so a device of
group g holds ``P_s + Σ_{t∈g} P_h(t)`` parameters (one head a group gives
``P_s + P_h``), and AdamW's two moments triple it. A flat plan is the
same model with its groups read off the mesh (``plan_placement``).

``repro`` estimates a device's bytes from a sharded template's
``PartitionSpec`` s; a rank of the port holds only its own tree, so
``param_bytes_per_device`` sums the tree it is given.
"""
from __future__ import annotations

from repro_torch.core.taskpar import HeadPlacement


def param_bytes_per_device(tree) -> int:
    """Bytes of a rank's own parameter tree (nested dicts of tensors,
    ``meta`` tensors or numpy arrays): each leaf's elements times its
    item size."""
    if isinstance(tree, dict):
        return sum(param_bytes_per_device(v) for v in tree.values())
    n = 1
    for d in tree.shape:
        n *= int(d)
    size = getattr(tree, "itemsize", None)       # numpy
    if size is None:
        size = tree.element_size()               # torch
    return n * int(size)


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
