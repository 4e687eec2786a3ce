"""One rank's step, counted at the dispatcher (the counterpart of
``repro.launch.hlo_analysis.analyze_hlo`` and ``repro.launch.hlo_stats``'s
``collective_stats`` / ``op_histogram``).

``repro`` reads its per-device numbers off the compiled SPMD program's
HLO text. Eager PyTorch has no such program: the rank's program is the
sequence of ATen ops its step dispatches, which ``count`` records under a
``TorchDispatchMode`` (and ``FakeTensorMode`` when the tensors are fake:
shapes only, nothing allocated, nothing computed):

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total — 2 x
    M x N x K for every matrix product, convolution and attention op, as
    ``analyze_hlo`` counts ``dot``s. A hand kernel is a bound library, not
    an ATen op: its arithmetic is not seen (a traced run takes the plain
    versions, which are ATen ops);
  * ``traffic_bytes``: each op's input and output bytes summed — eager
    mode materialises every op's output, so this is what the ops move, the
    counterpart of ``analyze_hlo``'s per-instruction operand + output
    bytes (views move nothing and are not counted);
  * ``collectives``: ``{kind: {"count", "bytes"}}`` of the ``c10d`` ops the
    step issues (``all-reduce``, ``broadcast``, ``all-gather``, ...; the
    bytes of the tensors each moves), and ``collective_bytes``, their sum.
    A tensor-parallel step's sums over ``model`` are all-reduces: a
    row-parallel product's partial sums (Megatron's g: one a MoE layer,
    its routed and shared experts' partials together, one after MLA's or
    GQA's ``wo``) and, backward, the gradients of a replicated input of
    local products (Megatron's f);
  * ``top_ops``: the most frequent ops, ``[(name, count)]``;
  * ``peak_bytes``: ``torch.distributed._tools.mem_tracker.MemTracker``'s
    peak over the tensors the step allocates and those passed as
    ``track`` (the rank's state and batch).

``extrapolate`` combines counts of the same program at two or three
repetition counts of a body that repeats identically — a block unit of
the layer stack, an accumulation microbatch, a chunk of a recurrent
scan — into the count at the full number, as ``analyze_hlo`` multiplies
a while body by its trip count. ``add``
puts counts made apart (``count`` called inside a ``count``, with the
outer one's modes set aside) into the innermost running ``count``.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# c10d op name -> repro's collective kind
KINDS = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "broadcast_": "broadcast", "send": "send", "recv_": "recv",
         "barrier": "barrier", "reduce_": "reduce", "gather_": "gather",
         "scatter_": "scatter"}
_VIEWS = ("view", "_unsafe_view", "reshape", "expand", "permute",
          "transpose", "t", "unsqueeze", "squeeze", "slice", "select",
          "as_strided", "alias", "detach", "unbind", "split",
          "split_with_sizes", "chunk", "unflatten", "view_as", "lift_fresh",
          "_to_copy_view")


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.traffic = 0
        self.ops: Counter = Counter()
        self.coll: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "c10d" or ns == "_c10d_functional":
            kind = KINDS.get(name, name)
            ins, _ = tree_flatten((args, kwargs))
            rec = self.coll.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(_bytes(t) for t in ins)
            return out
        if ns == "prim":              # prim.device and the like: no work
            return out
        self.ops[f"{ns}.{name}"] += 1
        if name not in _VIEWS:
            ins, _ = tree_flatten((args, kwargs))
            outs, _ = tree_flatten(out)
            self.traffic += sum(_bytes(t) for t in ins) + \
                sum(_bytes(t) for t in outs)
        return out


_ACTIVE: list = []                 # the extras of the running ``count``s


def add(c: dict):
    """Add counts made apart (a ``count`` result: flops, traffic, ops,
    collectives) to the innermost running ``count``."""
    if not _ACTIVE:
        return
    ex = _ACTIVE[-1]
    ex["flops"] += c["flops"]
    ex["traffic"] += c["traffic_bytes"]
    ex["ops"].update(c["op_counts"])
    for k, v in c["collectives"].items():
        rec = ex["coll"].setdefault(k, {"count": 0, "bytes": 0})
        rec["count"] += v["count"]
        rec["bytes"] += v["bytes"]


def count(fn, *args, track=(), top: int = 12) -> tuple:
    """-> (fn's result, counts): ``fn(*args)`` run under the counters (see
    the module docstring). ``track``: tensors alive before the call (a
    nested tree), counted in the peak."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    held, _ = tree_flatten(track)
    held = [t for t in held if isinstance(t, torch.Tensor)]
    mt = MemTracker()
    if held:
        mt.track_external(*held)
    flops = FlopCounterMode(display=False)
    counter = _Counter()
    extra = {"flops": 0.0, "traffic": 0, "ops": Counter(),
             "coll": counter.coll}
    _ACTIVE.append(extra)
    try:
        with mt, flops, counter:
            out = fn(*args)
    finally:
        _ACTIVE.pop()
    counter.ops.update(extra["ops"])
    peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    coll = {k: dict(v) for k, v in sorted(counter.coll.items())}
    return out, {
        "flops": float(flops.get_total_flops()) + extra["flops"],
        "traffic_bytes": int(counter.traffic + extra["traffic"]),
        "collectives": coll,
        "collective_bytes": int(sum(v["bytes"] for v in coll.values())),
        "op_counts": dict(counter.ops),
        "top_ops": counter.ops.most_common(top),
        "peak_bytes": int(peak)}


def combine(terms) -> dict:
    """The counts ``sum(w x counts)`` over ``terms`` of (counts, weight):
    flops, op bytes, op counts and collectives (counts and bytes rounded to
    integers); ``top_ops`` from the combined op counts; the peak of the
    first term (a peak is not a sum)."""
    first = terms[0][0]
    ops: dict = {}
    coll: dict = {}
    flops = traffic = 0.0
    for c, w in terms:
        flops += w * c["flops"]
        traffic += w * c["traffic_bytes"]
        for o, n in c["op_counts"].items():
            ops[o] = ops.get(o, 0) + w * n
        for kind, v in c["collectives"].items():
            rec = coll.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += w * v["count"]
            rec["bytes"] += w * v["bytes"]
    ops = {o: int(round(n)) for o, n in ops.items()}
    coll = {k: {f: int(round(v[f])) for f in ("count", "bytes")}
            for k, v in sorted(coll.items())}
    return {"flops": flops, "traffic_bytes": int(round(traffic)),
            "collectives": coll,
            "collective_bytes": sum(v["bytes"] for v in coll.values()),
            "op_counts": ops,
            "top_ops": sorted(ops.items(), key=lambda kv: -kv[1])[
                :max(len(first.get("top_ops", ())), 12)],
            "peak_bytes": first.get("peak_bytes", 0)}


def extrapolate(points, n, peak: str = "fit") -> dict:
    """Counts at ``n`` repetitions of a body from counts at two or three
    repetition counts, ``points`` = [(n_i, counts_i)]: every number is the
    line (two points) or parabola (three) through the points, evaluated at
    ``n`` (Lagrange). ``peak="last"`` takes the last point's peak instead
    (a body whose activations die with it, as an accumulation
    microbatch's do: the peak stops growing after the second);
    ``peak="line"`` the line through the last two points' peaks (a peak
    is a maximum, not a sum of the body's work: a parabola through three
    small counts overshoots it)."""
    xs = [m for m, _ in points]
    ws = []
    for i, xi in enumerate(xs):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (n - xj) / (xi - xj)
        ws.append(w)
    out = combine([(c, w) for (_, c), w in zip(points, ws)])
    if peak == "line" and len(points) > 2:
        return dict(out, peak_bytes=extrapolate(points[-2:], n)["peak_bytes"])
    out["peak_bytes"] = int(round(sum(w * c["peak_bytes"] for (_, c), w in
                                      zip(points, ws)))) \
        if peak != "last" else points[-1][1]["peak_bytes"]
    return out
