"""Process meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

In training, one process (rank) stands for one device. ``init_distributed``
joins a rank to its job; the mesh builders are functions, so importing
this module touches no process group:

  * ``make_host_mesh(data, model)`` / ``make_gfm_paper_mesh(n_tasks, dp)``:
    a ``DeviceMesh`` with dims ``("data", "model")`` — the flat plans'
    meshes, the task axis as ``model``;
  * ``make_production_mesh(multi_pod=)`` / ``make_alt_mesh(model=)``: the
    production pod, 16 x 16 ``("data", "model")`` or 2 x 16 x 16 ``("pod",
    "data", "model")``, and the pod reshaped to 256 / model x model — they
    need a world of 256 or 512 ranks, which ``fake_world`` gives one process
    (the dry run: one rank's program, collectives that move no data);
  * ``make_group_meshes(placement)``: one ``GroupMesh`` per group of a
    ``HeadPlacement``, ranks dealt contiguously by ``device_counts``, one
    ``dist.new_group`` per group (every rank creates every group, in the
    same order, as ``new_group`` requires);
  * ``make_replica_meshes``: serving meshes, cut from a list of devices
    (not ranks): serving runs in one process, see its docstring;
  * ``run_ranks(fn, world)``: start ``world`` ranks with ``spawn`` and a
    file rendezvous, run ``fn(rank, world, *args)`` in each, and return
    their results — the launcher the tests and ``chip_smoke.py`` use. Its
    ranks run on ``cuda`` unless the caller passes ``device="cpu"``.

Several ranks may share one GPU only over gloo: NCCL refuses two ranks on
one card, and ``init_distributed`` raises for that rather than switch
backends. gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors by
staging them through the host.

The collectives of tensor parallelism and FSDP (``models.common.
TensorParallel``, ``engine.plan.ShardingPlan.gather_unit``) go through
``all_reduce``, ``all_gather_flat`` and ``reduce_scatter_flat`` here. On
a gloo group a CUDA tensor's all-gather and reduce-scatter run on a
pinned host copy (chosen by the group's backend): gloo's own CUDA
staging covers ``all_reduce`` and ``broadcast`` only. Every other backend
(``nccl``, ``fake_world``'s ``"fake"``, gloo on CPU tensors) takes the
tensors as they are, and ``launch.cost.count`` sees each call as one
``all-reduce``, ``all-gather`` or ``reduce-scatter``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Callable, NamedTuple

import torch

TIMEOUT_S = 60             # a collective that one rank skips fails here

# per process, as torch.distributed's default group is: one process is one
# rank, and init_distributed resets both
_state = {"device": None}
_groups: dict = {}         # ranks -> process group, created in one order


def init_distributed(rank: int, world: int, *, backend: str,
                     init_method: str, device=None,
                     timeout: float = TIMEOUT_S) -> torch.device:
    """Join rank ``rank`` of ``world`` to the job at ``init_method`` (e.g.
    ``"file:///path/rdzv"`` or ``"tcp://localhost:<port>"``) over
    ``backend`` (``"gloo"`` or ``"nccl"``). ``device``: ``"cpu"``, or
    ``"cuda"`` for ``cuda:<rank mod cards>`` (None: ``"cuda"``). Returns
    the rank's device. A collective that waits longer than ``timeout``
    seconds fails instead of hanging."""
    import torch.distributed as dist
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device='cuda' but no CUDA device is visible")
        if backend == "nccl" and world > n:
            raise ValueError(
                f"backend 'nccl' with {world} ranks on {n} card(s): NCCL "
                "refuses two ranks on one card — use backend='gloo'")
        dev = torch.device("cuda", rank % n if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs device='cuda'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    _state["device"] = dev
    _groups.clear()
    return dev


def rank_device() -> torch.device:
    """The device ``init_distributed`` gave this rank."""
    if _state["device"] is None:
        raise RuntimeError("init_distributed has not run in this process")
    return _state["device"]


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(rank_device().type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_host_mesh(data: int, model: int):
    """A ``(data, model)`` ``DeviceMesh`` over all ranks (row-major)."""
    return _mesh((data, model), ("data", "model"))


def make_gfm_paper_mesh(n_tasks: int = 5, dp: int | None = None):
    """The paper's process layout: ``dp`` data-parallel ranks x ``n_tasks``
    head sub-groups (paper: 640 GPUs = 128 x 5 on Frontier). ``dp``
    defaults to the world size over ``n_tasks``."""
    import torch.distributed as dist
    if dp is None:
        dp = dist.get_world_size() // n_tasks
    return _mesh((dp, n_tasks), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The production pod: 16 x 16 ``("data", "model")``, or two pods, 2 x
    16 x 16 ``("pod", "data", "model")`` (a world of 256 / 512 ranks)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_alt_mesh(model: int = 8):
    """The same 256-rank pod reshaped so the tensor-parallel degree divides
    awkward head counts (granite's 24 heads on ``model=8``)."""
    return _mesh((256 // model, model), ("data", "model"))


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0, device=None):
    """Run the enclosed code as rank ``rank`` of a job of ``world`` ranks in
    this one process: the ``"fake"`` process-group backend, whose
    collectives complete without moving data (every rank's result is the
    rank's own input). The meshes above build over it, and every
    collective a step makes is issued as the real job would issue it.
    ``device``: the rank's device (None: ``cuda``, raising without a GPU).
    The world is torn down on exit; a process that is already in a job
    raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import resolve_device
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process is already in a job")
    dev = resolve_device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    prev = _state["device"]
    _state["device"] = dev
    _groups.clear()
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        _state["device"] = prev
        _groups.clear()


class GroupMesh(NamedTuple):
    """One group's 1-axis ``("data",)`` mesh: its ranks and its process
    group (``None`` on ranks outside it)."""
    ranks: tuple
    group: object


def process_group(ranks) -> object:
    """The process group over ``ranks``, created once per process: every
    rank must ask for the same groups in the same order."""
    import torch.distributed as dist
    ranks = tuple(int(r) for r in ranks)
    if ranks not in _groups:
        if len(ranks) == dist.get_world_size():
            _groups[ranks] = dist.group.WORLD
        else:
            _groups[ranks] = dist.new_group(list(ranks))
    g = _groups[ranks]
    return g if dist.get_rank() in ranks else None


def _via_host(group, x) -> bool:
    """Whether ``x``'s gather or scatter over ``group`` is staged through
    pinned host memory: a CUDA tensor on a gloo group."""
    import torch.distributed as dist
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(x) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x)


def all_reduce(x, group=None, op: str = "sum"):
    """``x`` reduced in place over ``group`` (None: the world) with
    ``op`` (``"sum"``, ``"max"`` or ``"min"``); every rank receives the
    same bits. Returns ``x``."""
    import torch.distributed as dist
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op], group=group)
    return x


def all_gather_flat(x, group, size: int) -> torch.Tensor:
    """This rank's flat ``(n,)`` buffer -> ``(size, n)``, row ``i`` the
    buffer of the group's rank ``i`` (one all-gather)."""
    import torch.distributed as dist
    if size == 1:
        return x[None]
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    n = x.numel()
    if _via_host(group, x):
        out = torch.empty(size * n, dtype=x.dtype, pin_memory=True)
        gather(out, _pinned(x.reshape(-1)), group=group)
        return out.to(x.device).view(size, n)
    out = x.new_empty(size * n)
    gather(out, x.contiguous().reshape(-1), group=group)
    return out.view(size, n)


def reduce_scatter_flat(x, group, size: int) -> torch.Tensor:
    """``(size, n)`` -> ``(n,)``: row ``i`` summed over the group's ranks
    lands on its rank ``i`` (one reduce-scatter)."""
    import torch.distributed as dist
    if size == 1:
        return x[0]
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    n = x.shape[1]
    if _via_host(group, x):
        out = torch.empty(n, dtype=x.dtype, pin_memory=True)
        scatter(out, _pinned(x.reshape(-1)), group=group)
        return out.to(x.device)
    out = x.new_empty(n)
    scatter(out, x.contiguous().reshape(-1), group=group)
    return out


def make_group_meshes(placement) -> list:
    """Per-group meshes of a hierarchical plan: the ranks are dealt
    contiguously by ``placement.device_counts``; within a group the batch
    is data-parallel and the group's head slice is replicated, so the
    group IS its heads' model shard (the paper's head sub-group). Raises
    when the job has fewer ranks than the placement needs."""
    import torch.distributed as dist
    from repro_torch.core.taskpar import group_ranks
    world = dist.get_world_size()
    if placement.n_devices > world:
        raise ValueError(f"placement needs {placement.n_devices} devices, "
                         f"the job has {world} ranks — solve the placement "
                         "against the real world size")
    return [GroupMesh(ranks=r, group=process_group(r))
            for r in group_ranks(placement)]


class ServeMesh(NamedTuple):
    """One serving replica's 1-axis ``("data",)`` mesh: the devices a
    batch's rows are split over, in order (``ServeSession(mesh=)``)."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}


def make_replica_meshes(n_replicas: int, *, devices_per_replica: int = 1,
                        devices=None) -> list:
    """Serving scale-out meshes: cut a device list, contiguously, into
    ``n_replicas`` one-axis ``ServeMesh``es of ``devices_per_replica``
    entries each (``repro.launch.mesh.make_replica_meshes``).

    ``devices``: the list to cut (``torch.device``s or strings). None takes
    every visible CUDA card and raises without one — a CPU run passes
    ``devices=["cpu"] * n``. Too few devices raise. The list may name one
    device more than once, which ``repro`` has no counterpart for: each
    entry gets a CUDA stream of its own (``ServeSession``), so one H100
    stands in for a mesh of several.

    Serving needs no process group. A replica never exchanges a tensor
    with another (it holds every head), a sharded batch's rows are
    independent, and the router is a host-side object, so one process
    drives every device, each entry through its own stream: no
    cross-process futures, and no rank start-up (interpreters, CUDA
    contexts, a rendezvous) before the first request."""
    if n_replicas < 1 or devices_per_replica < 1:
        raise ValueError("need >= 1 replica of >= 1 device")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to "
                "serve on the CPU (device='cpu' in the other entry points)")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    need = n_replicas * devices_per_replica
    if len(devs) < need:
        raise ValueError(f"{n_replicas} replicas of {devices_per_replica} "
                         f"need {need} devices, {len(devs)} given")
    k = devices_per_replica
    return [ServeMesh(tuple(devs[r * k:(r + 1) * k]))
            for r in range(n_replicas)]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, world, job, init_method, backend, device, threads,
               results):
    try:
        import pickle
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        init_distributed(rank, world, backend=backend,
                         init_method=init_method, device=device)
        out = fn(rank, world, *args)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                     # report, then exit nonzero
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, backend: str = "gloo",
              device=None, args: tuple = (), timeout: float = 300.0,
              rdzv_dir: str | None = None, threads: int | None = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks joined by
    ``init_distributed`` through a file rendezvous under ``rdzv_dir`` (a
    new temporary directory by default). ``fn`` and ``args`` must pickle
    (a module-level function). Returns the ranks' results in rank order.
    Raises when a rank fails (with its traceback) or the job outlasts
    ``timeout`` seconds; every rank process is stopped before it returns.
    ``device``: ``"cpu"``, or ``"cuda"`` (None: ``"cuda"``, raising here
    when no GPU is available — the CPU must be asked for). On CUDA the
    kernels are built here first, so ranks only load them. ``threads``:
    torch's intra-op threads per rank (None: torch's default).

    ``fn`` and ``args`` go to the ranks through one file beside the
    rendezvous, which each rank reads once it has started: a spawned
    process's own arguments come through a pipe that ``start()`` fills,
    so arguments larger than the pipe held each start until that rank
    had imported torch to read them, and the ranks started one after
    another."""
    import multiprocessing as mp
    import pickle
    from repro_torch import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    own_dir = rdzv_dir is None
    rdzv_dir = tempfile.mkdtemp(prefix="rdzv-") if own_dir else rdzv_dir
    init = os.path.join(os.path.abspath(rdzv_dir),
                        f"rdzv-{os.getpid()}-{uuid.uuid4().hex}")
    job = init + ".job"
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, job, f"file://{init}", backend,
                               device, threads, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(out)} of "
                                   f"{world} ranks unfinished after "
                                   f"{timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    # a rank that died without reporting (killed, crashed)
                    errors.append(f"rank process exit codes "
                                  f"{[p.exitcode for p in procs]}")
                if errors:
                    break
                continue
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
        if errors:
            raise RuntimeError("run_ranks failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(rdzv_dir, ignore_errors=True)
        else:
            for path in (init, job):
                if os.path.exists(path):
                    os.unlink(path)
