"""Device meshes, ported from ``repro/launch/mesh.py``.

The JAX package is single-controller: one process sees every chip and
``jax.make_mesh`` lays them out.  PyTorch is SPMD: one process a device,
started by ``torchrun`` or ``torch.multiprocessing``, each in the same
default process group.  So a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks,
built by every rank at once, and a function that returns one needs that
group first (`init_distributed`).

`AbstractMesh` is the port's stand-in for ``jax.sharding.AbstractMesh``:
a shape and axis names and no process group, so the spec functions of
`launch.sharding` and `sharding_ctx` run at 256 or 512 chips on a host
with none.  Every function here that reads a mesh takes either kind.
"""
from __future__ import annotations

import os
from collections.abc import Sequence
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices: ``shape[name]`` and
    ``axis_names`` as on ``jax.sharding.AbstractMesh``."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"shape {self.sizes} and axes {self.axis_names} differ in rank")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an `AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of an `AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def production_shape(*, multi_pod: bool = False, tp: int | None = None,
                     rep: int | None = None) -> AbstractMesh:
    """The JAX production mesh's shape and axes: a 16x16 pod (256 chips)
    or two of them (512).  ``tp`` reshapes a pod's 256 chips to
    (256 // tp, tp); ``rep`` adds a pure data-parallel "rep" axis between
    "data" (expert parallelism at width 256 // (tp * rep)) and "model"."""
    tp = 16 if tp is None else int(tp)
    if tp < 1 or 256 % tp:
        raise ValueError(f"bad tp={tp}")
    if rep:
        if 256 % (tp * rep):
            raise ValueError(f"tp * rep = {tp * rep} does not divide 256")
        shape, axes = (256 // (tp * rep), rep, tp), ("data", "rep", "model")
    else:
        shape, axes = (256 // tp, tp), ("data", "model")
    if multi_pod:
        shape, axes = (2, *shape), ("pod", *axes)
    return AbstractMesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, tp: int | None = None,
                         rep: int | None = None, device: str = "cuda"):
    """`production_shape` as a ``DeviceMesh`` over the world's ranks, in
    rank order.  The world's size must equal the mesh's chip count (256
    or 512); use `production_shape` for the shape alone."""
    spec = production_shape(multi_pod=multi_pod, tp=tp, rep=rep)
    return device_mesh(spec.sizes, spec.axis_names, device=device)


def device_mesh(shape, names, *, ranks=None, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (the whole world in rank
    order by default).  Every rank of the world must call it, members or
    not; a rank outside ``ranks`` holds no shard of a tensor on it."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_distributed first")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = 1
    for s in shape:
        n *= int(s)
    if len(ranks) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, got {len(ranks)} "
                         f"(world {world})")
    if len(set(ranks)) != n or not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(device), torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return kind


def init_distributed(device: str = "cuda", *, rank: int | None = None,
                     world_size: int | None = None, init_method: str | None = None,
                     store=None, timeout_s: float = 600.0, backend: str | None = None,
                     card: int | None = None) -> tuple[int, int]:
    """Joins (or finds) the default process group: NCCL on the card, gloo
    on the CPU, or ``backend``.  Rank and world come from the arguments or
    from ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; a
    process on the card takes card ``card``, else ``LOCAL_RANK``.  The
    rendezvous is ``store``, ``init_method``, or ``torchrun``'s
    ``MASTER_ADDR`` / ``MASTER_PORT``; a world of one with none of them
    uses a file store in a fresh temporary directory.  Returns (rank,
    world).  Several processes on one card need ``backend="gloo"`` and
    ``card=0``: NCCL refuses two ranks on one device."""
    kind = _device_type(device)
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) if card is None
                                  else card)
        if store is None and init_method is None and "MASTER_ADDR" not in os.environ:
            if world_size != 1:
                raise RuntimeError(f"a world of {world_size} needs a rendezvous: run under "
                                   "torchrun, or pass store= or init_method=")
            import tempfile
            store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        kw = dict(backend=backend or ("nccl" if kind == "cuda" else "gloo"), rank=rank,
                  world_size=world_size, timeout=timedelta(seconds=timeout_s))
        if store is not None:
            kw["store"] = store
        else:
            kw["init_method"] = init_method or "env://"
        dist.init_process_group(**kw)
    return dist.get_rank(), dist.get_world_size()


def data_axes(mesh) -> tuple[str, ...]:
    """Axes over which the batch is sharded (everything but "model")."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def model_axis(mesh) -> str:
    return "model"


def mesh_device_count(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def mesh_ranks(mesh) -> list[int]:
    """The ranks a ``DeviceMesh`` covers, in its row-major order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def stage_device_slices(mesh_or_devices, stg, sel) -> dict:
    """Partition a mesh's ranks (or any device sequence) into per-stage
    replica slices: each stage of the plan gets tp-sized tuples, one a
    replica, in topological order."""
    from ..runtime.pipeline.placement import place
    devs = _pool(mesh_or_devices)
    pl = place(stg, sel, devs)
    out: dict = {}
    for sl in pl.slices.values():
        out.setdefault(sl.stage, []).append((sl.replica, sl.devices))
    return {k: [d for _, d in sorted(v)] for k, v in out.items()}


def stage_submeshes(mesh_or_devices, stg, sel, *, device: str = "cuda") -> dict:
    """Per-stage, per-replica ("data", "model") sub-meshes of shape (1, tp),
    or None where `submesh_of` gives none.  Every rank builds every
    sub-mesh, in the same order (a ``DeviceMesh`` is made by the whole
    world)."""
    from ..runtime.pipeline.placement import place
    devs = _pool(mesh_or_devices)
    pl = place(stg, sel, devs)
    out: dict = {}
    for sl in pl.slices.values():
        out.setdefault(sl.stage, []).append(
            (sl.replica, submesh_of(sl.resolve(devs), device=device)))
    return {k: [m for _, m in sorted(v, key=lambda t: t[0])] for k, v in out.items()}


def submesh_of(ranks, *, device: str = "cuda"):
    """A (1, tp) ("data", "model") ``DeviceMesh`` over one replica's ranks,
    or None where no honest sub-mesh exists, as in the JAX package: tp < 2
    (nothing to shard), repeated ranks (a slice folded by
    oversubscription), or handles that name no process of this world (the
    interpreter's device model, the JAX package's integer handles)."""
    ranks = tuple(ranks)
    if len(ranks) < 2 or len(set(ranks)) != len(ranks):
        return None
    if not dist.is_initialized() or not all(
            isinstance(r, int) and 0 <= r < dist.get_world_size() for r in ranks):
        return None
    return device_mesh((1, len(ranks)), ("data", "model"), ranks=ranks, device=device)


def _pool(mesh_or_devices) -> list:
    if hasattr(mesh_or_devices, "mesh_dim_names"):
        return mesh_ranks(mesh_or_devices)
    return list(mesh_or_devices)


class RankPool(Sequence):
    """The ranks a pipeline runs on, one rank standing for one JAX device,
    and the two process groups its ranks talk over: ``control``, gloo,
    for the controller's commands and the workers' reports, and ``data``,
    the caller's ``transport``, for the activations, cotangents and
    gradients that go from rank to rank.  As a sequence it is its ranks,
    so `placement.place` lays slices over it as over any device list.

    The pool's first rank is the controller (`runtime.pipeline.remote`);
    ``device`` is the device of this process.  ``transport`` is "nccl"
    (a card a rank) or "gloo": gloo sends CPU tensors only, so on the
    card its tensors go through host copies (``host_staged``).
    ``timeout_s`` bounds every wait on a peer: a receive, a report, the
    next command."""

    def __init__(self, ranks, device, transport: str, control, data, timeout_s: float):
        self.ranks = tuple(int(r) for r in ranks)
        self.device = device
        self.transport = transport
        self.control = control
        self.data = data
        self.timeout_s = float(timeout_s)

    def __len__(self) -> int:
        return len(self.ranks)

    def __getitem__(self, i):
        return self.ranks[i]

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def controller(self) -> int:
        return self.ranks[0]

    @property
    def is_controller(self) -> bool:
        return self.rank == self.controller

    @property
    def host_staged(self) -> bool:
        return self.transport == "gloo" and self.device.type == "cuda"


def rank_pool(ranks=None, *, device: str = "cuda", transport: str | None = None,
              timeout_s: float = 600.0) -> RankPool:
    """A `RankPool` over ``ranks`` (the world by default, or a
    ``DeviceMesh``'s ranks in its order), on this process's ``device``.
    Every rank of the world calls it, in the same order (it makes the
    pool's groups).  ``transport``: "gloo" on the CPU (the default there);
    on the card the caller names it, "nccl" where each rank has a card of
    its own, "gloo" where ranks share one.  A pool of several ranks needs
    the default process group (`init_distributed`) first."""
    from datetime import timedelta

    from .. import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("a pool of ranks needs a process group: call init_distributed "
                           "first")
    world = dist.get_world_size()
    if ranks is None:
        ranks = range(world)
    elif hasattr(ranks, "mesh_dim_names"):
        ranks = mesh_ranks(ranks)
    ranks = [int(r) for r in ranks]
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    device = resolve_device(device)
    if transport is None:
        if device.type == "cuda":
            raise ValueError("name the data transport on the card: 'nccl' (a card a rank) "
                             "or 'gloo' (ranks sharing a card, host-staged)")
        transport = "gloo"
    if transport not in ("nccl", "gloo") or (transport == "nccl" and device.type != "cuda"):
        raise ValueError(f"transport {transport!r} on {device.type}: NCCL moves CUDA "
                         "tensors, gloo moves any")
    timeout = timedelta(seconds=timeout_s)
    control = dist.new_group(backend="gloo", timeout=timeout)
    data = dist.new_group(backend=transport, timeout=timeout)
    return RankPool(ranks, device, transport, control, data, timeout_s)


def as_rank_pool(devices, device="cuda"):
    """``devices`` as a `RankPool` when it names ranks: a pool, a
    ``DeviceMesh`` or a list of ints (a pool over the default group, its
    transport the default group's backend, the one the caller started it
    with); None for a list of devices, which one process drives."""
    if isinstance(devices, RankPool):
        return devices
    if hasattr(devices, "mesh_dim_names"):
        kind = devices.device_type
    elif devices is not None and len(devices) and all(
            isinstance(d, int) and not isinstance(d, bool) for d in devices):
        kind = torch.device(device).type
    else:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"a pool of ranks {list(devices) if not hasattr(devices, 'mesh') else devices} "
                           "needs a process group: call init_distributed first")
    backend = str(dist.get_backend())
    return rank_pool(devices, device=kind, transport=backend if kind == "cuda" else "gloo")
