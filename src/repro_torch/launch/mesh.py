"""Production mesh definitions.

Functions, not module-level constants: importing this module opens no
process group and touches no device.

Topology: 256-chip pods.

* single-pod:  (data=16, model=16)           — 256 chips
* multi-pod:   (pod=2, data=16, model=16)    — 512 chips, the "pod" axis
  carries pure data parallelism across the inter-pod boundary.

:func:`make_production_mesh` builds the mesh over a ``fake`` process group
of that many ranks in this one process (``torch.distributed``'s testing
store): collectives are recorded, never sent, so only the dry run
(``launch.dryrun``), which allocates nothing, opens it.  A process holds
one default process group, so a process that opens it can open no other.

:func:`flat_index`, :func:`mesh_size` and :func:`gather_objects` are what a
multi-rank sweep (``SweepPlan.run(mesh=...)``) needs to split its lanes
over a mesh in the reference's order and to collect the results on every
rank.
"""
from __future__ import annotations

import pickle

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sharding.rules import MeshAxes


def production_axes(*, multi_pod: bool = False) -> MeshAxes:
    """The production mesh's axis names and sizes (no devices)."""
    if multi_pod:
        return MeshAxes(("pod", "data", "model"), (2, 16, 16))
    return MeshAxes(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh as a ``DeviceMesh`` of CPU ranks over a ``fake``
    process group, opened as this process's default group on first use
    (rank 0 of 256 or 512).  Raises if another default group is open."""
    axes = production_axes(multi_pod=multi_pod)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
    elif dist.get_backend() != "fake":
        raise RuntimeError("make_production_mesh: this process's default "
                           f"group is {dist.get_backend()!r}, not the dry "
                           "run's fake group; run it in a process of its own")
    mesh = torch.arange(axes.size).reshape(axes.sizes)
    return DeviceMesh("cpu", mesh, mesh_dim_names=axes.axis_names)


def make_host_mesh() -> DeviceMesh:
    """This process's CUDA devices as a 1-D 'data' mesh: the default
    process group's ranks, one device each.  Without one, opens a
    one-rank group over an in-process store (``nccl`` for CUDA tensors,
    ``gloo`` for CPU ones; one H100: a one-device mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device")
    if not dist.is_initialized():
        dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                                rank=0, world_size=1)
    return init_device_mesh("cuda", (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def mesh_size(mesh: DeviceMesh) -> int:
    """The number of ranks of ``mesh``."""
    return int(mesh.mesh.numel())


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's index in ``mesh`` flattened row-major over its dims
    (``mesh.get_coordinate()``): the order in which the reference's
    ``PartitionSpec(mesh.axis_names)`` splits a lane dimension.  The
    global rank need not follow it (a mesh may lay its ranks out in any
    order).  Raises if this rank is not in ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("flat_index: this rank is not in the mesh")
    i = 0
    for c, n in zip(coord, mesh.mesh.shape):
        i = i * int(n) + int(c)
    return i


def gather_objects(mesh: DeviceMesh, obj) -> list:
    """``obj`` of every rank of ``mesh``, in flattened-mesh order
    (:func:`flat_index`), returned on every rank.  Pickled into CPU byte
    tensors and all-gathered over each mesh dim's group in turn, so each
    group needs a CPU backend (``gloo``; ``make_host_mesh`` opens
    ``cpu:gloo,cuda:nccl``).  Every rank of the mesh must call it."""
    items = [(flat_index(mesh), obj)]
    for d in range(mesh.ndim):
        if mesh.mesh.shape[d] > 1:
            items = [it for part in _all_gather_bytes(items,
                                                      mesh.get_group(d))
                     for it in part]
    return [o for _, o in sorted(items, key=lambda it: it[0])]


def _all_gather_bytes(obj, group) -> list:
    """``obj`` of every rank of ``group`` (in its rank order)."""
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    n = dist.get_world_size(group)
    size = torch.tensor([data.numel()], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    top = int(max(s.item() for s in sizes))
    buf = torch.zeros(top, dtype=torch.uint8)
    buf[:data.numel()] = data
    bufs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(bufs, buf, group=group)
    return [pickle.loads(b[:int(s.item())].numpy().tobytes())
            for b, s in zip(bufs, sizes)]
