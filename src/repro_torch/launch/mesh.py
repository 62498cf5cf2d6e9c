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
"""
from __future__ import annotations

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
