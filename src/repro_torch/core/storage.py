"""Data-locality storage subsystem: block placement as tensor data.

An HDFS-style block store (DESIGN.md §7): each job's dataset is split into
fixed-size blocks, map task ``m`` reads block ``m mod n_blocks``, and every
block is replicated onto distinct VMs by a seeded counter-based hash of
``(seed, job, block)``.  The placement is encoded into ``ScenarioArrays`` as
per-task ``block_vm`` / ``block_size``; a map task bound off its replica set
pays a remote-fetch delay before it becomes ready.

The hash is a uint32 wrap-around avalanche.  Torch has almost no uint32
arithmetic, so :func:`map_block_placement_torch` computes it in int64 and
masks to 32 bits after every multiply and add; the numpy form
(:func:`map_block_placement`) serves the host encoder.  Both give the bits
of the JAX package's ``storage.map_block_placement`` exactly.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from .util import fma32


class Placement(enum.IntEnum):
    """Block-placement variant (stable wire constants — i32 sweep data).

    UNIFORM — the replica set's start VM is a uniform hash of the block.
    SKEWED  — hot-spot placement: the start VM is ``floor(u² · V)`` for a
        hashed uniform ``u``, biased toward low VM indices.
    """
    UNIFORM = 0
    SKEWED = 1


def as_placement(v) -> Placement:
    """Coerce a name (``"uniform"``/``"skewed"``), int, or member."""
    if isinstance(v, str):
        try:
            return Placement[v.upper()]
        except KeyError:
            raise ValueError(
                f"unknown placement {v!r}; "
                f"known: {[p.name.lower() for p in Placement]}") from None
    return Placement(v)


@dataclass(frozen=True)
class StorageSpec:
    """The scenario-level storage model (disabled by default).

    ``replication`` is clipped to the VM count at placement time (a block
    cannot have two replicas on one VM).
    """
    enabled: bool = False
    block_size_mb: float = 2048.0
    replication: int = 3
    placement: Placement = Placement.UNIFORM
    seed: int = 0


# ---------------------------------------------------------------------------
# Seeded counter-based placement
# ---------------------------------------------------------------------------

_M1 = np.uint32(0x7FEB352D)     # lowbias32 (Walker) avalanche constants
_M2 = np.uint32(0x846CA68B)
_C1 = np.uint32(0x9E3779B9)     # distinct odd mix-in constants per input
_C2 = np.uint32(0x85EBCA6B)
_C3 = np.uint32(0xC2B2AE35)
_INV24 = np.float32(1.0 / (1 << 24))
_MASK32 = 0xFFFFFFFF


def _mix32(h):
    """lowbias32-style avalanche on numpy uint32 arrays (they wrap)."""
    h = (h ^ (h >> 16)) * _M1
    h = (h ^ (h >> 15)) * _M2
    return h ^ (h >> 16)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in ``[0, 2**32)``: the constant
    is split in 16-bit halves so no partial product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32_torch(h: torch.Tensor) -> torch.Tensor:
    h = _mul32(h ^ (h >> 16), int(_M1))
    h = _mul32(h ^ (h >> 15), int(_M2))
    return h ^ (h >> 16)


def map_block_placement(map_idx, job_idx, *, seed, placement, replication,
                        block_size_mb, job_data, n_vms, pad_vms: int):
    """Replica VMs + block size for each map task of a job (host numpy).

    Returns ``(block_vm i32[K, pad_vms], block_mb f32[K])``: slot ``r``
    holds VM ``(start + r) mod n_vms`` for ``r`` below the effective
    replication ``min(max(replication, 1), n_vms)``, else ``-1``.
    """
    i32, f32, u32 = np.int32, np.float32, np.uint32
    if isinstance(seed, int):
        seed = seed % (1 << 32)
    map_idx = np.asarray(map_idx, i32)
    n_vms_i = np.asarray(n_vms, i32)
    bs = np.maximum(np.asarray(block_size_mb, f32), f32(1e-6))
    data = np.asarray(job_data, f32)
    n_blocks = np.maximum(np.ceil(data / bs), f32(1.0)).astype(i32)
    block = map_idx % n_blocks
    last_mb = data - (n_blocks - 1).astype(f32) * bs
    block_mb = np.where(block == n_blocks - 1, last_mb, bs)
    h = _mix32(np.asarray(block, u32) * _C1
               + np.asarray(job_idx, u32) * _C2
               + np.asarray(seed, u32) * _C3)
    start_uni = (h % np.asarray(np.maximum(n_vms_i, 1), u32)).astype(i32)
    u01 = (h >> u32(8)).astype(f32) * _INV24
    n_vms_f = n_vms_i.astype(f32)
    start_skew = np.minimum((u01 * u01 * n_vms_f).astype(i32),
                            np.maximum(n_vms_i - 1, 0))
    start = np.where(np.asarray(placement, i32) == int(Placement.SKEWED),
                     start_skew, start_uni)
    eff_repl = np.clip(np.asarray(replication, i32), 1, n_vms_i)
    r = np.arange(pad_vms, dtype=i32)
    vm = (start[:, None] + r[None, :]) % np.maximum(n_vms_i, 1)
    block_vm = np.where(r[None, :] < eff_repl, vm, i32(-1))
    return block_vm, block_mb


def map_block_placement_torch(map_idx, job_idx, *, seed, placement,
                              replication, block_size_mb, job_data, n_vms,
                              pad_vms: int):
    """Batched :func:`map_block_placement` on tensors.

    ``map_idx``/``job_idx`` are int ``[K]``; the per-cell knobs ``seed``,
    ``placement``, ``replication``, ``n_vms`` (int) and ``block_size_mb``,
    ``job_data`` (float32) are ``[N]`` tensors.  Returns ``(block_vm
    i32[N, K, pad_vms], block_mb f32[N, K])``, bit for bit the numpy form.
    """
    f32 = torch.float32
    dev = job_data.device
    bs = torch.clamp(block_size_mb.to(f32), min=float(np.float32(1e-6)))
    data = job_data.to(f32)
    n_blocks = torch.clamp(torch.ceil(data / bs), min=1.0).to(torch.int32)
    map_idx = map_idx.to(torch.int32)
    block = torch.remainder(map_idx[None, :], n_blocks[:, None])  # [N, K]
    # one rounding, as the reference's XLA:CPU lowering fuses it (an FMA)
    last_mb = fma32(-(n_blocks - 1).to(f32), bs, data)
    block_mb = torch.where(block == (n_blocks - 1)[:, None],
                           last_mb[:, None], bs[:, None])
    u = torch.int64
    h = (_mul32(block.to(u) & _MASK32, int(_C1))
         + _mul32(job_idx.to(u)[None, :] & _MASK32, int(_C2))) & _MASK32
    h = (h + _mul32(seed.to(u)[:, None] & _MASK32, int(_C3))) & _MASK32
    h = _mix32_torch(h)
    n_vms_i = n_vms.to(torch.int32)
    start_uni = torch.remainder(
        h, torch.clamp(n_vms_i, min=1).to(u)[:, None]).to(torch.int32)
    inv24 = torch.tensor(float(_INV24), dtype=f32, device=dev)
    u01 = (h >> 8).to(f32) * inv24
    start_skew = torch.minimum(
        (u01 * u01 * n_vms_i.to(f32)[:, None]).to(torch.int32),
        torch.clamp(n_vms_i - 1, min=0)[:, None])
    start = torch.where((placement.to(torch.int32)
                         == int(Placement.SKEWED))[:, None],
                        start_skew, start_uni)
    eff_repl = torch.minimum(torch.clamp(replication.to(torch.int32), min=1),
                             n_vms_i)
    r = torch.arange(pad_vms, dtype=torch.int32, device=dev)
    vm = torch.remainder(start[:, :, None] + r,
                         torch.clamp(n_vms_i, min=1)[:, None, None])
    block_vm = torch.where(r < eff_repl[:, None, None], vm,
                           torch.full_like(vm, -1))
    return block_vm.to(torch.int32), block_mb


def scenario_placement(scenario, pad_vms: int):
    """Realize a whole :class:`Scenario`'s block placement, host-side:
    ``(block_vm i32[n_tasks, pad_vms], block_mb f32[n_tasks])`` over the
    canonical task order (per job: maps, then reduces)."""
    st = scenario.storage
    n_tasks = scenario.total_tasks()
    block_vm = np.full((n_tasks, pad_vms), -1, np.int32)
    block_mb = np.zeros(n_tasks, np.float32)
    if not st.enabled:
        return block_vm, block_mb
    k = 0
    for ji, job in enumerate(scenario.jobs):
        bvm, bmb = map_block_placement(
            np.arange(job.n_maps, dtype=np.int32),
            np.full(job.n_maps, ji, np.int32),
            seed=st.seed, placement=int(st.placement),
            replication=st.replication,
            block_size_mb=np.float32(st.block_size_mb),
            job_data=np.float32(job.data_mb),
            n_vms=len(scenario.vms), pad_vms=pad_vms)
        block_vm[k:k + job.n_maps] = bvm
        block_mb[k:k + job.n_maps] = bmb
        k += job.n_maps + job.n_reduces
    return block_vm, block_mb


# ---------------------------------------------------------------------------
# Derived quantities (tensors with any leading batch shape)
# ---------------------------------------------------------------------------

def replica_holders(block_vm: torch.Tensor, n_vms: int) -> torch.Tensor:
    """``bool[..., T, n_vms]``: VM ``v`` holds a replica of the task's
    block.  One pass per replica slot, so no ``[..., T, V, V]`` temporary
    is built."""
    ids = torch.arange(n_vms, dtype=block_vm.dtype, device=block_vm.device)
    holds = torch.zeros(block_vm.shape[:-1] + (n_vms,), dtype=torch.bool,
                        device=block_vm.device)
    for r in range(block_vm.shape[-1]):
        holds |= block_vm[..., r, None] == ids
    return holds


def locality_candidates(block_vm, vm_valid):
    """LOCALITY's candidate mask ``bool[..., T, V]``: replica holders for a
    task with a block, every valid VM otherwise (``vm_valid [..., V]``)."""
    holds = replica_holders(block_vm, vm_valid.shape[-1])
    return torch.where(has_block(block_vm)[..., None], holds,
                       vm_valid[..., None, :])


def is_local(block_vm, task_vm):
    """``bool[..., T]``: the bound VM holds a replica of the task's block
    (tensors or numpy arrays)."""
    return (block_vm == task_vm[..., None]).any(-1)


def has_block(block_vm):
    """``bool[..., T]``: the task reads a placed input block at all
    (tensors or numpy arrays)."""
    return (block_vm >= 0).any(-1)


def remote_fetch_delay(block_vm, block_size, task_vm, kappa_in, net_bw,
                       net_enabled):
    """Per-task remote-fetch delay added to map readiness (0 when local):
    the shared kappa formula at its ``M = 0`` point.  ``kappa_in``,
    ``net_bw`` and ``net_enabled`` must broadcast against ``block_size``."""
    from . import network
    fetch = network.transfer_delay(kappa_in, block_size, 0.0, net_bw,
                                   net_enabled)
    remote = has_block(block_vm) & ~is_local(block_vm, task_vm)
    return torch.where(remote, fetch, torch.zeros_like(fetch))


def remote_fetch_delay_np(block_vm, block_size, task_vm, kappa_in, net_bw,
                          net_enabled):
    """:func:`remote_fetch_delay` on numpy arrays (the oracle passes
    float32 scalars for ``kappa_in``, ``net_bw`` and ``net_enabled``, so
    the delay is the float32 op sequence of the encoders)."""
    from . import network
    fetch = network.transfer_delay(kappa_in, block_size, 0.0, net_bw,
                                   net_enabled)
    remote = has_block(block_vm) & ~is_local(block_vm, task_vm)
    return np.where(remote, fetch, 0.0)
