"""Closed-loop control (DESIGN.md §10–11): the host side of the lowering.

The policy enums ride in ``ScenarioArrays`` as i32 data and the
``ControlSpec`` on every :class:`~repro_torch.core.config.Scenario`;
:func:`failover_targets` gives the second binding slot a killed or evicted
task moves to (``SimOutput.task_vm2`` reports it in open-loop runs too),
and :func:`earliest_finish` is the f32 deadline-pressure estimate the SHED
and BOOST predicates of the ``mr_epoch`` control lowering compare.  The
failure stream (:func:`failure_times`) is host numpy.  The sequential
oracle (``refsim``) calls the numpy forms :func:`earliest_finish_np` and
:func:`failover_targets_np`, the same op sequences on host arrays.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np
import torch

from .storage import _C1, _C3, _INV24, _mix32, replica_holders

_BIG = 1e30


class ControlPolicy(enum.IntEnum):
    """Per-epoch control rule (stable wire constants — i32 sweep data)."""
    NONE = 0
    AUTOSCALE = 1


def as_control_policy(v) -> ControlPolicy:
    """Coerce a name (``"none"``/``"autoscale"``), int, or member."""
    if isinstance(v, str):
        try:
            return ControlPolicy[v.upper()]
        except KeyError:
            raise ValueError(
                f"unknown control policy {v!r}; known: "
                f"{[p.name.lower() for p in ControlPolicy]}") from None
    return ControlPolicy(v)


class DeadlinePolicy(enum.IntEnum):
    """Per-task deadline rule (stable wire constants — i32 sweep data)."""
    NONE = 0
    SHED = 1
    BOOST = 2


def as_deadline_policy(v) -> DeadlinePolicy:
    """Coerce a name (``"none"``/``"shed"``/``"boost"``), int, or member."""
    if isinstance(v, str):
        try:
            return DeadlinePolicy[v.upper()]
        except KeyError:
            raise ValueError(
                f"unknown deadline policy {v!r}; known: "
                f"{[p.name.lower() for p in DeadlinePolicy]}") from None
    return DeadlinePolicy(v)


def earliest_finish(now, rem, mips):
    """The f32 earliest-finish estimate ``now + rem / max(mips, 1e-30)``:
    division then add, one rounding each.  ``earliest_finish > deadline``
    decides SHED and ``earliest_finish + slack >= deadline`` BOOST urgency;
    the plain ``mr_epoch`` and its CUDA kernel share this op sequence."""
    return now + rem / torch.clamp(mips, min=1e-30)


def earliest_finish_np(now, rem, mips):
    """:func:`earliest_finish` on numpy float32 scalars or arrays, as the
    oracle calls it: every operand float32, so each op rounds to float32
    and the SHED and BOOST tiers are the kernel's (a Python float operand
    would promote the sum to float64 and could move a task across a
    tier)."""
    return now + rem / np.maximum(mips, np.float32(1e-30))


@dataclass(frozen=True)
class ControlSpec:
    """Scenario-level closed-loop control model (disabled by default:
    zero failure rate and ``NONE`` policies are the open loop)."""
    policy: ControlPolicy = ControlPolicy.NONE
    failure_rate: float = 0.0
    failure_seed: int = 0
    repair_delay: float = math.inf
    redispatch_delay: float = 0.0
    queue_threshold: float = 0.0
    busy_threshold: float = 0.0
    deadline_policy: DeadlinePolicy = DeadlinePolicy.NONE
    deadline_slack: float = 0.0
    preempt: bool = False
    preempt_resume: bool = False


def failure_times(n_vms: int, *, rate: float, seed: int = 0,
                  repair_delay: float = math.inf
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-VM failure/restore instants ``(F, R)`` (f32, host-side):
    ``F_v = -log1p(-u_v) / rate`` over the counter hash of ``(seed, v)``,
    ``R_v = F_v + repair_delay``; ``_BIG`` where nothing fires."""
    if n_vms < 1:
        raise ValueError(f"failure_times: need n_vms >= 1, got {n_vms}")
    v = np.arange(int(n_vms), dtype=np.uint32)
    seed_mix = np.uint32((int(seed) % (1 << 32)) * int(_C3) % (1 << 32))
    h = _mix32(v * _C1 + seed_mix)
    u = (h >> np.uint32(8)).astype(np.float64) * float(_INV24)
    if not rate > 0.0:
        fail = np.full(n_vms, _BIG, np.float64)
    else:
        fail = -np.log1p(-u) / float(rate)
    rest = np.where(fail >= _BIG / 2, _BIG,
                    np.minimum(fail + float(repair_delay), _BIG))
    return fail.astype(np.float32), rest.astype(np.float32)


def failover_targets(task_vm, vm_valid, vm_auto, block_vm):
    """Per-task failover VM ``i32[N, T]`` — the second binding slot.

    A killed task re-dispatches to the first VM cyclically after its bound
    VM that is (in preference order) a valid non-reserve replica holder of
    its input block, else any valid non-reserve VM, else any valid VM,
    else the bound VM itself.  ``task_vm [N, T]``, ``vm_valid``/``vm_auto``
    ``[N, V]``, ``block_vm [N, T, V]``.
    """
    V = vm_valid.shape[-1]
    vmr = torch.arange(V, dtype=torch.int32, device=task_vm.device)
    order = torch.remainder(vmr - task_vm[..., None].to(torch.int32) - 1,
                            V)                                  # [N, T, V]
    holds = replica_holders(block_vm, V)
    valid = vm_valid.bool()[:, None, :]
    reserve = vm_auto.bool()[:, None, :]
    fill = torch.full_like(order, V + 1)

    def pick(mask):
        key = torch.where(mask, order, fill)
        best = torch.argmin(key, dim=-1).to(torch.int32)
        ok = key.amin(dim=-1) <= V
        return best, ok

    t1, ok1 = pick(valid & ~reserve & holds)
    t2, ok2 = pick(valid & ~reserve)
    t3, ok3 = pick(valid.expand_as(order))
    out = torch.where(ok1, t1, torch.where(ok2, t2, torch.where(
        ok3, t3, task_vm.to(torch.int32))))
    return out.to(torch.int32)


def failover_targets_np(task_vm, vm_valid, vm_auto, block_vm):
    """:func:`failover_targets` of one scenario on numpy arrays, for the
    oracle: ``task_vm [T]``, ``vm_valid``/``vm_auto [V]``, ``block_vm
    [T, V]``; returns i32 ``[T]``, the same preference order and ties."""
    task_vm = np.asarray(task_vm)
    vm_valid = np.asarray(vm_valid, bool)
    vm_auto = np.asarray(vm_auto, bool)
    V = vm_valid.shape[0]
    vmr = np.arange(V, dtype=np.int32)[None, :]
    order = (vmr - task_vm[:, None].astype(np.int32) - 1) % V     # [T, V]
    holds = np.any(block_vm[:, :, None] == vmr[:, None, :], axis=1)
    valid = vm_valid[None, :]
    reserve = vm_auto[None, :]

    def pick(mask):
        key = np.where(mask, order, V + 1)
        return (np.argmin(key, axis=1).astype(np.int32),
                np.min(key, axis=1) <= V)

    t1, ok1 = pick(valid & ~reserve & holds)
    t2, ok2 = pick(valid & ~reserve)
    t3, ok3 = pick(valid)
    out = np.where(ok1, t1, np.where(ok2, t2,
                   np.where(ok3, t3, task_vm.astype(np.int32))))
    return out.astype(np.int32)


def scenario_control(scenario, pad_vms: int):
    """One scenario's control model as padded per-VM numpy arrays —
    ``(vm_fail, vm_restore, vm_auto)``; padding VMs never fail and are
    never reserves."""
    spec = scenario.control
    n = len(scenario.vms)
    vm_fail = np.full(pad_vms, _BIG, np.float32)
    vm_restore = np.full(pad_vms, _BIG, np.float32)
    vm_auto = np.zeros(pad_vms, bool)
    if spec.failure_rate > 0.0:
        f, r = failure_times(n, rate=spec.failure_rate,
                             seed=spec.failure_seed,
                             repair_delay=spec.repair_delay)
        vm_fail[:n], vm_restore[:n] = f, r
    vm_auto[:n] = [bool(getattr(v, "autoscale", False))
                   for v in scenario.vms]
    return vm_fail, vm_restore, vm_auto
