"""Wrappers: ScenarioArrays (J=1) -> kernel inputs -> schedules.

The derived per-task quantities (task lengths, stage-in readiness with the
storage fetch delay, shuffle delays, and under control each task's failover
VM with its re-replication fetch) are plain tensor ops, O(N·T), in the
reference's exact op sequence; the event loop runs in a kernel:

* :func:`schedule` — ``mr_schedule`` (fixed ``2T + 2`` epochs, no lease
  windows, no priorities), returns ``(start, finish)``;
* :func:`epoch_schedule` / :func:`epoch_trace` — ``mr_epoch``, returns a
  :class:`~repro_torch.core.engine.SimOutput` (and under trace the time
  series, or the whole :class:`~repro_torch.core.telemetry.TraceBuffers`).
"""
from __future__ import annotations

import torch

from ...core import network, storage
from ...core.control import failover_targets
from ...core.engine import (ScenarioArrays, SimOutput, _sim_output,
                            _trace_caps, _trace_of)
from ...core.telemetry import TraceBuffers
from .kernel import mr_schedule, mr_schedule_plain
from .megakernel import TRACE_LEAVES, initial_state, mr_epoch, mr_epoch_plain

F32, I32 = torch.float32, torch.int32
BACKENDS = ("cuda", "torch")


def _derived_inputs(batch: ScenarioArrays):
    """``(task_len, ready0, shuffle)`` for single-job lanes."""
    nm = batch.job_n_maps.to(F32)[:, 0]
    nr = batch.job_n_reduces.to(F32)[:, 0]
    stage_in = network.transfer_delay(batch.kappa_in, batch.job_data[:, 0],
                                      nm, batch.net_bw, batch.net_enabled)
    shuffle = network.transfer_delay(batch.kappa_shuffle,
                                     batch.job_data[:, 0], nm,
                                     batch.net_bw, batch.net_enabled)
    map_len = batch.job_length[:, 0] / nm
    red_len = batch.job_reduce_factor[:, 0] * batch.job_length[:, 0] / nr
    task_len = torch.where(batch.task_is_reduce, red_len[:, None],
                           map_len[:, None]) * batch.task_mult
    task_len = torch.where(batch.task_valid, task_len,
                           torch.zeros_like(task_len))
    fetch = storage.remote_fetch_delay(
        batch.block_vm, batch.block_size, batch.task_vm,
        batch.kappa_in[:, None], batch.net_bw[:, None],
        batch.net_enabled[:, None])
    ready0 = torch.where(batch.task_valid & ~batch.task_is_reduce,
                         (batch.job_submit[:, 0] + stage_in)[:, None] + fetch,
                         torch.full_like(fetch, 1e30))
    return task_len, ready0, shuffle


def kernel_inputs(batch: ScenarioArrays):
    """The 13 ``mr_epoch`` lane-data tensors of a batch, in call order."""
    task_len, ready0, shuffle = _derived_inputs(batch)
    c = torch.Tensor.contiguous
    return (c(task_len.to(F32)), c(batch.task_vm.to(I32)), c(ready0.to(F32)),
            c(batch.task_is_reduce.to(I32)), c(batch.task_valid.to(I32)),
            c(shuffle.to(F32)[:, None]), c(batch.vm_mips.to(F32)),
            c(batch.vm_pes.to(F32)), c(batch.sched_policy.to(I32)[:, None]),
            c(batch.vm_start.to(F32)), c(batch.vm_stop.to(F32)),
            c(batch.spinup_delay.to(F32)[:, None]),
            c(batch.task_prio.to(F32)))


def schedule(batch: ScenarioArrays, *, backend: str | None = None,
             device=None):
    """Schedule a stacked J=1 batch through ``mr_schedule``; returns
    ``(start, finish)`` ``(N, T)`` f32.

    The kernel models neither lease windows nor admission priorities, so
    it gives the scenario's schedule only for lanes with the static fleet
    (``vm_start`` 0, ``vm_stop`` ``1e30``, no spin-up) and zero
    priorities, as the reference's.  ``backend``/``device`` as in
    :func:`epoch_schedule`.
    """
    if device is not None:
        batch = ScenarioArrays(*(x.to(device) for x in batch))
    backend = resolve_backend(backend, batch.task_vm.device)
    if batch.job_length.shape[1] != 1:
        raise ValueError("schedule: the kernel steps one job per lane "
                         f"(J=1), got J={batch.job_length.shape[1]}")
    lanes = kernel_inputs(batch)
    step = mr_schedule if backend == "cuda" else mr_schedule_plain
    return step(*lanes[:9])


def control_derived(batch: ScenarioArrays):
    """``(task_vm2, refetch)``: each task's failover VM and the
    re-replication fetch delay it pays on moving there."""
    task_vm2 = failover_targets(batch.task_vm, batch.vm_valid, batch.vm_auto,
                                batch.block_vm)
    refetch = storage.remote_fetch_delay(
        batch.block_vm, batch.block_size, task_vm2,
        batch.kappa_in[:, None], batch.net_bw[:, None],
        batch.net_enabled[:, None])
    return task_vm2, refetch


def control_lane_data(batch: ScenarioArrays, task_vm2=None, refetch=None):
    """The 15 control lane-data tensors of a batch, in ``mr_epoch``'s
    order (``vm_valid`` .. ``preempt_resume``)."""
    if task_vm2 is None:
        task_vm2, refetch = control_derived(batch)
    c = torch.Tensor.contiguous
    col = lambda x, dt: c(x.to(dt)[:, None])                   # noqa: E731
    return (c(batch.vm_valid.to(I32)), c(batch.vm_fail.to(F32)),
            c(batch.vm_restore.to(F32)), c(batch.vm_auto.to(I32)),
            col(batch.control_policy, I32), col(batch.ctl_queue, F32),
            col(batch.ctl_busy, F32), col(batch.redispatch_delay, F32),
            c(task_vm2.to(I32)), c(refetch.to(F32)),
            c(batch.task_deadline.to(F32)), col(batch.deadline_policy, I32),
            col(batch.deadline_slack, F32), col(batch.preempt, I32),
            col(batch.preempt_resume, I32))


def batch_max_pes(batch: ScenarioArrays) -> int:
    """The static admission-scan depth a batch needs."""
    if batch.vm_pes.numel() == 0:
        return 1
    return max(int(torch.ceil(batch.vm_pes.max()).item()), 1)


def resolve_backend(backend: str | None, device: torch.device) -> str:
    """``None`` picks the kernel on the card and its plain version on the
    CPU; an explicit ``"cuda"`` needs tensors on the card."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' runs the CUDA kernel and needs "
                         f"tensors on the card, got {device}")
    return backend


def _step(batch: ScenarioArrays, backend, max_pes, control: bool,
          trace: bool, trace_events, device):
    """Run ``mr_epoch`` over a batch: ``(SimOutput, final carry)``."""
    if device is not None:
        batch = ScenarioArrays(*(x.to(device) for x in batch))
    backend = resolve_backend(backend, batch.task_vm.device)
    if batch.job_length.shape[1] != 1:
        raise ValueError("epoch_schedule: the kernel steps one job per lane "
                         f"(J=1), got J={batch.job_length.shape[1]}")
    if max_pes is None:
        max_pes = batch_max_pes(batch)
    step = mr_epoch if backend == "cuda" else mr_epoch_plain
    task_vm2, refetch = control_derived(batch)
    lanes = kernel_inputs(batch)
    ctl = ()
    if control:
        ctl = control_lane_data(batch, task_vm2, refetch)
    elif trace:
        ctl = (batch.vm_valid.to(I32).contiguous(),)
    state = None
    if trace:
        N, T = batch.task_vm.shape
        V = batch.vm_mips.shape[1]
        state = initial_state(lanes[0], lanes[2], lanes[3], lanes[4],
                              lanes[9], lanes[10],
                              ctl[3] if control else None,
                              *_trace_caps(T, V, control, True, trace_events))
    st = step(*lanes, *ctl, state=state, max_pes=max_pes, control=control,
              trace=trace)
    carry = None
    if control:
        carry = (st[8] != 0, st[9], st[10], st[11][:, 0], st[12] != 0,
                 st[13], st[14][:, 0])
    out = _sim_output(batch, st[3], st[4], st[5], st[7][:, 0], task_vm2,
                      carry)
    return out, st


def epoch_schedule(batch: ScenarioArrays, *, backend: str | None = None,
                   max_pes: int | None = None, control: bool = False,
                   trace: bool = False, device=None):
    """Step a stacked J=1 batch to completion through ``mr_epoch``.

    ``device`` moves the batch first (``None`` keeps it where it is);
    ``backend="cuda"`` launches the CUDA kernel, ``"torch"`` runs the
    plain version on the batch's device.  ``max_pes`` bounds the static
    admission scan (default: the batch's largest PE count).
    ``control=True`` runs the closed-loop lowering (failures, autoscale,
    deadlines, preemption); degenerate control data gives the open-loop
    schedule bit for bit.

    ``trace=True`` runs the trace instantiation and returns ``(SimOutput,
    ts)`` with the per-epoch time series ``ts [N, C, 8]`` in
    ``telemetry.TS_COLUMNS`` layout, as the reference does; its event log
    has no rows (the kernel only counts events), :func:`epoch_trace`
    returns it.
    """
    out, st = _step(batch, backend, max_pes, control, trace, 0, device)
    if trace:
        return out, _trace_of(st[-len(TRACE_LEAVES):]).ts
    return out


def epoch_trace(batch: ScenarioArrays, *, backend: str | None = None,
                max_pes: int | None = None, control: bool = False,
                trace_events: int | None = None, device=None
                ) -> tuple[SimOutput, TraceBuffers]:
    """:func:`epoch_schedule` under ``trace=True``, returning the whole
    :class:`~repro_torch.core.telemetry.TraceBuffers` (time series and
    event log, ``trace_events`` rows per lane; default: the worst case)."""
    out, st = _step(batch, backend, max_pes, control, True, trace_events,
                    device)
    return out, _trace_of(st[-len(TRACE_LEAVES):])
