"""Wrappers: ScenarioArrays (J=1) -> kernel inputs -> schedules.

The derived per-task quantities (task lengths, stage-in readiness with the
storage fetch delay, shuffle delays, and under control each task's failover
VM with its re-replication fetch) are plain tensor ops, O(N·T), in the
reference's exact op sequence; the event loop runs in a kernel:

* :func:`schedule` — ``mr_schedule`` (fixed ``2T + 2`` epochs, no lease
  windows, no priorities), returns ``(start, finish)``;
* :func:`epoch_schedule` / :func:`epoch_trace` — ``mr_epoch``, returns a
  :class:`~repro_torch.core.engine.SimOutput` (and under trace the time
  series, or the whole :class:`~repro_torch.core.telemetry.TraceBuffers`);
* :func:`epoch_schedule_compact` — the same kernel stepped in resumable
  chunks over a working set of the still-active lanes, gathered again
  whenever it halves (DESIGN.md §9).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import network, storage
from ...core.control import DeadlinePolicy, failover_targets
from ...core.engine import (ScenarioArrays, SimOutput, _active_lanes,
                            _lane_bound, _put_lanes, _put_lanes_donated,
                            _sim_output, _take_lanes, _trace_caps, _trace_of)
from ...core.telemetry import TraceBuffers
from ...core.util import pow2_pad, validate_pow2_floor
from .kernel import mr_schedule, mr_schedule_plain
from .megakernel import (_BIG, TRACE_LEAVES, initial_state, mr_epoch,
                         mr_epoch_plain)

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


def _prepare(batch: ScenarioArrays, backend, max_pes, control: bool,
             trace: bool, device, what: str):
    """``(batch, step, max_pes, lane data, task_vm2)`` of one run: the
    batch on its device, the kernel or its plain version, and the lane
    data in ``mr_epoch``'s order (the control tensors, or an open-loop
    trace's ``vm_valid``, after the 13 open-loop ones)."""
    if device is not None:
        batch = ScenarioArrays(*(x.to(device) for x in batch))
    backend = resolve_backend(backend, batch.task_vm.device)
    if batch.job_length.shape[1] != 1:
        raise ValueError(f"{what}: the kernel steps one job per lane "
                         f"(J=1), got J={batch.job_length.shape[1]}")
    if max_pes is None:
        max_pes = batch_max_pes(batch)
    step = mr_epoch if backend == "cuda" else mr_epoch_plain
    task_vm2, refetch = control_derived(batch)
    lanes = kernel_inputs(batch)
    if control:
        lanes = lanes + control_lane_data(batch, task_vm2, refetch)
    elif trace:
        lanes = lanes + (batch.vm_valid.to(I32).contiguous(),)
    return batch, step, max_pes, lanes, task_vm2


def _initial(batch: ScenarioArrays, lanes, control: bool, trace: bool,
             trace_events):
    """The t=0 carry of a run over ``lanes`` (:func:`_prepare`)."""
    T, V = batch.task_vm.shape[1], batch.vm_mips.shape[1]
    caps = _trace_caps(T, V, control, trace, trace_events) or (None, None)
    return initial_state(lanes[0], lanes[2], lanes[3], lanes[4], lanes[9],
                         lanes[10], lanes[16] if control else None, *caps)


def _output(batch: ScenarioArrays, st, task_vm2, control: bool) -> SimOutput:
    """The :class:`SimOutput` of a final carry."""
    carry = None
    if control:
        carry = (st[8] != 0, st[9], st[10], st[11][:, 0], st[12] != 0,
                 st[13], st[14][:, 0])
    return _sim_output(batch, st[3], st[4], st[5], st[7][:, 0], task_vm2,
                       carry)


def _step(batch: ScenarioArrays, backend, max_pes, control: bool,
          trace: bool, trace_events, device):
    """Run ``mr_epoch`` over a batch: ``(SimOutput, final carry)``."""
    batch, step, max_pes, lanes, task_vm2 = _prepare(
        batch, backend, max_pes, control, trace, device, "epoch_schedule")
    state = (_initial(batch, lanes, control, True, trace_events)
             if trace else None)
    st = step(*lanes, state=state, max_pes=max_pes, control=control,
              trace=trace)
    return _output(batch, st, task_vm2, control), st


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


# ---------------------------------------------------------------------------
# Active-lane compaction (DESIGN.md §9)
# ---------------------------------------------------------------------------

def _state_activity(valid, finish, shed=None, n_epochs=None, bound=None):
    """The still-active lane count (a 0-d device tensor: the one scalar a
    round pulls) and the stable active-first order of the lanes (pulled
    only on rounds that compact); arguments as :func:`_active_lanes`."""
    act = _active_lanes(valid, finish, shed, n_epochs, bound)
    return act.sum(dtype=I32), torch.argsort((~act).to(torch.uint8),
                                             stable=True)


def _host_bound(batch: ScenarioArrays, control: bool) -> int:
    """Epochs that run every lane of the batch to its end: the batch-wide
    worst case of the additive per-lane bound."""
    T, V = batch.task_vm.shape[1], batch.vm_mips.shape[1]
    bound = 2 * T + 2
    if control:
        if bool((batch.vm_valid & (batch.vm_fail < _BIG / 2)).any()):
            bound += 2 * T + V
        if bool(((batch.deadline_policy == int(DeadlinePolicy.SHED))
                 & (batch.task_valid & (batch.task_deadline < _BIG / 2)
                    ).any(dim=1)).any()):
            bound += T + 1
        if bool((batch.preempt != 0).any()):
            bound += 2 * T
    return bound


def _compact_interval(k, cost_model, N: int, T: int, dev, what: str) -> int:
    """The compaction interval: ``k`` itself, or under ``"auto"`` the cost
    model's (``cost_model``, default the device's measured one)."""
    if k == "auto":
        from ...core import costmodel as costmodel_mod
        cm = cost_model or costmodel_mod.default_cost_model(device=dev)
        k = cm.compact_interval(N, T)
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)) or k < 1:
        raise ValueError(f"{what}: k must be an int >= 1 or 'auto', got "
                         f"{k!r}")
    return int(k)


def _compact(batch: ScenarioArrays, *, k, backend, max_pes, floor: int,
             cost_model, control: bool, trace: bool, trace_events,
             stats: dict | None, donate: bool, legacy: bool, device,
             what: str):
    """The compacted loop: ``(SimOutput, final carry)``.

    A host loop steps the working set in chunks of ``k`` epochs through
    the resumable kernel (``state`` in and out, ``epoch_limit``).  When
    the still-active count, padded to a power of two (at least
    ``floor``), falls below the working set, the active lanes (padded
    with finished ones, which the kernel leaves as they are) are gathered
    from the lane data and the dense carry store, and the advanced carry
    is scattered back by lane index before the next gather.  The kernel
    steps each lane by its own data to its own end, so the result is the
    dense run's bit for bit, per-lane ``n_epochs`` included.

    The lean loop pulls one scalar per round, the order only on rounds
    that compact, and with ``donate`` scatters into the store in place.
    ``legacy`` pulls the whole activity mask every round, orders the lanes
    on the host and never updates the store in place."""
    if stats is None:
        stats = {}
    for key in ("syncs", "scalar_syncs", "compactions", "dispatches"):
        stats.setdefault(key, 0)
    validate_pow2_floor(floor)
    batch, step, max_pes, lanes, task_vm2 = _prepare(
        batch, backend, max_pes, control, trace, device, what)
    N, T = batch.task_vm.shape
    dev = batch.task_vm.device
    bound = _host_bound(batch, control)
    k = _compact_interval(k, cost_model, N, T, dev, what)
    state = _initial(batch, lanes, control, trace, trace_events)
    # ready0 (lane data 2) only seeds the t=0 carry: chunks resume
    data = lanes[:2] + lanes[3:]
    lane_bound = _lane_bound(batch) if control else None

    def args(data_, state_, bound_):
        """:func:`_active_lanes`'s arguments for a working set."""
        return (data_[3], state_[4], state_[12] if control else None,
                state_[7], bound_)

    def chunk(data_, state_, limit):
        stats["dispatches"] += 1
        return step(data_[0], data_[1], None, *data_[2:], state=state_,
                    max_pes=max_pes, epoch_limit=limit, control=control,
                    trace=trace)

    loop = _compact_loop_legacy if legacy else _compact_loop_lean
    st = loop(data, state, lane_bound, N, bound, k, floor, args, chunk,
              stats, donate, dev)
    return _output(batch, st, task_vm2, control), st


def _compact_loop_lean(data, state, lane_bound, N, bound, k, floor,
                       args, chunk, stats, donate, dev):
    """One scalar pull per round; the order crosses to the host only on
    rounds that compact.  ``store`` stays ``None`` until the first
    compaction (``cur`` is the whole batch in lane order until then);
    afterwards it holds every lane outside ``idx``."""
    store, cur_data, cur, cur_bound = None, data, state, lane_bound
    idx = np.arange(N)
    idx_dev = None
    n_act_dev, order_dev = _state_activity(*args(cur_data, cur, cur_bound))
    n_act = int(n_act_dev)
    stats["scalar_syncs"] += 1
    total = 0
    while total < bound and n_act:
        pad = pow2_pad(n_act, cap=len(idx), floor=floor)
        if pad < len(idx):
            order = order_dev[:pad].cpu().numpy()
            stats["syncs"] += 1
            if store is None:
                store = cur
            else:
                store = (_put_lanes_donated if donate else _put_lanes)(
                    store, idx_dev, cur)
            idx = idx[order]
            idx_dev = torch.as_tensor(idx, device=dev)
            cur_data = _take_lanes(data, idx_dev)
            cur = _take_lanes(store, idx_dev)
            if lane_bound is not None:
                cur_bound = lane_bound.index_select(0, idx_dev)
            stats["compactions"] += 1
        limit = min(k, bound - total)
        cur = chunk(cur_data, cur, limit)
        total += limit
        n_act_dev, order_dev = _state_activity(
            *args(cur_data, cur, cur_bound))
        n_act = int(n_act_dev)
        stats["scalar_syncs"] += 1
    if store is None:
        return cur
    return (_put_lanes_donated if donate else _put_lanes)(store, idx_dev,
                                                          cur)


def _compact_loop_legacy(data, state, lane_bound, N, bound, k, floor,
                         args, chunk, stats, donate, dev):
    """The A/B comparator: the whole activity mask crosses to the host
    every round and the order is made there; the store is never updated
    in place."""
    del donate
    store, cur_data, cur, cur_bound = state, data, state, lane_bound
    idx = np.arange(N)
    idx_dev = torch.as_tensor(idx, device=dev)
    total = 0
    while total < bound:
        act = _active_lanes(*args(cur_data, cur, cur_bound)).cpu()
        act = act.numpy()
        stats["syncs"] += 1
        n_act = int(act.sum())
        if n_act == 0:
            break
        pad = pow2_pad(n_act, cap=len(idx), floor=floor)
        if pad < len(idx):
            store = _put_lanes(store, idx_dev, cur)
            order = np.concatenate([np.nonzero(act)[0],
                                    np.nonzero(~act)[0]])[:pad]
            idx = idx[order]
            idx_dev = torch.as_tensor(idx, device=dev)
            cur_data = _take_lanes(data, idx_dev)
            cur = _take_lanes(store, idx_dev)
            if lane_bound is not None:
                cur_bound = lane_bound.index_select(0, idx_dev)
            stats["compactions"] += 1
        limit = min(k, bound - total)
        cur = chunk(cur_data, cur, limit)
        total += limit
    return _put_lanes(store, idx_dev, cur)


def epoch_schedule_compact(batch: ScenarioArrays, *, k="auto",
                           backend: str | None = None,
                           max_pes: int | None = None, floor: int = 8,
                           cost_model=None, control: bool = False,
                           trace: bool = False, stats: dict | None = None,
                           donate: bool = True, device=None):
    """Active-lane compaction over ``mr_epoch`` (DESIGN.md §9): the
    compacted twin of :func:`epoch_schedule`.

    The batch steps in chunks of ``k`` epochs through the resumable kernel
    (``state`` in and out, ``epoch_limit``).  After each chunk one scalar,
    the still-active lane count, crosses to the host.  When that count,
    padded to a power of two (at least ``floor``), is below the working
    set, the active lanes are gathered front first into a smaller working
    set (lane data and carry, ``index_select``) and the carry of the old
    one goes back into the dense store by lane index (``index_copy_``, in
    place under ``donate``, out of place otherwise).  The kernel steps
    each lane by its own data to its own end, so the result is the dense
    path's bit for bit, per-lane ``n_epochs`` included, under control as
    well (a lane's result never depends on its batch mates, ROADMAP C6).
    The host bound is the batch's worst case of the additive per-lane
    epoch bound; under control a lane leaves the working set at its own
    bound.

    ``k="auto"`` takes the interval from the cost model (``cost_model``,
    default :func:`~repro_torch.core.costmodel.default_cost_model` of the
    batch's device).  ``trace=True`` carries the six trace leaves through
    the gathers (each lane keeps its rows, its capacity and its ``ev_n``)
    and returns ``(SimOutput, realized, ts)``; otherwise ``(SimOutput,
    realized)``, ``realized`` the batch's largest ``n_epochs``.

    ``stats`` (a dict, updated in place) counts ``syncs`` (order pulls,
    one per compaction), ``scalar_syncs`` (one per round, plus the first
    check), ``compactions`` and ``dispatches`` (chunk steps).
    ``backend``/``device`` as in :func:`epoch_schedule`.
    """
    out, st = _compact(
        batch, k=k, backend=backend, max_pes=max_pes, floor=floor,
        cost_model=cost_model, control=control, trace=trace,
        trace_events=0, stats=stats, donate=donate, legacy=False,
        device=device, what="epoch_schedule_compact")
    realized = int(out.n_epochs.max()) if out.n_epochs.numel() else 0
    if trace:
        return out, realized, _trace_of(st[-len(TRACE_LEAVES):]).ts
    return out, realized
