"""Scenario encoding, batch stepping and metrics on torch tensors.

The JAX package's event-epoch engine, written on a leading lane dimension
in place of ``vmap``.  A batch of encoded scenarios (:class:`ScenarioArrays`,
every leaf ``[N, ...]``) is stepped to completion and reduced by
:func:`job_metrics` / :func:`scenario_metrics`.  Single-job batches step
through the ``mr_epoch`` kernel (``kernels.mr_sched.epoch_schedule``: the
CUDA kernel on the card, its plain PyTorch version on the CPU); batches
with more than one job column step through the engine's own epoch body
(:func:`simulate_arrays`: the reference's ``_epoch_step`` with its T×T
admission rank, in plain tensor ops on the batch's device, open loop,
``control`` and ``trace`` lowerings).  Either runs densely
(:func:`simulate_batch_arrays`) or in chunks over the still-active lanes
(:func:`simulate_batch_arrays_compact`).

Every float op keeps the JAX package's op sequence, one rounding per op, so
schedules are bitwise equal to the reference.  Sums run in one fixed order
(:func:`_sum`, :func:`_fold`), never through a library reduction whose order
depends on the device, and the reference's products with 0/1 matrices are
gathers and integer counts, so a run on the card and one on the CPU give
the same bits.  Batches with closed-loop inputs (failures, autoscale
reserves, deadline policies, preemption) step through the control lowering.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import elasticity, network, storage
from .config import BindingPolicy, Scenario, base_task_lengths_f32
from .control import (ControlPolicy, DeadlinePolicy, earliest_finish,
                      failover_targets, scenario_control)
from .telemetry import (EV_FINISH, EV_KILL, EV_PREEMPT, EV_SCALE_CLOSE,
                        EV_SCALE_OPEN, EV_SHED, EV_START, N_TS_COLS,
                        TraceBuffers, event_capacity, timeseries_capacity)
from .util import fma32, validate_pow2_floor

_BIG = 1e30          # stand-in for +inf that survives arithmetic
_TIME_EPS = 1e-6     # relative tie window for simultaneous events

F32, I32 = torch.float32, torch.int32


# ---------------------------------------------------------------------------
# Array-of-structs scenario encoding
# ---------------------------------------------------------------------------

class ScenarioArrays(NamedTuple):
    """A batch of scenarios as fixed-shape tensors, lane dimension first.

    Shapes: N lanes, T padded tasks, J padded jobs, V padded VMs.  Per-cell
    scalars are ``[N]``.  Field order and meaning follow the JAX package's
    ``engine.ScenarioArrays``.
    """
    # tasks
    task_job: torch.Tensor        # i32[N, T]
    task_is_reduce: torch.Tensor  # bool[N, T]
    task_vm: torch.Tensor         # i32[N, T] policy-resolved VM binding
    task_valid: torch.Tensor      # bool[N, T]
    task_mult: torch.Tensor       # f32[N, T] straggler length multiplier
    # jobs
    job_length: torch.Tensor      # f32[N, J] MI
    job_data: torch.Tensor        # f32[N, J] MB
    job_n_maps: torch.Tensor      # i32[N, J]
    job_n_reduces: torch.Tensor   # i32[N, J]
    job_submit: torch.Tensor      # f32[N, J]
    job_reduce_factor: torch.Tensor  # f32[N, J]
    job_valid: torch.Tensor       # bool[N, J]
    # vms
    vm_mips: torch.Tensor         # f32[N, V]
    vm_pes: torch.Tensor          # f32[N, V]
    vm_cost: torch.Tensor         # f32[N, V]
    vm_valid: torch.Tensor        # bool[N, V]
    # network
    net_enabled: torch.Tensor     # f32[N] (0/1)
    net_bw: torch.Tensor          # f32[N]
    kappa_in: torch.Tensor        # f32[N]
    kappa_shuffle: torch.Tensor   # f32[N]
    net_cost_per_unit: torch.Tensor  # f32[N]
    # policies
    sched_policy: torch.Tensor    # i32[N] (0 time-shared | 1 space-shared)
    binding_policy: torch.Tensor  # i32[N] (provenance: resolved in task_vm)
    # storage (DESIGN.md §7)
    block_vm: torch.Tensor        # i32[N, T, V] replica VMs, -1 = no slot
    block_size: torch.Tensor      # f32[N, T] input-block size in MB
    storage_enabled: torch.Tensor  # f32[N]
    # elasticity (DESIGN.md §8)
    vm_start: torch.Tensor        # f32[N, V] lease start
    vm_stop: torch.Tensor         # f32[N, V] lease stop; _BIG = never
    spinup_delay: torch.Tensor    # f32[N]
    bill_gran: torch.Tensor       # f32[N]
    task_prio: torch.Tensor       # f32[N, T] space-shared admission prio
    # closed-loop control (DESIGN.md §10)
    vm_fail: torch.Tensor         # f32[N, V]; _BIG = never fails
    vm_restore: torch.Tensor      # f32[N, V]
    vm_auto: torch.Tensor         # bool[N, V] autoscale reserve
    control_policy: torch.Tensor  # i32[N]
    ctl_queue: torch.Tensor       # f32[N]
    ctl_busy: torch.Tensor        # f32[N]
    redispatch_delay: torch.Tensor  # f32[N]
    # graceful degradation (DESIGN.md §11)
    task_deadline: torch.Tensor   # f32[N, T]; _BIG = none
    deadline_policy: torch.Tensor  # i32[N]
    deadline_slack: torch.Tensor  # f32[N]
    preempt: torch.Tensor         # i32[N]
    preempt_resume: torch.Tensor  # i32[N]


class SimOutput(NamedTuple):
    """Raw per-task schedule + bookkeeping, lane dimension first."""
    start: torch.Tensor      # f32[N, T]
    finish: torch.Tensor     # f32[N, T]
    ready: torch.Tensor      # f32[N, T]
    exec_time: torch.Tensor  # f32[N, T]
    n_epochs: torch.Tensor   # i32[N] event epochs executed per lane
    finish_time: torch.Tensor  # f32[N] last completion
    hit: torch.Tensor        # bool[N, T] (all false open-loop)
    task_vm2: torch.Tensor   # i32[N, T] failover binding
    vm_open: torch.Tensor    # f32[N, V] realized lease open
    vm_close: torch.Tensor   # f32[N, V] realized lease close
    n_scale: torch.Tensor    # i32[N]
    shed: torch.Tensor       # bool[N, T]
    n_evict: torch.Tensor    # i32[N, T]
    work_lost: torch.Tensor  # f32[N]


class JobMetrics(NamedTuple):
    """Paper §5.3 dependent variables, per job: ``f32[N, J]``."""
    avg_exec: torch.Tensor
    max_exec: torch.Tensor
    min_exec: torch.Tensor
    makespan: torch.Tensor
    delay_time: torch.Tensor
    vm_cost: torch.Tensor
    network_cost: torch.Tensor
    map_avg_exec: torch.Tensor
    reduce_avg_exec: torch.Tensor
    completion: torch.Tensor


class ScenarioMetrics(NamedTuple):
    """Per-scenario dependent variables for sweep results (``[N]``)."""
    finish_time: torch.Tensor
    utilization: torch.Tensor
    n_epochs: torch.Tensor
    locality_fraction: torch.Tensor
    transfer_bytes: torch.Tensor
    billed_cost: torch.Tensor
    vm_busy_fraction: torch.Tensor
    queue_wait: torch.Tensor
    failures_injected: torch.Tensor
    tasks_redispatched: torch.Tensor
    scale_events: torch.Tensor
    recovered_fraction: torch.Tensor
    deadline_miss_fraction: torch.Tensor
    shed_tasks: torch.Tensor
    preemptions: torch.Tensor
    wasted_work_frac: torch.Tensor
    p99_slack: torch.Tensor


_BOOL_FIELDS = frozenset({"task_is_reduce", "task_valid", "job_valid",
                          "vm_valid", "vm_auto"})
_INT_FIELDS = frozenset({"task_job", "task_vm", "job_n_maps",
                         "job_n_reduces", "sched_policy", "binding_policy",
                         "block_vm", "control_policy", "deadline_policy",
                         "preempt", "preempt_resume"})


def _field_dtype(name: str) -> torch.dtype:
    if name in _BOOL_FIELDS:
        return torch.bool
    return I32 if name in _INT_FIELDS else F32


def scenario_arrays_from_numpy(d, device="cuda") -> ScenarioArrays:
    """Build a :class:`ScenarioArrays` batch from a mapping of numpy arrays
    keyed by field name (e.g. the JAX package's batch as
    ``{k: np.asarray(v) for k, v in batch._asdict().items()}``), each leaf
    led by the lane dimension."""
    return ScenarioArrays(**{
        k: torch.tensor(np.asarray(d[k]), dtype=_field_dtype(k),
                        device=device)
        for k in ScenarioArrays._fields})


def to_numpy(tree) -> dict:
    """A NamedTuple of tensors as ``{field: numpy array}``."""
    return {k: v.detach().cpu().numpy() for k, v in tree._asdict().items()}


# ---------------------------------------------------------------------------
# Fixed-order reductions
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim strictly left to right, from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of XLA:CPU's reduce, which the
    reference's ``jnp.sum`` lowers to: left to right up to 32 terms; longer
    rows are cut into 32-wide windows (the row centred, its padding split
    low-half first), each window summed left to right and the window sums
    reduced the same way again.  (Where XLA fuses a reduce into its
    producer, LLVM may vectorise it into another order; ROADMAP C5.)"""
    n = x.shape[-1]
    if n <= 32:
        return _fold(x)
    k = -(-n // 32)
    lo = (32 * k - n) // 2
    parts = []
    for c in range(k):
        a, b = max(32 * c - lo, 0), min(32 * c + 32 - lo, n)
        parts.append(_fold(x[..., a:b]))
    return _sum(torch.stack(parts, dim=-1))


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def task_lengths(sc: ScenarioArrays) -> torch.Tensor:
    """Effective per-task lengths in MI (straggler multiplier applied)."""
    map_len = sc.job_length / sc.job_n_maps.to(F32)
    red_len = sc.job_reduce_factor * sc.job_length / sc.job_n_reduces.to(F32)
    job = sc.task_job.long()
    task_len = torch.where(sc.task_is_reduce, torch.gather(red_len, 1, job),
                           torch.gather(map_len, 1, job)) * sc.task_mult
    return torch.where(sc.task_valid, task_len, torch.zeros_like(task_len))


def _greedy_scan(task_valid, task_len, vm_mips, vm_pes_f, load0, cand=None):
    """LEAST_LOADED's greedy float32 scan over tasks in submission order,
    ``cand [N, T, V]`` restricting each task's argmin (LOCALITY)."""
    N, T = task_valid.shape
    V = vm_mips.shape[1]
    iota = torch.arange(V, device=task_len.device)
    load = load0
    out = torch.zeros((N, T), dtype=I32, device=task_len.device)
    big = torch.full_like(load0, _BIG)
    zero = torch.zeros((N,), dtype=F32, device=task_len.device)
    for i in range(T):
        key = load if cand is None else torch.where(cand[:, i], load, big)
        v = torch.argmin(key, dim=1)
        cap = (torch.gather(vm_mips, 1, v[:, None])[:, 0]
               * torch.gather(vm_pes_f, 1, v[:, None])[:, 0])
        add = torch.where(task_valid[:, i], task_len[:, i] / cap, zero)
        load = load + torch.where(iota[None, :] == v[:, None], add[:, None],
                                  torch.zeros_like(load))
        out[:, i] = v.to(I32)
    return out


def bind_tasks(binding_policy, task_valid, task_len, vm_mips, vm_pes,
               vm_valid, locality_cand=None) -> torch.Tensor:
    """Resolve the broker's task→VM binding as data (DESIGN.md §3.2).

    ``binding_policy`` is an i32 ``[N]`` tensor (one policy per lane) or a
    Python int shared by the batch; only the strategies the batch can take
    are computed.  ``task_len`` is the *base* length (pre-straggler); the
    LEAST_LOADED estimate ``assigned_MI / (mips * pes)`` accumulates in
    float32 exactly as the reference does.  ``locality_cand [N, T, V]`` is
    LOCALITY's candidate mask; ``None`` binds LOCALITY as LEAST_LOADED.
    """
    dev = task_len.device
    N, T = task_valid.shape
    if isinstance(binding_policy, int):
        wanted = {int(binding_policy)}
        bp = torch.full((N,), int(binding_policy), dtype=I32, device=dev)
    else:
        bp = binding_policy.to(I32)
        wanted = set(torch.unique(bp).tolist())
    validi = task_valid.to(I32)
    counter = torch.cumsum(validi, dim=1, dtype=I32) - validi
    strategies = {}
    if BindingPolicy.ROUND_ROBIN in wanted:
        n_vms = torch.clamp(vm_valid.to(I32).sum(dim=1, dtype=I32), min=1)
        strategies[BindingPolicy.ROUND_ROBIN] = torch.remainder(
            counter, n_vms[:, None])
    if BindingPolicy.PACKED in wanted:
        pes_i = torch.where(vm_valid, vm_pes.to(I32),
                            torch.zeros_like(vm_pes, dtype=I32))
        total = torch.clamp(pes_i.sum(dim=1, dtype=I32), min=1)
        slot = torch.remainder(counter, total[:, None])
        cum = torch.cumsum(pes_i, dim=1, dtype=I32)
        strategies[BindingPolicy.PACKED] = (
            slot[:, :, None] >= cum[:, None, :]).sum(dim=2, dtype=I32)
    load0 = torch.where(vm_valid, torch.zeros_like(vm_mips),
                        torch.full_like(vm_mips, _BIG))
    vm_pes_f = vm_pes.to(F32)
    # LOCALITY, and any id outside the enum, take the masked scan
    need_loc = any(p not in (0, 1, 2) for p in wanted)
    ll = None
    if BindingPolicy.LEAST_LOADED in wanted or (
            need_loc and locality_cand is None):
        ll = _greedy_scan(task_valid, task_len, vm_mips, vm_pes_f, load0)
        strategies[BindingPolicy.LEAST_LOADED] = ll
    if need_loc:
        strategies[BindingPolicy.LOCALITY] = (
            ll if locality_cand is None else _greedy_scan(
                task_valid, task_len, vm_mips, vm_pes_f, load0,
                locality_cand))
    vm = torch.zeros((N, T), dtype=I32, device=dev)
    for p, choice in strategies.items():
        if p == BindingPolicy.LOCALITY:
            sel = (bp != 0) & (bp != 1) & (bp != 2)
        else:
            sel = bp == int(p)
        vm = torch.where(sel[:, None], choice.to(I32), vm)
    return torch.where(task_valid, vm, torch.zeros_like(vm))


# ---------------------------------------------------------------------------
# Host encoder
# ---------------------------------------------------------------------------

def from_scenario(sc: Scenario, *, pad_tasks: int | None = None,
                  pad_jobs: int | None = None,
                  pad_vms: int | None = None) -> dict[str, np.ndarray]:
    """Encode one :class:`Scenario` into padded numpy arrays, one entry per
    :class:`ScenarioArrays` field without the lane dimension (stack them
    and pass them to :func:`scenario_arrays_from_numpy`)."""
    T = pad_tasks or sc.total_tasks()
    J = pad_jobs or len(sc.jobs)
    V = pad_vms or len(sc.vms)
    if T < sc.total_tasks() or J < len(sc.jobs) or V < len(sc.vms):
        raise ValueError(
            f"from_scenario: padding too small — need pad_tasks>="
            f"{sc.total_tasks()} (got {T}), pad_jobs>={len(sc.jobs)} "
            f"(got {J}), pad_vms>={len(sc.vms)} (got {V})")
    f32 = np.float32
    t_job = np.zeros(T, np.int32)
    t_red = np.zeros(T, bool)
    t_val = np.zeros(T, bool)
    t_prio = np.zeros(T, f32)
    t_len = np.zeros(T, f32)
    t_dl = np.full(T, _BIG, f32)
    k = 0
    for ji, job in enumerate(sc.jobs):
        map_l, red_l = base_task_lengths_f32(
            f32(job.length_mi), f32(job.n_maps), f32(job.n_reduces),
            f32(job.reduce_factor))
        for phase, n in ((False, job.n_maps), (True, job.n_reduces)):
            for _ in range(n):
                t_job[k], t_red[k], t_val[k] = ji, phase, True
                t_len[k] = red_l if phase else map_l
                t_prio[k] = job.priority
                t_dl[k] = f32(min(job.deadline, _BIG))
                k += 1

    vm_mips = _padf([v.mips for v in sc.vms], V, fill=1.0)
    vm_pes = _padf([v.pes for v in sc.vms], V, fill=1.0)
    vm_valid = np.arange(V) < len(sc.vms)
    block_vm = np.full((T, V), -1, np.int32)
    block_mb = np.zeros(T, f32)
    bvm, bmb = storage.scenario_placement(sc, V)
    block_vm[:len(bvm)] = bvm
    block_mb[:len(bmb)] = bmb
    vm_fail, vm_restore, vm_auto = scenario_control(sc, V)

    if sc.binding_policy in (BindingPolicy.LEAST_LOADED,
                             BindingPolicy.LOCALITY):
        tt = torch.as_tensor
        cand = None
        if sc.binding_policy == BindingPolicy.LOCALITY:
            cand = storage.locality_candidates(tt(block_vm)[None],
                                               tt(vm_valid)[None])
        t_vm = bind_tasks(int(sc.binding_policy), tt(t_val)[None],
                          tt(t_len)[None], tt(vm_mips)[None],
                          tt(vm_pes)[None], tt(vm_valid)[None],
                          locality_cand=cand)[0].numpy()
    else:
        counter = np.cumsum(t_val) - t_val      # submission-order index
        if sc.binding_policy == BindingPolicy.PACKED:
            slots = np.repeat(np.arange(len(sc.vms)),
                              [int(v.pes) for v in sc.vms])
            t_vm = slots[counter % len(slots)]
        else:                                   # ROUND_ROBIN
            t_vm = counter % len(sc.vms)
        t_vm = np.where(t_val, t_vm, 0).astype(np.int32)
    return dict(
        task_job=t_job, task_is_reduce=t_red, task_vm=t_vm, task_valid=t_val,
        task_mult=np.ones(T, f32),
        job_length=_padf([j.length_mi for j in sc.jobs], J),
        job_data=_padf([j.data_mb for j in sc.jobs], J),
        job_n_maps=_padi([j.n_maps for j in sc.jobs], J),
        job_n_reduces=_padi([j.n_reduces for j in sc.jobs], J),
        job_submit=_padf([j.submit_time for j in sc.jobs], J),
        job_reduce_factor=_padf([j.reduce_factor for j in sc.jobs], J),
        job_valid=np.arange(J) < len(sc.jobs),
        vm_mips=vm_mips, vm_pes=vm_pes,
        vm_cost=_padf([v.cost_per_sec for v in sc.vms], V),
        vm_valid=vm_valid,
        net_enabled=f32(1.0 if sc.network.enabled else 0.0),
        net_bw=f32(sc.network.bw_mbps),
        kappa_in=f32(sc.network.kappa_in),
        kappa_shuffle=f32(sc.network.kappa_shuffle),
        net_cost_per_unit=f32(sc.network.cost_per_unit),
        sched_policy=np.int32(sc.sched_policy),
        binding_policy=np.int32(sc.binding_policy),
        block_vm=block_vm, block_size=block_mb,
        storage_enabled=f32(1.0 if sc.storage.enabled else 0.0),
        vm_start=_padf([v.lease_start for v in sc.vms], V),
        vm_stop=_padf([elasticity.encode_lease_stop(v.lease_stop)
                       for v in sc.vms], V, fill=_BIG),
        spinup_delay=f32(sc.elasticity.spinup_delay),
        bill_gran=f32(sc.elasticity.billing_granularity),
        task_prio=t_prio,
        vm_fail=vm_fail, vm_restore=vm_restore, vm_auto=vm_auto,
        control_policy=np.int32(sc.control.policy),
        ctl_queue=f32(sc.control.queue_threshold),
        ctl_busy=f32(sc.control.busy_threshold),
        redispatch_delay=f32(sc.control.redispatch_delay),
        task_deadline=t_dl,
        deadline_policy=np.int32(sc.control.deadline_policy),
        deadline_slack=f32(sc.control.deadline_slack),
        preempt=np.int32(bool(sc.control.preempt)),
        preempt_resume=np.int32(bool(sc.control.preempt_resume)),
    )


def _padf(xs, n, fill=0.0):
    out = np.full(n, fill, np.float32)
    out[:len(xs)] = xs
    return out


def _padi(xs, n):
    out = np.ones(n, np.int32)
    out[:len(xs)] = xs
    return out


def _control_active(sc: ScenarioArrays) -> bool:
    """Whether the batch encodes any closed-loop input (failures, reserves,
    a control or deadline policy, preemption)."""
    vv = sc.vm_valid
    return bool((vv & (sc.vm_fail < _BIG / 2)).any() or (vv & sc.vm_auto).any()
                or (sc.control_policy != 0).any()
                or (sc.deadline_policy != 0).any() or (sc.preempt != 0).any())


def _bound_terms(T: int, V: int, any_fail, any_shed, preempt_on):
    """The additive per-lane epoch bound from its three triggers (i32
    ``[N]``): ``2T + 2``, plus ``2T + V`` for a lane that encodes a VM
    failure, ``T + 1`` for a SHED lane with a deadline and ``2T`` for a
    preempting lane."""
    zero = torch.zeros(any_fail.shape, dtype=I32, device=any_fail.device)
    return (2 * T + 2
            + torch.where(any_fail, zero + (2 * T + V), zero)
            + torch.where(any_shed, zero + (T + 1), zero)
            + torch.where(preempt_on, zero + 2 * T, zero))


def _lane_bound(sc: ScenarioArrays) -> torch.Tensor:
    """Per-lane epoch bound of the closed loop (i32 ``[N]``).

    Open loop, every live epoch fires a start or a completion: ``2T + 2``.
    Each mechanism widens it additively, and only for lanes whose data can
    trigger it, so degenerate lanes keep the open-loop bound: failures
    (a task restarts at most twice, plus ``V`` failure instants), deadline
    shedding (epochs that only shed) and preemption (two evictions per
    task)."""
    T, V = sc.task_valid.shape[1], sc.vm_valid.shape[1]
    any_fail = (sc.vm_valid & (sc.vm_fail < _BIG / 2)).any(dim=1)
    any_shed = (sc.deadline_policy == int(DeadlinePolicy.SHED)) \
        & (sc.task_valid & (sc.task_deadline < _BIG / 2)).any(dim=1)
    return _bound_terms(T, V, any_fail, any_shed, sc.preempt != 0)


# ---------------------------------------------------------------------------
# Simulation
# ---------------------------------------------------------------------------

def _sim_output(sc: ScenarioArrays, start, finish, ready, n_epochs,
                task_vm2, control=None) -> SimOutput:
    """Shape a schedule into :class:`SimOutput`.

    ``control`` holds a closed-loop run's seven realized control leaves
    ``(hit, vm_open, vm_close, n_scale [N], shed, n_evict, work_lost
    [N])``; without it (open loop) they are the encoded scenario.  Shed
    tasks never finish and leave the makespan.  ``task_vm2`` is the
    failover binding, reported by both lowerings."""
    zero = torch.zeros_like(start)
    exec_time = torch.where(sc.task_valid, finish - start, zero)
    N = start.shape[0]
    if control is None:
        control = (torch.zeros_like(sc.task_valid), sc.vm_start.to(F32),
                   sc.vm_stop.to(F32),
                   torch.zeros(N, dtype=I32, device=start.device),
                   torch.zeros_like(sc.task_valid),
                   torch.zeros_like(sc.task_vm),
                   torch.zeros(N, dtype=F32, device=start.device))
    hit, vm_open, vm_close, n_scale, shed, n_evict, work_lost = control
    finish_time = torch.where(sc.task_valid & ~shed, finish,
                              zero).amax(dim=1)
    return SimOutput(start=start, finish=finish, ready=ready,
                     exec_time=exec_time, n_epochs=n_epochs,
                     finish_time=finish_time, hit=hit, task_vm2=task_vm2,
                     vm_open=vm_open, vm_close=vm_close, n_scale=n_scale,
                     shed=shed, n_evict=n_evict, work_lost=work_lost)


def _trace_caps(T: int, V: int, control: bool, trace: bool,
                trace_events: int | None) -> tuple[int, int] | None:
    """Trace capacities ``(time-series rows, event-log rows)``, or ``None``
    when off: the per-lane epoch bound, and the worst-case event count
    unless ``trace_events`` sets it."""
    if not trace:
        return None
    ev = (int(trace_events) if trace_events is not None
          else event_capacity(T, V, control))
    return (timeseries_capacity(T, V, control), ev)


def _trace_of(leaves) -> TraceBuffers:
    """The six trace leaves of an ``mr_epoch`` carry as lane-stacked
    :class:`TraceBuffers` (``ts [N, C, 8]``, ``ev_n [N]``)."""
    ts, ev_t, ev_kind, ev_task, ev_vm, ev_n = leaves
    return TraceBuffers(ts=ts.reshape(ts.shape[0], -1, N_TS_COLS),
                        ev_t=ev_t, ev_kind=ev_kind, ev_task=ev_task,
                        ev_vm=ev_vm, ev_n=ev_n[:, 0])


# ---------------------------------------------------------------------------
# The engine's own epoch body (any number of jobs per lane)
# ---------------------------------------------------------------------------

# lanes one pass of the engine body steps at once, as a budget on N * T^2:
# the admission rank compares every pair of a lane's tasks, so each of its
# [N, T, T] masks takes N * T^2 bytes (134 MB at the budget)
LANE_BUDGET = 1 << 27
# epochs the engine body runs on the card between two looks at whether any
# lane is still active (each look waits for the card); finished lanes are
# frozen, so the steps past the end change nothing
CHECK_EVERY_CUDA = 4


class _Carry(NamedTuple):
    """The engine body's event-loop state, every leaf led by the lane dim.

    The control leaves are ``None`` unless the ``control`` flag is on, the
    trace leaves unless ``trace`` is.  The trace buffers hold one row
    (``ts``) and one column (``ev_*``) past their capacity, which take the
    writes that do not fit, so that no epoch has to ask the device how many
    do; :func:`_engine_trace` drops them."""
    time: torch.Tensor       # f32[N]
    rem: torch.Tensor        # f32[N, T] remaining MI
    running: torch.Tensor    # bool[N, T]
    start: torch.Tensor      # f32[N, T]
    finish: torch.Tensor     # f32[N, T]
    ready: torch.Tensor      # f32[N, T]
    maps_left: torch.Tensor  # i32[N, J]
    epoch: torch.Tensor      # i32[N] realized event epochs of the lane
    hit: torch.Tensor | None = None        # bool[N, T] killed at least once
    vm_open: torch.Tensor | None = None    # f32[N, V] realized lease open
    vm_close: torch.Tensor | None = None   # f32[N, V] realized lease close
    n_scale: torch.Tensor | None = None    # i32[N] autoscale events
    shed: torch.Tensor | None = None       # bool[N, T] deadline-shed
    n_evict: torch.Tensor | None = None    # i32[N, T] preemptions per task
    work_lost: torch.Tensor | None = None  # f32[N] discarded progress (MI)
    ts: torch.Tensor | None = None         # f32[N, C + 1, 8] time series
    ev_t: torch.Tensor | None = None       # f32[N, E + 1] event times
    ev_kind: torch.Tensor | None = None    # i32[N, E + 1] kinds (-1 empty)
    ev_task: torch.Tensor | None = None    # i32[N, E + 1] task (-1 scale)
    ev_vm: torch.Tensor | None = None      # i32[N, E + 1] VM
    ev_n: torch.Tensor | None = None       # i32[N] events attempted


class _EpochInv(NamedTuple):
    """Per-lane quantities every epoch reads, led by the lane dim.

    The reference's one-hot task→VM and task→job matrices become gather
    indices: ``vm_idx`` (the bound VM, clamped into ``[0, V)``) with
    ``vm_in`` (whether it is in range: a one-hot row outside is all zero),
    and ``job_idx``.  The control leaves (``None`` unless ``control``) are
    the failover slot and its gathers and the failure/restore instants of
    both slots."""
    shuffle: torch.Tensor    # f32[N, J]
    task_pes: torch.Tensor   # f32[N, T] vm_pes[task_vm]
    vm_idx: torch.Tensor     # i64[N, T]
    vm_in: torch.Tensor      # bool[N, T]
    job_idx: torch.Tensor    # i64[N, T]
    is_space: torch.Tensor   # bool[N]
    avail_t: torch.Tensor    # f32[N, T] bound VM's admission opening
    close_t: torch.Tensor    # f32[N, T] bound VM's lease stop
    bound: torch.Tensor      # i32[N] the lane's epoch bound
    task_len: torch.Tensor | None = None   # f32[N, T] (kill reset)
    task_vm2: torch.Tensor | None = None   # i32[N, T] failover binding
    vm_idx2: torch.Tensor | None = None    # i64[N, T]
    vm_in2: torch.Tensor | None = None     # bool[N, T]
    task_pes2: torch.Tensor | None = None  # f32[N, T]
    refetch: torch.Tensor | None = None    # f32[N, T] re-replication fetch
    fail1: torch.Tensor | None = None      # f32[N, T] vm_fail[task_vm]
    rest1: torch.Tensor | None = None      # f32[N, T] vm_restore[task_vm]
    fail2: torch.Tensor | None = None      # f32[N, T] vm_fail[task_vm2]
    rest2: torch.Tensor | None = None      # f32[N, T] vm_restore[task_vm2]


def _slot(vm: torch.Tensor, V: int):
    """``(gather index, in range)`` of a task→VM binding."""
    return vm.clamp(0, V - 1).long(), (vm >= 0) & (vm < V)


def _at(per: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each task's entry of a per-VM (or per-job) row, as the reference's
    indexing gives it (an index outside the row clamps)."""
    return torch.gather(per, 1, idx)


def _onehot_at(per_vm: torch.Tensor, idx: torch.Tensor,
               inside: torch.Tensor) -> torch.Tensor:
    """Each task's VM's value as the reference's one-hot product gives it:
    0 for a VM outside ``[0, V)``, and ``+0.0`` where the value is
    ``-0.0`` (a sum that starts from zero)."""
    g = torch.gather(per_vm, 1, idx) + 0.0
    return torch.where(inside, g, torch.zeros_like(g))


def _count_per(idx: torch.Tensor, mask: torch.Tensor, width: int,
               inside: torch.Tensor | None = None) -> torch.Tensor:
    """The exact count of the set tasks per VM (or job), i32 ``[N, width]``:
    the reference's 0/1 product, as an integer scatter."""
    if inside is not None:
        mask = mask & inside
    out = torch.zeros((idx.shape[0], width), dtype=I32, device=idx.device)
    return out.scatter_add_(1, idx, mask.to(I32))


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The reference's float sum of a 0/1 row: an exact count, f32."""
    return mask.sum(dim=1, dtype=I32).to(F32)


def _active_lanes(valid, finish, shed=None, n_epochs=None, bound=None):
    """The lanes still to step (bool ``[N]``): a valid task is unfinished,
    not counting shed tasks (``shed``: they never finish), and where
    ``bound`` is given the lane's ``n_epochs`` (``[N, 1]``) is below its
    own epoch bound.  Shared by the engine body and the ``mr_epoch``
    compaction loop."""
    unfin = (valid != 0) & (finish >= _BIG / 2)
    if shed is not None:
        unfin &= shed == 0
    act = unfin.any(dim=1)
    if bound is not None:
        act &= n_epochs[:, 0] < bound
    return act


def _lane_active(sc: ScenarioArrays, c: _Carry,
                 inv: _EpochInv) -> torch.Tensor:
    """A lane still takes epochs: unfinished work below its epoch bound."""
    return _active_lanes(sc.task_valid, c.finish, c.shed, c.epoch[:, None],
                         inv.bound)


def _epoch_setup(sc: ScenarioArrays, *, control: bool = False,
                 trace: tuple[int, int] | None = None
                 ) -> tuple[_EpochInv, _Carry]:
    """Derived quantities and the t=0 carry of a batch (the reference's
    ``_epoch_setup``).  ``trace`` is the ``(time-series rows, event-log
    rows)`` capacity pair, ``None`` without a trace."""
    N, T = sc.task_valid.shape
    J, V = sc.job_length.shape[1], sc.vm_mips.shape[1]
    dev = sc.task_vm.device
    col = lambda x: x[:, None]                                 # noqa: E731
    n_maps_f = sc.job_n_maps.to(F32)
    stage_in = network.transfer_delay(col(sc.kappa_in), sc.job_data, n_maps_f,
                                      col(sc.net_bw), col(sc.net_enabled))
    shuffle = network.transfer_delay(col(sc.kappa_shuffle), sc.job_data,
                                     n_maps_f, col(sc.net_bw),
                                     col(sc.net_enabled))
    task_len = task_lengths(sc)
    fetch = storage.remote_fetch_delay(sc.block_vm, sc.block_size, sc.task_vm,
                                       col(sc.kappa_in), col(sc.net_bw),
                                       col(sc.net_enabled))
    job_idx = sc.task_job.clamp(0, J - 1).long()
    is_map = sc.task_valid & ~sc.task_is_reduce
    ready0 = torch.where(is_map, _at(sc.job_submit + stage_in, job_idx)
                         + fetch, torch.full_like(fetch, _BIG))
    vm_idx, vm_in = _slot(sc.task_vm, V)
    if control:
        bound = _lane_bound(sc)
    else:
        bound = torch.full((N,), 2 * T + 2, dtype=I32, device=dev)
    inv = _EpochInv(
        shuffle=shuffle, task_pes=_at(sc.vm_pes, vm_idx), vm_idx=vm_idx,
        vm_in=vm_in, job_idx=job_idx, is_space=sc.sched_policy == 1,
        avail_t=_at(sc.vm_start + col(sc.spinup_delay), vm_idx),
        close_t=_at(sc.vm_stop, vm_idx), bound=bound)
    ft = torch.full((N, T), _BIG, dtype=F32, device=dev)
    c0 = _Carry(time=torch.zeros(N, dtype=F32, device=dev), rem=task_len,
                running=torch.zeros((N, T), dtype=torch.bool, device=dev),
                start=ft, finish=ft.clone(), ready=ready0,
                maps_left=_count_per(job_idx, is_map, J),
                epoch=torch.zeros(N, dtype=I32, device=dev))
    if control:
        task_vm2 = failover_targets(sc.task_vm, sc.vm_valid, sc.vm_auto,
                                    sc.block_vm)
        vm_idx2, vm_in2 = _slot(task_vm2, V)
        inv = inv._replace(
            task_len=task_len, task_vm2=task_vm2, vm_idx2=vm_idx2,
            vm_in2=vm_in2, task_pes2=_at(sc.vm_pes, vm_idx2),
            refetch=storage.remote_fetch_delay(
                sc.block_vm, sc.block_size, task_vm2, col(sc.kappa_in),
                col(sc.net_bw), col(sc.net_enabled)),
            fail1=_at(sc.vm_fail, vm_idx), rest1=_at(sc.vm_restore, vm_idx),
            fail2=_at(sc.vm_fail, vm_idx2), rest2=_at(sc.vm_restore, vm_idx2))
        c0 = c0._replace(
            hit=torch.zeros((N, T), dtype=torch.bool, device=dev),
            vm_open=torch.where(sc.vm_auto, torch.full_like(sc.vm_start, _BIG),
                                sc.vm_start),
            vm_close=sc.vm_stop.clone(),
            n_scale=torch.zeros(N, dtype=I32, device=dev),
            shed=torch.zeros((N, T), dtype=torch.bool, device=dev),
            n_evict=torch.zeros((N, T), dtype=I32, device=dev),
            work_lost=torch.zeros(N, dtype=F32, device=dev))
    if trace is not None:
        C, E = trace
        c0 = c0._replace(
            ts=torch.zeros((N, C + 1, N_TS_COLS), dtype=F32, device=dev),
            ev_t=torch.zeros((N, E + 1), dtype=F32, device=dev),
            ev_kind=torch.full((N, E + 1), -1, dtype=I32, device=dev),
            ev_task=torch.full((N, E + 1), -1, dtype=I32, device=dev),
            ev_vm=torch.full((N, E + 1), -1, dtype=I32, device=dev),
            ev_n=torch.zeros(N, dtype=I32, device=dev))
    return inv, c0


def _ahead(same_vm, prio, key, earlier, urg=None):
    """``[N, i, j]``: task j is on task i's VM and the space-shared
    admission takes it first, by (urgency desc, priority desc, eligible
    time asc, index asc)."""
    pi, pj = prio[:, :, None], prio[:, None, :]
    ki, kj = key[:, :, None], key[:, None, :]
    first = (pj > pi) | ((pj == pi) & ((kj < ki) | ((kj == ki) & earlier)))
    if urg is not None:
        ui, uj = urg[:, :, None], urg[:, None, :]
        first = (uj > ui) | ((uj == ui) & first)
    return same_vm & first


def _epoch_step(sc: ScenarioArrays, inv: _EpochInv, c: _Carry,
                act: torch.Tensor, *, control: bool = False,
                trace: bool = False) -> _Carry:
    """Advance every lane one event epoch (the reference's ``_epoch_step``,
    batch-native).  Each leaf of a lane that ``act`` marks finished keeps
    its value, so a lane stops at its own end whatever its batch mates do
    (ROADMAP C6), and ``epoch`` counts the lane's own epochs.

    Rates follow from the per-VM counts of running tasks; the next event is
    the earliest completion, lease-gated arrival (and under control VM
    failure); completions inside the ``1e-6`` tie window fire together; a
    job's last map releases its reduces after the shuffle delay; arrivals
    start at once on time-shared lanes and by the T×T ``(priority,
    eligible time, index)`` rank into the free PEs on space-shared ones.
    ``control`` adds the AUTOSCALE hook at the opening clock, the
    ``[fail, restore)`` gates, failure kills with failover, SHED at the
    arrival candidate and at the admission instant, preemption, the BOOST
    urgency tier and the shed-orphan rule; ``trace`` records the epoch's
    time-series row and its events (in place, in the buffers' spare slots
    where they do not fit).  No op reads a value back to the host."""
    N, T = sc.task_valid.shape
    J, V = sc.job_length.shape[1], sc.vm_mips.shape[1]
    dev = c.rem.device
    valid, is_red, prio = sc.task_valid, sc.task_is_reduce, sc.task_prio
    zt = torch.zeros_like(c.rem)
    big_t = torch.full_like(c.rem, _BIG)
    now = c.time[:, None]
    tidx = torch.arange(T, device=dev)
    earlier = (tidx[None, :] < tidx[:, None])[None]      # [1, i, j]: j < i
    is_space = inv.is_space[:, None]
    if control:
        hit = c.hit
        vm_idx = torch.where(hit, inv.vm_idx2, inv.vm_idx)
        vm_in = torch.where(hit, inv.vm_in2, inv.vm_in)
        task_pes = torch.where(hit, inv.task_pes2, inv.task_pes)
        f_t = torch.where(hit, inv.fail2, inv.fail1)
        r_t = torch.where(hit, inv.rest2, inv.rest1)
        cur_vm = torch.where(hit, inv.task_vm2, sc.task_vm)
    else:
        vm_idx, vm_in, task_pes = inv.vm_idx, inv.vm_in, inv.task_pes
        cur_vm = sc.task_vm
    same_vm = cur_vm[:, :, None] == cur_vm[:, None, :]

    def vm_counts(mask):
        return _count_per(vm_idx, mask, V, vm_in).to(F32)

    def oh(per_vm):
        return _onehot_at(per_vm, vm_idx, vm_in)

    if control:
        # the control hook at the epoch's opening clock
        pol_on = sc.control_policy == int(ControlPolicy.AUTOSCALE)
        unfinished = valid & (c.finish >= _BIG / 2) & ~c.shed
        qdepth = _count(unfinished & (c.start >= _BIG / 2) & (c.ready <= now))
        busy_v = vm_counts(c.running) > 0.5
        open_v = sc.vm_valid & (c.vm_open + sc.spinup_delay[:, None] <= now) \
            & (now < c.vm_close)
        n_open = _count(open_v)
        busy_frac = _count(open_v & busy_v) / torch.clamp(n_open, min=1.0)
        trigger = pol_on & (qdepth > sc.ctl_queue) & (busy_frac >= sc.ctl_busy)
        reserve = sc.vm_valid & sc.vm_auto
        unopened = reserve & (c.vm_open >= _BIG / 2)
        vidx = torch.arange(V, dtype=I32, device=dev)
        first = torch.where(unopened, vidx, V + 1).amin(dim=1)
        open_mask = trigger[:, None] & unopened & (vidx == first[:, None])
        close_mask = pol_on[:, None] & reserve & (c.vm_open < _BIG / 2) \
            & (now < c.vm_close) & (vm_counts(unfinished) < 0.5)
        now_v = now.expand_as(c.vm_open)
        vm_open = torch.where(open_mask, now_v, c.vm_open)
        vm_close = torch.where(close_mask, now_v, c.vm_close)
        n_scale = c.n_scale + open_mask.sum(dim=1, dtype=I32) \
            + close_mask.sum(dim=1, dtype=I32)
        avail_t = oh(vm_open + sc.spinup_delay[:, None])
        close_t = oh(vm_close)
        mips_t = oh(sc.vm_mips)
        dl_shed = (sc.deadline_policy == int(DeadlinePolicy.SHED))[:, None]
        dl_boost = (sc.deadline_policy == int(DeadlinePolicy.BOOST))[:, None]
        pre_on = ((sc.preempt != 0) & inv.is_space)[:, None]
        res_on = (sc.preempt_resume != 0)[:, None]
    else:
        avail_t, close_t = inv.avail_t, inv.close_t

    n_on_vm = vm_counts(c.running)
    share = sc.vm_mips * torch.minimum(torch.ones_like(sc.vm_mips), sc.vm_pes
                                       / torch.clamp(n_on_vm, min=1.0))
    r = torch.where(c.running, oh(share), zt)
    eta = torch.where(c.running, now + c.rem / torch.clamp(r, min=1e-30),
                      big_t)
    not_started = valid & ~c.running & (c.finish >= _BIG / 2) \
        & (c.start >= _BIG / 2)
    elig = torch.maximum(c.ready, avail_t)
    if control:
        def gate(x):
            """Slide an instant inside its VM's down window to the restore
            edge."""
            return torch.where((x >= f_t) & (x < r_t), r_t, x)

        elig = gate(elig)
        cand_t = gate(torch.maximum(elig, now.expand_as(elig)))
        evaluable = not_started & (elig < _BIG / 2)
        shed_c = c.shed | (dl_shed & evaluable & (cand_t < close_t)
                           & (earliest_finish(cand_t, c.rem, mips_t)
                              > sc.task_deadline))
    else:
        cand_t = torch.maximum(elig, now.expand_as(elig))
    has_slot = (task_pes - oh(n_on_vm)) > 0.5
    if control:
        # a pending task that strictly outranks an evictable running task
        # on its VM defines an arrival even with no free slot
        evictable = c.running & (c.n_evict < 2)
        prey = same_vm & evictable[:, None, :] \
            & (prio[:, :, None] > prio[:, None, :])
        can_pre = pre_on & prey.any(dim=2)
        arr = torch.where(not_started & ~shed_c
                          & (~is_space | has_slot | can_pre)
                          & (cand_t < close_t), cand_t, big_t)
    else:
        arr = torch.where(not_started & (~is_space | has_slot)
                          & (cand_t < close_t), cand_t, big_t)
    t_next = torch.minimum(eta.amin(dim=1), arr.amin(dim=1))
    if control:
        fail_ev = torch.where(sc.vm_valid & (sc.vm_fail > now), sc.vm_fail,
                              torch.full_like(sc.vm_fail, _BIG))
        t_next = torch.minimum(t_next, fail_ev.amin(dim=1))
    live = t_next < _BIG / 2
    tn = t_next[:, None]
    # XLA:CPU fuses the reference's ``t_next + 1e-6 * max(t_next, 1)`` and
    # ``rem - (t_next - time) * r`` into one FMA each: one rounding
    thr = fma32(torch.full_like(t_next, _TIME_EPS),
                torch.clamp(t_next, min=1.0), t_next)[:, None]
    dt = (t_next - c.time)[:, None].expand_as(c.rem)
    rem = torch.where(c.running, fma32(-dt, r, c.rem), c.rem)

    # completions, then each job's map phase releases its reduces
    done_now = live[:, None] & c.running & (eta <= thr)
    finish = torch.where(done_now, tn.expand_as(c.finish), c.finish)
    running = c.running & ~done_now
    rem = torch.where(done_now, zt, rem)
    maps_left = c.maps_left - _count_per(inv.job_idx, done_now & ~is_red, J)
    phase_done = (maps_left == 0) & (c.maps_left > 0)
    red_ready = torch.where(phase_done, tn + inv.shuffle,
                            torch.full_like(inv.shuffle, _BIG))
    ready = torch.where(is_red & _at(phase_done, inv.job_idx),
                        _at(red_ready, inv.job_idx), c.ready)
    start_base = c.start
    if control:
        # failure kills, after completions: the first hit moves the task to
        # its failover slot and pays the re-replication fetch
        fired = live[:, None] & (f_t > now) & (f_t <= tn)
        affected = valid & fired & (finish >= _BIG / 2) & ~shed_c
        first_hit = affected & ~hit
        lost_fail = torch.where(affected, inv.task_len - rem, zt)
        rem = torch.where(affected, inv.task_len, rem)
        running = running & ~affected
        start_base = torch.where(affected, big_t, start_base)
        ready = torch.where(affected, torch.maximum(
            ready, f_t + sc.redispatch_delay[:, None]), ready)
        ready = torch.where(first_hit, ready + inv.refetch, ready)
        hit = hit | first_hit

    eligible = live[:, None] & not_started & (elig <= thr) & (tn < close_t)
    done_v = vm_counts(done_now)
    if control:
        eligible = eligible & ~((tn >= f_t) & (tn < r_t))
        # SHED again at the admission instant
        efin_t = earliest_finish(tn.expand_as(c.rem), c.rem, mips_t)
        shed_t = shed_c | (dl_shed & evaluable & (tn < close_t)
                           & (efin_t > sc.task_deadline))
        eligible = eligible & ~shed_t
        # preemption: on each full space-shared VM the weakest evictable
        # running task (lowest priority, latest index) loses its PE to an
        # eligible task that strictly outranks it
        vic_cand = pre_on & running & (c.n_evict < 2)
        full = (task_pes - oh(n_on_vm - done_v)) <= 0.5
        beats = same_vm & vic_cand[:, :, None] & eligible[:, None, :] \
            & (prio[:, None, :] > prio[:, :, None])
        cand_e = vic_cand & full & beats.any(dim=2)
        weaker = same_vm & cand_e[:, None, :] & (
            (prio[:, None, :] < prio[:, :, None])
            | ((prio[:, None, :] == prio[:, :, None])
               & earlier.transpose(1, 2)))
        evicted = cand_e & ~weaker.any(dim=2)
        restart = evicted & ~res_on
        lost_evict = torch.where(restart, inv.task_len - rem, zt)
        e_first = evicted & ~hit
        rem = torch.where(restart, inv.task_len, rem)
        running = running & ~evicted
        start_base = torch.where(evicted, big_t, start_base)
        ready = torch.where(evicted, torch.maximum(
            ready, (tn + sc.redispatch_delay[:, None]).expand_as(ready)),
            ready)
        ready = torch.where(e_first, ready + inv.refetch, ready)
        hit = hit | e_first
        n_evict = c.n_evict + evicted.to(I32)
        work_lost = c.work_lost + _sum(lost_fail) + _sum(lost_evict)
        free_after = task_pes - oh(n_on_vm - done_v - vm_counts(evicted))
        # BOOST: urgent pending tasks outrank every other task
        urg = (dl_boost & evaluable
               & (efin_t + sc.deadline_slack[:, None] >= sc.task_deadline)
               ).to(F32)
        ahead = _ahead(same_vm, prio, elig, earlier, urg)
    else:
        free_after = task_pes - oh(n_on_vm - done_v)
        ahead = _ahead(same_vm, prio, elig, earlier)
    rank = (ahead & eligible[:, None, :]).sum(dim=2, dtype=I32).to(F32)
    start_now = eligible & (~is_space | (rank < free_after))
    start = torch.where(start_now, tn.expand_as(start_base), start_base)
    running = running | start_now
    time = torch.where(live, t_next, c.time)
    new = dict(time=time, rem=rem, running=running, start=start,
               finish=finish, ready=ready, maps_left=maps_left)
    if control:
        # a job with a shed map can never finish its map phase: its
        # pending reduces are shed too, so they end the lane
        job_dead = _count_per(inv.job_idx, shed_t & ~is_red, J) > 0
        shed = shed_t | (valid & is_red & _at(job_dead, inv.job_idx)
                         & (finish >= _BIG / 2) & ~running)
        new.update(hit=hit, vm_open=vm_open, vm_close=vm_close,
                   n_scale=n_scale, shed=shed, n_evict=n_evict,
                   work_lost=work_lost)
    if trace:
        if control:
            new_shed = shed & ~c.shed
            vals = (qdepth, busy_frac, n_open, _count(affected),
                    _count(new_shed), _count(evicted))
            tv = now.expand(N, V)
            tt = tn.expand(N, T)
            log = ((open_mask, tv, EV_SCALE_OPEN, None),
                   (close_mask, tv, EV_SCALE_CLOSE, None),
                   (done_now, tt, EV_FINISH, cur_vm),
                   (affected, f_t, EV_KILL, cur_vm),
                   (evicted, tt, EV_PREEMPT, cur_vm),
                   (start_now, tt, EV_START, cur_vm),
                   (new_shed, time[:, None].expand(N, T), EV_SHED, cur_vm))
        else:
            # the control hook's observables over the static lease windows
            open_v = sc.vm_valid \
                & (sc.vm_start + sc.spinup_delay[:, None] <= now) \
                & (now < sc.vm_stop)
            n_open = _count(open_v)
            zero = torch.zeros_like(n_open)
            vals = (_count(valid & (c.finish >= _BIG / 2)
                           & (c.start >= _BIG / 2) & (c.ready <= now)),
                    _count(open_v & (vm_counts(c.running) > 0.5))
                    / torch.clamp(n_open, min=1.0), n_open, zero, zero, zero)
            tt = tn.expand(N, T)
            log = ((done_now, tt, EV_FINISH, cur_vm),
                   (start_now, tt, EV_START, cur_vm))
        _record(c, act, time, vals, log)
    def keep(x, old):
        """The new value on an active lane, the old one on a finished."""
        return torch.where(act if x.dim() == 1 else act[:, None], x, old)

    return c._replace(epoch=c.epoch + act.to(I32),
                      **{k: keep(v, getattr(c, k)) for k, v in new.items()})


def _record(c: _Carry, act, time, vals, log) -> None:
    """Write one epoch's trace into the carry's buffers in place: each
    active lane's time-series row at its epoch index, and its events at its
    cursor in ``log`` order, ``(mask, t, kind, vm)`` per group (``vm=None``:
    a per-VM group, whose task is -1).  A write that does not fit, or of an
    inactive lane, lands in the spare row or column; ``ev_n`` counts every
    event.  The reference adds rows through one-hot products: each slot is
    written at most once, and ``+ 0.0`` gives the product's ``+0.0`` for a
    ``-0.0``."""
    N, C1, _ = c.ts.shape
    E = c.ev_t.shape[1] - 1
    row = torch.where(act & (c.epoch < C1 - 1), c.epoch,
                      C1 - 1).long()[:, None, None].expand(N, 1, N_TS_COLS)
    vals = torch.stack((time, *vals[:3], act.to(F32), *vals[3:]), dim=1)
    c.ts.scatter_(1, row, vals[:, None, :] + 0.0)
    mask = torch.cat([m for m, *_ in log], dim=1) & act[:, None]
    dev = mask.device
    t_all = torch.cat([t for _, t, _, _ in log], dim=1) + 0.0
    kind = torch.cat([torch.full(m.shape, k, dtype=I32, device=dev)
                      for m, _, k, _ in log], dim=1)
    task = torch.cat([torch.full(m.shape, -1, dtype=I32, device=dev)
                      if vm is None else
                      torch.arange(m.shape[1], dtype=I32,
                                   device=dev).expand(N, -1)
                      for m, _, _, vm in log], dim=1)
    vm = torch.cat([torch.arange(m.shape[1], dtype=I32,
                                 device=dev).expand(N, -1)
                    if v is None else v.to(I32) for m, _, _, v in log], dim=1)
    mi = mask.to(I32)
    pos = c.ev_n[:, None] + torch.cumsum(mi, dim=1, dtype=I32) - mi
    slot = torch.where(mask & (pos < E), pos, E).long()
    for buf, src in zip((c.ev_t, c.ev_kind, c.ev_task, c.ev_vm),
                        (t_all, kind, task, vm)):
        buf.scatter_(1, slot, src)
    c.ev_n.add_(mi.sum(dim=1, dtype=I32))


def _drive(sc: ScenarioArrays, inv: _EpochInv, c: _Carry, limit: int, *,
           control: bool, trace: bool) -> _Carry:
    """Step a batch up to ``limit`` epochs, or until no lane is active.
    Whether any lane is, is the one value read back to the host: every
    epoch on the CPU, every :data:`CHECK_EVERY_CUDA` epochs on the card."""
    every = CHECK_EVERY_CUDA if c.rem.is_cuda else 1
    act = _lane_active(sc, c, inv)
    n = 0
    while n < limit and bool(act.any()):
        for _ in range(min(every, limit - n)):
            c = _epoch_step(sc, inv, c, act, control=control, trace=trace)
            act = _lane_active(sc, c, inv)
            n += 1
    return c


def _engine_output(sc: ScenarioArrays, inv: _EpochInv, c: _Carry
                   ) -> SimOutput:
    """The :class:`SimOutput` of an engine-body carry."""
    if c.hit is None:
        task_vm2 = failover_targets(sc.task_vm, sc.vm_valid, sc.vm_auto,
                                    sc.block_vm)
        ctl = None
    else:
        task_vm2 = inv.task_vm2
        ctl = (c.hit, c.vm_open, c.vm_close, c.n_scale, c.shed, c.n_evict,
               c.work_lost)
    return _sim_output(sc, c.start, c.finish, c.ready, c.epoch, task_vm2, ctl)


def _engine_trace(c: _Carry) -> TraceBuffers:
    """The trace buffers of an engine-body carry, spare slots dropped."""
    return TraceBuffers(*(x[:, :-1].contiguous() for x in
                          (c.ts, c.ev_t, c.ev_kind, c.ev_task, c.ev_vm)),
                        ev_n=c.ev_n)


def _lane_chunks(batch: ScenarioArrays):
    """The batch cut into runs of lanes within :data:`LANE_BUDGET`."""
    N, T = batch.task_valid.shape
    step = max(1, LANE_BUDGET // max(T * T, 1))
    if N <= step:
        yield batch
        return
    for a in range(0, N, step):
        yield ScenarioArrays(*(x[a:a + step] for x in batch))


def _cat(parts: list, cls):
    """Join the per-chunk NamedTuples of :func:`_lane_chunks` lane-wise."""
    if len(parts) == 1:
        return parts[0]
    return cls(*(torch.cat(xs) for xs in zip(*parts)))


def _engine_batch(batch: ScenarioArrays, *, control: bool, trace: bool,
                  trace_events: int | None, run):
    """Run the engine body over a batch, chunk by chunk: ``run(sub, inv,
    c0, host_bound)`` steps one chunk's carry.  Returns ``(SimOutput,
    TraceBuffers or None)``."""
    T, V = batch.task_valid.shape[1], batch.vm_mips.shape[1]
    caps = _trace_caps(T, V, control, trace, trace_events)
    outs, traces = [], []
    for sub in _lane_chunks(batch):
        inv, c0 = _epoch_setup(sub, control=control, trace=caps)
        host_bound = int(inv.bound.max()) if sub.task_valid.shape[0] else 0
        c = run(sub, inv, c0, host_bound)
        outs.append(_engine_output(sub, inv, c))
        if trace:
            traces.append(_engine_trace(c))
    return _cat(outs, SimOutput), (_cat(traces, TraceBuffers) if trace
                                   else None)


def simulate_arrays(batch: ScenarioArrays, *, control: bool | None = None,
                    trace: bool = False, trace_events: int | None = None):
    """Run a batch through the engine's own epoch body, each lane to its
    own end: the reference's per-lane ``simulate_arrays`` under ``vmap``,
    for any number of jobs per lane.

    ``control`` picks the closed-loop lowering (default: whether the batch
    encodes any closed-loop input).  A lane stops when no valid task is
    unfinished (shed tasks aside) or at its epoch bound (``2T + 2`` open
    loop, :func:`_lane_bound` under control).  Returns the
    :class:`SimOutput`; under ``trace=True`` ``(SimOutput,
    TraceBuffers)``, with ``trace_events`` event rows per lane (default:
    the worst case).  The traced schedule is bitwise the untraced one.
    Batches are stepped in runs of lanes within :data:`LANE_BUDGET`;
    lanes are independent, so the cut changes no bit.
    """
    if control is None:
        control = _control_active(batch)
    out, buffers = _engine_batch(
        batch, control=control, trace=trace, trace_events=trace_events,
        run=lambda sc, inv, c, n: _drive(sc, inv, c, n, control=control,
                                         trace=trace))
    return (out, buffers) if trace else out


def _engine_compact(batch: ScenarioArrays, *, k: int, floor: int,
                    control: bool, trace: bool, trace_events, stats: dict,
                    donate: bool, legacy: bool):
    """:func:`simulate_arrays` through the compaction loop of
    ``kernels.mr_sched.ops`` (the reference's ``_step_epoch_chunk`` and
    its host loops): the working set steps ``k`` epochs at a time, and the
    still-active lanes are gathered into a smaller one whenever it halves.
    Returns ``(SimOutput, TraceBuffers or None)``."""
    from ..kernels.mr_sched.ops import _compact_loop_lean, _compact_loop_legacy
    nb = len(ScenarioArrays._fields)
    f = _Carry._fields
    i_fin, i_shed, i_ep = f.index("finish"), f.index("shed"), f.index("epoch")
    i_valid = ScenarioArrays._fields.index("task_valid")

    def args(data, state, bound):
        return (data[i_valid], state[i_fin],
                state[i_shed] if control else None, state[i_ep][:, None],
                bound)

    def chunk(data, state, limit):
        stats["dispatches"] += 1
        return tuple(_drive(ScenarioArrays(*data[:nb]),
                            _EpochInv(*data[nb:]), _Carry(*state), limit,
                            control=control, trace=trace))

    def run(sc, inv, c0, host_bound):
        loop = _compact_loop_legacy if legacy else _compact_loop_lean
        st = loop(tuple(sc) + tuple(inv), tuple(c0), inv.bound,
                  sc.task_valid.shape[0], host_bound, k, floor, args, chunk,
                  stats, donate, sc.task_valid.device)
        return _Carry(*st)

    return _engine_batch(batch, control=control, trace=trace,
                         trace_events=trace_events, run=run)


def _wants_engine(batch: ScenarioArrays, backend: str | None) -> bool:
    """Whether a batch steps through the engine body: it has more than one
    job column, or the caller asks for ``backend="engine"``."""
    return backend == "engine" or batch.job_length.shape[1] != 1


def simulate_batch_arrays(batch: ScenarioArrays, *, control: bool | None = None,
                          backend: str | None = None,
                          max_pes: int | None = None, trace: bool = False,
                          trace_events: int | None = None):
    """Step a batch of scenarios to completion.

    Single-job batches run their epoch loop in the ``mr_epoch`` kernel
    (``kernels.mr_sched.epoch_schedule``): ``backend="cuda"`` launches the
    CUDA kernel (tensors on the card), ``"torch"`` runs its plain version;
    ``None`` picks by the batch's device.  A batch with more than one job
    column, or any batch under ``backend="engine"``, steps through the
    engine's own epoch body (:func:`simulate_arrays`, plain tensor ops on
    the batch's device; ``max_pes`` does not apply).  ``control`` picks the
    closed-loop lowering (default: whether the batch encodes any
    closed-loop input, :func:`_control_active`).  Returns ``(SimOutput,
    realized_epochs)``, the latter the batch's largest per-lane count.

    ``trace=True`` runs the trace lowering and returns ``(SimOutput,
    realized_epochs, TraceBuffers)``: the per-epoch time series and the
    event log of every lane, ``trace_events`` rows each (default: the
    worst case, so none is dropped).  The schedule is bitwise the untraced
    one.
    """
    from ..kernels.mr_sched.ops import epoch_trace, epoch_schedule
    if control is None:
        control = _control_active(batch)
    if _wants_engine(batch, backend):
        res = simulate_arrays(batch, control=control, trace=trace,
                              trace_events=trace_events)
        out, buffers = res if trace else (res, None)
    elif trace:
        out, buffers = epoch_trace(batch, backend=backend, max_pes=max_pes,
                                   control=control,
                                   trace_events=trace_events)
    else:
        out = epoch_schedule(batch, backend=backend, max_pes=max_pes,
                             control=control)
    realized = int(out.n_epochs.max()) if out.n_epochs.numel() else 0
    return (out, realized, buffers) if trace else (out, realized)


def _take_lanes(tree, idx: torch.Tensor) -> tuple:
    """Gather a lane subset of a tuple of lane-led tensors (``None``
    entries stay ``None``)."""
    return tuple(None if x is None else x.index_select(0, idx) for x in tree)


def _put_lanes(store, idx: torch.Tensor, sub) -> tuple:
    """Scatter a lane subset back into a copy of the dense store (distinct
    indices, so the write order cannot matter)."""
    return tuple(None if s is None else s.index_copy(0, idx, x)
                 for s, x in zip(store, sub))


def _put_lanes_donated(store, idx: torch.Tensor, sub) -> tuple:
    """:func:`_put_lanes` into the store itself (``index_copy_``): the
    port's counterpart of the reference's donated scatter.  The caller
    owns the store and reads no other reference to it."""
    for s, x in zip(store, sub):
        if s is not None:
            s.index_copy_(0, idx, x)
    return tuple(store)


def simulate_batch_arrays_compact(
        batch: ScenarioArrays, *, k: int | str = "auto", floor: int = 8,
        cost_model=None, control: bool | None = None, trace: bool = False,
        trace_events: int | None = None, stats: dict | None = None,
        donate: bool = True, legacy: bool = False,
        backend: str | None = None, max_pes: int | None = None):
    """:func:`simulate_batch_arrays` with active-lane compaction
    (DESIGN.md §9).

    Every ``k`` epochs the still-active lanes are gathered into a
    power-of-two working set (at least ``floor`` lanes) and stepping
    resumes on those alone, so a batch whose tail is 40 lanes steps 64,
    not 2048: through the resumable ``mr_epoch`` kernel
    (``kernels.mr_sched.ops.epoch_schedule_compact``), or through the
    engine body for a batch with more than one job column or under
    ``backend="engine"``.  Each lane runs to its own end by its own data,
    so the result is the dense run's bit for bit, per-lane ``n_epochs``
    and ``realized_epochs`` included.  ``k="auto"`` takes the interval
    from the cost model (``cost_model``, default
    :func:`costmodel.default_cost_model` of the batch's device).

    Returns ``(SimOutput, realized_epochs)``, or under ``trace=True``
    ``(SimOutput, realized_epochs, TraceBuffers)`` with ``trace_events``
    event rows per lane (default: the worst case).  ``stats`` (a dict,
    updated in place) counts ``syncs``, ``scalar_syncs``, ``compactions``
    and ``dispatches``.  ``donate=True`` scatters into the carry store in
    place.  ``legacy=True`` runs the reference's A/B loop: the whole
    activity mask crosses to the host every round, the lanes are ordered
    there, and the store is never updated in place.
    """
    from ..kernels.mr_sched.ops import _compact, _compact_interval
    if control is None:
        control = _control_active(batch)
    if _wants_engine(batch, backend):
        if stats is None:
            stats = {}
        for key in ("syncs", "scalar_syncs", "compactions", "dispatches"):
            stats.setdefault(key, 0)
        validate_pow2_floor(floor)
        N, T = batch.task_valid.shape
        k = _compact_interval(k, cost_model, N, T, batch.task_vm.device,
                              "simulate_batch_arrays_compact")
        out, buffers = _engine_compact(
            batch, k=k, floor=floor, control=control, trace=trace,
            trace_events=trace_events, stats=stats, donate=donate,
            legacy=legacy)
    else:
        out, st = _compact(
            batch, k=k, backend=backend, max_pes=max_pes, floor=floor,
            cost_model=cost_model, control=control, trace=trace,
            trace_events=trace_events, stats=stats, donate=donate,
            legacy=legacy, device=None, what="simulate_batch_arrays_compact")
        if trace:
            buffers = _trace_of(st[-len(TraceBuffers._fields):])
    realized = int(out.n_epochs.max()) if out.n_epochs.numel() else 0
    return (out, realized, buffers) if trace else (out, realized)


def job_metrics(sc: ScenarioArrays, out: SimOutput) -> JobMetrics:
    """Per-job metrics ``[N, J]`` (paper §5.3)."""
    J = sc.job_length.shape[1]
    is_map = sc.task_valid & ~sc.task_is_reduce
    is_red = sc.task_valid & sc.task_is_reduce
    on_job = [sc.task_job == j for j in range(J)]
    zero = torch.zeros_like(out.exec_time)

    def seg_sum(x, m):
        # the reference's one-hot contraction: a dot over tasks, which
        # XLA:CPU accumulates in task-index order
        return torch.stack([_fold(torch.where(m & oj, x, zero))
                            for oj in on_job], dim=1)

    def seg_max(x, m):
        # a job whose tasks are all masked out maxes the -_BIG fill; a job
        # no task maps to stays at -inf (the reference's two-level identity)
        filled = torch.where(m, x, torch.full_like(x, -_BIG))
        ninf = torch.full_like(x, -np.inf)
        return torch.stack([torch.where(oj, filled, ninf).amax(dim=1)
                            for oj in on_job], dim=1)

    def seg_min(x, m):
        return -seg_max(-x, m)

    ones = torch.ones_like(out.exec_time)
    nm = torch.clamp(seg_sum(ones, is_map), min=1.0)
    nr = torch.clamp(seg_sum(ones, is_red), min=1.0)
    m_avg = seg_sum(out.exec_time, is_map) / nm
    r_avg = seg_sum(out.exec_time, is_red) / nr
    m_max, r_max = seg_max(out.exec_time, is_map), seg_max(out.exec_time,
                                                          is_red)
    m_min, r_min = seg_min(out.exec_time, is_map), seg_min(out.exec_time,
                                                          is_red)
    last_map_fin = seg_max(out.finish, is_map)
    last_red_fin = seg_max(out.finish, is_red)
    last_map_st = seg_max(out.start, is_map)
    last_red_st = seg_max(out.start, is_red)
    delay = last_map_st + last_red_st - last_map_fin
    cur_vm = torch.where(out.hit, out.task_vm2, sc.task_vm).long()
    cost_rate = torch.gather(sc.vm_cost, 1, cur_vm)
    vm_cost = seg_sum(out.exec_time * cost_rate, is_map | is_red)
    return JobMetrics(
        avg_exec=m_avg + r_avg,
        max_exec=m_max + r_max,
        min_exec=m_min + r_min,
        makespan=last_red_fin - sc.job_submit,
        delay_time=delay,
        vm_cost=vm_cost,
        network_cost=delay * sc.net_cost_per_unit[:, None]
        * sc.net_enabled[:, None],
        map_avg_exec=m_avg,
        reduce_avg_exec=r_avg,
        completion=torch.where(sc.job_valid, last_red_fin,
                               torch.zeros_like(last_red_fin)),
    )


def scenario_metrics(sc: ScenarioArrays, out: SimOutput) -> ScenarioMetrics:
    """Whole-scenario metrics ``[N]`` (sweep-result companions to
    :class:`JobMetrics`)."""
    f = lambda m: m.to(F32)                                    # noqa: E731
    zt = torch.zeros_like(out.finish)
    zv = torch.zeros_like(sc.vm_mips)
    lengths = task_lengths(sc)
    total_mi = _sum(lengths)
    capacity = _sum(torch.where(sc.vm_valid, sc.vm_mips * sc.vm_pes, zv))
    util = total_mi / torch.clamp(capacity * out.finish_time, min=1e-30)
    blocked = storage.has_block(sc.block_vm) & sc.task_valid
    local = blocked & storage.is_local(sc.block_vm, sc.task_vm)
    n_blocked = _sum(f(blocked))
    loc_frac = _sum(f(local)) / torch.clamp(n_blocked, min=1.0)
    xfer = _sum(torch.where(blocked & ~local, sc.block_size, zt)) * 1e6
    V = sc.vm_mips.shape[1]
    cur_vm = torch.where(out.hit, out.task_vm2, sc.task_vm)
    onehot = cur_vm[:, :, None] == torch.arange(V, device=cur_vm.device)
    ran = sc.task_valid & (out.finish < _BIG / 2)
    fin_ran = torch.where(ran, out.finish, zt)
    busy_end = torch.where(onehot, fin_ran[:, :, None],
                           torch.zeros_like(fin_ran)[:, :, None]).amax(dim=1)
    billed_t = elasticity.billed_lease(out.vm_open, out.vm_close, busy_end,
                                       out.finish_time[:, None],
                                       sc.bill_gran[:, None])
    billed = _sum(torch.where(sc.vm_valid, billed_t * sc.vm_cost, zv))
    lease_end = torch.where(out.vm_close >= _BIG / 2,
                            out.finish_time[:, None].expand_as(out.vm_close),
                            torch.maximum(out.vm_close, busy_end))
    lease_dur = torch.clamp(lease_end - out.vm_open, min=0.0)
    delivered = _sum(torch.where(ran, lengths, zt))
    leased_cap = _sum(torch.where(sc.vm_valid,
                                  sc.vm_mips * sc.vm_pes * lease_dur, zv))
    busy_frac = delivered / torch.clamp(leased_cap, min=1e-30)
    started = sc.task_valid & (out.start < _BIG / 2)
    q_wait = _sum(torch.where(started, out.start - out.ready, zt)) \
        / torch.clamp(_sum(f(started)), min=1.0)
    fail_fired = sc.vm_valid & (sc.vm_fail < _BIG / 2) \
        & (sc.vm_fail <= out.finish_time[:, None])
    n_failures = _sum(f(fail_fired))
    hit_tasks = sc.task_valid & out.hit
    n_hit = _sum(f(hit_tasks))
    n_recovered = _sum(f(hit_tasks & ran))
    recovered = n_recovered / torch.clamp(n_hit, min=1.0)
    fin_dl = sc.task_valid & (sc.task_deadline < _BIG / 2)
    n_dl = _sum(f(fin_dl))
    missed = fin_dl & ((out.finish >= _BIG / 2)
                       | (out.finish > sc.task_deadline))
    miss_frac = _sum(f(missed)) / torch.clamp(n_dl, min=1.0)
    shed_tasks = _sum(f(sc.task_valid & out.shed))
    preemptions = out.n_evict.sum(dim=1).to(F32)
    late = fin_dl & ran & (out.finish > sc.task_deadline)
    wasted = out.work_lost + _sum(torch.where(late, lengths, zt))
    wasted_frac = wasted / torch.clamp(delivered + out.work_lost, min=1e-30)
    comp_dl = fin_dl & ran
    n_comp = _sum(f(comp_dl))
    slack_sorted = torch.sort(torch.where(
        comp_dl, out.finish - sc.task_deadline, torch.full_like(zt, _BIG)),
        dim=1).values
    p_idx = torch.clamp(torch.ceil(0.99 * n_comp).to(I32) - 1, 0,
                        slack_sorted.shape[1] - 1)
    p99 = torch.where(n_comp > 0.5,
                      torch.gather(slack_sorted, 1, p_idx.long()[:, None])[:, 0],
                      torch.zeros_like(n_comp))
    return ScenarioMetrics(finish_time=out.finish_time, utilization=util,
                           n_epochs=out.n_epochs,
                           locality_fraction=loc_frac, transfer_bytes=xfer,
                           billed_cost=billed, vm_busy_fraction=busy_frac,
                           queue_wait=q_wait,
                           failures_injected=n_failures,
                           tasks_redispatched=n_hit,
                           scale_events=out.n_scale.to(F32),
                           recovered_fraction=recovered,
                           deadline_miss_fraction=miss_frac,
                           shed_tasks=shed_tasks,
                           preemptions=preemptions,
                           wasted_work_frac=wasted_frac,
                           p99_slack=p99)


def simulate(sc: Scenario, *, device="cuda") -> JobMetrics:
    """Convenience single-scenario entry point (returns ``[1, J]``
    tensors); a scenario with a closed-loop model (``sc.control``, reserve
    VMs, deadlines) runs the control lowering.  A single-job scenario
    steps through the ``mr_epoch`` kernel, a multi-job one through the
    engine body."""
    enc = from_scenario(sc)
    batch = scenario_arrays_from_numpy(
        {k: np.asarray(v)[None] for k, v in enc.items()}, device=device)
    out, _ = simulate_batch_arrays(batch)
    return job_metrics(batch, out)
