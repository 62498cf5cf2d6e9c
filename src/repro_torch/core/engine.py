"""Scenario encoding, batch stepping and metrics on torch tensors.

The JAX package's event-epoch engine, open-loop lowering, written on a
leading lane dimension in place of ``vmap``.  A batch of encoded scenarios
(:class:`ScenarioArrays`, every leaf ``[N, ...]``) is stepped to completion
by the ``mr_epoch`` kernel (``kernels.mr_sched.epoch_schedule``: the CUDA
kernel on the card, its plain PyTorch version on the CPU), or by
:func:`simulate_batch_arrays_compact` in chunks over the still-active
lanes, and reduced by :func:`job_metrics` / :func:`scenario_metrics`.

Every float op keeps the JAX package's op sequence, one rounding per op, so
schedules are bitwise equal to the reference.  Sums run in one fixed order
(:func:`_sum`, :func:`_fold`), never through a library reduction whose order
depends on the device, so a run on the card and one on the CPU give the same
bits.  Batches with closed-loop inputs (failures, autoscale reserves,
deadline policies, preemption) step through the kernel's control lowering.
The JAX engine's own XLA formulation of the epoch body (``_epoch_step``
with its T×T admission rank) is ROADMAP slice A2.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import elasticity, storage
from .config import BindingPolicy, Scenario, base_task_lengths_f32
from .control import DeadlinePolicy, scenario_control
from .telemetry import (N_TS_COLS, TraceBuffers, event_capacity,
                        timeseries_capacity)

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


def simulate_batch_arrays(batch: ScenarioArrays, *, control: bool | None = None,
                          backend: str | None = None,
                          max_pes: int | None = None, trace: bool = False,
                          trace_events: int | None = None):
    """Step a batch of single-job scenarios to completion.

    The epoch loop runs in the ``mr_epoch`` kernel
    (``kernels.mr_sched.epoch_schedule``): ``backend="cuda"`` launches the
    CUDA kernel (tensors on the card), ``"torch"`` runs its plain version;
    ``None`` picks by the batch's device.  ``control`` picks the
    closed-loop lowering (default: whether the batch encodes any
    closed-loop input, :func:`_control_active`).  Returns ``(SimOutput,
    realized_epochs)``, the latter the batch's largest per-lane count.

    ``trace=True`` runs the trace instantiation and returns ``(SimOutput,
    realized_epochs, TraceBuffers)``: the per-epoch time series and the
    event log of every lane, ``trace_events`` rows each (default: the
    worst case, so none is dropped).  The schedule is bitwise the untraced
    one.
    """
    from ..kernels.mr_sched.ops import epoch_trace, epoch_schedule
    if control is None:
        control = _control_active(batch)
    if trace:
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
    power-of-two working set (at least ``floor`` lanes) and the kernel
    resumes on those alone, so a batch whose tail is 40 lanes steps 64,
    not 2048 (``kernels.mr_sched.ops.epoch_schedule_compact``).  Each lane
    runs to its own end by its own data, so the result is the dense run's
    bit for bit, per-lane ``n_epochs`` and ``realized_epochs`` included.
    ``k="auto"`` takes the interval from the cost model (``cost_model``,
    default :func:`costmodel.default_cost_model` of the batch's device).

    Returns ``(SimOutput, realized_epochs)``, or under ``trace=True``
    ``(SimOutput, realized_epochs, TraceBuffers)`` with ``trace_events``
    event rows per lane (default: the worst case).  ``stats`` (a dict,
    updated in place) counts ``syncs``, ``scalar_syncs``, ``compactions``
    and ``dispatches``.  ``donate=True`` scatters into the carry store in
    place.  ``legacy=True`` runs the reference's A/B loop: the whole
    activity mask crosses to the host every round, the lanes are ordered
    there, and the store is never updated in place.
    """
    from ..kernels.mr_sched.ops import _compact
    if control is None:
        control = _control_active(batch)
    out, st = _compact(
        batch, k=k, backend=backend, max_pes=max_pes, floor=floor,
        cost_model=cost_model, control=control, trace=trace,
        trace_events=trace_events, stats=stats, donate=donate,
        legacy=legacy, device=None, what="simulate_batch_arrays_compact")
    realized = int(out.n_epochs.max()) if out.n_epochs.numel() else 0
    if trace:
        return out, realized, _trace_of(st[-len(TraceBuffers._fields):])
    return out, realized


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
    VMs, deadlines) runs the control lowering.  The kernel steps
    single-job scenarios; multi-job scenarios need the engine formulation
    of ROADMAP slice A2."""
    if len(sc.jobs) != 1:
        raise NotImplementedError(
            "simulate: multi-job scenarios need the engine epoch body "
            "(ROADMAP slice A2); the mr_epoch kernel steps one job per lane")
    enc = from_scenario(sc)
    batch = scenario_arrays_from_numpy(
        {k: np.asarray(v)[None] for k, v in enc.items()}, device=device)
    out, _ = simulate_batch_arrays(batch)
    return job_metrics(batch, out)
