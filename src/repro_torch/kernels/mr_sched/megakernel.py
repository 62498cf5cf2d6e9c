"""``mr_epoch``: the fused epoch loop for a batch of scenario lanes.

It replaces the JAX package's Pallas kernel ``kernels/mr_sched/
megakernel.py:_kernel`` (via ``_mr_epoch_impl``), open-loop and
``control=True`` lowerings.  One launch advances every lane through its
whole event history: processor-sharing rates, the next-event min over
completions and lease-gated arrivals, completions inside the ``1e-6`` tie
window, the shuffle release of reduces, and space-shared admission by
per-task rank: the eligible tasks on a task's VM ahead of it by
``(priority desc, eligible time, index)`` must be fewer than ``max_pes``
and than the VM's free PEs, exactly the outcome of the Pallas kernel's
``max_pes``-step scan.  The control lowering adds, each epoch, the
AUTOSCALE hook at the opening clock, the ``[fail, restore)`` down-window
gates, failure kills with failover re-dispatch and re-replication, SHED at
the arrival candidate and at the admission instant, preemption of the
weakest evictable task per full VM, and the BOOST urgency tier (urgent
tasks rank first).  It is
resumable: ``state`` carries the 8-leaf carry (15 under control) in and
out and ``epoch_limit`` caps the epochs of one call.

Where the reference multiplies into an add, XLA:CPU fuses the two into one
FMA (``rem - dt * r`` and the tie threshold ``t + 1e-6 * max(t, 1)``);
both forms round once there too, every other op rounds on its own.

Two forms, one algorithm:

* :func:`mr_epoch_plain` — plain PyTorch on ``[N, ...]`` tensors, any
  device.  The CPU tests hold it against the JAX kernel in interpret mode,
  bit for bit on every carry leaf but the control lowering's ``work_lost``
  (a float sum over tasks, ROADMAP C5).
* :func:`mr_epoch` — the wrapper: a CUDA tensor launches the hand-written
  kernel of its instantiation, ``csrc/mr_epoch.cu`` or
  ``csrc/mr_epoch_control.cu``, each built for ``sm_90a`` at first use and
  again with ``-DMR_TRACE`` for its trace instantiation; a CPU tensor takes
  the plain version.  ``mr_epoch.launches``, ``control_launches``,
  ``trace_launches`` and ``control_trace_launches`` count the four
  instantiations' launches.

Lanes are independent, so the TPU kernel's per-tile ``while_loop`` becomes
a per-lane loop: each lane stops at its own end, its per-lane ``n_epochs``
as in the reference.  Under control a finished lane is not a fixed point
of the reference's epoch body, which therefore moves a lane's clock and
reserve leases while batch mates run on (ROADMAP C6); stopping per lane is
the reference's per-lane meaning (``engine.simulate_arrays``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.control import earliest_finish
from ...core.engine import _bound_terms, _sum, _trace_caps
from ...core.telemetry import (EV_FINISH, EV_KILL, EV_PREEMPT,
                               EV_SCALE_CLOSE, EV_SCALE_OPEN, EV_SHED,
                               EV_START, N_TS_COLS)
from ...core.util import fma32

_BIG = 1e30
_TIME_EPS = 1e-6
F32, I32 = torch.float32, torch.int32

STATE_LEAVES = ("time", "rem", "running", "start", "finish", "ready",
                "maps_left", "n_epochs")
# the control lowering's carry: the open-loop leaves, then seven more
STATE_LEAVES_CONTROL = STATE_LEAVES + ("hit", "vm_open", "vm_close",
                                       "n_scale", "shed", "n_evict",
                                       "work_lost")
# the trace lowering's leaves, appended after either carry
TRACE_LEAVES = ("ts", "ev_t", "ev_kind", "ev_task", "ev_vm", "ev_n")


def state_leaves(control: bool = False, trace: bool = False) -> tuple:
    """The carry's leaf names of one instantiation."""
    return ((STATE_LEAVES_CONTROL if control else STATE_LEAVES)
            + (TRACE_LEAVES if trace else ()))


def initial_state(task_len, ready0, is_red, valid, vm_start=None,
                  vm_stop=None, vm_auto=None, trace_capacity=None,
                  event_capacity=None):
    """The t=0 carry: ``(time (N,1) f32, rem (N,T) f32, running (N,T) i32,
    start (N,T) f32, finish (N,T) f32, ready (N,T) f32, maps_left (N,1)
    i32, n_epochs (N,1) i32)`` — the JAX package's ``initial_state``.

    Passing ``vm_auto`` (with ``vm_start``/``vm_stop``) appends the seven
    control leaves: ``hit (N,T) i32, vm_open (N,V) f32, vm_close (N,V)
    f32, n_scale (N,1) i32, shed (N,T) i32, n_evict (N,T) i32, work_lost
    (N,1) f32``; reserve VMs start unopened (``vm_open = 1e30``).

    ``trace_capacity`` ``C`` and ``event_capacity`` ``E`` (both or
    neither) append the six trace leaves: ``ts (N,C*8) f32`` zeros,
    ``ev_t (N,E) f32`` zeros, ``ev_kind``/``ev_task``/``ev_vm (N,E) i32``
    filled with -1 and ``ev_n (N,1) i32`` zero — the JAX engine's initial
    recorder leaves."""
    N, T = task_len.shape
    dev = task_len.device
    maps = ((valid != 0) & ~(is_red != 0)).sum(dim=1, keepdim=True,
                                                dtype=I32)
    base = (torch.zeros((N, 1), dtype=F32, device=dev),
            task_len.clone(),
            torch.zeros((N, T), dtype=I32, device=dev),
            torch.full((N, T), _BIG, dtype=F32, device=dev),
            torch.full((N, T), _BIG, dtype=F32, device=dev),
            ready0.clone(),
            maps,
            torch.zeros((N, 1), dtype=I32, device=dev))
    if vm_auto is not None:
        base = base + (
            torch.zeros((N, T), dtype=I32, device=dev),
            torch.where(vm_auto != 0,
                        torch.full_like(vm_start, _BIG, dtype=F32),
                        vm_start.to(F32)),
            vm_stop.to(F32).clone(),
            torch.zeros((N, 1), dtype=I32, device=dev),
            torch.zeros((N, T), dtype=I32, device=dev),
            torch.zeros((N, T), dtype=I32, device=dev),
            torch.zeros((N, 1), dtype=F32, device=dev))
    if (trace_capacity is None) != (event_capacity is None):
        raise ValueError("initial_state: give trace_capacity and "
                         "event_capacity together")
    if trace_capacity is not None:
        C, E = int(trace_capacity), int(event_capacity)
        base = base + (
            torch.zeros((N, C * N_TS_COLS), dtype=F32, device=dev),
            torch.zeros((N, E), dtype=F32, device=dev),
            *(torch.full((N, E), -1, dtype=I32, device=dev)
              for _ in range(3)),
            torch.zeros((N, 1), dtype=I32, device=dev))
    return base


def default_epoch_limit(T: int, V: int, control: bool) -> int:
    """Epochs that run every lane to its end: ``2T + 2`` open loop, the
    additive worst case ``7T + V + 3`` under control."""
    return 7 * T + V + 3 if control else 2 * T + 2


def _check_control(control: bool, ctl, trace: bool = False) -> None:
    if control and any(x is None for x in ctl):
        raise ValueError("mr_epoch: control=True needs all fifteen control "
                         "lane-data tensors (vm_valid .. preempt_resume)")
    if not control and trace and ctl[0] is None:
        raise ValueError("mr_epoch: an open-loop trace needs vm_valid (the "
                         "open-VM observable)")
    if not control and any(x is not None for x in ctl[int(trace):]):
        raise ValueError("mr_epoch: control lane data given with "
                         "control=False")


def mr_epoch_plain(task_len, task_vm, ready0, is_red, valid, shuffle,
                   vm_mips, vm_pes, sched_policy, vm_start, vm_stop, spinup,
                   prio, vm_valid=None, vm_fail=None, vm_restore=None,
                   vm_auto=None, ctl_policy=None, ctl_queue=None,
                   ctl_busy=None, redispatch=None, task_vm2=None,
                   refetch=None, task_deadline=None, dl_policy=None,
                   dl_slack=None, preempt=None, preempt_resume=None,
                   state=None, *, max_pes: int = 8,
                   epoch_limit: int | None = None, control: bool = False,
                   trace: bool = False):
    """Plain PyTorch ``mr_epoch``; arguments and result as :func:`mr_epoch`.

    The TPU kernel's op sequence on batched tensors: one-hot contractions
    become gathers (``to_task``) and exact 0/1 counts (``per_vm_sum``), the
    per-VM extrema are masked reductions, and the ``max_pes``-step
    admission scan becomes the rank rule it reproduces (a ``(N, T, T)``
    comparison of the eligible tasks of each VM), as in the kernels.  Every
    carry update is gated on its lane still being active, so a lane stops
    at its own end whatever its batch mates do (ROADMAP C6); on the open
    loop a finished lane is a fixed point and the gate changes no bit.

    Under ``trace`` each active epoch writes its time-series row at the
    lane's epoch index (the Pallas trace lowering's rows) and appends its
    events at the lane's cursor in the JAX engine recorder's order: scale
    opens and closes (per VM), then completions, kills, evictions, starts
    and new sheds (per task, in index order).  A row lands only where the
    cursor is below the log's capacity; ``ev_n`` counts every event.  The
    reference adds each row through a one-hot product; a direct store is
    the same bits because every slot is written at most once with a
    finite value that is never ``-0.0``.
    """
    ctl = (vm_valid, vm_fail, vm_restore, vm_auto, ctl_policy, ctl_queue,
           ctl_busy, redispatch, task_vm2, refetch, task_deadline,
           dl_policy, dl_slack, preempt, preempt_resume)
    _check_control(control, ctl, trace)
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if state is None:
        caps = _trace_caps(T, V, control, trace, None) or (None, None)
        state = initial_state(task_len, ready0, is_red, valid, vm_start,
                              vm_stop, vm_auto if control else None, *caps)
    n_leaves = len(state_leaves(control, trace))
    if len(state) != n_leaves:
        raise ValueError(f"mr_epoch: state must have {n_leaves} leaves, got "
                         f"{len(state)}")
    if epoch_limit is None:
        epoch_limit = default_epoch_limit(T, V, control)
    time = state[0][:, 0]
    rem, running, start, finish, ready = (state[1], state[2] != 0, state[3],
                                          state[4], state[5])
    maps_left, lane_ep = state[6][:, 0], state[7][:, 0]
    is_red = is_red != 0
    valid = valid != 0
    shuffle = shuffle[:, 0]
    is_space = (sched_policy[:, 0] != 0)[:, None]
    vidx = torch.arange(V, dtype=I32, device=dev)

    def slot(vm):
        """``(in range, gather index, one-hot)`` of a task→VM binding."""
        return ((vm >= 0) & (vm < V), vm.clamp(0, V - 1).long(),
                vm[:, :, None] == vidx)

    in_range, vm_idx, onehot = slot(task_vm)
    onehot_f = onehot.to(F32)
    zt = torch.zeros((N, T), dtype=F32, device=dev)
    idx = torch.arange(T, dtype=I32, device=dev)[None, :]

    def to_task(per_vm):
        """Each task's VM's value (0 for a task bound out of range)."""
        return torch.where(in_range, torch.gather(per_vm, 1, vm_idx), zt)

    def per_vm_sum(per_task):
        """Exact 0/1 counts per VM."""
        return (onehot_f * per_task[:, :, None]).sum(dim=1)

    def vm_extreme(x, fill, op):
        return op(torch.where(onehot, x[:, :, None],
                              torch.full_like(x, fill)[:, :, None]), dim=1)

    def count(mask):
        return mask.sum(dim=1, dtype=I32).to(F32)

    task_pes = to_task(vm_pes)
    avail_t = to_task(vm_start + spinup)
    close_t = to_task(vm_stop)
    big_t = torch.full_like(zt, _BIG)
    neg_big_t = torch.full_like(zt, -_BIG)
    one_v = torch.ones_like(vm_mips)
    eps = torch.full((N,), _TIME_EPS, dtype=F32, device=dev)
    carry = [time, rem, running, start, finish, ready, maps_left]

    if control:
        vm_valid, vm_auto = vm_valid != 0, vm_auto != 0
        pol_on = ctl_policy[:, 0] == 1
        ctl_queue, ctl_busy = ctl_queue[:, 0], ctl_busy[:, 0]
        dl_shed, dl_boost = dl_policy == 1, dl_policy == 2     # (N, 1)
        pre_onl = (preempt != 0) & is_space
        res_onl = preempt_resume != 0
        reserve = vm_valid & vm_auto
        big_v = torch.full_like(vm_mips, _BIG)
        bound = _bound_terms(
            T, V, (vm_valid & (vm_fail < _BIG / 2)).any(dim=1),
            dl_shed[:, 0] & (valid & (task_deadline < _BIG / 2)).any(dim=1),
            preempt[:, 0] != 0)
        carry += [state[8] != 0, state[9], state[10], state[11][:, 0],
                  state[12] != 0, state[13], state[14][:, 0]]

    def active_lanes(c):
        unfin = valid & (c[4] >= _BIG / 2)
        if not control:
            return unfin.any(dim=1)
        return (unfin & ~c[11]).any(dim=1) & (lane_ep < bound)

    if trace:
        nb = n_leaves - len(TRACE_LEAVES)
        ts = state[nb].reshape(N, -1, N_TS_COLS).clone()
        ev = [x.clone() for x in state[nb + 1:nb + 5]]
        ev_n = state[nb + 5][:, 0].clone()
        if not control:
            open_at = vm_start + spinup       # each VM's admission opening
            vm_on = vm_valid != 0

    active = active_lanes(carry)
    n = 0
    while n < epoch_limit and bool(active.any()):
        time, rem, running, start, finish, ready, maps_left = carry[:7]
        runf = running.to(F32)
        if trace and not control:
            # the observables of the control hook on the opening carry,
            # over the static lease windows
            q_d = count(valid & (finish >= _BIG / 2) & (start >= _BIG / 2)
                        & (ready <= time[:, None]))
            open_v = vm_on & (open_at <= time[:, None]) \
                & (time[:, None] < vm_stop)
            n_o = count(open_v)
            b_f = count(open_v & (per_vm_sum(runf) > 0.5)) \
                / torch.clamp(n_o, min=1.0)
        if control:
            hit, vm_open, vm_close, n_scale, shed0, n_evict0, work_lost = \
                carry[7:]
            # every per-VM quantity reads each task's current slot
            cur_vm = torch.where(hit, task_vm2, task_vm)
            in_range, vm_idx, onehot = slot(cur_vm)
            onehot_f = onehot.to(F32)
            task_pes = to_task(vm_pes)
            f_t, r_t, mips_t = (to_task(vm_fail), to_task(vm_restore),
                                to_task(vm_mips))
            # the control hook at the epoch's opening clock
            unfinished = valid & (finish >= _BIG / 2) & ~shed0
            qdepth = count(unfinished & (start >= _BIG / 2)
                           & (ready <= time[:, None]))
            busy_v = per_vm_sum(runf) > 0.5
            open_v = vm_valid & (vm_open + spinup <= time[:, None]) \
                & (time[:, None] < vm_close)
            n_open = count(open_v)
            busy_frac = count(open_v & busy_v) / torch.clamp(n_open, min=1.0)
            trigger = pol_on & (qdepth > ctl_queue) & (busy_frac >= ctl_busy)
            unopened = reserve & (vm_open >= _BIG / 2)
            first = torch.where(unopened, vidx, V + 1).amin(dim=1)
            open_mask = trigger[:, None] & unopened \
                & (vidx == first[:, None])
            bound_unfin = per_vm_sum(unfinished.to(F32))
            close_mask = pol_on[:, None] & reserve & (vm_open < _BIG / 2) \
                & (time[:, None] < vm_close) & (bound_unfin < 0.5)
            now_v = time[:, None].expand_as(vm_open)
            vm_open = torch.where(open_mask, now_v, vm_open)
            vm_close = torch.where(close_mask, now_v, vm_close)
            n_scale = n_scale + open_mask.sum(dim=1, dtype=I32) \
                + close_mask.sum(dim=1, dtype=I32)
            avail_t = to_task(vm_open + spinup)
            close_t = to_task(vm_close)

        n_on_vm = per_vm_sum(runf)
        share = vm_mips * torch.minimum(one_v, vm_pes
                                        / torch.clamp(n_on_vm, min=1.0))
        r = torch.where(running, to_task(share), zt)
        eta = torch.where(running,
                          time[:, None] + rem / torch.clamp(r, min=1e-30),
                          big_t)
        not_started = valid & ~running & (finish >= _BIG / 2) \
            & (start >= _BIG / 2)
        elig = torch.maximum(ready, avail_t)
        if control:
            def gate(x):
                """Slide an instant inside its VM's down window to the
                restore edge."""
                return torch.where((x >= f_t) & (x < r_t), r_t, x)

            elig = gate(elig)
            cand_t = gate(torch.maximum(elig, time[:, None].expand_as(elig)))
            # SHED at the arrival candidate, on the carried rem
            rem_c = rem
            evaluable = not_started & (elig < _BIG / 2)
            shed_c = shed0 | (dl_shed & evaluable & (cand_t < close_t)
                              & (earliest_finish(cand_t, rem_c, mips_t)
                                 > task_deadline))
        else:
            cand_t = torch.maximum(elig, time[:, None].expand_as(elig))
        has_slot = (task_pes - to_task(n_on_vm)) > 0.5
        if control:
            # a pending task beating the weakest evictable running task on
            # its VM defines an arrival even with no free slot
            ev_m = torch.where(running & (n_evict0 < 2), prio, big_t)
            can_pre = pre_onl & (prio > to_task(vm_extreme(ev_m, _BIG,
                                                           torch.amin)))
            arr = torch.where(not_started & ~shed_c
                              & (~is_space | has_slot | can_pre)
                              & (cand_t < close_t), cand_t, big_t)
        else:
            arr = torch.where(not_started & (~is_space | has_slot)
                              & (cand_t < close_t), cand_t, big_t)
        t_next = torch.minimum(eta.amin(dim=1), arr.amin(dim=1))
        if control:
            # pending failure instants of valid VMs are events too
            fail_ev = torch.where(vm_valid & (vm_fail > time[:, None]),
                                  vm_fail, big_v)
            t_next = torch.minimum(t_next, fail_ev.amin(dim=1))
        live = t_next < _BIG / 2
        # the reference's XLA:CPU lowering fuses each multiply that feeds
        # an add into one FMA: ``t_next + eps * max(t_next, 1)`` and
        # ``rem - dt * r`` round once
        thr = fma32(eps, torch.clamp(t_next, min=1.0), t_next)[:, None]
        dt = (t_next - time)[:, None].expand_as(rem)
        rem = torch.where(running, fma32(-dt, r, rem), rem)
        done_now = live[:, None] & running & (eta <= thr)
        finish = torch.where(done_now, t_next[:, None].expand_as(finish),
                             finish)
        running = running & ~done_now
        rem = torch.where(done_now, zt, rem)
        maps_done_now = (done_now & ~is_red).sum(dim=1, dtype=I32)
        maps_left_new = maps_left - maps_done_now
        phase_done = (maps_left_new == 0) & (maps_left > 0)
        ready = torch.where(is_red & phase_done[:, None],
                            (t_next + shuffle)[:, None].expand_as(ready),
                            ready)
        start_base = start
        if control:
            # failure kills, after completions: the first hit moves the
            # task to its failover slot and pays the re-replication fetch
            fired = live[:, None] & (f_t > time[:, None]) \
                & (f_t <= t_next[:, None])
            affected = valid & fired & (finish >= _BIG / 2) & ~shed_c
            first_hit = affected & ~hit
            lost_fail = torch.where(affected, task_len - rem, zt)
            rem = torch.where(affected, task_len, rem)
            running = running & ~affected
            start_base = torch.where(affected, big_t, start_base)
            ready = torch.where(affected,
                                torch.maximum(ready, f_t + redispatch), ready)
            ready = torch.where(first_hit, ready + refetch, ready)
            hit = hit | first_hit

        eligible = live[:, None] & not_started & (elig <= thr) \
            & (t_next[:, None] < close_t)
        if control:
            eligible = eligible & ~((t_next[:, None] >= f_t)
                                    & (t_next[:, None] < r_t))
            # SHED again at the admission instant
            efin_t = earliest_finish(t_next[:, None].expand_as(rem_c), rem_c,
                                     mips_t)
            shed_t = shed_c | (dl_shed & evaluable
                               & (t_next[:, None] < close_t)
                               & (efin_t > task_deadline))
            eligible = eligible & ~shed_t
            # preemption: on each full space-shared VM the weakest
            # evictable running task (lowest priority, latest index) loses
            # its PE to an eligible task that strictly outranks it
            done_f = done_now.to(F32)
            full_t = (task_pes - to_task(n_on_vm - per_vm_sum(done_f))) \
                <= 0.5
            max_el_v = vm_extreme(torch.where(eligible, prio, neg_big_t),
                                  -_BIG, torch.amax)
            cand_e = pre_onl & running & (n_evict0 < 2) & full_t \
                & (to_task(max_el_v) > prio)
            min_low_v = vm_extreme(torch.where(cand_e, prio, big_t), _BIG,
                                   torch.amin)
            low = cand_e & (prio == to_task(min_low_v))
            max_idx_v = torch.where(onehot, torch.where(low, idx, -1)[:, :, None],
                                    -1).amax(dim=1)
            evicted = low & (idx == to_task(max_idx_v.to(F32)).to(I32))
            restart = evicted & ~res_onl
            lost_evict = torch.where(restart, task_len - rem, zt)
            e_first = evicted & ~hit
            rem = torch.where(restart, task_len, rem)
            running = running & ~evicted
            start_base = torch.where(evicted, big_t, start_base)
            ready = torch.where(evicted, torch.maximum(
                ready, (t_next[:, None] + redispatch).expand_as(ready)),
                ready)
            ready = torch.where(e_first, ready + refetch, ready)
            hit = hit | e_first
            n_evict = n_evict0 + evicted.to(I32)
            work_lost = work_lost + _sum(lost_fail) + _sum(lost_evict)
            free_v = vm_pes - (n_on_vm - per_vm_sum(done_f)
                               - per_vm_sum(evicted.to(F32)))
            # BOOST: urgent pending tasks outrank every other task
            urg = (dl_boost & evaluable
                   & (efin_t + dl_slack >= task_deadline)).to(F32)
        else:
            free_v = vm_pes - (n_on_vm
                               - per_vm_sum(done_now.to(F32)))
        # space-shared admission by rank (the JAX engine's rule,
        # core/engine.py:953-955, which the Pallas kernel's max_pes-step
        # scan reproduces): a task's rank is the count of eligible tasks on
        # its VM that the scan picks before it, by (urgency desc, priority
        # desc, eligible time asc, index asc); it is admitted iff its rank
        # is below max_pes and, as a float, below the VM's free PEs.  A
        # priority below -1e30 (the scan's starting maximum) or NaN is never
        # picked, and such an urgent task keeps the scan in the urgent tier.
        # A task bound outside [0, V) sees no free PE.
        same = (in_range[:, :, None] & in_range[:, None, :]
                & (vm_idx[:, :, None] == vm_idx[:, None, :])
                & eligible[:, None, :])
        pt, pu = prio[:, :, None], prio[:, None, :]
        et, eu = elig[:, :, None], elig[:, None, :]
        ahead = (pu > pt) | ((pu == pt) & ((eu < et) | (
            (eu == et) & (idx[:, None, :] < idx[:, :, None]))))
        pickable = eligible & (prio >= neg_big_t)
        if control:
            ut, uu = urg[:, :, None], urg[:, None, :]
            ahead = (uu > ut) | ((uu == ut) & ahead)
            stalled = (same & (uu > 0.5) & ~(pu >= neg_big_t[:, None, :])
                       ).any(dim=2)
            pickable = pickable & ~(stalled & (urg < 0.5))
        rank = (same & ahead).sum(dim=2, dtype=I32)
        admit = pickable & (rank < max_pes) \
            & (rank.to(F32) < to_task(free_v))
        start_now = eligible & (~is_space | admit)
        start = torch.where(start_now, t_next[:, None].expand_as(start),
                            start_base)
        running = running | start_now
        time = torch.where(live, t_next, time)
        new = [time, rem, running, start, finish, ready, maps_left_new]
        if control:
            # a shed map dooms the lane's reduces (J = 1): mark them shed
            # so they end the lane
            map_shed_any = (shed_t & ~is_red).sum(dim=1, dtype=I32) > 0
            shed = shed_t | (valid & is_red & map_shed_any[:, None]
                             & (finish >= _BIG / 2) & ~running)
            new += [hit, vm_open, vm_close, n_scale, shed, n_evict,
                    work_lost]
        if trace:
            t_open, t_new = carry[0], new[0]
            if control:
                new_shed = shed & ~shed0
                vals = (qdepth, busy_frac, n_open, count(affected),
                        count(new_shed), count(evicted))
                tv = lambda x: x[:, None].expand(N, V)         # noqa: E731
                tt = lambda x: x[:, None].expand(N, T)         # noqa: E731
                log = ((open_mask, tv(t_open), EV_SCALE_OPEN, None),
                       (close_mask, tv(t_open), EV_SCALE_CLOSE, None),
                       (done_now, tt(t_next), EV_FINISH, cur_vm),
                       (affected, f_t, EV_KILL, cur_vm),
                       (evicted, tt(t_next), EV_PREEMPT, cur_vm),
                       (start_now, tt(t_next), EV_START, cur_vm),
                       (new_shed, tt(t_new), EV_SHED, cur_vm))
            else:
                zero = torch.zeros_like(q_d)
                vals = (q_d, b_f, n_o, zero, zero, zero)
                log = ((done_now, t_next[:, None].expand(N, T), EV_FINISH,
                        task_vm),
                       (start_now, t_next[:, None].expand(N, T), EV_START,
                        task_vm))
            ev_n = _record(ts, ev, ev_n, active, lane_ep, t_new, vals, log,
                           vidx, idx)
        carry = [torch.where(active if x.dim() == 1 else active[:, None],
                             x, old) for x, old in zip(new, carry)]
        lane_ep = lane_ep + active.to(I32)
        n += 1
        active = active_lanes(carry)
    out = [carry[0][:, None], carry[1], carry[2].to(I32), carry[3],
           carry[4], carry[5], carry[6][:, None], lane_ep[:, None]]
    if control:
        out += [carry[7].to(I32), carry[8], carry[9], carry[10][:, None],
                carry[11].to(I32), carry[12], carry[13][:, None]]
    if trace:
        out += [ts.reshape(N, -1), *ev, ev_n[:, None]]
    return tuple(x.contiguous() for x in out)


def _record(ts, ev, ev_n, active, lane_ep, t_new, vals, log, vidx, idx):
    """Write one epoch's trace in place: the time-series row of each
    active lane at its epoch index (below the capacity), and each active
    lane's events at its cursor in ``log`` order, ``(mask, t, kind, vm)``
    per group (``vm=None``: a per-VM group, whose task is -1).  Returns the
    advanced cursor, which counts the events that did not fit too."""
    N, C, _ = ts.shape
    E = ev[0].shape[1]
    one = torch.ones_like(t_new)
    rows = (active & (lane_ep < C)).nonzero()[:, 0]
    row = torch.stack((t_new, *vals[:3], one, *vals[3:]), dim=1)
    ts[rows, lane_ep[rows].long()] = row[rows]
    mask = torch.cat([m for m, *_ in log], dim=1) & active[:, None]
    t_all = torch.cat([t for _, t, _, _ in log], dim=1)
    kind = torch.cat([torch.full_like(m, k, dtype=I32) for m, _, k, _ in log],
                     dim=1)
    task = torch.cat([(torch.full_like(m, -1, dtype=I32) if vm is None
                       else idx.expand_as(m).to(I32)) for m, _, _, vm in log],
                     dim=1)
    vm = torch.cat([(vidx.expand_as(m) if v is None else v).to(I32)
                    for m, _, _, v in log], dim=1)
    mi = mask.long()
    pos = ev_n[:, None].long() + torch.cumsum(mi, dim=1) - mi
    lane, k = (mask & (pos < E)).nonzero(as_tuple=True)
    slot = pos[lane, k]
    for buf, src in zip(ev, (t_all, kind, task, vm)):
        buf[lane, slot] = src[lane, k]
    return ev_n + mask.sum(dim=1, dtype=I32)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_SPEC_T, _SPEC_1, _SPEC_V = "T", "1", "V"
# (name, dtype, width) of the lane data the kernel reads, in its C order
_LANE_DATA = (("task_vm", I32, _SPEC_T), ("is_red", I32, _SPEC_T),
              ("valid", I32, _SPEC_T), ("shuffle", F32, _SPEC_1),
              ("vm_mips", F32, _SPEC_V), ("vm_pes", F32, _SPEC_V),
              ("sched_policy", I32, _SPEC_1), ("vm_start", F32, _SPEC_V),
              ("vm_stop", F32, _SPEC_V), ("spinup", F32, _SPEC_1),
              ("prio", F32, _SPEC_T))
# the control instantiation reads task_len (kills restart a task from it)
# and the carried lease windows in place of vm_start/vm_stop
_LANE_DATA_CONTROL = (
    ("task_len", F32, _SPEC_T),
    *(d for d in _LANE_DATA if d[0] not in ("vm_start", "vm_stop")),
    ("vm_valid", I32, _SPEC_V), ("vm_fail", F32, _SPEC_V),
    ("vm_restore", F32, _SPEC_V), ("vm_auto", I32, _SPEC_V),
    ("ctl_policy", I32, _SPEC_1), ("ctl_queue", F32, _SPEC_1),
    ("ctl_busy", F32, _SPEC_1), ("redispatch", F32, _SPEC_1),
    ("task_vm2", I32, _SPEC_T), ("refetch", F32, _SPEC_T),
    ("task_deadline", F32, _SPEC_T), ("dl_policy", I32, _SPEC_1),
    ("dl_slack", F32, _SPEC_1), ("preempt", I32, _SPEC_1),
    ("preempt_resume", I32, _SPEC_1))
_STATE_SPEC = (("time", F32, _SPEC_1), ("rem", F32, _SPEC_T),
               ("running", I32, _SPEC_T), ("start", F32, _SPEC_T),
               ("finish", F32, _SPEC_T), ("ready", F32, _SPEC_T),
               ("maps_left", I32, _SPEC_1), ("n_epochs", I32, _SPEC_1))
_STATE_SPEC_CONTROL = _STATE_SPEC + (
    ("hit", I32, _SPEC_T), ("vm_open", F32, _SPEC_V),
    ("vm_close", F32, _SPEC_V), ("n_scale", I32, _SPEC_1),
    ("shed", I32, _SPEC_T), ("n_evict", I32, _SPEC_T),
    ("work_lost", F32, _SPEC_1))
# an open-loop trace reads vm_valid (the open-VM observable) as one more
# lane input, as the Pallas kernel does; under control it is lane data
_SPEC_TS, _SPEC_E = "C8", "E"
_TRACE_SPEC = (("ts", F32, _SPEC_TS), ("ev_t", F32, _SPEC_E),
               ("ev_kind", I32, _SPEC_E), ("ev_task", I32, _SPEC_E),
               ("ev_vm", I32, _SPEC_E), ("ev_n", I32, _SPEC_1))


def _check(name, x, dtype, shape, device, kernel="mr_epoch"):
    """Raise unless ``x`` is a contiguous tensor of this dtype and shape on
    the batch's device (a kernel reads raw pointers)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, the batch on "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


_LIBS: dict[tuple[bool, bool], ctypes.CDLL] = {}
# launches that found their instantiation's library bound, and bindings
# (each loading the library, built with nvcc first if missing)
_LIB_CACHE = {"hits": 0, "misses": 0}


def instantiation(control: bool, trace: bool) -> str:
    """The kernel library (``_build.LIBRARIES`` key) of an instantiation."""
    return "mr_epoch" + ("_control" if control else "") \
        + ("_trace" if trace else "")


def _specs(control: bool, trace: bool):
    """``(lane-data spec, state spec)`` of an instantiation, C order."""
    lane = _LANE_DATA_CONTROL if control else _LANE_DATA
    if trace and not control:
        lane = lane + (("vm_valid", I32, _SPEC_V),)
    state = _STATE_SPEC_CONTROL if control else _STATE_SPEC
    return lane, state + (_TRACE_SPEC if trace else ())


def _lib(control: bool, trace: bool = False):
    """The built kernel library of one instantiation, its C signature
    declared."""
    key = (control, trace)
    _LIB_CACHE["hits" if key in _LIBS else "misses"] += 1
    if key not in _LIBS:
        from .. import _build
        name = instantiation(control, trace)
        lib = _build.load(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lane, state = _specs(control, trace)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [p] * (len(lane) + 2 * len(state) + 1) \
            + [i] * (8 if trace else 6) + [f] * 4 + [p]
        fn.restype = ctypes.c_int
        _LIBS[key] = fn
    return _LIBS[key]


def mr_epoch(task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips,
             vm_pes, sched_policy, vm_start, vm_stop, spinup, prio,
             vm_valid=None, vm_fail=None, vm_restore=None, vm_auto=None,
             ctl_policy=None, ctl_queue=None, ctl_busy=None,
             redispatch=None, task_vm2=None, refetch=None,
             task_deadline=None, dl_policy=None, dl_slack=None,
             preempt=None, preempt_resume=None, state=None, *,
             max_pes: int = 8, epoch_limit: int | None = None,
             control: bool = False, trace: bool = False):
    """Advance every lane through its event epochs (the JAX ``mr_epoch``
    signature).

    Lane data, all led by the lane dim N: ``task_len``/``ready0``/``prio``
    ``(N,T)`` f32; ``task_vm``/``is_red``/``valid`` ``(N,T)`` i32;
    ``shuffle``/``spinup`` ``(N,1)`` f32; ``sched_policy`` ``(N,1)`` i32;
    ``vm_mips``/``vm_pes``/``vm_start``/``vm_stop`` ``(N,V)`` f32.
    ``control=True`` takes the fifteen control tensors too, in
    ``ops.control_lane_data`` order: ``vm_valid``/``vm_auto`` ``(N,V)``
    i32, ``vm_fail``/``vm_restore`` ``(N,V)`` f32, ``ctl_policy``,
    ``dl_policy``, ``preempt``, ``preempt_resume`` ``(N,1)`` i32,
    ``ctl_queue``, ``ctl_busy``, ``redispatch``, ``dl_slack`` ``(N,1)``
    f32, ``task_vm2`` ``(N,T)`` i32, ``refetch``/``task_deadline``
    ``(N,T)`` f32.

    ``trace=True`` appends the six trace leaves to the carry (see
    :func:`initial_state`); an open-loop trace takes ``vm_valid`` ``(N,V)``
    i32 as its one control tensor.

    ``state`` is a carry in :func:`initial_state` layout, 8 leaves or 15
    under control, 6 more under trace (default: the t=0 state with the
    default capacities, which reads ``task_len``/``ready0``; on resume
    ``ready0`` may be ``None``).  ``max_pes`` must cover the largest per-VM
    PE count; ``epoch_limit`` caps this call's epochs (default
    :func:`default_epoch_limit`: to the end).  Each lane stops at its own
    end.  Returns the advanced carry.

    CUDA tensors launch the kernel of the instantiation (or raise); CPU
    tensors take :func:`mr_epoch_plain`.  ``mr_epoch.launches``,
    ``control_launches``, ``trace_launches`` and ``control_trace_launches``
    count the four instantiations' launches.
    """
    ctl = (vm_valid, vm_fail, vm_restore, vm_auto, ctl_policy, ctl_queue,
           ctl_busy, redispatch, task_vm2, refetch, task_deadline,
           dl_policy, dl_slack, preempt, preempt_resume)
    if task_vm.device.type == "cpu":
        return mr_epoch_plain(task_len, task_vm, ready0, is_red, valid,
                              shuffle, vm_mips, vm_pes, sched_policy,
                              vm_start, vm_stop, spinup, prio, *ctl,
                              state=state, max_pes=max_pes,
                              epoch_limit=epoch_limit, control=control,
                              trace=trace)
    if task_vm.device.type != "cuda":
        raise ValueError(f"mr_epoch: no kernel for device {task_vm.device}")
    _check_control(control, ctl, trace)
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if state is None:
        _check("task_len", task_len, F32, (N, T), dev)
        _check("ready0", ready0, F32, (N, T), dev)
        _check("vm_start", vm_start, F32, (N, V), dev)
        _check("vm_stop", vm_stop, F32, (N, V), dev)
        caps = _trace_caps(T, V, control, trace, None) or (None, None)
        state = initial_state(task_len, ready0, is_red, valid, vm_start,
                              vm_stop, vm_auto if control else None, *caps)
    if epoch_limit is None:
        epoch_limit = default_epoch_limit(T, V, control)
    spec, state_spec = _specs(control, trace)
    if len(state) != len(state_spec):
        raise ValueError(f"mr_epoch: state must have {len(state_spec)} "
                         f"leaves, got {len(state)}")
    if max_pes < 0 or epoch_limit < 0:
        raise ValueError("mr_epoch: max_pes and epoch_limit must be >= 0")
    width = {_SPEC_T: T, _SPEC_1: 1, _SPEC_V: V}
    caps = ()
    if trace:
        ts, ev_t = state[-len(_TRACE_SPEC)], state[-len(_TRACE_SPEC) + 1]
        C, E = ts.shape[-1] // N_TS_COLS, ev_t.shape[-1]
        width.update({_SPEC_TS: C * N_TS_COLS, _SPEC_E: E})
        caps = (C, E)
    if control:
        data = (task_len, task_vm, is_red, valid, shuffle, vm_mips, vm_pes,
                sched_policy, spinup, prio, *ctl)
    else:
        data = (task_vm, is_red, valid, shuffle, vm_mips, vm_pes,
                sched_policy, vm_start, vm_stop, spinup, prio,
                *ctl[:int(trace)])
    for (name, dtype, w), x in zip(spec, data):
        _check(name, x, dtype, (N, width[w]), dev)
    for (name, dtype, w), x in zip(state_spec, state):
        _check(f"state.{name}", x, dtype, (N, width[w]), dev)
    lanes, shared_sets = block_layout(T, V, control, trace)
    out = tuple(torch.empty_like(x) for x in state)
    if N == 0:
        return out
    # the VMs' task sets (2 per VM under control), where shared memory
    # cannot hold them; the kernel fills them
    sets = None if shared_sets else torch.empty(
        N * (1 + control) * V * ((T + 31) // 32), dtype=I32, device=dev)
    launch = _lib(control, trace)
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            *(x.data_ptr() for x in data), *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in out),
            None if sets is None else sets.data_ptr(), N, T, V,
            int(max_pes), int(epoch_limit), lanes, *caps,
            float(f32(_BIG)), float(f32(_BIG / 2)), float(f32(_TIME_EPS)),
            float(f32(1e-30)), stream)
    if err != 0:
        raise RuntimeError(f"mr_epoch: kernel launch failed with CUDA error "
                           f"{err}")
    counter = ("control_" if control else "") \
        + ("trace_" if trace else "") + "launches"
    setattr(mr_epoch, counter, getattr(mr_epoch, counter) + 1)
    return out


mr_epoch.launches = 0
mr_epoch.control_launches = 0
mr_epoch.trace_launches = 0
mr_epoch.control_trace_launches = 0
LAUNCH_COUNTERS = ("launches", "control_launches", "trace_launches",
                   "control_trace_launches")


def total_launches() -> int:
    """Launches of every ``mr_epoch`` instantiation so far."""
    return sum(getattr(mr_epoch, c) for c in LAUNCH_COUNTERS)

# shared memory one lane (one warp) of the kernel holds, as bytes per task,
# per VM, per VM and task-set word, and per task-set word (W = ceil(T/32)
# words hold one bit per task): the open loop keeps each VM's task set and
# three per-epoch sets, the control lowering two sets per VM (bound,
# failover) and six per-epoch sets; the control trace instantiation keeps
# two more flags per task (killed, newly shed) and per VM (opened, closed)
_LANE_BYTES = {(False, False): (11 * 4 + 4 + 5, 5 * 4, 4, 3 * 4),
               (True, False): (13 * 4 + 4 * 4 + 12, 9 * 4 + 4 * 4 + 3, 8,
                               6 * 4)}
_LANE_BYTES[(False, True)] = _LANE_BYTES[(False, False)]
_LANE_BYTES[(True, True)] = (13 * 4 + 4 * 4 + 14, 9 * 4 + 4 * 4 + 5, 8,
                             6 * 4)
# dynamic shared memory one block may take on the H100 (228 KB per SM, 1 KB
# of it reserved for each block)
SMEM_PER_BLOCK = 232_448


def lane_smem_bytes(T: int, V: int, control: bool = False,
                    trace: bool = False, shared_sets: bool = True) -> int:
    """Bytes of shared memory one lane of the kernel keeps (16-aligned);
    ``shared_sets=False``: with the VMs' task sets in global scratch."""
    per_t, per_v, per_vw, per_w = _LANE_BYTES[(control, trace)]
    W = (T + 31) // 32
    vw = V * W if shared_sets else 0
    return (per_t * T + per_v * V + per_vw * vw + per_w * W + 15) \
        // 16 * 16


def fit_lanes(with_sets: int, without_sets: int, most: int,
              what: str) -> tuple[int, bool]:
    """``(lanes per block, VM task sets in shared memory)`` of a kernel
    whose lane takes ``with_sets`` bytes of shared memory with its VMs'
    task sets there and ``without_sets`` with them in global scratch: the
    sets stay in shared memory while the lane fits a block with them, and
    a block takes up to ``most`` lanes.  Raises ``ValueError`` when even
    ``without_sets`` exceeds :data:`SMEM_PER_BLOCK`."""
    for per_lane, shared in ((with_sets, True), (without_sets, False)):
        if per_lane <= SMEM_PER_BLOCK:
            return min(most, SMEM_PER_BLOCK // per_lane), shared
    raise ValueError(f"{what} needs {without_sets} bytes of shared memory "
                     f"per lane, above the {SMEM_PER_BLOCK} bytes a block "
                     "can take")


def block_layout(T: int, V: int, control: bool = False,
                 trace: bool = False) -> tuple[int, bool]:
    """``(lanes per block, VM task sets in shared memory)`` of a launch.

    Up to 2 lanes (warps) per block.  A launch lasts as long as its
    slowest lane, and smaller blocks spread a bucket's lanes more evenly
    over the SMs (on the H100, 1 and 2 lanes per block ran the
    65,536-cell grids' buckets fastest, 4 and 8 slower); 2 keeps 64 warps
    resident per SM on batches too large for one wave, where 1 would keep
    32.  The VMs' task sets (V x ceil(T/32) words, twice under control) go
    to global scratch when a lane does not fit a block with them.

    The ceiling: a lane must fit :data:`SMEM_PER_BLOCK` (232,448 bytes)
    without its task sets, i.e. ``lane_smem_bytes(T, V, control, trace,
    shared_sets=False) <= 232448``: open loop ``53 T + 20 V + 12 W``, so
    T <= 4351 at V = 9 and T <= 3971 at V = 1024; control ``80 T + 55 V +
    24 W`` (traced ``82 T + 57 V + 24 W``), T <= 2872 (2802) at V = 9 and
    T <= 2180 (2103) at V = 1024.  Beyond it ``ValueError``."""
    return fit_lanes(lane_smem_bytes(T, V, control, trace),
                     lane_smem_bytes(T, V, control, trace, False), 2,
                     f"mr_epoch: T={T}, V={V}")
