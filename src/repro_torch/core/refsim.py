"""Sequential discrete-event reference simulator (the paper-faithful oracle).

This module mirrors IOTSim's entity structure (paper Figures 5–7) directly:

* :class:`IoTSimBroker`  — accepts multiple cloudlet lists and executes them
  *sequentially* (reduce list of a job only after its map list), the paper's
  §4.5 extension to CloudSim's single-list broker;
* :class:`JobTracker`    — splits a job into ``MapCloudlet``/``ReduceCloudlet``
  tasks, tracks map completion, triggers the shuffle and the reduce launch;
* :class:`TaskTracker`   — binds tasks to VMs per the scenario's
  :class:`~repro_torch.core.config.BindingPolicy` (round-robin as CloudSim's
  DatacenterBroker does, least-loaded, or locality-style packing) and
  manages per-VM execution slots;
* the datacentre executes cloudlets under the scenario's
  :class:`~repro_torch.core.config.SchedPolicy`: **time-shared**
  (CloudletSchedulerTimeShared — ``n`` concurrent 1-PE cloudlets on a VM
  with ``pes`` PEs at ``mips`` each run at ``mips * min(1, pes / n)``) or
  **space-shared** (CloudletSchedulerSpaceShared — at most ``pes`` run at
  full ``mips``; the rest wait in a per-VM (ready, id)-ordered queue).

The event loop is a classic heapq calendar; processor-sharing completions are
computed lazily between calendar events (rates only change at arrivals and
completions, so the fluid dynamics are exact, not time-stepped).

This implementation is deliberately *sequential and simple*: host Python
over numpy, with no device.  It is the oracle the port's ``mr_epoch``
kernel and engine body are held against, and it consumes the same shared
artifacts as the array encoders (``storage.scenario_placement``,
``control.scenario_control``, ``elasticity.scenario_windows``,
``config.base_task_lengths_f32``), so no layer can drift.  Its float ops are
the JAX package's ``refsim`` op for op, and the f32 predicates (binding
load, SHED/BOOST, refetch delays) use the numpy forms of the helpers the
encoders use.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field

import numpy as np

from . import control, elasticity, network, storage, telemetry
from .config import (BindingPolicy, Scenario, SchedPolicy,
                     base_task_lengths_f32)
# the engine's masked-argmin fill: LOCALITY's candidate masking must use
# the exact value engine.bind_tasks uses or the two layers' f32 argmin
# sequences could diverge on a (pathological) load that reaches the fill
from .engine import _BIG

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Task records
# ---------------------------------------------------------------------------

@dataclass
class Task:
    """One MapCloudlet or ReduceCloudlet instance."""
    job: int
    index: int                 # index within its job's phase
    is_reduce: bool
    length_mi: float           # work in MI
    vm: int = -1               # bound VM (round-robin at creation)
    ready: float = math.inf    # time the task may start (stage-in/shuffle done)
    start: float = math.inf
    finish: float = math.inf
    remaining: float = 0.0     # MI left (engine state)
    priority: float = 0.0      # space-shared admission priority (job-level)
    deadline: float = math.inf  # completion deadline (DESIGN.md §11),
    #                             f32-encoded like the engine's column
    shed: bool = False         # refused by deadline admission control
    n_evict: int = 0           # times preempted (capped at 2)

    @property
    def exec_time(self) -> float:
        return self.finish - self.start


@dataclass
class JobResult:
    """Per-job dependent variables (paper §5.3).

    ``map_avg_exec`` / ``reduce_avg_exec`` split the paper's Average
    Execution Time into its two addends: the paper's Fig 9 percentages
    (≈40%/≈50%) are reproduced by the *map-phase* average (see
    EXPERIMENTS.md §Paper-validation).
    """
    avg_exec: float
    max_exec: float
    min_exec: float
    makespan: float
    delay_time: float
    vm_cost: float
    network_cost: float
    map_avg_exec: float = 0.0
    reduce_avg_exec: float = 0.0


@dataclass
class SimResult:
    tasks: list[Task]
    jobs: list[JobResult]
    finish_time: float
    n_events: int = 0
    # closed-loop control counters (DESIGN.md §10; zero open-loop)
    failures_injected: int = 0
    tasks_redispatched: int = 0
    scale_events: int = 0
    recovered_fraction: float = 0.0
    # graceful-degradation counters (DESIGN.md §11; zero without
    # deadlines/preemption — parity-pinned against the engine's SLO layer)
    shed_tasks: int = 0
    preemptions: int = 0
    # event mirror (DESIGN.md §12): ``(t, kind, task, vm)`` rows in
    # simulation order, kinds from ``telemetry.EVENT_NAMES`` — the
    # engine's device-side event log must reduce to exactly these
    # counts (and timestamps, SHED excepted) per kind
    events: list = field(default_factory=list)

    def job(self, j: int = 0) -> JobResult:
        return self.jobs[j]


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------

class TaskTracker:
    """Binds tasks to VMs per the broker's binding policy and manages the
    per-VM execution state: active sets (both policies) and, under
    SPACE_SHARED, the (priority desc, eligible time, id)-ordered wait
    queues for the PE slots.  ``avail``/``close`` are the per-VM lease
    admission windows (DESIGN.md §8): tasks are admitted only at times
    ``t`` with ``avail[vm] <= t < close[vm]``.
    """

    def __init__(self, vms, sched_policy=SchedPolicy.TIME_SHARED,
                 binding_policy=BindingPolicy.ROUND_ROBIN,
                 avail=None, close=None):
        self.vms = tuple(vms)
        self.n_vms = len(self.vms)
        self.sched = SchedPolicy(sched_policy)
        self.binding = BindingPolicy(binding_policy)
        self.avail = (np.zeros(self.n_vms) if avail is None
                      else np.asarray(avail, float))
        self.close = (np.full(self.n_vms, math.inf) if close is None
                      else np.asarray(close, float))
        self._rr = 0
        # least-loaded bookkeeping: float32 on purpose — the vectorized
        # engine accumulates in f32, and both layers must pick the same VM
        self._load = np.zeros(self.n_vms, np.float32)
        # packed slots: [vm0]*pes0 ++ [vm1]*pes1 ++ ...
        self._slots = [vi for vi, vm in enumerate(self.vms)
                       for _ in range(int(vm.pes))]
        self.active: list[set[int]] = [set() for _ in range(self.n_vms)]
        self.queue: list[list[tuple[float, float, int]]] = \
            [[] for _ in range(self.n_vms)]

    def bind(self, task: Task, base_len: np.float32,
             cand: np.ndarray | None = None) -> None:
        """``base_len`` is the pre-multiplier task length computed with the
        f32 op sequence shared by every layer (see engine.bind_tasks);
        ``cand`` is LOCALITY's candidate-VM mask (replica holders of the
        task's input block; ``None`` — all VMs — degenerates the rule to
        LEAST_LOADED's exact argmin sequence)."""
        if self.binding in (BindingPolicy.LEAST_LOADED,
                            BindingPolicy.LOCALITY):
            masked = self._load
            if self.binding == BindingPolicy.LOCALITY and cand is not None:
                masked = np.where(cand, self._load, np.float32(_BIG))
            vm = int(np.argmin(masked))
            self._load[vm] += base_len / (np.float32(self.vms[vm].mips)
                                          * np.float32(self.vms[vm].pes))
        elif self.binding == BindingPolicy.PACKED:
            vm = self._slots[self._rr % len(self._slots)]
        else:
            vm = self._rr % self.n_vms
        task.vm = vm
        self._rr += 1

    def launch(self, tid: int, task: Task) -> None:
        self.active[task.vm].add(tid)

    def complete(self, tid: int, task: Task) -> None:
        self.active[task.vm].discard(tid)

    # ---- SPACE_SHARED slot management ------------------------------------

    def has_free_slot(self, vm: int) -> bool:
        return len(self.active[vm]) < int(self.vms[vm].pes)

    def eligible_at(self, task: Task) -> float:
        """Earliest admissible instant: data readiness joined with the
        bound VM's lease-open edge (the lease start *is* a calendar
        event — arrival events are scheduled at this time)."""
        return max(task.ready, self.avail[task.vm])

    def is_open(self, vm: int, t: float) -> bool:
        """The lease admits new tasks at ``t`` (strictly before close)."""
        return t < self.close[vm]

    def enqueue(self, tid: int, task: Task) -> None:
        heapq.heappush(self.queue[task.vm],
                       (-task.priority, self.eligible_at(task), tid))

    def admit(self, vm: int, now: float) -> int | None:
        """Pop the highest-priority queued task if a PE slot is free and
        the lease is still open; a closed lease strands its queue."""
        if self.queue[vm] and self.has_free_slot(vm) \
                and self.is_open(vm, now):
            return heapq.heappop(self.queue[vm])[2]
        return None


class JobTracker:
    """Splits jobs, watches map completion, triggers shuffle + reduce."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.maps_left = [j.n_maps for j in scenario.jobs]
        self.tasks: list[Task] = []
        self.map_ids: list[list[int]] = []
        self.reduce_ids: list[list[int]] = []
        for ji, job in enumerate(scenario.jobs):
            m_ids, r_ids = [], []
            # deadline encoded exactly like the engine's f32 column
            dl = float(np.float32(min(job.deadline, _BIG)))
            for mi in range(job.n_maps):
                m_ids.append(len(self.tasks))
                self.tasks.append(Task(ji, mi, False,
                                       job.length_mi / job.n_maps,
                                       priority=job.priority, deadline=dl))
            for ri in range(job.n_reduces):
                r_ids.append(len(self.tasks))
                self.tasks.append(Task(
                    ji, ri, True,
                    job.reduce_factor * job.length_mi / job.n_reduces,
                    priority=job.priority, deadline=dl))
            self.map_ids.append(m_ids)
            self.reduce_ids.append(r_ids)

    def map_finished(self, task: Task, now: float) -> float | None:
        """Returns the reduce-ready time if this was the job's last map."""
        self.maps_left[task.job] -= 1
        if self.maps_left[task.job] == 0:
            job = self.scenario.jobs[task.job]
            return now + network.shuffle_delay(job, self.scenario.network)
        return None


class IoTSimBroker:
    """Drives the simulation: sequential cloudlet lists per job (paper §4.5)."""

    def __init__(self, scenario: Scenario,
                 length_multipliers: list[float] | None = None):
        self.scenario = scenario
        self.jt = JobTracker(scenario)
        # Lease admission windows (DESIGN.md §8): avail = start + spinup,
        # close = stop — the same realized quantities the array encoders
        # carry as vm_start/vm_stop/spinup_delay.
        avail, close = elasticity.scenario_windows(scenario)
        self.tt = TaskTracker(scenario.vms, scenario.sched_policy,
                              scenario.binding_policy,
                              avail=avail, close=close)
        # Storage subsystem (DESIGN.md §7): the same realized placement
        # the array encoders consume (one shared helper — the layers
        # cannot drift), reshaped into per-task candidate masks.
        n_tasks = len(self.jt.tasks)
        n_vms = len(scenario.vms)
        self._cand: list[np.ndarray | None] = [None] * n_tasks
        bvm, self._block_mb = storage.scenario_placement(scenario, n_vms)
        for tid in range(n_tasks):
            holders = bvm[tid][bvm[tid] >= 0]
            if holders.size:
                mask = np.zeros(n_vms, bool)
                mask[holders] = True
                self._cand[tid] = mask
        # Bind every task in submission order: per job, the map list is
        # submitted first, then (later, after maps) the reduce list;
        # CloudSim's broker keeps one rolling VM pointer across submissions.
        # Base lengths for the load estimate use the shared f32 op sequence
        # (not the f64 task lengths) so binding matches the engine exactly.
        f32 = np.float32
        for tid, t in enumerate(self.jt.tasks):
            job = scenario.jobs[t.job]
            map_l, red_l = base_task_lengths_f32(
                f32(job.length_mi), f32(job.n_maps), f32(job.n_reduces),
                f32(job.reduce_factor))
            self.tt.bind(t, red_l if t.is_reduce else map_l,
                         cand=self._cand[tid])
        if length_multipliers is not None:
            if len(length_multipliers) != len(self.jt.tasks):
                raise ValueError(
                    f"length_multipliers: expected one entry per task "
                    f"({len(self.jt.tasks)}), got {len(length_multipliers)}"
                    f" — the multiplier list must match the scenario's "
                    f"task count (maps then reduces, per job)")
            for t, m in zip(self.jt.tasks, length_multipliers):
                t.length_mi *= m
        # Closed-loop control (DESIGN.md §10): the same realized failure
        # streams / reserve markers the array encoders consume, plus the
        # shared failover-target resolution against the block store and
        # the shared remote-fetch delay a moved task pays on its new VM.
        self._ctl = scenario.control
        self._policy = control.ControlPolicy(self._ctl.policy)
        vm_fail, vm_restore, vm_auto = control.scenario_control(
            scenario, n_vms)
        self._vm_fail = vm_fail.astype(np.float64)
        self._vm_restore = vm_restore.astype(np.float64)
        self._vm_auto = vm_auto
        task_vm = np.asarray([t.vm for t in self.jt.tasks], np.int32)
        self._task_vm2 = control.failover_targets_np(
            task_vm, np.ones(n_vms, bool), vm_auto, bvm)
        self._refetch2 = np.asarray(storage.remote_fetch_delay_np(
            bvm, self._block_mb, self._task_vm2,
            np.float32(scenario.network.kappa_in),
            np.float32(scenario.network.bw_mbps),
            np.float32(1.0 if scenario.network.enabled else 0.0)),
            np.float64)
        # reserve VMs admit nothing until the control hook opens them
        self.tt.avail = np.where(vm_auto, math.inf, self.tt.avail)
        self._opened: set[int] = set()
        self._n_scale = 0
        # graceful degradation (DESIGN.md §11)
        self._dlpol = control.DeadlinePolicy(self._ctl.deadline_policy)
        self._dl_slack = np.float32(self._ctl.deadline_slack)
        self._preempt = bool(self._ctl.preempt)
        self._resume = bool(self._ctl.preempt_resume)
        self._n_preempt = 0

    # ---- event-driven run ------------------------------------------------

    def run(self) -> SimResult:
        sc = self.scenario
        tasks = self.jt.tasks
        vms = sc.vms
        # (time, seq, task_id, generation): the generation stamp makes
        # events *revocable* — a control action (failure re-dispatch,
        # reserve open) bumps the task's generation and re-pushes, so the
        # superseded calendar entry is skipped at pop time
        calendar: list[tuple[float, int, int, int]] = []
        events: list[tuple[float, int, int, int]] = []
        seq = itertools.count()
        gen = [0] * len(tasks)
        hit = [False] * len(tasks)

        def gate(x: float, vm: int) -> float:
            """The engine's failure-window gate: an instant inside the
            VM's down window [F, R) is deferred to the restore edge."""
            f, r = self._vm_fail[vm], self._vm_restore[vm]
            return r if f <= x < r else x

        def shed_at(tid: int, at: float) -> bool:
            """The engine's SHED predicate (DESIGN.md §11), same shared
            f32 op sequence: earliest possible finish at the bound VM's
            full per-PE rate already past the deadline."""
            task = tasks[tid]
            if self._dlpol != control.DeadlinePolicy.SHED \
                    or task.deadline >= _BIG / 2:
                return False
            efin = control.earliest_finish_np(
                np.float32(at), np.float32(task.remaining),
                np.float32(vms[task.vm].mips))
            return bool(efin > np.float32(task.deadline))

        def mark_shed(tid: int, at: float) -> None:
            """Shed once: orphan-reduce marking can re-touch a task
            already shed by admission control — only the first refusal
            is an event (the engine's ``new_shed`` edge mask)."""
            task = tasks[tid]
            if not task.shed:
                task.shed = True
                events.append((at, telemetry.EV_SHED, tid, task.vm))

        def urgent(tid: int) -> bool:
            """The engine's BOOST urgency predicate, evaluated at the
            current clock (pop time — urgency grows as slack shrinks)."""
            task = tasks[tid]
            if self._dlpol != control.DeadlinePolicy.BOOST \
                    or task.deadline >= _BIG / 2:
                return False
            efin = control.earliest_finish_np(
                np.float32(now), np.float32(task.remaining),
                np.float32(vms[task.vm].mips))
            return bool(efin + self._dl_slack >= np.float32(task.deadline))

        def push_arrival(tid: int) -> None:
            task = tasks[tid]
            if task.shed:
                return
            elig = gate(self.tt.eligible_at(task), task.vm)
            if not self.tt.is_open(task.vm, elig):
                return
            if shed_at(tid, elig):     # push-time admission control
                mark_shed(tid, elig)
                return
            heapq.heappush(calendar, (elig, next(seq), tid, gen[tid]))

        # Map tasks become ready at submit + stage-in delay (+ the storage
        # remote-fetch delay when bound off the input block's replica set).
        # The *arrival event* lands at the eligible time — readiness joined
        # with the bound VM's lease-open edge, so lease starts are calendar
        # events — and is never scheduled at all when it would fall at or
        # past the lease close (the task is stranded: finish stays inf).
        for ji, job in enumerate(sc.jobs):
            ready = job.submit_time + network.stage_in_delay(job, sc.network)
            for tid in self.jt.map_ids[ji]:
                cand = self._cand[tid]
                fetch = 0.0
                if cand is not None and not cand[tasks[tid].vm]:
                    fetch = network.transfer_delay(
                        sc.network.kappa_in, float(self._block_mb[tid]),
                        0.0, sc.network.bw_mbps,
                        1.0 if sc.network.enabled else 0.0)
                tasks[tid].ready = ready + fetch
                push_arrival(tid)

        for t in tasks:
            t.remaining = t.length_mi

        running: set[int] = set()
        now = 0.0
        n_events = 0
        space = self.tt.sched == SchedPolicy.SPACE_SHARED
        fail_pending = [v for v in range(self.tt.n_vms)
                        if self._vm_fail[v] < _BIG / 2]

        def rates() -> dict[int, float]:
            """Per-running-task rates — computed once per event epoch.

            Under SPACE_SHARED the slot gate keeps ``n <= pes``, so every
            running task owns a full PE at ``mips``; the time-shared fluid
            share degenerates to the same value, hence one formula.
            """
            out = {}
            for tid in running:
                t = tasks[tid]
                n = len(self.tt.active[t.vm])
                vm = vms[t.vm]
                out[tid] = vm.mips * min(1.0, vm.pes / n)
            return out

        def start_task(tid: int) -> None:
            task = tasks[tid]
            task.start = now
            self.tt.launch(tid, task)
            running.add(tid)
            events.append((now, telemetry.EV_START, tid, task.vm))

        def admit(vm: int) -> int | None:
            """Deadline-aware admission (DESIGN.md §11): pops the
            admission-order head, discarding queued tasks whose decision
            window closed while they waited (the engine's pop-time SHED
            check).  Under BOOST the heap key is stale — urgency is a
            function of the clock — so the head is a linear scan by
            (urgent desc, priority desc, eligible, id); with no BOOST
            lanes this is exactly ``TaskTracker.admit``."""
            q = self.tt.queue[vm]
            while q and self.tt.has_free_slot(vm) \
                    and self.tt.is_open(vm, now):
                if self._dlpol == control.DeadlinePolicy.BOOST:
                    i = min(range(len(q)),
                            key=lambda j: (not urgent(q[j][2]),) + q[j])
                    tid = q.pop(i)[2]
                else:
                    tid = heapq.heappop(q)[2]
                if shed_at(tid, now):
                    mark_shed(tid, now)
                    continue
                return tid
            return None

        def evict(tid: int) -> None:
            """Preempt a running task — the §10 failure-kill op
            sequence driven by the policy mask: progress reset (kept
            under preempt_resume), re-dispatch latency, first hit moves
            to the failover slot and pays the re-replication fetch."""
            task = tasks[tid]
            events.append((now, telemetry.EV_PREEMPT, tid, task.vm))
            task.n_evict += 1
            self._n_preempt += 1
            running.discard(tid)
            self.tt.complete(tid, task)
            if not self._resume:
                task.remaining = task.length_mi
            task.start = math.inf
            task.ready = max(task.ready, now + self._ctl.redispatch_delay)
            if not hit[tid]:
                hit[tid] = True
                task.vm = int(self._task_vm2[tid])
                task.ready += float(self._refetch2[tid])
            gen[tid] += 1
            if task.ready < math.inf:
                push_arrival(tid)

        def preempt_pass() -> None:
            """The engine's per-epoch eviction rule, event-wise: on each
            full space-shared VM, while a queued (non-shed) task's raw
            priority strictly beats the weakest still-evictable running
            task (lowest priority, latest index), that victim loses its
            PE and the admission-order head takes it.  Runs after every
            event batch — the running set only changes at events."""
            if not self._preempt or not space:
                return
            for vm in range(self.tt.n_vms):
                while self.tt.queue[vm] and self.tt.is_open(vm, now) \
                        and not self.tt.has_free_slot(vm):
                    vics = [t for t in self.tt.active[vm]
                            if tasks[t].n_evict < 2]
                    if not vics:
                        break
                    v = min(vics, key=lambda t: (tasks[t].priority, -t))
                    if not any(tasks[e[2]].priority > tasks[v].priority
                               and not shed_at(e[2], now)
                               for e in self.tt.queue[vm]):
                        break
                    evict(v)
                    qid = admit(vm)
                    if qid is None:
                        break
                    start_task(qid)

        def control_hook() -> None:
            """The engine's per-epoch control rule, event-wise: evaluated
            at the top of every loop iteration at the current clock (the
            engine evaluates at ``c.time`` before stepping to the next
            event), opening one reserve per evaluation while both
            thresholds are exceeded and closing drained opened reserves.
            ``NONE`` makes this a no-op — the open-loop path is
            untouched."""
            if self._policy != control.ControlPolicy.AUTOSCALE:
                return
            # close opened reserves with no unfinished bound tasks
            # (shed tasks are out of the system: refused backlog neither
            # holds a reserve open nor counts toward scaling pressure)
            for v in sorted(self._opened):
                if now < self.tt.close[v] and not any(
                        t.finish == math.inf and not t.shed and t.vm == v
                        for t in tasks):
                    self.tt.close[v] = now
                    self._n_scale += 1
                    events.append((now, telemetry.EV_SCALE_CLOSE, -1, v))
            qdepth = sum(1 for t in tasks
                         if t.finish == math.inf and t.start == math.inf
                         and not t.shed and t.ready <= now)
            open_vms = [v for v in range(self.tt.n_vms)
                        if self.tt.avail[v] <= now < self.tt.close[v]]
            busy = sum(1 for v in open_vms if self.tt.active[v])
            busy_frac = busy / max(len(open_vms), 1)
            if qdepth > self._ctl.queue_threshold \
                    and busy_frac >= self._ctl.busy_threshold:
                unopened = [v for v in range(self.tt.n_vms)
                            if self._vm_auto[v] and v not in self._opened]
                if unopened:
                    v = unopened[0]        # lowest index first, one/epoch
                    self._opened.add(v)
                    self.tt.avail[v] = now + sc.elasticity.spinup_delay
                    self._n_scale += 1
                    events.append((now, telemetry.EV_SCALE_OPEN, -1, v))
                    # the lease edge re-arms pending arrivals bound here
                    for tid, t in enumerate(tasks):
                        if t.finish == math.inf and t.start == math.inf \
                                and t.vm == v and t.ready < math.inf:
                            gen[tid] += 1
                            push_arrival(tid)

        def fire_failure(v: int) -> None:
            """Kill + re-dispatch every unfinished task whose *current*
            VM is ``v`` (running, queued, or still pending — the engine's
            ``affected`` mask): work restarts from scratch, readiness is
            pushed past the broker's detection latency, and the first hit
            moves the task to its precomputed failover VM, paying the
            shared remote-fetch delay to re-replicate its input block."""
            tf = self._vm_fail[v]
            rd = self._ctl.redispatch_delay
            self.tt.queue[v].clear()
            for tid, task in enumerate(tasks):
                if task.finish < math.inf or task.shed or task.vm != v:
                    continue
                events.append((tf, telemetry.EV_KILL, tid, v))
                if tid in running:
                    running.discard(tid)
                    self.tt.complete(tid, task)
                task.remaining = task.length_mi
                task.start = math.inf
                task.ready = max(task.ready, tf + rd)
                if not hit[tid]:
                    hit[tid] = True
                    task.vm = int(self._task_vm2[tid])
                    task.ready += float(self._refetch2[tid])
                gen[tid] += 1
                if task.ready < math.inf:
                    push_arrival(tid)

        while calendar or running:
            n_events += 1
            control_hook()
            r = rates()
            # Next completion under current processor-sharing rates.
            t_comp, comp_ids = math.inf, []
            for tid in running:
                eta = now + tasks[tid].remaining / r[tid]
                if eta < t_comp - _EPS:
                    t_comp, comp_ids = eta, [tid]
                elif eta <= t_comp + _EPS:
                    comp_ids.append(tid)
            t_evt = calendar[0][0] if calendar else math.inf
            t_fail = min((self._vm_fail[v] for v in fail_pending),
                         default=math.inf)
            t_next = min(t_comp, t_evt, t_fail)

            # Advance fluid state.
            for tid in running:
                tasks[tid].remaining -= (t_next - now) * r[tid]
            now = t_next

            if t_comp <= min(t_evt, t_fail):   # completions win all ties
                for tid in comp_ids:
                    task = tasks[tid]
                    task.remaining = 0.0
                    task.finish = now
                    events.append((now, telemetry.EV_FINISH, tid, task.vm))
                    running.discard(tid)
                    self.tt.complete(tid, task)
                    if not task.is_reduce:
                        r_ready = self.jt.map_finished(task, now)
                        if r_ready is not None:
                            for rid in self.jt.reduce_ids[task.job]:
                                tasks[rid].ready = r_ready
                                push_arrival(rid)
                    # freed PE slot -> admit the next queued task (only
                    # while the VM's lease is still open)
                    if space:
                        qid = admit(task.vm)
                        if qid is not None:
                            start_task(qid)
            elif t_fail <= t_evt:          # failures next: kills beat
                for v in [v for v in fail_pending    # same-instant starts
                          if self._vm_fail[v] <= now + _EPS]:
                    fail_pending.remove(v)
                    fire_failure(v)
            else:                          # arrivals: task(s) become ready
                # Space-shared arrivals pool through the per-VM wait queue
                # even when a slot is free: simultaneous arrivals must be
                # admitted in (priority desc, eligible, id) order — the
                # engine ranks all tied-eligible tasks in one epoch — not
                # in calendar pop order.
                arrived_vms = set()
                while calendar and calendar[0][0] <= now + _EPS:
                    _, _, tid, g = heapq.heappop(calendar)
                    task = tasks[tid]
                    if g != gen[tid] or task.shed or task.start < math.inf \
                            or task.finish < math.inf:
                        continue           # superseded by a control action
                    if space:
                        self.tt.enqueue(tid, task)
                        arrived_vms.add(task.vm)
                    else:
                        if shed_at(tid, now):
                            mark_shed(tid, now)
                        else:
                            start_task(tid)
                for vm in arrived_vms:
                    while (qid := admit(vm)) is not None:
                        start_task(qid)
            # preemption runs after every event batch at the current
            # clock — exactly the engine's in-epoch eviction instant
            preempt_pass()

        # Closed-form tail sheds (the engine keeps evaluating pending
        # tasks each epoch; the calendar stops producing pop-time checks
        # once no slot ever frees again): any schedulable never-started
        # task whose window closed by the final clock is shed, and
        # reduces of a job with a shed map can never be released.
        if self._dlpol == control.DeadlinePolicy.SHED:
            for tid, task in enumerate(tasks):
                if task.shed or task.start < math.inf \
                        or task.finish < math.inf:
                    continue
                at = gate(max(self.tt.eligible_at(task), now), task.vm)
                if self.tt.is_open(task.vm, at) and shed_at(tid, at):
                    mark_shed(tid, at)
            for ji in range(len(sc.jobs)):
                if any(tasks[t].shed for t in self.jt.map_ids[ji]):
                    for rid in self.jt.reduce_ids[ji]:
                        if tasks[rid].finish == math.inf:
                            mark_shed(rid, now)

        n_hit = sum(hit)
        n_rec = sum(1 for tid, h in enumerate(hit)
                    if h and tasks[tid].finish < math.inf)
        # makespan over the work the system kept: a shed task's arrival
        # can be the calendar's last event, but it completes nothing —
        # the engine's max-finish op sequence never sees it (and the
        # injected-failure census clocks against the same horizon)
        fin_t = max((t.finish for t in tasks if t.finish < math.inf),
                    default=0.0)
        injected = int(np.sum((self._vm_fail < _BIG / 2)
                              & (self._vm_fail <= fin_t)))
        return SimResult(tasks=tasks, jobs=self._job_metrics(tasks),
                         finish_time=fin_t, n_events=n_events,
                         failures_injected=injected,
                         tasks_redispatched=n_hit,
                         scale_events=self._n_scale,
                         recovered_fraction=n_rec / max(n_hit, 1),
                         shed_tasks=sum(1 for t in tasks if t.shed),
                         preemptions=self._n_preempt,
                         events=events)

    # ---- dependent variables (paper §5.3) ---------------------------------

    def _job_metrics(self, tasks: list[Task]) -> list[JobResult]:
        sc = self.scenario
        out = []
        for ji, job in enumerate(sc.jobs):
            maps = [tasks[i] for i in self.jt.map_ids[ji]]
            reds = [tasks[i] for i in self.jt.reduce_ids[ji]]
            met = (sum(t.exec_time for t in maps) / len(maps),
                   max(t.exec_time for t in maps),
                   min(t.exec_time for t in maps))
            ret = (sum(t.exec_time for t in reds) / len(reds),
                   max(t.exec_time for t in reds),
                   min(t.exec_time for t in reds))
            last_map = max(maps, key=lambda t: t.finish)
            last_red = max(reds, key=lambda t: t.finish)
            delay = (max(t.start for t in maps) + max(t.start for t in reds)
                     - last_map.finish)
            vm_cost = sum(t.exec_time * sc.vms[t.vm].cost_per_sec
                          for t in maps + reds)
            out.append(JobResult(
                avg_exec=met[0] + ret[0],
                max_exec=met[1] + ret[1],
                min_exec=met[2] + ret[2],
                makespan=last_red.finish - job.submit_time,
                delay_time=delay,
                vm_cost=vm_cost,
                network_cost=delay * sc.network.cost_per_unit
                if sc.network.enabled else 0.0,
                map_avg_exec=met[0],
                reduce_avg_exec=ret[0],
            ))
        return out


def simulate(scenario: Scenario,
             length_multipliers: list[float] | None = None) -> SimResult:
    """Run one scenario through the sequential reference simulator."""
    return IoTSimBroker(scenario, length_multipliers).run()
