"""Smart-city case study (paper §5.1) + a pod-scale what-if sweep, on the
PyTorch port (the counterpart of ``examples/smart_city.py``).

A city council sizes the cloud deployment for its MapReduce road-network
analytics: three IoT feeds (road sensors, traffic cams, commuter apps)
arrive as jobs of different sizes.  Part 1 simulates the mixed workload on
a candidate datacentre (sequential oracle — the paper's workflow).
Part 2 asks the question the paper's CloudSim architecture cannot: sweep
*every* provisioning candidate (VM type × VM count × MR split) at once
with the vectorized engine and pick the cheapest config meeting an SLA.
Part 3 turns on the storage subsystem (DESIGN.md §7) and sweeps block
replication × binding policy over a skewed placement to find where
data-local (LOCALITY) dispatch beats load balancing.
Part 4 right-sizes a *pay-as-you-go* fleet (DESIGN.md §8): lease length ×
VM count × Poisson arrival rate, picking the cheapest `billed_cost`
configuration whose worst arrival still meets the makespan target.
Part 5 stress-tests the winner with the closed-loop control subsystem
(DESIGN.md §10): a disaster surge — burst arrivals while the gateway-zone
VMs fail — comparing a reactive fleet (reserves opened by autoscaling,
failed tasks re-dispatched against block replicas) to a static
over-provisioned one on `recovered_fraction` and `billed_cost`.
Part 6 reruns the same surge with decision-window deadlines (DESIGN.md
§11): analytics that finish after the window are wasted, so the council
compares running everything late (the Part-5 posture) against shedding
doomed work and preempting for the critical feed — same recovery, far
fewer missed windows.
Part 7 runs one surge scenario with the in-loop trace recorder on
(DESIGN.md §12) and exports the event timeline as Chrome trace-event
JSON for chrome://tracing / Perfetto, to the path given by ``--trace``.

    PYTHONPATH=src python examples/smart_city_torch.py [--device cpu] \
        [--trace smart_city_trace.json]
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.core import (JOB_BIG, JOB_MEDIUM, JOB_SMALL, VM_TYPES,
                        BindingPolicy, ControlPolicy, ControlSpec,
                        DeadlinePolicy, Scenario, SchedPolicy, elasticity,
                        refsim, sweep, telemetry)


def part1_mixed_workload():
    print("== Part 1: mixed smart-city workload on 6 medium VMs ==")
    jobs = (
        dataclasses.replace(JOB_BIG, name="road-network", n_maps=12),
        dataclasses.replace(JOB_MEDIUM, name="traffic-cams", n_maps=8,
                            submit_time=600.0),
        dataclasses.replace(JOB_SMALL, name="commuter-apps", n_maps=4,
                            submit_time=1200.0),
    )
    sc = Scenario(vms=(VM_TYPES["medium"],) * 6, jobs=jobs)
    res = refsim.simulate(sc)
    for job, jr in zip(jobs, res.jobs):
        print(f"  {job.name:14s} makespan={jr.makespan:9.1f}s "
              f"avg_exec={jr.avg_exec:8.1f}s vm_cost=${jr.vm_cost:10.1f} "
              f"net_cost=${jr.network_cost:8.1f}")
    print(f"  cluster busy until t={res.finish_time:.1f}s, "
          f"{res.n_events} DES epochs\n")


def part2_provisioning_sweep(sla_makespan=4000.0, device="cuda"):
    print("== Part 2: provisioning sweep (one declarative SweepPlan) ==")
    plan = sweep.product(
        sweep.axis("vm_type", list(VM_TYPES)),
        sweep.axis("n_vms", range(2, 17, 2)),
        sweep.axis("n_maps", (4, 8, 16, 20)),
        job_type="big",
    )
    t0 = time.perf_counter()
    res = plan.run(device=device)
    dt = time.perf_counter() - t0
    makespan = res["makespan"]
    cost = res["vm_cost"] + res["network_cost"]
    print(f"  simulated {plan.size} provisioning candidates in "
          f"{dt*1e3:.1f} ms ({plan.size/dt:.0f} scenarios/s)")

    feasible = makespan <= sla_makespan
    if feasible.any():
        best = np.unravel_index(np.argmin(np.where(feasible, cost, np.inf)),
                                cost.shape)
        c = res.coord(best)
        print(f"  SLA: makespan <= {sla_makespan:.0f}s")
        print(f"  cheapest feasible: {c['n_vms']}x {c['vm_type']} VM, "
              f"M{c['n_maps']}R1 -> makespan={makespan[best]:.0f}s "
              f"total_cost=${cost[best]:.0f}")
    infeasible = int((~feasible).sum())
    print(f"  ({infeasible}/{plan.size} candidates miss the SLA)\n")


def part3_locality_sweep(device="cuda"):
    """Storage subsystem (DESIGN.md §7): where the road-network feed's
    blocks live now matters.  One replication x binding grid over the
    skewed (hot-spot) placement answers the sizing question Locality Sim
    poses: how much HDFS replication does the council need before
    data-local dispatch stops being a trade-off?"""
    print("== Part 3: block replication x binding locality sweep ==")
    plan = sweep.product(
        sweep.axis("binding_policy", [BindingPolicy.ROUND_ROBIN,
                                      BindingPolicy.LEAST_LOADED,
                                      BindingPolicy.LOCALITY]),
        sweep.axis("replication", (1, 2, 3, 4, 6, 8)),
        storage=True, placement="skewed", block_size_mb=32768.0,
        n_vms=8, n_maps=24, n_reduces=2, job_type="small",
    )
    res = plan.run(device=device)
    print(f"  {plan.size} cells; skewed placement, 8 VMs, M24R2 "
          "(block = 32 GB)")
    print(f"  {'replication':>11s}  " + "  ".join(
        f"{bp.name:>17s}" for bp in (BindingPolicy.ROUND_ROBIN,
                                     BindingPolicy.LEAST_LOADED,
                                     BindingPolicy.LOCALITY)))
    for i, r in enumerate((1, 2, 3, 4, 6, 8)):
        row = []
        for bp in (BindingPolicy.ROUND_ROBIN, BindingPolicy.LEAST_LOADED,
                   BindingPolicy.LOCALITY):
            c = res.select(binding_policy=bp, replication=r)
            row.append(f"{float(c['makespan']):7.0f}s "
                       f"lf={float(c['locality_fraction']):4.2f}")
        print(f"  {r:>11d}  " + "  ".join(f"{x:>17s}" for x in row))
    loc = res.select(binding_policy=BindingPolicy.LOCALITY)["makespan"]
    ll = res.select(binding_policy=BindingPolicy.LEAST_LOADED)["makespan"]
    wins = [r for i, r in enumerate((1, 2, 3, 4, 6, 8)) if loc[i] < ll[i]]
    print(f"  LOCALITY beats LEAST_LOADED at replication {wins} "
          "(converges bit-for-bit at replication = n_vms)\n")


def part4_lease_rightsizing(makespan_target=6000.0, device="cuda"):
    """Elasticity (DESIGN.md §8): the council leases VMs by the hour
    instead of owning a static cluster.  One grid over lease length × VM
    count × offered load answers the pay-as-you-go question the paper
    poses but CloudSim cannot sweep: the *cheapest billed fleet* that
    still meets the makespan target for every arrival in the stream."""
    print("== Part 4: right-size the pay-as-you-go fleet ==")
    n_arrivals = 12
    lease_hours = (2, 4, 8, 24)
    plan = sweep.product(
        sweep.axis("n_vms", (2, 4, 6, 8)),
        sweep.axis("vm_stop", [h * 3600.0 for h in lease_hours]),
        sweep.arrivals(n_arrivals, rate=[1 / 1800.0, 1 / 600.0],
                       process="poisson", seed=7),
        vm_type="medium", n_maps=12, n_reduces=2, job_type="medium",
        spinup_delay=120.0, billing_granularity=3600.0,
    )
    res = plan.run(device=device)
    print(f"  {plan.size} cells: {len(lease_hours)} lease lengths x 4 "
          f"fleet sizes x 2 arrival rates x {n_arrivals} arrivals "
          "(billing: hourly, 120 s spin-up)")
    print(f"  target: every arrival's makespan <= {makespan_target:.0f}s")
    for rate_name, rate in (("1/30 min", 1 / 1800.0),
                            ("1/10 min", 1 / 600.0)):
        best = None
        for n_vms in (2, 4, 6, 8):
            for h in lease_hours:
                cell = res.select(arrival_rate=rate, n_vms=n_vms,
                                  vm_stop=h * 3600.0)
                worst = float(cell["makespan"].max())
                cost = float(cell["billed_cost"].max())
                busy = float(cell["vm_busy_fraction"].mean())
                if worst <= makespan_target and (best is None
                                                 or cost < best[0]):
                    best = (cost, n_vms, h, worst, busy)
        if best:
            cost, n_vms, h, worst, busy = best
            print(f"  {rate_name} arrivals -> cheapest feasible: "
                  f"{n_vms}x medium on a {h}h lease "
                  f"(billed ${cost:.0f}, worst makespan {worst:.0f}s, "
                  f"busy {busy:.2f})")
        else:
            print(f"  {rate_name} arrivals -> no leased fleet meets the "
                  "target; lengthen the lease or add VMs")
    stranded = int((res["makespan"] > 1e20).sum())
    print(f"  ({stranded} cells strand work: the lease closes before "
          "the arrival — automatically infeasible)\n")


def part5_disaster_surge(device="cuda"):
    """Closed-loop control (DESIGN.md §10): an earthquake cuts the
    gateway-zone uplink at t=900 s (its two VMs fail; repaired 30 min
    later) just as re-routed sensor traffic surges in.  The council
    compares two postures over the same seeded surge:

    * **reactive** — 4 always-on VMs + 4 autoscale reserves the control
      hook opens only while the queue backs up; failed tasks re-dispatch
      to their block-replica holders after a 30 s detection delay;
    * **static** — 8 VMs leased around the clock, same failures.

    Same physics, same recovery — the closed loop just stops paying for
    the reserves once the surge drains."""
    print("== Part 5: disaster surge — reactive vs over-provisioned ==")
    n_arrivals = 6
    big = 1e30
    # the disaster: gateway-zone VMs (fleet slots 0-1) down 900s..2700s
    vm_fail = np.array([900.0, 900.0] + [big] * 6, np.float32)
    vm_restore = np.array([2700.0, 2700.0] + [big] * 6, np.float32)
    base = dict(vm_type="medium", n_vms=8, n_maps=8, n_reduces=2,
                job_type="medium", vm_fail=vm_fail, vm_restore=vm_restore,
                redispatch_delay=30.0, spinup_delay=120.0,
                billing_granularity=900.0)
    surge = sweep.arrivals(n_arrivals, rate=1 / 300.0, process="poisson",
                           seed=11)
    reactive = sweep.product(
        surge, vm_auto=np.array([0.0] * 4 + [1.0] * 4, np.float32),
        control_policy="autoscale", ctl_queue=0.0, ctl_busy=0.0, **base)
    static = sweep.product(surge, control_policy="none", **base)
    r, s = reactive.run(device=device), static.run(device=device)
    print(f"  {n_arrivals} seeded surge arrivals; gateway zone (2/8 VMs) "
          "down 900s-2700s, redispatch after 30s")
    for name, res in (("reactive", r), ("static ", s)):
        rec = float(np.asarray(res["recovered_fraction"]).min())
        inj = int(np.asarray(res["failures_injected"]).sum())
        red = int(np.asarray(res["tasks_redispatched"]).sum())
        scale = int(np.asarray(res["scale_events"]).max())
        billed = float(np.asarray(res["billed_cost"]).max())
        mk = float(np.asarray(res["makespan"]).max())
        print(f"  {name}: {inj} failures, {red} tasks re-dispatched, "
              f"min recovered={rec:.2f}, scale events={scale}, "
              f"worst makespan={mk:.0f}s, billed ${billed:.0f}")
    saving = 1.0 - (float(np.asarray(r['billed_cost']).max())
                    / float(np.asarray(s['billed_cost']).max()))
    print(f"  same recovery, {saving:.0%} cheaper: the control hook only "
          "bills the reserves while the surge queue is deep\n")


def part6_deadline_surge(device="cuda"):
    """Graceful degradation (DESIGN.md §11): the Part-5 surge again, but
    now the analytics only matter inside a decision window — a road
    closure computed after the evacuation window is wasted work.  Same
    seeded arrivals, same reactive fleet (4 always-on + 4 autoscale
    reserves), the gateway VM down 900s-2700s; each surge job now mixes
    one long critical road-network map (rank 2, 60 min window), four
    straggler maps stuck re-reading a flooded sensor archive (8x work —
    hopeless inside their 40 min window), and bulk camera maps on a
    45 min window.  The council compares two postures:

    * **run-everything** — the PR-7 fleet: deadlines recorded
      (`DeadlinePolicy.NONE`) but every task runs to completion, however
      late — the stragglers hog half the fleet for the whole surge;
    * **shed+preempt** — doomed tasks (earliest possible finish already
      past the window) are shed at admission, and the critical map
      preempts bulk work when the gateway failure re-queues it
      (`preempt_resume=1`: the evicted task keeps its progress).

    Failure physics are identical — degradation only changes *which*
    work the fleet spends the surge on."""
    print("== Part 6: the same surge under decision-window deadlines ==")
    n_arrivals = 6
    big = 1e30
    n_maps, n_red = 16, 2
    arr = np.asarray(elasticity.arrival_times(n_arrivals, rate=1 / 300.0,
                                              seed=11), np.float32)
    # task layout (round-robin bound, task i -> VM i % 8): map 0 the
    # critical feed, maps 2-5 the stragglers, the rest bulk; reduces
    # carry the _BIG sentinel (the job close-out is unconstrained, so
    # orphan-shed reduces don't count as missed windows)
    prio = np.array([2.0] + [0.0] * (n_maps - 1) + [1.0] * n_red,
                    np.float32)
    mult = np.full(n_maps + n_red, 2.0, np.float32)
    mult[0] = 3.0                       # critical: long analysis
    mult[2:6] = 8.0                     # stragglers: flooded archive
    mult[n_maps:] = 1.0
    window = np.full(n_maps + n_red, 2700.0, np.float32)
    window[0] = 3600.0                  # critical decision window
    window[2:6] = 2400.0                # stragglers cannot make this
    window[8] = 4200.0                  # late-tier partition, loose
    deadlines = (arr[:, None] + window[None, :]).astype(np.float32)
    deadlines[:, n_maps:] = big
    surge = sweep.zip_(sweep.axis("job_submit", arr),
                       sweep.axis("task_deadline", deadlines))
    base = dict(vm_type="small", n_vms=8, n_maps=n_maps, n_reduces=n_red,
                job_type="big", sched_policy=SchedPolicy.SPACE_SHARED,
                task_prio=prio, task_mult=mult,
                vm_fail=np.array([900.0] + [big] * 7, np.float32),
                vm_restore=np.array([2700.0] + [big] * 7, np.float32),
                redispatch_delay=30.0, spinup_delay=120.0,
                billing_granularity=900.0,
                vm_auto=np.array([0.0] * 4 + [1.0] * 4, np.float32),
                control_policy="autoscale", ctl_queue=0.0, ctl_busy=0.0)
    run_all = sweep.product(surge, deadline_policy="none", **base)
    degrade = sweep.product(surge, deadline_policy="shed", preempt=1,
                            preempt_resume=1, **base)
    ra, dg = run_all.run(device=device), degrade.run(device=device)
    print(f"  {n_arrivals} seeded surge arrivals; 40-70 min task windows; "
          "gateway VM down 900s-2700s; 4 straggler maps per job")
    for name, res in (("run-everything", ra), ("shed+preempt  ", dg)):
        rec = float(np.asarray(res["recovered_fraction"]).min())
        miss = float(np.asarray(res["deadline_miss_fraction"]).mean())
        shed = int(np.asarray(res["shed_tasks"]).sum())
        pre = int(np.asarray(res["preemptions"]).sum())
        waste = float(np.asarray(res["wasted_work_frac"]).mean())
        billed = float(np.asarray(res["billed_cost"]).sum())
        print(f"  {name}: miss fraction={miss:.2f}, "
              f"min recovered={rec:.2f}, shed={shed}, "
              f"preemptions={pre}, wasted work={waste:.2f}, "
              f"billed ${billed:.0f}")
    cut = 1.0 - (float(np.asarray(dg["deadline_miss_fraction"]).mean())
                 / float(np.asarray(ra["deadline_miss_fraction"]).mean()))
    save = 1.0 - (float(np.asarray(dg["billed_cost"]).sum())
                  / float(np.asarray(ra["billed_cost"]).sum()))
    print(f"  {cut:.0%} fewer missed windows at {save:.0%} lower cost: "
          "shedding the doomed archive re-reads frees the fleet for "
          "maps that can still make their window, and the critical feed "
          "preempts its way back after the failure.  Every kill the "
          "degraded fleet keeps is recovered — the only unrecovered "
          "re-dispatches are ones the policy itself shed, work the "
          "outage had already pushed past its window (run-everything "
          "resurrects them, and that work lands in its 0.67 wasted "
          "fraction)\n")


def part7_surge_trace(path, device="cuda"):
    """Observability (DESIGN.md §12): the council's post-mortem.  Parts
    5-6 said *how much* was recovered; the trace says *when the queue
    built up, which VM each kill landed on, and when the reserves
    opened*.  One surge-like scenario — failures striking the gateway
    zone, autoscale reserves, decision-window shedding and preemption —
    runs with the in-loop trace recorder on (bitwise the same schedule),
    and the event log exports as Chrome trace-event JSON: load it at
    chrome://tracing or https://ui.perfetto.dev to scrub the timeline
    of task spans per VM track."""
    print("== Part 7: exporting the surge timeline for chrome://tracing ==")
    jobs = tuple(
        dataclasses.replace(JOB_BIG, name=f"feed{i}", n_maps=10,
                            n_reduces=2, submit_time=300.0 * i,
                            priority=float(2 - i),
                            deadline=3600.0 + 600.0 * i)
        for i in range(3))
    vms = tuple(dataclasses.replace(VM_TYPES["small"],
                                    autoscale=(i >= 4)) for i in range(6))
    sc = Scenario(vms=vms, jobs=jobs,
                  sched_policy=SchedPolicy.SPACE_SHARED,
                  control=ControlSpec(policy=ControlPolicy.AUTOSCALE,
                                      queue_threshold=2.0,
                                      busy_threshold=0.5,
                                      failure_rate=0.0005, failure_seed=3,
                                      repair_delay=600.0,
                                      redispatch_delay=30.0,
                                      deadline_policy=DeadlinePolicy.SHED,
                                      preempt=1, preempt_resume=1))
    out, tr = telemetry.trace_scenario(sc, label="smart-city surge",
                                       device=device)
    counts = {k: v for k, v in tr.counts_by_kind(0).items() if v}
    doc = tr.to_chrome_trace(path)
    spans = sum(e["ph"] == "X" for e in doc["traceEvents"])
    print(f"  events by kind: {counts}")
    print(f"  wrote {os.path.basename(path)}: {spans} task spans over "
          f"{tr.ts[0][:, 4].sum():.0f} realized epochs, "
          f"{doc['otherData']['dropped_events']} dropped events")
    print("  -> open chrome://tracing (or https://ui.perfetto.dev) and "
          "load the file: lanes are processes, VM tracks are threads; "
          "kills, redispatches, sheds and scale events are instants\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweeps (default: cuda)")
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "smart_city_trace.json"),
        help="where Part 7 writes its Chrome trace (default: the "
             "temporary directory)")
    args = ap.parse_args()
    part1_mixed_workload()
    part2_provisioning_sweep(device=args.device)
    part3_locality_sweep(device=args.device)
    part4_lease_rightsizing(device=args.device)
    part5_disaster_surge(device=args.device)
    part6_deadline_surge(device=args.device)
    part7_surge_trace(args.trace, device=args.device)
