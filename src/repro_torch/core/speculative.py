"""Speculative execution (beyond-paper): Hadoop-style backup tasks.

The paper models deterministic task lengths; real MapReduce clusters
straggle, and Hadoop's remedy — launch a backup copy of a slow task, take
whichever finishes first — is the canonical mitigation (Dean &
Ghemawat §3.6).  This module extends the reference simulator with:

* per-task straggler multipliers (lognormal),
* a speculation policy: when a map task's *projected* finish exceeds
  ``threshold ×`` the median projected finish of its phase, a backup is
  bound to the least-loaded VM; the task completes at min(original,
  backup).

It answers the study the IOTSim methodology enables but the paper left as
future work: makespan and cost with and without speculation against
straggler severity.  Host numpy, op for op the JAX package's module, so
its outputs are the reference's (including ROADMAP C2: with all
multipliers at 1.0, round-robin imbalance can still pick suspects).
"""
from __future__ import annotations

import math

import numpy as np

from .config import BindingPolicy, Scenario, SchedPolicy
from .network import shuffle_delay, stage_in_delay


def straggler_multipliers(scenario: Scenario, sigma: float,
                          seed: int = 0) -> list[float]:
    rng = np.random.default_rng(seed)
    return list(rng.lognormal(0.0, sigma, scenario.total_tasks()))


def simulate_speculative(scenario: Scenario, multipliers: list[float], *,
                         threshold: float = 1.5,
                         max_backups: int | None = None) -> dict:
    """Fluid time-shared simulation with one speculation round.

    Exact for the paper's single-job cells (all maps ready together);
    reduces to the reference result when multipliers are all 1.0.
    Returns per-phase times + totals with and without speculation.
    """
    if len(scenario.jobs) != 1:
        raise ValueError(
            f"simulate_speculative: scenario has {len(scenario.jobs)} jobs; "
            "the fluid model covers single-job cells only")
    # this analytic model hardcodes time-shared sharing + round-robin
    # binding; reject other policies rather than silently mis-simulating
    if (scenario.sched_policy != SchedPolicy.TIME_SHARED
            or scenario.binding_policy != BindingPolicy.ROUND_ROBIN):
        raise ValueError(
            "simulate_speculative models TIME_SHARED + ROUND_ROBIN only "
            f"(got {scenario.sched_policy.name}, "
            f"{scenario.binding_policy.name})")
    if len(multipliers) != scenario.total_tasks():
        raise ValueError(
            f"simulate_speculative: {len(multipliers)} multipliers for "
            f"{scenario.total_tasks()} tasks — one per task required")
    job = scenario.jobs[0]
    vms = scenario.vms
    V = len(vms)
    M, R = job.n_maps, job.n_reduces
    net = scenario.network
    t_ready = job.submit_time + stage_in_delay(job, net)

    base_len = job.length_mi / M
    lens = np.array([base_len * multipliers[i] for i in range(M)])
    vm_of = np.arange(M) % V

    def phase_finish(lens, vm_of, start):
        """Fluid processor sharing on each VM until every task completes."""
        finish = np.zeros(len(lens))
        for v in range(V):
            ids = np.where(vm_of == v)[0]
            if len(ids) == 0:
                continue
            rem = lens[ids].astype(float).copy()
            t = start
            rate_cap = vms[v].mips
            pes = vms[v].pes
            order = np.argsort(rem)
            done = np.zeros(len(ids), bool)
            while not done.all():
                n = (~done).sum()
                rate = rate_cap * min(1.0, pes / n)
                nxt = rem[~done].min()
                dt = nxt / rate
                rem[~done] -= nxt
                t += dt
                newly = (~done) & (rem <= 1e-9)
                finish[ids[newly]] = t
                done |= newly
        return finish

    # --- no speculation -------------------------------------------------
    fin_plain = phase_finish(lens, vm_of, t_ready)
    map_end_plain = fin_plain.max()

    # --- one speculation round ------------------------------------------
    # projected finishes under equal sharing; back up tasks projected
    # beyond threshold x median
    proj = phase_finish(lens, vm_of, t_ready)
    med = np.median(proj)
    suspects = np.where(proj > threshold * med)[0]
    if max_backups is not None:
        suspects = suspects[np.argsort(-proj[suspects])][:max_backups]
    if len(suspects):
        # backups start when detected (at the median finish time, i.e.
        # when healthy tasks complete) on the least-loaded VMs, and run
        # the task's *base* length (the slowness was machine-local)
        detect = med
        load = np.bincount(vm_of, minlength=V).astype(float)
        b_vm, b_len, b_start = [], [], []
        for s in suspects:
            v = int(np.argmin(load))
            load[v] += 1
            b_vm.append(v)
            b_len.append(base_len)
            b_start.append(detect)
        # approximate: backups run on their VM sharing with any original
        # tasks still resident; originals keep running
        fin_backup = np.array([
            b_start[i] + b_len[i] / (vms[b_vm[i]].mips
                                     * min(1.0, vms[b_vm[i]].pes
                                           / (1 + (load[b_vm[i]] - 1 > 0))))
            for i in range(len(suspects))])
        fin_spec = fin_plain.copy()
        fin_spec[suspects] = np.minimum(fin_plain[suspects], fin_backup)
        map_end_spec = fin_spec.max()
        backup_work = sum(b_len)
    else:
        map_end_spec = map_end_plain
        backup_work = 0.0

    sh = shuffle_delay(job, net)
    red_len = job.reduce_factor * job.length_mi / R
    red_time = red_len / vms[0].mips
    mk_plain = map_end_plain + sh + red_time
    mk_spec = map_end_spec + sh + red_time
    cost_rate = vms[0].cost_per_sec
    work_plain = lens.sum() + red_len * R
    work_spec = work_plain + backup_work
    return {
        "makespan_plain": mk_plain,
        "makespan_spec": mk_spec,
        "speedup": mk_plain / mk_spec,
        "n_backups": int(len(suspects)),
        "extra_work_frac": backup_work / work_plain,
        "cost_plain": work_plain / vms[0].mips * cost_rate,
        "cost_spec": work_spec / vms[0].mips * cost_rate,
    }
