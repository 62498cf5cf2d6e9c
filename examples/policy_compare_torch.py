"""Group 5 on the PyTorch port: scheduling & binding policy comparison
(beyond the paper); the counterpart of ``examples/policy_compare.py``.

Policy is an *axis* of a declarative ``SweepPlan`` (DESIGN.md §4): one run
simulates every (SchedPolicy x BindingPolicy) combination of the paper's
Group-1 sweep at once, and a second plan shows least-loaded binding
rescuing a heterogeneous cluster, encoded on the device through per-VM
mips/pes/cost vectors.

    PYTHONPATH=src python examples/policy_compare_torch.py [--device cpu]
"""
import argparse
import time

from repro_torch.core import BindingPolicy, SchedPolicy
from repro_torch.core.sweep import axis, product

M_SWEEP = range(1, 21)
# The three bindings that differ without a storage model — LOCALITY is
# bit-identical to LEAST_LOADED when the block store is off (DESIGN.md
# §7.3); see examples/smart_city_torch.py Part 3 for the storage-on
# comparison.
BINDINGS = [BindingPolicy.ROUND_ROBIN, BindingPolicy.LEAST_LOADED,
            BindingPolicy.PACKED]


def part1_policy_grid(device="cuda"):
    print(f"== Part 1: M-sweep x all {2 * len(BINDINGS)} distinct policy "
          "combos, one run ==")
    plan = product(axis("sched_policy", list(SchedPolicy)),
                   axis("binding_policy", BINDINGS),
                   axis("n_maps", M_SWEEP),
                   vm_type="medium")
    t0 = time.perf_counter()
    res = plan.run(device=device)
    dt = time.perf_counter() - t0
    print(f"  {plan.size} scenarios in {dt * 1e3:.1f} ms")
    print(f"  {'policy':34s} makespan@M1  makespan@M20")
    for sp in SchedPolicy:
        for bp in BINDINGS:
            mk = res.select(sched_policy=sp, binding_policy=bp)["makespan"]
            print(f"  {sp.name:13s} + {bp.name:12s}     {mk[0]:9.1f}     "
                  f"{mk[-1]:9.1f}")
    print()


def part2_heterogeneous_binding(device="cuda"):
    print("== Part 2: binding policy on a heterogeneous cluster "
          "(device-side cell) ==")
    # 2 fast + 4 slow VMs: round-robin overloads the slow ones; least-loaded
    # weighs placement by each VM's capacity (mips x PEs).  The mixed
    # cluster is one per-VM-encoded cell.
    plan = product(axis("binding_policy", BINDINGS),
                   vms=("medium",) * 2 + ("small",) * 4,
                   sched_policy=SchedPolicy.SPACE_SHARED,
                   n_maps=12, n_reduces=2, job_type="medium")
    res = plan.run(device=device)
    for bp in BINDINGS:
        r = res.select(binding_policy=bp).to_dict()
        print(f"  {bp.name:12s} makespan={r['makespan']:9.1f}s "
              f"avg_exec={r['avg_exec']:8.1f}s vm_cost=${r['vm_cost']:9.1f} "
              f"util={r['utilization']:.2f}")
    rr = res.select(binding_policy=BindingPolicy.ROUND_ROBIN)["makespan"]
    ll = res.select(binding_policy=BindingPolicy.LEAST_LOADED)["makespan"]
    assert float(ll) < float(rr), "least-loaded should beat round-robin"
    print()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweeps (default: cuda)")
    dev = ap.parse_args().device
    part1_policy_grid(dev)
    part2_heterogeneous_binding(dev)
