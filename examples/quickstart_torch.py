"""Quickstart on the PyTorch port: the paper's Group 1 experiment (Fig
8a/8b).

Runs the same sweep through the sequential paper-faithful oracle and the
declarative ``SweepPlan`` API (DESIGN.md §4), prints the dependent
variables side by side, and checks Table IV's network-cost column; the
counterpart of ``examples/quickstart.py``.  The sweep steps through the
``mr_epoch`` CUDA kernel on the card, its plain version on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import engine, paper_scenario, refsim
from repro_torch.core.sweep import axis, product


def main(device="cuda"):
    print("IOTSim-PyTorch quickstart — paper §5.4 Group 1 (Small job, "
          "Small VM, 3 VMs)\n")
    hdr = (f"{'MR':>6} {'avg_exec':>10} {'max_exec':>10} {'min_exec':>10} "
           f"{'makespan':>10} {'delay':>9} {'net_cost':>9} {'vm_cost':>9}")
    print(hdr)
    for m in range(1, 21):
        r = refsim.simulate(paper_scenario(n_maps=m)).job()
        print(f"M{m:<2}R1 {r.avg_exec:10.2f} {r.max_exec:10.2f} "
              f"{r.min_exec:10.2f} {r.makespan:10.2f} {r.delay_time:9.2f} "
              f"{r.network_cost:9.2f} {r.vm_cost:9.2f}")

    # the same sweep, one declarative plan stepped as one batch
    plan = product(axis("n_maps", range(1, 21)),
                   axis("network_delay", (True, False)))
    res = plan.run(device=device)
    delayed = res.select(network_delay=True)
    ref = [refsim.simulate(paper_scenario(n_maps=m)).job().makespan
           for m in range(1, 21)]
    ok = np.allclose(delayed["makespan"], ref, rtol=1e-4)
    print(f"\nvectorized engine == sequential oracle: {ok}")
    assert ok

    expected = 4250.0 / (np.arange(1, 21) + 1)
    got = delayed["network_cost"]
    exact = np.allclose(got, expected, rtol=1e-4)
    print(f"Table IV exact (4250/(M+1)): {exact}")
    assert exact

    # labeled point lookup replaces positional row bookkeeping
    with_delay = res.select(n_maps=20, network_delay=True).to_dict()
    without = res.select(n_maps=20, network_delay=False).to_dict()
    print(f"\nwithout network delay, M20R1 makespan: "
          f"{without['makespan']:.2f}s (with: {with_delay['makespan']:.2f}s)")

    single = engine.simulate(paper_scenario(n_maps=20, network_delay=False),
                             device=device)
    assert np.isclose(float(single.makespan[0, 0]), without["makespan"],
                      rtol=1e-6)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep (default: cuda)")
    main(ap.parse_args().device)
