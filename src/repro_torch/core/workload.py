"""Bridge between the LM training/serving stack and the simulator.

IOTSim's purpose is *analysing big-data applications on clouds before
deploying them*.  The 2026 workload is pod-scale model training, so this
module converts a training step's cost model (FLOPs / HBM bytes /
collective bytes per device) into simulator scenarios:

* one *map task* per device per step (compute),
* the *shuffle* delay models the step's collective phase,
* VM MIPS ≡ chip FLOP/s, so straggling chips are straggler multipliers,
* node failures + checkpoint restarts enter as job interruptions.

This is the paper's MapReduce↔cloud methodology applied to its modern
workload (DESIGN.md §5): map = sharded compute, shuffle = collectives,
reduce = the optimizer update.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .config import (BindingPolicy, JobSpec, NetworkSpec, Scenario,
                     SchedPolicy, StorageSpec, VMSpec)


@dataclass(frozen=True)
class ChipSpec:
    """The simulated accelerator of a training run: an input of the model,
    not a figure of the machine that runs the simulator.  The defaults are
    the JAX package's (a TPU v5e's published bf16 peak, HBM and ICI link
    rates), so ``ChipSpec()`` names the same simulated chip in both
    packages."""
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s
    hbm_bw: float = 819e9             # bytes/s
    link_bw: float = 50e9             # bytes/s per ICI link


@dataclass(frozen=True)
class StepCost:
    """Per-device cost of one training step."""
    flops: float                      # HLO FLOPs / device
    hbm_bytes: float                  # HLO bytes accessed / device
    collective_bytes: float           # summed collective operand bytes / device

    def roofline_terms(self, chip: ChipSpec) -> dict[str, float]:
        return {
            "compute_s": self.flops / chip.peak_flops,
            "memory_s": self.hbm_bytes / chip.hbm_bw,
            "collective_s": self.collective_bytes / chip.link_bw,
        }

    def step_seconds(self, chip: ChipSpec) -> float:
        """Max-of-terms roofline step time (no overlap pessimism knob)."""
        return max(self.roofline_terms(chip).values())


def step_scenario(cost: StepCost, chip: ChipSpec, n_devices: int, *,
                  straggler_sigma: float = 0.0, seed: int = 0,
                  sched_policy: SchedPolicy = SchedPolicy.TIME_SHARED,
                  binding_policy: BindingPolicy = BindingPolicy.ROUND_ROBIN,
                  storage: StorageSpec | None = None,
                  ) -> tuple[Scenario, np.ndarray | None]:
    """One training step as an IOTSim scenario.

    Device compute becomes M = n_devices map tasks of length = per-device
    FLOPs on VMs of MIPS = effective FLOP/s (bounded by the memory-roofline
    term); the collective phase becomes the shuffle delay.  Straggler
    multipliers (lognormal, σ = ``straggler_sigma``) model slow chips.
    ``sched_policy=SPACE_SHARED`` models gang-scheduled exclusive chips
    (one step-shard per core, no oversubscription);
    ``binding_policy`` picks the shard→chip placement strategy.

    ``storage`` (DESIGN.md §7) attaches the block store to the step: data
    shards become placed input blocks, so
    ``binding_policy=BindingPolicy.LOCALITY`` models shard-local dispatch
    (each step-shard runs on a chip already holding its data-parallel
    shard) while locality-blind policies pay
    ``storage.remote_fetch_delay`` per off-host shard read — the
    input-pipeline analogue of HDFS rack awareness.
    """
    terms = cost.roofline_terms(chip)
    eff_rate = cost.flops / max(terms["compute_s"], terms["memory_s"])
    vm = VMSpec(name=chip.name, mips=eff_rate, pes=1, cost_per_sec=0.0)
    # Calibrate the shuffle delay to the collective term:
    #   shuffle = kappa_shuffle * S / ((M+1) * BW)  ==  collective_s
    net = NetworkSpec(enabled=True, bw_mbps=1.0, kappa_in=0.0,
                      kappa_shuffle=1.0,
                      cost_per_unit=0.0)
    data = terms["collective_s"] * (n_devices + 1)
    job = JobSpec(name="train-step", length_mi=cost.flops * n_devices,
                  data_mb=data, n_maps=n_devices, n_reduces=1,
                  reduce_factor=1e-6)
    mult = None
    if straggler_sigma > 0.0:
        rng = np.random.default_rng(seed)
        mult = np.ones(n_devices + 1)
        mult[:n_devices] = rng.lognormal(0.0, straggler_sigma, n_devices)
    return Scenario(vms=(vm,) * n_devices, jobs=(job,), network=net,
                    storage=storage if storage is not None else StorageSpec(),
                    sched_policy=sched_policy,
                    binding_policy=binding_policy), mult


def simulate_training(cost: StepCost, chip: ChipSpec, *, n_devices: int,
                      n_steps: int, straggler_sigma: float = 0.0,
                      mtbf_hours: float = 0.0, checkpoint_every: int = 100,
                      checkpoint_secs: float = 30.0, restart_secs: float = 120.0,
                      seed: int = 0) -> dict[str, float]:
    """Predict a run's makespan under stragglers + failures + checkpoints.

    Hybrid: per-step makespan from the DES engine (stragglers change the
    processor-sharing critical path); failure/restart overhead composed
    analytically on top (Poisson failures at cluster MTBF/n_devices, each
    costing ``restart_secs`` + recomputation since the last checkpoint).
    """
    from . import refsim
    sc, mult = step_scenario(cost, chip, n_devices,
                             straggler_sigma=straggler_sigma, seed=seed)
    res = refsim.simulate(sc, None if mult is None else list(mult))
    step_s = res.job().makespan
    ideal_s = cost.step_seconds(chip)          # roofline (perfect overlap)
    terms = cost.roofline_terms(chip)
    # the simulator's own no-straggler step: serial compute then shuffle
    base_s = max(terms["compute_s"], terms["memory_s"]) \
        + terms["collective_s"]

    ckpt_overhead = checkpoint_secs * (n_steps / max(checkpoint_every, 1))
    total = step_s * n_steps + ckpt_overhead
    failures = 0.0
    if mtbf_hours > 0.0:
        rate = n_devices / (mtbf_hours * 3600.0)     # cluster failure rate
        failures = rate * total
        # each failure: restart + half a checkpoint interval of lost work
        total += failures * (restart_secs
                             + 0.5 * checkpoint_every * step_s)
    return {
        "step_seconds": step_s,
        "ideal_step_seconds": ideal_s,
        "straggler_slowdown": step_s / base_s if base_s else float("nan"),
        "expected_failures": failures,
        "total_hours": total / 3600.0,
        "goodput": (ideal_s * n_steps) / total if total else float("nan"),
    }
