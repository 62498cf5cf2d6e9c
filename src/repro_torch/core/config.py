"""Scenario configuration (copied from the JAX package, numpy only).

Mirrors the paper's independent variables (§5.2): datacentre configuration
(Table I), VM configuration (Table II), VM number, job configuration
(Table III), and MR combination.  A :class:`Scenario` bundles one complete
simulation input; ``ScenarioBatch`` (see ``sweep.py``) stacks many of them
into arrays for the vectorized engine.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Sequence

from .storage import Placement, StorageSpec, as_placement  # noqa: F401
#   (re-exported: Scenario carries a StorageSpec; DESIGN.md §7)
from .elasticity import (ArrivalProcess, ElasticitySpec,  # noqa: F401
                         as_arrival_process)
#   (re-exported: Scenario carries an ElasticitySpec; DESIGN.md §8)
from .control import (ControlPolicy, ControlSpec,  # noqa: F401
                      DeadlinePolicy, as_control_policy,
                      as_deadline_policy)
#   (re-exported: Scenario carries a ControlSpec; DESIGN.md §10)
from .telemetry import TraceSpec  # noqa: F401
#   (re-exported: the trace request rides next to the scenario specs —
#    config is the one-stop import for experiment setup; DESIGN.md §12)


# ---------------------------------------------------------------------------
# Scheduling & binding policies (DESIGN.md §3)
# ---------------------------------------------------------------------------

class SchedPolicy(enum.IntEnum):
    """Per-VM cloudlet scheduling discipline (CloudSim's scheduler family).

    TIME_SHARED  — CloudletSchedulerTimeShared: all assigned cloudlets run
        concurrently; ``n`` 1-PE cloudlets on a VM with ``pes`` PEs at
        ``mips`` each progress at ``mips * min(1, pes / n)`` (fluid
        processor sharing).
    SPACE_SHARED — CloudletSchedulerSpaceShared: at most ``pes`` cloudlets
        run concurrently, each pinned to a dedicated PE at full ``mips``;
        the rest wait in a per-VM FIFO queue ordered by (ready time,
        task id).

    Values are stable wire constants: they are stored as i32 scalars in
    :class:`~repro.core.engine.ScenarioArrays`, so batches may mix policies
    under ``vmap`` without retracing.
    """
    TIME_SHARED = 0
    SPACE_SHARED = 1


class BindingPolicy(enum.IntEnum):
    """Broker task→VM binding strategy (DatacenterBroker extension point).

    ROUND_ROBIN  — CloudSim's default: one rolling VM pointer across all
        submissions (task ``k`` → VM ``k mod V``).
    LEAST_LOADED — greedy: each task (in submission order) goes to the VM
        with the smallest accumulated ``assigned_MI / (mips * pes)`` load
        estimate (full-VM capacity, so multi-PE VMs are not undervalued);
        ties break to the lowest VM index.  The load accumulator is float32
        in every layer so the oracle and the engine pick identical VMs.
    PACKED       — locality-style packing (cf. Locality Sim, PAPERS.md):
        tasks fill PE *slots* in VM order — task ``k`` lands on the VM
        owning slot ``k mod total_pes`` where slots are laid out
        ``[vm0]*pes0 ++ [vm1]*pes1 ++ …`` — so consecutive tasks of a job
        (which share input splits) co-locate until a VM's PEs are full.
    LOCALITY     — data-local binding over the storage subsystem
        (DESIGN.md §7): a map task binds to the least-loaded VM *among
        the replica holders* of its input block (same f32 load estimate
        and tie-breaking as LEAST_LOADED); reduces, block-less tasks and
        disabled storage fall back to all VMs, where the rule degenerates
        to LEAST_LOADED bit for bit.  Any policy binding a map task off
        its replica set pays the remote-fetch delay
        (``storage.remote_fetch_delay``) before the task becomes ready —
        LOCALITY avoids it by construction.

    Binding is resolved at *encoding* time into the per-task ``task_vm``
    field (the broker binds before execution, as CloudSim does); the policy
    id rides along in ``ScenarioArrays`` for provenance.
    """
    ROUND_ROBIN = 0
    LEAST_LOADED = 1
    PACKED = 2
    LOCALITY = 3


def base_task_lengths_f32(length_mi, n_maps, n_reduces, reduce_factor):
    """The f32 op sequence every layer's binding-load estimate shares:

        map_len    = L / M
        reduce_len = rf * L / R

    with all operands float32 and each op rounding to float32.  Pure
    arithmetic, so it serves ``np.float32`` scalars (the oracle, host
    encoding) and traced f32 jnp arrays (``encode_cell``) identically.
    Keep it in ONE place: LEAST_LOADED resolves argmin ties bit-for-bit
    identically across refsim / ``from_scenario`` / ``encode_cell`` only
    while every layer uses this exact sequence (DESIGN.md §3.3).
    Returns ``(map_len, reduce_len)``.
    """
    return length_mi / n_maps, reduce_factor * length_mi / n_reduces


# ---------------------------------------------------------------------------
# Specs (paper §5.2, Tables I–III)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VMSpec:
    """One virtual machine (paper Table II).

    ``mips`` is per-PE, as in CloudSim.  A 1-PE cloudlet running alone gets
    ``mips``; with ``n`` concurrent cloudlets on the VM it gets
    ``mips * min(1, pes / n)`` (CloudletSchedulerTimeShared fluid semantics,
    see DESIGN.md §2.1).

    ``lease_start``/``lease_stop`` are the VM's pay-as-you-go lease window
    (DESIGN.md §8): the VM admits tasks only in
    ``[lease_start + spinup_delay, lease_stop)`` and is billed for its
    realized lease rounded up to the scenario's billing granularity.  The
    defaults — leased at 0, never torn down — reproduce the pre-elastic
    static fleet bit for bit.

    ``autoscale=True`` marks the VM as a *reserve* (DESIGN.md §10): its
    lease only materializes when the scenario's control policy opens it
    (it admits nothing and bills nothing until then), and an opened
    reserve is closed again once it has no unfinished bound tasks.
    """
    name: str = "small"
    mips: float = 250.0
    pes: int = 1
    ram_mb: int = 512
    bw_mbps: float = 1000.0
    image_size_mb: int = 10_000
    cost_per_sec: float = 1.0
    lease_start: float = 0.0
    lease_stop: float = math.inf
    autoscale: bool = False


@dataclass(frozen=True)
class DatacenterSpec:
    """Physical datacentre capacity (paper Table I)."""
    pes: int = 500
    ram_mb: int = 20_480
    storage_mb: int = 1_000_000
    bw_mbps: float = 1000.0
    mips: float = 1000.0


@dataclass(frozen=True)
class JobSpec:
    """One MapReduce job (paper Table III + §5.2.5 MR combination).

    ``length_mi`` is the total map work in MI; each of the ``n_maps`` map
    tasks gets ``length_mi / n_maps``.  Each of the ``n_reduces`` reduce
    tasks gets ``reduce_factor * length_mi / n_reduces`` (β, DESIGN.md §2.1).
    """
    name: str = "small"
    length_mi: float = 362_880.0
    data_mb: float = 200_000.0
    n_maps: int = 1
    n_reduces: int = 1
    submit_time: float = 0.0
    reduce_factor: float = 0.5
    # Per-task multiplicative length noise (straggler modelling, beyond-paper).
    # 1.0 == deterministic paper behaviour.
    straggler_scale: float = 1.0
    # Space-shared admission priority (DESIGN.md §8): among waiting tasks on
    # one VM, higher priority is admitted first; ties fall back to the
    # classic (ready time, task index) order.  0.0 everywhere reproduces the
    # pre-priority rank bit for bit.
    priority: float = 0.0
    # Completion deadline in simulated seconds (DESIGN.md §11): every task
    # of the job inherits it.  ``inf`` (the default, encoded as the engine's
    # _BIG sentinel) means no decision window — deadline machinery is a
    # bitwise no-op and only the miss metrics see it.
    deadline: float = math.inf


@dataclass(frozen=True)
class NetworkSpec:
    """Stage-in + shuffle delay model (DESIGN.md §2.1).

    ``DelayTime(job) = (kappa_in + kappa_shuffle) * S / ((M + 1) * BW)``;
    kappa values are calibrated so the paper's Table IV is reproduced
    exactly (kappa_in + kappa_shuffle = 21.25 for S=200000, BW=1000 gives
    4250/(M+1)).
    """
    enabled: bool = True
    bw_mbps: float = 1000.0
    kappa_in: float = 17.0
    kappa_shuffle: float = 4.25
    cost_per_unit: float = 1.0


@dataclass(frozen=True)
class Scenario:
    """One complete simulation input (one CloudSim "run")."""
    vms: Sequence[VMSpec] = field(default_factory=lambda: (VM_SMALL,) * 3)
    jobs: Sequence[JobSpec] = field(default_factory=lambda: (JOB_SMALL,))
    datacenter: DatacenterSpec = field(default_factory=DatacenterSpec)
    network: NetworkSpec = field(default_factory=NetworkSpec)
    storage: StorageSpec = field(default_factory=StorageSpec)
    elasticity: ElasticitySpec = field(default_factory=ElasticitySpec)
    control: ControlSpec = field(default_factory=ControlSpec)
    sched_policy: SchedPolicy = SchedPolicy.TIME_SHARED
    binding_policy: BindingPolicy = BindingPolicy.ROUND_ROBIN

    def total_tasks(self) -> int:
        return sum(j.n_maps + j.n_reduces for j in self.jobs)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Paper presets
# ---------------------------------------------------------------------------

VM_SMALL = VMSpec("small", mips=250.0, pes=1, ram_mb=512,
                  image_size_mb=10_000, cost_per_sec=1.0)
VM_MEDIUM = VMSpec("medium", mips=500.0, pes=2, ram_mb=1024,
                   image_size_mb=20_000, cost_per_sec=2.0)
VM_LARGE = VMSpec("large", mips=1000.0, pes=4, ram_mb=2048,
                  image_size_mb=40_000, cost_per_sec=4.0)
VM_TYPES = {"small": VM_SMALL, "medium": VM_MEDIUM, "large": VM_LARGE}

JOB_SMALL = JobSpec("small", length_mi=362_880.0, data_mb=200_000.0)
JOB_MEDIUM = JobSpec("medium", length_mi=725_760.0, data_mb=400_000.0)
JOB_BIG = JobSpec("big", length_mi=1_451_520.0, data_mb=800_000.0)
JOB_TYPES = {"small": JOB_SMALL, "medium": JOB_MEDIUM, "big": JOB_BIG}


def as_vm_spec(v) -> VMSpec:
    """Coerce a Table-II type name or :class:`VMSpec` to a spec (the value
    form sweep axes and plan base arguments accept)."""
    if isinstance(v, str):
        try:
            return VM_TYPES[v]
        except KeyError:
            raise ValueError(f"unknown VM type {v!r}; "
                             f"known: {list(VM_TYPES)}") from None
    if isinstance(v, VMSpec):
        return v
    raise TypeError(f"expected VMSpec or VM type name, got {type(v).__name__}")


def as_job_spec(v) -> JobSpec:
    """Coerce a Table-III type name or :class:`JobSpec` to a spec."""
    if isinstance(v, str):
        try:
            return JOB_TYPES[v]
        except KeyError:
            raise ValueError(f"unknown job type {v!r}; "
                             f"known: {list(JOB_TYPES)}") from None
    if isinstance(v, JobSpec):
        return v
    raise TypeError(
        f"expected JobSpec or job type name, got {type(v).__name__}")


def paper_scenario(*, job: str = "small", vm: str = "small", n_vms: int = 3,
                   n_maps: int = 1, n_reduces: int = 1,
                   network_delay: bool = True,
                   sched_policy: SchedPolicy = SchedPolicy.TIME_SHARED,
                   binding_policy: BindingPolicy = BindingPolicy.ROUND_ROBIN,
                   ) -> Scenario:
    """The paper's §5 experimental cell: one job, homogeneous VMs."""
    j = dataclasses.replace(JOB_TYPES[job], n_maps=n_maps, n_reduces=n_reduces)
    return Scenario(vms=(VM_TYPES[vm],) * n_vms, jobs=(j,),
                    network=NetworkSpec(enabled=network_delay),
                    sched_policy=sched_policy, binding_policy=binding_policy)
