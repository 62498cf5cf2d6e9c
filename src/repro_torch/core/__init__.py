"""The IOTSim simulator core on PyTorch (the sweep path, open and closed
loop).

* configs — :class:`~repro_torch.core.config.Scenario` and the paper's
  Table I–III presets;
* :func:`~repro_torch.core.refsim.simulate` — the sequential
  paper-faithful oracle (host numpy);
* :mod:`~repro_torch.core.engine` — batch encoding, ``mr_epoch`` stepping,
  metrics;
* :mod:`~repro_torch.core.sweep` — declarative scenario sweeps;
* :mod:`~repro_torch.core.costmodel` — the measured cost model that
  prices bucket splits and the compaction interval;
* :mod:`~repro_torch.core.workload` — LM-training-step → scenario bridge
  (stragglers, failures, checkpoint goodput); :mod:`speculative` and
  :mod:`streaming`, the beyond-paper layers.
"""
from . import (control, costmodel, elasticity, engine, network, refsim,
               storage, sweep, telemetry, workload)
from .config import (JOB_BIG, JOB_MEDIUM, JOB_SMALL, JOB_TYPES, VM_LARGE,
                     VM_MEDIUM, VM_SMALL, VM_TYPES, BindingPolicy,
                     DatacenterSpec, JobSpec, NetworkSpec, Scenario,
                     SchedPolicy, VMSpec, paper_scenario)
from .control import ControlPolicy, ControlSpec, DeadlinePolicy
from .elasticity import ArrivalProcess, ElasticitySpec
from .engine import JobMetrics, ScenarioArrays, ScenarioMetrics, SimOutput
from .storage import Placement, StorageSpec
from .sweep import Axis, StreamedSweep, SweepPlan, SweepResult
from .telemetry import RunReport, TraceResult, TraceSpec, trace_scenario
from .workload import ChipSpec, StepCost

__all__ = [
    "control", "costmodel", "elasticity", "engine", "network", "refsim",
    "storage", "sweep", "telemetry", "workload",
    "Scenario", "VMSpec", "JobSpec", "NetworkSpec", "DatacenterSpec",
    "StorageSpec", "Placement", "SchedPolicy", "BindingPolicy",
    "ElasticitySpec", "ArrivalProcess", "ControlSpec", "ControlPolicy",
    "DeadlinePolicy",
    "VM_SMALL", "VM_MEDIUM", "VM_LARGE", "VM_TYPES",
    "JOB_SMALL", "JOB_MEDIUM", "JOB_BIG", "JOB_TYPES",
    "paper_scenario", "JobMetrics", "ScenarioArrays", "ScenarioMetrics",
    "SimOutput", "Axis", "SweepPlan", "SweepResult", "StreamedSweep",
    "TraceSpec", "TraceResult", "RunReport", "trace_scenario",
    "ChipSpec", "StepCost",
]

from . import speculative, streaming  # noqa: E402  (beyond-paper layers)
