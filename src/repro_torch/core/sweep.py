"""Declarative scenario sweeps on torch tensors (DESIGN.md §4, §6).

* :func:`axis` — one labelled sweep dimension over any ``Scenario``-level
  parameter (MR combination, VM count, per-VM vectors, policies, network,
  storage and elasticity knobs, VM/job presets);
* :func:`zip_` / :func:`product` — compose axes into a :class:`SweepPlan`;
* :meth:`SweepPlan.run` — encode the plan into :class:`ScenarioArrays`
  batches (one per shape bucket), step them through the ``mr_epoch``
  kernel (densely, or compacted to the still-active lanes) and return a
  labelled :class:`SweepResult` (with a
  :class:`~repro_torch.core.telemetry.RunReport` under ``report=True``),
  or stream it to a parquet file (:class:`StreamedSweep`);
* :func:`stack_scenarios` — encode and stack ``Scenario`` objects into one
  batch.

:func:`encode_cell` is written batch-native: every parameter is a Python
scalar shared by the batch or a tensor led by the cell dimension, in place
of the reference's ``vmap`` over one cell.  Its float ops are the
reference's, one rounding each, so encoded batches are bitwise equal.
"""
from __future__ import annotations

import dataclasses
import enum
import inspect
import time
from functools import partial
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import costmodel as costmodel_mod
from . import elasticity as elasticity_mod
from . import storage as storage_mod
from . import telemetry
from .config import (JOB_SMALL, VM_SMALL, BindingPolicy, SchedPolicy,
                     as_job_spec, as_vm_spec, base_task_lengths_f32)
from .control import (ControlPolicy, DeadlinePolicy, as_control_policy,
                      as_deadline_policy)
from .control import failure_times as _failure_times
from .elasticity import ElasticitySpec, as_arrival_process
from .engine import (_BIG, JobMetrics, ScenarioArrays, ScenarioMetrics,
                     bind_tasks, from_scenario, job_metrics,
                     scenario_arrays_from_numpy, scenario_metrics,
                     simulate_batch_arrays)
from .storage import Placement, StorageSpec, as_placement
from .util import pow2_pad, pow2_pads

_DEFAULT_STORAGE = StorageSpec()
_DEFAULT_ELASTICITY = ElasticitySpec()
F32, I32 = torch.float32, torch.int32


# ---------------------------------------------------------------------------
# Host-side batch builder
# ---------------------------------------------------------------------------

def stack_scenarios(scenarios: Sequence, device="cuda", *,
                    pad_tasks: int | None = None, pad_jobs: int | None = None,
                    pad_vms: int | None = None) -> ScenarioArrays:
    """Encode and stack :class:`~repro_torch.core.config.Scenario` objects
    with shared padding into one batch (leading lane dimension): the
    largest task, job and VM counts of the batch, or the ``pad_*`` given
    (a scenario above one raises ``ValueError``)."""
    T = pad_tasks or max(s.total_tasks() for s in scenarios)
    J = pad_jobs or max(len(s.jobs) for s in scenarios)
    V = pad_vms or max(len(s.vms) for s in scenarios)
    encoded = [from_scenario(s, pad_tasks=T, pad_jobs=J, pad_vms=V)
               for s in scenarios]
    return scenario_arrays_from_numpy(
        {f: np.stack([np.asarray(e[f]) for e in encoded])
         for f in ScenarioArrays._fields}, device=device)


def simulate_batch(batch: ScenarioArrays) -> JobMetrics:
    """Per-job metrics ``[N, J]`` of a stacked batch, each lane stepped to
    its own end on the batch's device: the ``mr_epoch`` kernel for
    single-job batches, the engine body for multi-job ones
    (``engine.simulate_batch_arrays``)."""
    out, _ = simulate_batch_arrays(batch)
    return job_metrics(batch, out)


# ---------------------------------------------------------------------------
# Batch-native cell encoder
# ---------------------------------------------------------------------------

def _lead(*xs) -> int | None:
    """The cell count of the first tensor among ``xs``."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return x.shape[0]
    return None


def encode_cell(n_maps, n_reduces, n_vms, vm_mips, vm_pes, vm_cost,
                job_length, job_data, *, pad_tasks: int, pad_vms: int,
                reduce_factor=0.5, net_enabled=1.0, net_bw=1000.0,
                kappa_in=17.0, kappa_shuffle=4.25, net_cost_per_unit=1.0,
                task_mult=None, sched_policy=0, binding_policy=0,
                storage_enabled=0.0,
                block_size_mb=_DEFAULT_STORAGE.block_size_mb,
                replication=_DEFAULT_STORAGE.replication,
                placement=int(_DEFAULT_STORAGE.placement),
                storage_seed=_DEFAULT_STORAGE.seed,
                job_submit=0.0, vm_start=0.0, vm_stop=_BIG,
                spinup_delay=_DEFAULT_ELASTICITY.spinup_delay,
                billing_granularity=_DEFAULT_ELASTICITY.billing_granularity,
                task_prio=None, vm_fail=_BIG, vm_restore=_BIG, vm_auto=0.0,
                control_policy=0, ctl_queue=0.0, ctl_busy=0.0,
                redispatch_delay=0.0, task_deadline=None,
                deadline_policy=0, deadline_slack=0.0, preempt=0,
                preempt_resume=0, device="cuda") -> ScenarioArrays:
    """A batch of paper cells — homogeneous or per-VM heterogeneous.

    Each parameter is a Python scalar (shared by every cell) or a tensor
    with the cell dimension first: ``[N]`` for one value per cell,
    ``[N, pad_vms]`` for the per-VM parameters, ``[N, pad_tasks]`` for the
    per-task ones.  The parameters and their defaults are the reference
    ``encode_cell``'s; a statically disabled store (the scalar default
    ``storage_enabled=0.0``) skips the placement math, and a scalar
    ``binding_policy`` computes only that strategy.
    """
    given = locals()
    N = _lead(*(given[p] for p in _CELL_PARAMS)) or 1
    dev = torch.device(device)
    T, V = pad_tasks, pad_vms

    def col(x, dtype):
        """A per-cell ``[N]`` column."""
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.expand(N) if x.dim() == 0 else x

    def vec(x, width):
        """A per-VM / per-task ``[N, width]`` block."""
        x = torch.as_tensor(x, dtype=F32, device=dev)
        if x.dim() == 0:
            return x.expand(N, width)
        return x[:, None].expand(N, width) if x.dim() == 1 else x

    f32 = partial(col, dtype=F32)
    i32 = partial(col, dtype=I32)
    t = torch.arange(T, dtype=I32, device=dev)
    n_maps, n_reduces, n_vms = i32(n_maps), i32(n_reduces), i32(n_vms)
    n_tasks = n_maps + n_reduces
    is_red = t[None, :] >= n_maps[:, None]
    valid = t[None, :] < n_tasks[:, None]
    task_mult = (torch.ones((N, T), dtype=F32, device=dev)
                 if task_mult is None else vec(task_mult, T))
    task_prio = (torch.zeros((N, T), dtype=F32, device=dev)
                 if task_prio is None else vec(task_prio, T))
    task_deadline = (torch.full((N, T), _BIG, dtype=F32, device=dev)
                     if task_deadline is None else vec(task_deadline, T))
    vm_valid = torch.arange(V, device=dev)[None, :] < n_vms[:, None]

    def per_vm(x, fill):
        return torch.where(vm_valid, vec(x, V), torch.full(
            (N, V), fill, dtype=F32, device=dev))

    def per_vm_capped(x):
        big = torch.full((N, V), _BIG, dtype=F32, device=dev)
        return torch.where(vm_valid, torch.minimum(vec(x, V), big), big)

    vm_mips_a = per_vm(vm_mips, 1.0)
    vm_pes_a = per_vm(vm_pes, 1.0)
    vm_cost_a = per_vm(vm_cost, 0.0)
    vm_start_a = per_vm(vm_start, 0.0)
    vm_stop_a = per_vm_capped(vm_stop)
    vm_fail_a = per_vm_capped(vm_fail)
    vm_restore_a = per_vm_capped(vm_restore)
    vm_auto_a = vm_valid & (vec(vm_auto, V) > 0.5)
    map_len, red_len = base_task_lengths_f32(
        f32(job_length), n_maps.to(F32), n_reduces.to(F32),
        f32(reduce_factor))
    base_len = torch.where(is_red, red_len[:, None], map_len[:, None])

    static_off = (not isinstance(storage_enabled, torch.Tensor)
                  and np.ndim(storage_enabled) == 0
                  and float(storage_enabled) == 0.0)
    if static_off:
        block_vm = torch.full((N, T, V), -1, dtype=I32, device=dev)
        block_mb = torch.zeros((N, T), dtype=F32, device=dev)
        cand = None
    else:
        seed = storage_seed
        if isinstance(seed, int):
            seed = seed % (1 << 32)
        rep_vm, rep_mb = storage_mod.map_block_placement_torch(
            t, torch.zeros(T, dtype=I32, device=dev),
            seed=col(seed, torch.int64), placement=i32(placement),
            replication=i32(replication), block_size_mb=f32(block_size_mb),
            job_data=f32(job_data), n_vms=n_vms, pad_vms=V)
        on = (f32(storage_enabled) > 0.5)[:, None]
        is_map = valid & ~is_red
        block_vm = torch.where((on & is_map)[:, :, None], rep_vm,
                               torch.full_like(rep_vm, -1))
        block_mb = torch.where(on & is_map, rep_mb,
                               torch.zeros_like(rep_mb))
        cand = storage_mod.locality_candidates(block_vm, vm_valid)
    bp = (int(binding_policy) if not isinstance(binding_policy, torch.Tensor)
          and np.ndim(binding_policy) == 0 else i32(binding_policy))
    task_vm = bind_tasks(bp, valid, base_len, vm_mips_a, vm_pes_a, vm_valid,
                         locality_cand=cand)
    return ScenarioArrays(
        task_job=torch.zeros((N, T), dtype=I32, device=dev),
        task_is_reduce=is_red & valid,
        task_vm=task_vm,
        task_valid=valid,
        task_mult=task_mult.contiguous(),
        job_length=f32(job_length)[:, None],
        job_data=f32(job_data)[:, None],
        job_n_maps=n_maps[:, None],
        job_n_reduces=n_reduces[:, None],
        job_submit=f32(job_submit)[:, None],
        job_reduce_factor=f32(reduce_factor)[:, None],
        job_valid=torch.ones((N, 1), dtype=torch.bool, device=dev),
        vm_mips=vm_mips_a, vm_pes=vm_pes_a, vm_cost=vm_cost_a,
        vm_valid=vm_valid,
        net_enabled=f32(net_enabled), net_bw=f32(net_bw),
        kappa_in=f32(kappa_in), kappa_shuffle=f32(kappa_shuffle),
        net_cost_per_unit=f32(net_cost_per_unit),
        sched_policy=i32(sched_policy), binding_policy=i32(binding_policy),
        block_vm=block_vm, block_size=block_mb,
        storage_enabled=f32(storage_enabled),
        vm_start=vm_start_a, vm_stop=vm_stop_a,
        spinup_delay=f32(spinup_delay),
        bill_gran=f32(billing_granularity),
        task_prio=task_prio.contiguous(),
        vm_fail=vm_fail_a, vm_restore=vm_restore_a, vm_auto=vm_auto_a,
        control_policy=i32(control_policy), ctl_queue=f32(ctl_queue),
        ctl_busy=f32(ctl_busy), redispatch_delay=f32(redispatch_delay),
        task_deadline=torch.minimum(
            task_deadline, torch.full_like(task_deadline, _BIG)),
        deadline_policy=i32(deadline_policy),
        deadline_slack=f32(deadline_slack), preempt=i32(preempt),
        preempt_resume=i32(preempt_resume),
    )


# encode_cell parameters an axis/grid may target (pads/device are not)
_CELL_PARAMS = tuple(p for p in inspect.signature(encode_cell).parameters
                     if p not in ("pad_tasks", "pad_vms", "device"))
_INT_PARAMS = frozenset(
    {"n_maps", "n_reduces", "n_vms", "sched_policy", "binding_policy",
     "replication", "placement", "storage_seed", "control_policy",
     "deadline_policy", "preempt", "preempt_resume"})
_PER_VM = frozenset({"vm_mips", "vm_pes", "vm_cost", "vm_start", "vm_stop",
                     "vm_fail", "vm_restore", "vm_auto"})
_PER_TASK = frozenset({"task_mult", "task_prio", "task_deadline"})
_STORAGE_KNOBS = frozenset(
    {"block_size_mb", "replication", "placement", "storage_seed"})
# columns that switch a run onto the closed-loop control lowering
# (DESIGN.md §10-11): a plan that names none of them never pays for control
_CONTROL_PARAMS = frozenset(
    {"vm_fail", "vm_restore", "vm_auto", "control_policy", "ctl_queue",
     "ctl_busy", "redispatch_delay", "task_deadline", "deadline_policy",
     "deadline_slack", "preempt", "preempt_resume"})
_PER_VM_FILL = {"vm_fail": _BIG, "vm_restore": _BIG}


def _validate_cell_columns(cols: Mapping[str, Any]) -> None:
    """Plan-build-time checks of the parameter columns (named errors, not
    shape errors deep inside the encoder)."""
    conc = {n: np.asarray(v) for n, v in cols.items()}
    for n in conc:
        if n in _INT_PARAMS and not np.issubdtype(conc[n].dtype, np.integer):
            raise ValueError(
                f"grid_arrays: parameter {n!r} is integer-valued; got "
                f"dtype {conc[n].dtype} (a float column here would be "
                "silently truncated per cell)")
    if "placement" in conc:
        bad = np.setdiff1d(conc["placement"], [int(p) for p in Placement])
        if bad.size:
            raise ValueError(
                f"grid_arrays: placement values {bad.tolist()} are not "
                f"Placement members {[f'{int(p)}={p.name}' for p in Placement]}")
    if "replication" in conc and (conc["replication"] < 1).any():
        raise ValueError(
            "grid_arrays: replication must be >= 1 in every cell (disable "
            "the store with storage_enabled=0 instead of replication=0)")
    for n, what in (("block_size_mb", "> 0"), ("billing_granularity", "> 0"),
                    ("spinup_delay", ">= 0"), ("vm_start", ">= 0"),
                    ("job_submit", ">= 0"), ("deadline_slack", ">= 0"),
                    ("redispatch_delay", ">= 0"), ("ctl_queue", ">= 0"),
                    ("ctl_busy", ">= 0")):
        if n in conc:
            bad = (conc[n] <= 0) if what == "> 0" else (conc[n] < 0)
            if bad.any():
                raise ValueError(
                    f"grid_arrays: {n} must be {what} in every cell")
    for n, enum_t in (("control_policy", ControlPolicy),
                      ("deadline_policy", DeadlinePolicy)):
        if n in conc:
            bad = np.setdiff1d(conc[n], [int(p) for p in enum_t])
            if bad.size:
                raise ValueError(
                    f"grid_arrays: {n} values {bad.tolist()} are not "
                    f"{enum_t.__name__} members "
                    f"{[f'{int(p)}={p.name}' for p in enum_t]}")
    if "task_deadline" in conc:
        dl = conc["task_deadline"].astype(np.float64)
        if not np.isfinite(dl).all():
            raise ValueError(
                "grid_arrays: task_deadline must be finite in every cell "
                "(use the _BIG sentinel, not inf/nan, for 'no deadline')")
        live = dl < _BIG / 2
        submit = conc.get("job_submit")
        sub = np.asarray(0.0 if submit is None else submit, np.float64)
        while sub.ndim < dl.ndim:
            sub = sub[..., None]
        if (live & (dl <= sub)).any():
            raise ValueError(
                "grid_arrays: task_deadline must exceed the job's submit "
                "time in every cell")
    for n in ("preempt", "preempt_resume"):
        if n in conc and (conc[n] != 0).any() and "task_prio" not in cols:
            raise ValueError(
                f"grid_arrays: {n!r} enables priority preemption but no "
                "'task_prio' column is set, so the knob would silently do "
                f"nothing — add a task_prio axis/base or drop {n!r}")
    knobs = sorted(_STORAGE_KNOBS & set(cols))
    if knobs and "storage_enabled" not in cols:
        raise ValueError(
            f"grid_arrays: {knobs} configure the storage model but "
            "'storage_enabled' is never set, so they would silently do "
            "nothing — add axis('storage', [True]) / storage=True (or an "
            "explicit storage_enabled column)")


def grid_arrays(params: dict[str, np.ndarray], *, pad_tasks: int,
                pad_vms: int, static_params: Mapping[str, int] | None = None,
                device="cuda") -> ScenarioArrays:
    """Encode equal-length parameter columns into one batch on ``device``.

    Each value is ``[N]`` (one scalar per cell) or ``[N, pad_vms]`` /
    ``[N, pad_tasks]`` for the per-VM / per-task parameters.
    ``static_params`` pins parameters to one Python value for the whole
    batch (the bucketed ``run`` path pins a bucket's uniform policies).
    """
    names = list(params)
    static = dict(static_params or {})
    for n in static:
        if n not in _CELL_PARAMS:
            raise ValueError(f"grid_arrays: unknown static parameter {n!r}")
        if n in names:
            raise ValueError(
                f"grid_arrays: parameter {n!r} passed both as a column and "
                "as a static parameter")
    if not names:
        raise ValueError("grid_arrays: empty parameter dict")
    unknown = [n for n in names if n not in _CELL_PARAMS]
    if unknown:
        raise ValueError(
            f"grid_arrays: unknown encode_cell parameter(s) {unknown}; "
            f"valid: {list(_CELL_PARAMS)}")
    sizes = {}
    for n in names:
        shape = np.shape(params[n])
        if len(shape) == 0:
            raise ValueError(
                f"grid_arrays: parameter {n!r} must be an array with a "
                "leading grid dimension (got a scalar)")
        if len(shape) == 2:
            if n in _PER_VM:
                want, pad = "pad_vms", pad_vms
            elif n in _PER_TASK:
                want, pad = "pad_tasks", pad_tasks
            else:
                raise ValueError(
                    f"grid_arrays: parameter {n!r} takes one scalar per "
                    f"cell, got 2-D shape {shape}")
            if shape[1] != pad:
                raise ValueError(
                    f"grid_arrays: {n!r} has trailing width {shape[1]}, "
                    f"expected {want}={pad}")
        elif len(shape) > 2:
            raise ValueError(
                f"grid_arrays: parameter {n!r} has {len(shape)} dims; "
                "at most [N, width] is supported")
        sizes[n] = shape[0]
    n0 = sizes[names[0]]
    bad = [f"{n} has length {sizes[n]}" for n in names if sizes[n] != n0]
    if bad:
        raise ValueError(
            "grid_arrays: parameter arrays must share one leading grid "
            f"length; {names[0]!r} has length {n0} but " + ", ".join(bad))
    _validate_cell_columns(params)
    dev = torch.device(device)
    kw = {n: torch.as_tensor(np.ascontiguousarray(params[n]), device=dev)
          for n in names}
    kw.update(static)
    return encode_cell(**kw, pad_tasks=pad_tasks, pad_vms=pad_vms,
                       device=dev)


# ---------------------------------------------------------------------------
# Declarative sweep plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """One labelled sweep dimension: coordinate ``names``, one label tuple
    per point, and the encode_cell parameter ``columns`` it sets."""
    names: tuple[str, ...]
    labels: tuple[tuple[Any, ...], ...]
    columns: Mapping[str, np.ndarray]

    def __len__(self) -> int:
        return len(self.labels)


def axis(name: str, values: Sequence[Any]) -> Axis:
    """One sweep dimension: ``name`` + the values it takes.

    ``name`` is a raw :func:`encode_cell` parameter or a spec axis:
    ``"vm"``/``"vm_type"``, ``"vms"`` (heterogeneous clusters),
    ``"job"``/``"job_type"``, ``"sched_policy"``/``"binding_policy"``,
    ``"network_delay"``, ``"storage"``, ``"placement"``,
    ``"control_policy"``, ``"deadline_policy"``.
    """
    values = list(values)
    if not values:
        raise ValueError(f"axis {name!r}: empty value list")
    f32 = partial(np.asarray, dtype=np.float32)
    if name in ("vm", "vm_type"):
        specs = [as_vm_spec(v) for v in values]
        return Axis((name,), tuple((s.name,) for s in specs), {
            "vm_mips": f32([s.mips for s in specs]),
            "vm_pes": f32([float(s.pes) for s in specs]),
            "vm_cost": f32([s.cost_per_sec for s in specs]),
        })
    if name == "vms":
        clusters = [tuple(as_vm_spec(v) for v in vs) for vs in values]
        if any(not c for c in clusters):
            raise ValueError("axis 'vms': every point needs >= 1 VM")
        V = max(len(c) for c in clusters)

        def vcol(get):
            out = np.zeros((len(clusters), V), np.float32)
            for i, c in enumerate(clusters):
                out[i, :len(c)] = [get(s) for s in c]
            return out

        return Axis((name,),
                    tuple((tuple(s.name for s in c),) for c in clusters), {
            "n_vms": np.asarray([len(c) for c in clusters], np.int32),
            "vm_mips": vcol(lambda s: s.mips),
            "vm_pes": vcol(lambda s: float(s.pes)),
            "vm_cost": vcol(lambda s: s.cost_per_sec),
        })
    if name in ("job", "job_type"):
        specs = [as_job_spec(v) for v in values]
        return Axis((name,), tuple((s.name,) for s in specs), {
            "job_length": f32([s.length_mi for s in specs]),
            "job_data": f32([s.data_mb for s in specs]),
            "reduce_factor": f32([s.reduce_factor for s in specs]),
        })
    if name == "network_delay":
        labels = tuple((bool(v),) for v in values)
        return Axis((name,), labels,
                    {"net_enabled": f32([1.0 if v else 0.0 for v in values])})
    if name == "storage":
        labels = tuple((bool(v),) for v in values)
        return Axis((name,), labels, {
            "storage_enabled": f32([1.0 if v else 0.0 for v in values])})
    coerce = {"placement": as_placement, "sched_policy": SchedPolicy,
              "binding_policy": BindingPolicy,
              "control_policy": as_control_policy,
              "deadline_policy": as_deadline_policy}
    if name in coerce:
        members = [coerce[name](v) for v in values]
        return Axis((name,), tuple((m,) for m in members),
                    {name: np.asarray(members, np.int32)})
    if name not in _CELL_PARAMS:
        raise ValueError(
            f"axis {name!r}: not an encode_cell parameter or spec axis; "
            f"valid: {list(_CELL_PARAMS)} + ['vm', 'vm_type', 'vms', 'job', "
            "'job_type', 'network_delay', 'storage', 'placement', "
            "'control_policy', 'deadline_policy']")
    if any(np.ndim(v) > 0 for v in values):        # per-VM / per-task vectors
        if name not in _PER_VM and name not in _PER_TASK:
            raise ValueError(
                f"axis {name!r}: vector values only make sense for the "
                f"per-VM parameters {sorted(_PER_VM)} or the per-task "
                f"parameters {sorted(_PER_TASK)}; "
                f"{name!r} takes one scalar per cell")
        if not all(np.ndim(v) == 1 for v in values):
            raise ValueError(
                f"axis {name!r}: vector values must all be 1-D with one "
                "shared length (use the 'vms' axis for ragged clusters)")
        widths = {int(np.shape(v)[0]) for v in values}
        if len(widths) != 1:
            raise ValueError(
                f"axis {name!r}: vector values must share one length, got "
                f"{sorted(widths)} (use the 'vms' axis for ragged clusters)")
        return Axis((name,), tuple((tuple(np.asarray(v).tolist()),)
                                   for v in values),
                    {name: np.stack([f32(v) for v in values])})
    dtype = np.int32 if name in _INT_PARAMS else np.float32
    return Axis((name,), tuple((v,) for v in values),
                {name: np.asarray(values, dtype)})


def zip_(*axes: Axis) -> Axis:
    """Fuse equal-length axes into one dimension that advances together."""
    if not axes:
        raise ValueError("zip_: need at least one axis")
    lens = {"x".join(a.names): len(a) for a in axes}
    if len(set(lens.values())) != 1:
        raise ValueError(f"zip_: axes must share one length; got {lens}")
    columns: dict[str, np.ndarray] = {}
    for a in axes:
        for cname, c in a.columns.items():
            if cname in columns:
                raise ValueError(
                    f"zip_: parameter {cname!r} set by more than one axis")
            columns[cname] = c
    names = tuple(n for a in axes for n in a.names)
    if len(set(names)) != len(names):
        raise ValueError(f"zip_: duplicate coordinate names in {names}")
    labels = tuple(tuple(part for a in axes for part in a.labels[i])
                   for i in range(len(axes[0])))
    return Axis(names, labels, columns)


def arrivals(n: int, *, rate, process="poisson", seed: int = 0,
             burst: int = 4) -> Axis:
    """An arrival-stream dimension (DESIGN.md §8): ``n`` seeded draws of an
    inter-arrival process become ``job_submit`` instants; a sequence of
    rates flattens rates × arrivals into one labelled dimension."""
    proc = as_arrival_process(process)
    rates = list(rate) if np.ndim(rate) > 0 else [rate]
    if not rates:
        raise ValueError("arrivals: empty rate list")
    times = [elasticity_mod.arrival_times(n, rate=float(r), process=proc,
                                          seed=seed, burst=burst)
             for r in rates]
    c = np.concatenate(times).astype(np.float32)
    if np.ndim(rate) > 0:
        labels = tuple((float(r), k) for r in rates for k in range(n))
        return Axis(("arrival_rate", "arrival"), labels, {"job_submit": c})
    return Axis(("arrival",), tuple((k,) for k in range(n)),
                {"job_submit": c})


def failures(n: int, *, rate, n_vms: int, seed: int = 0,
             repair_delay: float = np.inf) -> Axis:
    """A failure-stream dimension (DESIGN.md §10): ``n`` seeded draws of
    per-VM failure/restore instants; a sequence of rates flattens rates ×
    draws into one labelled dimension."""
    rates = list(rate) if np.ndim(rate) > 0 else [rate]
    if not rates:
        raise ValueError("failures: empty rate list")
    cols_f, cols_r = [], []
    for r in rates:
        for k in range(n):
            f, rr = _failure_times(n_vms, rate=float(r), seed=seed + k,
                                   repair_delay=float(repair_delay))
            cols_f.append(f)
            cols_r.append(rr)
    col_f = np.stack(cols_f).astype(np.float32)
    col_r = np.stack(cols_r).astype(np.float32)
    if np.ndim(rate) > 0:
        labels = tuple((float(r), k) for r in rates for k in range(n))
        return Axis(("failure_rate", "failure"), labels,
                    {"vm_fail": col_f, "vm_restore": col_r})
    return Axis(("failure",), tuple((k,) for k in range(n)),
                {"vm_fail": col_f, "vm_restore": col_r})


def product(*dims: Axis, **base: Any) -> "SweepPlan":
    """Cartesian :class:`SweepPlan` over ``dims`` (row-major: the last axis
    varies fastest); ``base`` pins non-swept parameters for every cell."""
    return SweepPlan(dims=tuple(dims), base=dict(base))


# Paper defaults for parameters no axis/base sets: the §5 baseline cell
_DEFAULTS: dict[str, float] = dict(
    n_maps=1, n_reduces=1, n_vms=3,
    vm_mips=VM_SMALL.mips, vm_pes=float(VM_SMALL.pes),
    vm_cost=VM_SMALL.cost_per_sec,
    job_length=JOB_SMALL.length_mi, job_data=JOB_SMALL.data_mb,
)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """A declarative experiment plan: labelled axes × pinned base
    parameters.  ``pad_tasks``/``pad_vms`` override the inferred paddings
    (they cap the buckets)."""
    dims: tuple[Axis, ...]
    base: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    pad_tasks: int | None = None
    pad_vms: int | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(d) for d in self.dims)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.dims else 1

    def replace(self, **kw) -> "SweepPlan":
        return dataclasses.replace(self, **kw)

    def arrivals(self, n: int, *, rate, process="poisson", seed: int = 0,
                 burst: int = 4) -> "SweepPlan":
        """Append an arrival-stream dimension (see :func:`arrivals`)."""
        dim = arrivals(n, rate=rate, process=process, seed=seed, burst=burst)
        return self.replace(dims=self.dims + (dim,))

    def failures(self, n: int, *, rate, n_vms: int, seed: int = 0,
                 repair_delay: float = np.inf) -> "SweepPlan":
        """Append a failure-stream dimension (see :func:`failures`)."""
        dim = failures(n, rate=rate, n_vms=n_vms, seed=seed,
                       repair_delay=repair_delay)
        return self.replace(dims=self.dims + (dim,))

    def _compiled(self) -> tuple[dict[str, np.ndarray], int, int]:
        """Flatten axes + base + defaults into N-cell parameter columns."""
        shape, N = self.shape, self.size
        cols: dict[str, np.ndarray] = {}
        owner: dict[str, str] = {}
        for k, dim in enumerate(self.dims):
            outer = int(np.prod(shape[:k], dtype=np.int64))
            inner = int(np.prod(shape[k + 1:], dtype=np.int64))
            idx = np.tile(np.repeat(np.arange(shape[k]), inner), outer)
            src = "axis " + "×".join(dim.names)
            for cname, c in dim.columns.items():
                if cname in cols:
                    raise ValueError(
                        f"SweepPlan: parameter {cname!r} set by both "
                        f"{owner[cname]} and {src}")
                cols[cname] = np.asarray(c)[idx]
                owner[cname] = src
        for bname, value in self.base.items():
            for cname, c in axis(bname, [value]).columns.items():
                if cname in cols:
                    raise ValueError(
                        f"SweepPlan: parameter {cname!r} set by both "
                        f"{owner[cname]} and base argument {bname!r}")
                c = np.asarray(c)
                cols[cname] = np.broadcast_to(c[0], (N,) + c.shape[1:])
                owner[cname] = f"base argument {bname!r}"
        for cname, default in _DEFAULTS.items():
            if cname not in cols:
                dtype = np.int32 if cname in _INT_PARAMS else np.float32
                cols[cname] = np.full(N, default, dtype)
        n_tasks = int((cols["n_maps"].astype(np.int64)
                       + cols["n_reduces"].astype(np.int64)).max())
        pad_tasks = self.pad_tasks if self.pad_tasks is not None else n_tasks
        v_needed = max(int(cols["n_vms"].max()),
                       *(c.shape[1] for n, c in cols.items()
                         if n in _PER_VM and c.ndim == 2), 1)
        pad_vms = self.pad_vms if self.pad_vms is not None else v_needed
        if pad_tasks < n_tasks or pad_vms < v_needed:
            raise ValueError(
                f"SweepPlan: padding too small — need pad_tasks>={n_tasks} "
                f"(got {pad_tasks}), pad_vms>={v_needed} (got {pad_vms})")
        n_vms_max = int(cols["n_vms"].max())
        for cname in _PER_VM:
            c = cols.get(cname)
            if c is None or c.ndim != 2:
                continue
            if c.shape[1] < n_vms_max:
                raise ValueError(
                    f"SweepPlan: per-VM column {cname!r} has width "
                    f"{c.shape[1]} but some cell has n_vms={n_vms_max}; "
                    "give every VM vector >= n_vms entries (or use the "
                    "'vms' axis, which sets n_vms itself)")
            if c.shape[1] < pad_vms:
                cols[cname] = np.pad(
                    c, ((0, 0), (0, pad_vms - c.shape[1])),
                    constant_values=_PER_VM_FILL.get(cname, 0.0))
        for cname, fill in (("task_mult", 1.0), ("task_prio", 0.0),
                            ("task_deadline", _BIG)):
            if cname in cols and cols[cname].ndim == 2 \
                    and cols[cname].shape[1] != pad_tasks:
                tm = cols[cname]
                if tm.shape[1] > pad_tasks:
                    raise ValueError(
                        f"SweepPlan: {cname} width {tm.shape[1]} exceeds "
                        f"pad_tasks={pad_tasks}")
                cols[cname] = np.pad(
                    tm, ((0, 0), (0, pad_tasks - tm.shape[1])),
                    constant_values=fill)
        _validate_cell_columns(cols)
        return cols, pad_tasks, pad_vms

    def params(self) -> dict[str, np.ndarray]:
        """The flattened ``grid_arrays`` parameter columns (host numpy)."""
        return self._compiled()[0]

    def arrays(self, device="cuda") -> ScenarioArrays:
        """Encode the whole plan as one batch (leading dim = the grid)."""
        cols, pad_tasks, pad_vms = self._compiled()
        return grid_arrays(cols, pad_tasks=pad_tasks, pad_vms=pad_vms,
                           device=device)

    def run(self, mesh=None, chunk: int | None = None, *,
            bucket: object = "auto", backend: str | None = None,
            stream_to=None, compact: object = None,
            cost_model: costmodel_mod.CostModel | None = None,
            report: bool = False, device="cuda"):
        """Execute the plan and return a labelled :class:`SweepResult`.

        ``bucket="auto"`` groups cells into power-of-two padded-shape
        buckets (and per-policy buckets when every combination fills one),
        ``False`` runs one max-shape batch; metric values are the same
        either way, only ``realized_epochs`` follows the buckets.  ``chunk``
        encodes and steps at most ``chunk`` cells at a time.

        ``backend="cuda"`` steps the batches through the CUDA ``mr_epoch``
        kernel (the default on the card), ``"torch"`` through its plain
        version (the default on the CPU).  ``cost_model`` prices bucket
        splits and the compaction interval (default:
        :func:`costmodel.default_cost_model` of ``device``, measured once
        and cached; pin one for the same decisions on every host).

        ``compact`` turns on active-lane compaction (DESIGN.md §9): every
        K epochs the still-active lanes of a bucket (of a chunk under
        ``chunk``) are gathered into a power-of-two working set and the
        kernel resumes on those alone.  ``"auto"`` (or ``True``) takes K
        from the cost model, an int pins it.  Every metric, per-lane
        ``n_epochs`` and ``realized_epochs`` are the dense run's bit for
        bit.

        ``stream_to`` (with ``chunk``) appends each chunk's long-form
        :meth:`SweepResult.to_table` rows to one parquet file instead of
        keeping the metrics in host memory, and returns a
        :class:`StreamedSweep` (needs the optional ``pyarrow``).

        A plan that names any closed-loop column (``_CONTROL_PARAMS``:
        failures, reserves, the control and deadline policies, preemption)
        runs the kernel's control lowering; the choice follows the columns,
        not their values, as in the reference.

        ``report=True`` returns ``(result, RunReport)``: one
        :class:`~repro_torch.core.telemetry.BucketReport` per dispatched
        bucket (per chunk under ``chunk=``) with its ``mr_epoch`` launches,
        its compaction syncs and wall time, the run's totals and the cost
        model (resolved once, up front).  It changes no metric.

        ``mesh`` (a ``DeviceMesh``) runs the plan over the mesh's ranks,
        SPMD: every rank calls ``run`` with the same plan and arguments.
        Each bucket's cells are padded (by repeating its last cell) to a
        multiple of the mesh size, split over the mesh flattened row-major
        (``launch.mesh.flat_index``, the reference's
        ``PartitionSpec(mesh.axis_names)`` order) and each rank encodes and
        steps only its contiguous block of lanes on ``device``; the host
        metrics are all-gathered over the mesh's groups (CPU tensors: a
        ``gloo`` backend) and trimmed, so every rank returns the whole
        result.  A bucket's ``realized_epochs`` is the largest per-lane
        ``n_epochs`` of its real cells, and ``report=True`` counts one
        dispatch per bucket, as in the reference.  Every rank prices the
        buckets with the first rank's cost model (the one passed there, or
        its default), so the ranks bucket alike whatever each was handed;
        a rank whose bucket list still differs raises.  ``mesh`` takes
        neither ``chunk`` nor ``stream_to`` and ignores ``compact``.  The
        reference refuses ``backend="pallas"`` with a mesh (its Pallas
        path is single-device); here each rank steps its lanes through the
        same ``mr_epoch`` kernel (``"cuda"``) or plain version
        (``"torch"``) as without a mesh, whose results the parity contract
        holds bitwise to the reference's engine: a difference of route,
        not of result.
        """
        if mesh is not None and chunk is not None:
            raise ValueError("run: pass mesh or chunk, not both")
        if chunk is not None and chunk < 1:
            raise ValueError(f"run: chunk must be >= 1, got {chunk}")
        if stream_to is not None and chunk is None:
            raise ValueError(
                "run: stream_to= needs chunk= (the streamed write "
                "appends one chunk of cells at a time)")
        compact = _check_compact(compact)
        if mesh is not None:
            compact = None          # ignored, as the reference ignores it
        from ..kernels.mr_sched.ops import resolve_backend
        dev = torch.device(device)
        backend = resolve_backend(backend, dev)
        if mesh is not None:
            cost_model = _first_rank_cost_model(mesh, cost_model, dev)
        buckets = None
        if report:
            # one calibration prices the schedule and the report
            cost_model = cost_model or costmodel_mod.default_cost_model(
                device=dev)
            t0, libs0 = time.perf_counter(), _library_loads()
            buckets = []
        if stream_to is not None:
            result = self._run_streaming(stream_to, chunk, bucket, backend,
                                         compact, cost_model, dev, buckets)
        else:
            cols, pad_tasks, pad_vms = self._compiled()
            metrics, n_jobs = _execute_grid(
                cols, self.size, pad_tasks, pad_vms, bucket, chunk, backend,
                cost_model, dev, bool(_CONTROL_PARAMS & set(cols)),
                report=buckets, compact=compact, mesh=mesh)
            shaped = {
                name: (m.reshape(self.shape) if m.ndim == 1 or n_jobs == 1
                       else m.reshape(self.shape + (n_jobs,)))
                for name, m in metrics.items()}
            result = SweepResult(
                axis_names=tuple(d.names for d in self.dims),
                axis_labels=tuple(d.labels for d in self.dims),
                metrics=shaped, n_jobs=n_jobs)
        if buckets is None:
            return result
        return result, _finish_report(buckets, self.size, backend, compact,
                                      cost_model, dev, libs0, t0)

    def _run_streaming(self, path, chunk: int, bucket, backend, compact,
                       cost, device, report=None) -> "StreamedSweep":
        """Chunked execute + parquet append (see :meth:`run`)."""
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError as e:
            raise ImportError(
                "run(stream_to=...) needs the optional pyarrow dependency; "
                "without it use run(chunk=...) and to_table()") from e
        cols, pad_tasks, pad_vms = self._compiled()
        control = bool(_CONTROL_PARAMS & set(cols))
        N, shape = self.size, self.shape
        axis_names = tuple(d.names for d in self.dims)
        axis_labels = tuple(d.labels for d in self.dims)
        writer, n_rows, n_chunks = None, 0, 0
        try:
            for lo in range(0, N, chunk):
                hi = min(lo + chunk, N)
                sub = {k: v[lo:hi] for k, v in cols.items()}
                metrics, n_jobs = _execute_grid(
                    sub, hi - lo, pad_tasks, pad_vms, bucket, None, backend,
                    cost, device, control, report=report, compact=compact)
                table = pa.table(_long_form_columns(
                    axis_names, axis_labels, shape, metrics, n_jobs, lo, hi))
                # provenance rides in the file's schema metadata; schema
                # equality ignores metadata, so later chunks append as is
                table = table.replace_schema_metadata(
                    {**(table.schema.metadata or {}),
                     **telemetry.parquet_metadata()})
                if writer is None:
                    writer = pq.ParquetWriter(path, table.schema)
                writer.write_table(table)
                n_rows += table.num_rows
                n_chunks += 1
        finally:
            if writer is not None:
                writer.close()
        return StreamedSweep(path=str(path), n_cells=N, n_rows=n_rows,
                             n_chunks=n_chunks)


def _check_compact(compact):
    """Normalise the ``compact`` knob: None/False off, True -> 'auto',
    'auto' or a positive int interval pass through."""
    if compact is None or compact is False:
        return None
    if compact is True:
        return "auto"
    if compact == "auto" or (isinstance(compact, (int, np.integer))
                             and compact >= 1):
        return compact
    raise ValueError(
        f"run: compact must be None, False, True, 'auto', or an int "
        f">= 1; got {compact!r}")


@dataclasses.dataclass(frozen=True)
class StreamedSweep:
    """Summary of a ``run(chunk=..., stream_to=...)`` export: the grid's
    metrics live in the parquet file at ``path`` (long-form ``to_table``
    columns), not in host memory."""
    path: str
    n_cells: int
    n_rows: int
    n_chunks: int


def _library_loads() -> tuple[int, int]:
    """``(hits, misses)`` of ``mr_epoch``'s kernel-library cache: launches
    that found their instantiation bound, and bindings (each loading its
    library, built with ``nvcc`` first if missing) — the port's
    counterpart of the reference's compile cache."""
    from ..kernels.mr_sched.megakernel import _LIB_CACHE
    return _LIB_CACHE["hits"], _LIB_CACHE["misses"]


def _finish_report(buckets, n_cells: int, backend: str, compact, cost,
                   device, libs0, t0) -> "telemetry.RunReport":
    """Assemble the :class:`telemetry.RunReport` of one ``run()``."""
    hits, misses = (a - b for a, b in zip(_library_loads(), libs0))
    return telemetry.RunReport(
        n_cells=n_cells, n_buckets=len(buckets), backend=backend,
        compact=compact, buckets=buckets,
        compile_cache_hits=hits, compile_cache_misses=misses,
        # no encoder cache: grid_arrays encodes batch-native every call
        encoder_cache_hits=0, encoder_cache_misses=0,
        compaction_syncs=sum(b.compact_syncs for b in buckets),
        scalar_syncs=sum(b.compact_scalar_syncs for b in buckets),
        dispatches=sum(b.dispatches for b in buckets),
        cost_model={"dispatch_us": cost.dispatch_us,
                    "epoch_lane_us": cost.epoch_lane_us,
                    "sync_us": cost.sync_us,
                    "device": cost.device, "source": cost.source},
        device=costmodel_mod.device_key(device),
        provenance=dict(telemetry.provenance()),
        wall_s=time.perf_counter() - t0)


def _execute_grid(cols: dict[str, np.ndarray], N: int, pad_tasks: int,
                  pad_vms: int, bucket, chunk, backend, cost, device,
                  control: bool = False, report: list | None = None,
                  compact=None, mesh=None
                  ) -> tuple[dict[str, np.ndarray], int]:
    """Bucket + simulate ``N`` flattened cells; returns ``(metrics,
    n_jobs)`` with per-job columns ``[N, n_jobs]`` and per-scenario ones
    ``[N]``.  ``report`` (a list, appended in place) collects one
    :class:`telemetry.BucketReport` per dispatched bucket.  With ``mesh``
    each bucket's lanes are split over its ranks (:func:`_run_sharded`)."""
    from ..kernels.mr_sched.megakernel import total_launches
    if compact is not None and cost is None:
        cost = costmodel_mod.default_cost_model(device=device)
    groups = _bucket_groups(cols, pad_tasks, pad_vms, bucket, cost,
                            device=device)
    if mesh is not None:
        _check_same_buckets(mesh, groups)
    parts = []
    for idx, gcols, statics, tb, vb in groups:
        stats = {"syncs": 0, "scalar_syncs": 0, "compactions": 0,
                 "dispatches": 0}
        w0, l0 = time.perf_counter(), total_launches()
        if mesh is None:
            parts.append((idx, *_run_cells(gcols, len(idx), tb, vb, statics,
                                           chunk, backend, device, control,
                                           compact, cost, stats)))
        else:
            parts.append((idx, *_run_sharded(gcols, len(idx), tb, vb,
                                             statics, backend, device,
                                             control, mesh)))
        if report is not None:
            report.append(telemetry.BucketReport(
                cells=len(idx), pad_tasks=tb, pad_vms=vb, backend=backend,
                control=control, statics=dict(statics or {}),
                # the modelled lane-epoch saving vs running these cells at
                # the grid cap, which _bucket_groups weighed against
                # dispatch_us (None: the bucket is at the cap)
                split_gain_us=(cost.split_gain_us(len(idx), tb, pad_tasks)
                               if tb < pad_tasks else None),
                dispatches=(total_launches() - l0 if mesh is None else 1),
                compact_syncs=stats["syncs"],
                compact_scalar_syncs=stats["scalar_syncs"],
                compactions=stats["compactions"],
                compact_rounds=stats["dispatches"],
                wall_s=time.perf_counter() - w0))
    n_jobs = int(parts[0][1]["makespan"].shape[-1])
    metrics: dict[str, np.ndarray] = {}
    for f in JobMetrics._fields:
        out = np.empty((N, n_jobs), parts[0][1][f].dtype)
        for idx, jm, _, _ in parts:
            out[idx] = jm[f]
        metrics[f] = out
    for f in ScenarioMetrics._fields:
        out = np.empty(N, parts[0][2][f].dtype)
        for idx, _, sm, _ in parts:
            out[idx] = sm[f]
        metrics[f] = out
    realized = np.empty(N, np.int32)
    for idx, _, _, rz in parts:
        realized[idx] = rz
    metrics["realized_epochs"] = realized
    return metrics, n_jobs


def _pad_cells(cols: dict[str, np.ndarray], n: int) -> dict[str, np.ndarray]:
    """Pad parameter columns to ``n`` cells by repeating the last cell."""
    have = len(next(iter(cols.values())))
    if have == n:
        return cols
    return {k: np.concatenate([v, np.repeat(v[-1:], n - have, axis=0)])
            for k, v in cols.items()}


# ---------------------------------------------------------------------------
# Adaptive execution schedule: shape buckets + per-bucket execution
# ---------------------------------------------------------------------------

def _bucket_groups(cols: dict[str, np.ndarray], pad_tasks: int, pad_vms: int,
                   bucket, cost: costmodel_mod.CostModel | None = None, *,
                   device=None
                   ) -> list[tuple[np.ndarray, dict[str, np.ndarray],
                                   dict[str, int] | None, int, int]]:
    """Partition grid cells into padded-shape buckets (DESIGN.md §6).

    Returns ``[(cell_indices, columns, static_params, pad_tasks,
    pad_vms)]`` with indices ascending in every bucket.  Policy columns
    split per combination when every combination fills 64 cells; task
    paddings round up to powers of two and a run of cells stands alone
    when the cost model's split gain beats one dispatch; each bucket's
    VM padding is its own ``n_vms`` max rounded up likewise.  ``cost``
    defaults to :func:`costmodel.default_cost_model` of ``device``.
    """
    N = len(next(iter(cols.values())))
    all_idx = np.arange(N)
    if bucket is False or bucket is None or N <= 1:
        return [(all_idx, cols, None, pad_tasks, pad_vms)]
    if bucket is not True and bucket != "auto":
        raise ValueError(
            f"run: bucket must be 'auto', True, or False; got {bucket!r}")
    cost = cost or costmodel_mod.default_cost_model(device=device)
    need_t = (cols["n_maps"].astype(np.int64)
              + cols["n_reduces"].astype(np.int64))
    need_v = cols["n_vms"].astype(np.int64)
    tb = pow2_pads(need_t, pad_tasks)

    policy_cols = [p for p in ("sched_policy", "binding_policy")
                   if p in cols]
    uniform_pols = {p: int(cols[p][0]) for p in policy_cols
                    if len(np.unique(cols[p])) == 1}
    policy_names = [p for p in policy_cols if p not in uniform_pols]
    if policy_names:
        combo_key = np.stack([cols[p].astype(np.int64)
                              for p in policy_names], axis=1)
        combos, combo_id = np.unique(combo_key, axis=0, return_inverse=True)
        combo_id = combo_id.reshape(-1)
        if N < len(combos) * 64:            # too fragmented to specialize
            policy_names, combo_id = [], np.zeros(N, np.int64)
    else:
        combo_id = np.zeros(N, np.int64)

    merged: list[np.ndarray] = []
    for c in np.unique(combo_id):
        cidx = all_idx[combo_id == c]
        sizes = tb[cidx]
        pend: list[np.ndarray] = []
        done_here: list[np.ndarray] = []
        for t in np.unique(sizes):          # ascending shape runs
            pend.append(cidx[sizes == t])
            n_pend = sum(map(len, pend))
            if cost.split_gain_us(n_pend, int(t), pad_tasks) \
                    >= cost.dispatch_us:
                done_here.append(np.sort(np.concatenate(pend)))
                pend = []
        if pend:                            # tail that never paid alone
            tail = np.concatenate(pend)
            if done_here:
                prev = done_here[-1]
                t_prev = int(tb[prev].max())
                t_tail = int(tb[tail].max())
                if cost.split_gain_us(len(prev), t_prev, t_tail) \
                        < cost.dispatch_us:
                    tail = np.concatenate([done_here.pop(), tail])
            done_here.append(np.sort(tail))
        merged.extend(done_here)

    groups = []
    for idx in merged:
        t = pow2_pad(int(need_t[idx].max()), pad_tasks)
        vb = pow2_pad(int(need_v[idx].max()), pad_vms)
        statics = dict(uniform_pols)
        statics.update({p: int(cols[p][idx[0]]) for p in policy_names})
        gcols = {}
        for cname, cvals in cols.items():
            if cname in statics:
                continue
            cv = cvals[idx]
            if cv.ndim == 2:
                cv = cv[:, :t] if cname in _PER_TASK else cv[:, :vb]
            gcols[cname] = cv
        groups.append((idx, gcols, statics or None, t, vb))
    return groups


def _host_metrics(batch, out):
    """Job and scenario metrics of one stepped batch, on the host."""
    host = lambda t: {k: v.cpu().numpy()                       # noqa: E731
                      for k, v in t._asdict().items()}
    return (host(job_metrics(batch, out)),
            host(scenario_metrics(batch, out)))


def _run_batch(cols, pad_tasks, pad_vms, statics, backend, device, max_pes,
               control=False):
    """Encode, step and reduce one batch of cells; host-side results."""
    from ..kernels.mr_sched.ops import epoch_schedule
    batch = grid_arrays(cols, pad_tasks=pad_tasks, pad_vms=pad_vms,
                        static_params=statics, device=device)
    out = epoch_schedule(batch, backend=backend, max_pes=max_pes,
                         control=control)
    return (*_host_metrics(batch, out), int(out.n_epochs.max()))


def _run_compact(cols, pad_tasks, pad_vms, statics, backend, device,
                 max_pes, control, k, cost, stats):
    """:func:`_run_batch` with the epoch loop compacted to the
    still-active lanes (``ops.epoch_schedule_compact``, interval ``k``)."""
    from ..kernels.mr_sched.ops import epoch_schedule_compact
    batch = grid_arrays(cols, pad_tasks=pad_tasks, pad_vms=pad_vms,
                        static_params=statics, device=device)
    out, realized = epoch_schedule_compact(
        batch, k=k, backend=backend, max_pes=max_pes, cost_model=cost,
        control=control, stats=stats)
    return (*_host_metrics(batch, out), realized)


def _run_cells(cols: dict[str, np.ndarray], n: int, pad_tasks: int,
               pad_vms: int, statics: dict[str, int] | None, chunk, backend,
               device, control=False, compact=None, cost=None, stats=None):
    """Encode + simulate one bucket's cells, compacted per bucket (per
    chunk under ``chunk``) when ``compact`` is set; returns host-side
    ``(job metrics, scenario metrics, realized_epochs[n])``.  ``stats``
    collects the compacted loop's counts."""
    max_pes = max(int(np.ceil(float(np.max(cols["vm_pes"])))), 1)
    if compact is None:
        run = partial(_run_batch, control=control)
    else:
        run = partial(_run_compact, control=control, k=compact, cost=cost,
                      stats=stats)
    if chunk is None:
        jm, sm, rz = run(cols, pad_tasks, pad_vms, statics, backend, device,
                         max_pes)
        return jm, sm, np.full(n, rz, np.int32)
    parts, realized = [], np.empty(n, np.int32)
    for lo in range(0, n, chunk):
        part = _pad_cells({k: v[lo:lo + chunk] for k, v in cols.items()},
                          min(chunk, n))
        take = min(chunk, n - lo)
        jm, sm, rz = run(part, pad_tasks, pad_vms, statics, backend, device,
                         max_pes)
        parts.append(({k: v[:take] for k, v in jm.items()},
                      {k: v[:take] for k, v in sm.items()}))
        realized[lo:lo + take] = rz
    jm = {k: np.concatenate([p[0][k] for p in parts]) for k in parts[0][0]}
    sm = {k: np.concatenate([p[1][k] for p in parts]) for k in parts[0][1]}
    return jm, sm, realized


# ---------------------------------------------------------------------------
# Multi-rank sweeps: lanes split over a DeviceMesh (SPMD)
# ---------------------------------------------------------------------------

def _first_rank_cost_model(mesh, cost, device) -> costmodel_mod.CostModel:
    """The cost model of the mesh's first rank (``cost``, or its default
    for ``device``), on every rank: the bucket partition depends on it, and
    ranks that bucket apart would deadlock or mismatch in the gathers."""
    from ..launch.mesh import flat_index, gather_objects
    if flat_index(mesh) == 0:
        cost = cost or costmodel_mod.default_cost_model(device=device)
    else:
        cost = None
    return gather_objects(mesh, cost)[0]


def _check_same_buckets(mesh, groups) -> None:
    """Raise (on every rank) unless every rank of ``mesh`` holds the same
    bucket list: cell indices, paddings and static parameters."""
    import hashlib
    from ..launch.mesh import gather_objects
    h = hashlib.sha256()
    for idx, _, statics, tb, vb in groups:
        h.update(np.asarray(idx, np.int64).tobytes())
        h.update(repr((tb, vb, sorted((statics or {}).items()))).encode())
    digests = gather_objects(mesh, h.hexdigest())
    if len(set(digests)) > 1:
        raise RuntimeError(
            "run(mesh=...): the ranks bucketed the plan differently "
            f"(bucket digests {digests}); every rank must run the same plan "
            "with the same arguments")


def _lane_block(n: int, mesh) -> tuple[int, int, int]:
    """``(padded lanes, first lane, lanes)`` of this rank's contiguous
    block when ``n`` lanes are padded to a multiple of the mesh size and
    split over the mesh flattened row-major."""
    from ..launch.mesh import flat_index, mesh_size
    size = mesh_size(mesh)
    full = -(-n // size) * size
    per = full // size
    return full, flat_index(mesh) * per, per


def _run_sharded(cols, n: int, pad_tasks: int, pad_vms: int, statics,
                 backend, device, control, mesh):
    """One bucket over the mesh: this rank steps its block of the padded
    cells (:func:`_run_batch`), the blocks' host metrics are gathered in
    mesh order and trimmed to the ``n`` real cells.  Returns the whole
    bucket's ``(job metrics, scenario metrics, realized_epochs[n])``."""
    from ..launch.mesh import gather_objects
    max_pes = max(int(np.ceil(float(np.max(cols["vm_pes"])))), 1)
    full, lo, per = _lane_block(n, mesh)
    mine = {k: v[lo:lo + per] for k, v in _pad_cells(cols, full).items()}
    jm, sm, _ = _run_batch(mine, pad_tasks, pad_vms, statics, backend,
                           device, max_pes, control)
    blocks = gather_objects(mesh, (jm, sm))
    jm, sm = ({k: np.concatenate([b[i][k] for b in blocks])[:n]
               for k in blocks[0][i]} for i in (0, 1))
    return jm, sm, np.full(n, int(sm["n_epochs"].max()), np.int32)


def simulate_batch_sharded(batch: ScenarioArrays, mesh) -> JobMetrics:
    """:func:`simulate_batch` with the lanes split over ``mesh`` (SPMD:
    every rank of the mesh calls it with the same batch).  The lanes are
    padded to a multiple of the mesh size by repeating the last one and
    split over the mesh flattened row-major; each rank steps its block on
    the batch's device (the ``mr_epoch`` kernel for single-job lanes, the
    engine body for multi-job ones), and the per-job metrics are
    all-gathered (CPU tensors: a ``gloo`` backend) and trimmed, so every
    rank returns the whole ``[N, J]`` result on the batch's device."""
    from ..launch.mesh import gather_objects
    n = int(batch.task_valid.shape[0])
    full, lo, per = _lane_block(n, mesh)
    dev = batch.task_valid.device
    take = torch.clamp_max(torch.arange(lo, lo + per, device=dev), n - 1)
    mine = ScenarioArrays(*(f[take] for f in batch))
    jm = simulate_batch(mine)
    blocks = gather_objects(mesh, {k: v.cpu().numpy()
                                   for k, v in jm._asdict().items()})
    return JobMetrics(**{
        k: torch.from_numpy(np.concatenate([b[k] for b in blocks])[:n]).to(dev)
        for k in JobMetrics._fields})


# ---------------------------------------------------------------------------
# Labelled results
# ---------------------------------------------------------------------------

def _plain_label(v):
    """One coordinate label as a column-friendly scalar (enum -> name,
    nested sequences -> string)."""
    if isinstance(v, enum.Enum):
        return v.name
    if isinstance(v, (tuple, list, np.ndarray)):
        return ",".join(str(_plain_label(x)) for x in np.asarray(v).tolist())
    return v


def _long_form_columns(axis_names, axis_labels, shape, flat_metrics,
                       n_jobs, lo, hi) -> dict[str, np.ndarray]:
    """Long-form rows for the flat grid cells ``[lo, hi)``."""
    n = hi - lo
    flat = np.arange(lo, hi)
    cols: dict[str, np.ndarray] = {}
    for d, (names, labs) in enumerate(zip(axis_names, axis_labels)):
        inner = int(np.prod(shape[d + 1:], dtype=np.int64))
        di = (flat // inner) % shape[d]
        for ci, cname in enumerate(names):
            vals = np.asarray([_plain_label(lab[ci]) for lab in labs])
            cols[cname] = np.repeat(vals[di], n_jobs)
    if n_jobs > 1:
        cols["job"] = np.tile(np.arange(n_jobs), n)
    for mname, m in flat_metrics.items():
        cols[mname] = (m.reshape(n * n_jobs) if m.ndim == 2
                       else np.repeat(m, n_jobs))
    return cols


def _match_label(label, want) -> bool:
    if label is want:
        return True
    if isinstance(label, enum.Enum) and isinstance(want, str):
        return label.name == want
    try:
        return bool(label == want)
    except (TypeError, ValueError):
        return False


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Labelled sweep output: axis coordinates + named metric arrays
    (host numpy, the plan's grid shape; per-job metrics gain a trailing
    job dim when a cell holds more than one job)."""
    axis_names: tuple[tuple[str, ...], ...]
    axis_labels: tuple[tuple[tuple[Any, ...], ...], ...]
    metrics: Mapping[str, np.ndarray]
    n_jobs: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(labs) for labs in self.axis_labels)

    @property
    def metric_names(self) -> tuple[str, ...]:
        return tuple(self.metrics)

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            return self.metrics[name]
        except KeyError:
            raise KeyError(f"no metric {name!r}; "
                           f"available: {list(self.metrics)}") from None

    def coord(self, index: Sequence[int]) -> dict[str, Any]:
        """Axis coordinates of one grid point."""
        out: dict[str, Any] = {}
        for d, (names, labs) in enumerate(zip(self.axis_names,
                                              self.axis_labels)):
            out.update(zip(names, labs[int(index[d])]))
        return out

    def select(self, **coords: Any) -> "SweepResult":
        """Slice by axis-coordinate labels; a coordinate matching one point
        drops its dimension, several keep a filtered dimension."""
        names = list(self.axis_names)
        labels = list(self.axis_labels)
        metrics = dict(self.metrics)
        by_dim: dict[int, dict[str, Any]] = {}
        for key, want in coords.items():
            for d, ns in enumerate(names):
                if key in ns:
                    by_dim.setdefault(d, {})[key] = want
                    break
            else:
                raise KeyError(
                    f"select: no axis {key!r}; axes: "
                    f"{[n for ns in names for n in ns]}")
        for d in sorted(by_dim, reverse=True):
            wants = by_dim[d]
            comp = {k: names[d].index(k) for k in wants}
            hits = [i for i, lab in enumerate(labels[d])
                    if all(_match_label(lab[comp[k]], w)
                           for k, w in wants.items())]
            if not hits:
                raise KeyError(
                    f"select: {wants} not on the axis "
                    f"{'×'.join(names[d])}; labels: {list(labels[d])}")
            if len(hits) == 1:
                metrics = {k: v.take(hits[0], axis=d)
                           for k, v in metrics.items()}
                del names[d], labels[d]
            else:
                metrics = {k: v.take(hits, axis=d) for k, v in metrics.items()}
                labels[d] = tuple(labels[d][i] for i in hits)
        return SweepResult(tuple(names), tuple(labels), metrics, self.n_jobs)

    def to_dict(self) -> dict[str, Any]:
        """Metrics as plain ``{name: ndarray}`` (0-d arrays as scalars)."""
        return {k: (v.item() if np.ndim(v) == 0 else np.asarray(v))
                for k, v in self.metrics.items()}

    def to_table(self) -> dict[str, np.ndarray]:
        """Columnar (long-form) export: one row per grid cell (times
        ``n_jobs``), axis coordinates first, metric columns after."""
        shape = self.shape
        N = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nj = self.n_jobs
        flat = {}
        for mname, m in self.metrics.items():
            arr = np.asarray(m)
            flat[mname] = (arr.reshape(N, nj)
                           if arr.ndim == len(shape) + 1
                           else arr.reshape(N))
        return _long_form_columns(self.axis_names, self.axis_labels, shape,
                                  flat, nj, 0, N)

    def to_parquet(self, path) -> None:
        """Write :meth:`to_table` to a parquet file with the run provenance
        (port and torch/CUDA versions, device, git sha) in the schema
        metadata.  Needs the optional ``pyarrow``."""
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError as e:
            raise ImportError(
                "SweepResult.to_parquet needs the optional pyarrow "
                "dependency; to_table() returns the same columns as plain "
                "numpy") from e
        table = pa.table(dict(self.to_table()))
        table = table.replace_schema_metadata(
            {**(table.schema.metadata or {}),
             **telemetry.parquet_metadata()})
        pq.write_table(table, path)

    def __repr__(self) -> str:
        ax = ", ".join(f"{'×'.join(ns)}[{len(labs)}]"
                       for ns, labs in zip(self.axis_names, self.axis_labels))
        return (f"SweepResult(axes=({ax}), n_jobs={self.n_jobs}, "
                f"metrics={list(self.metrics)})")
