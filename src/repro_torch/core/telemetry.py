"""Trace & telemetry layer (the JAX package's DESIGN.md §12).

Three surfaces, all opt-in (the untraced path runs kernels that carry no
trace code):

* **In-loop trace recorder** — under ``trace=True`` the ``mr_epoch`` kernel
  carries, per lane, a fixed-capacity time series (one row per realized
  epoch: clock, queue depth, busy fraction, open VM count, activity,
  failures/sheds/preemptions this epoch) and a bounded event log of
  ``(t, kind, task, vm)`` rows in a canonical per-epoch order.  Capacities
  follow the per-lane epoch bounds, and :attr:`TraceBuffers.dropped_events`
  counts the rows an undersized log could not hold.

* **Export** — :class:`TraceResult` turns the buffers into a long-form
  per-epoch table (``to_table``/``to_parquet``) and a Chrome/Perfetto
  trace-event JSON (``to_chrome_trace``: per-VM tracks of task spans,
  instant events for kill/redispatch/shed/preempt/scale).

* **Sweep-runtime telemetry** — :class:`RunReport`
  (``SweepPlan.run(report=True)``): one :class:`BucketReport` per
  dispatched bucket with its kernel launches and wall time, the cost-model
  coefficients, the device and the run-provenance stamp every exported
  artifact carries.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import subprocess
from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# Event kinds
# ---------------------------------------------------------------------------

EV_START = 0        # a task takes a PE and begins (or resumes) executing
EV_FINISH = 1       # a task completes
EV_KILL = 2         # a VM failure kills an unfinished bound task
EV_PREEMPT = 3      # priority preemption evicts a running task
EV_SHED = 4         # deadline admission control refuses a task
EV_SCALE_OPEN = 5   # the autoscale hook opens a reserve lease
EV_SCALE_CLOSE = 6  # the autoscale hook closes a drained reserve

EVENT_NAMES = {
    EV_START: "start",
    EV_FINISH: "finish",
    EV_KILL: "kill",
    EV_PREEMPT: "preempt",
    EV_SHED: "shed",
    EV_SCALE_OPEN: "scale_open",
    EV_SCALE_CLOSE: "scale_close",
}

# Per-epoch time-series row layout (one f32 row per realized epoch).
TS_COLUMNS = ("time", "queue_depth", "busy_fraction", "open_vms",
              "active", "failures", "sheds", "preemptions")
N_TS_COLS = len(TS_COLUMNS)


# ---------------------------------------------------------------------------
# Capacity math
# ---------------------------------------------------------------------------

def timeseries_capacity(n_tasks: int, n_vms: int, control: bool) -> int:
    """Rows the per-epoch time series needs — the per-lane epoch bound:
    ``2T + 2`` open-loop, ``7T + V + 3`` under control, so no row is ever
    dropped."""
    t, v = int(n_tasks), int(n_vms)
    return 7 * t + v + 3 if control else 2 * t + 2


def event_capacity(n_tasks: int, n_vms: int, control: bool) -> int:
    """Default event-log capacity: the per-lane worst-case event count.

    Open loop a task starts once and finishes once.  Under control a task
    is killed at most twice (one failure per binding slot), preempted at
    most twice (``n_evict < 2``), so it starts at most five times, finishes
    once and sheds once — 11 rows per task — and each VM opens and closes
    at most once — 2 rows per VM.
    """
    t, v = int(n_tasks), int(n_vms)
    return 11 * t + 2 * v if control else 2 * t


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Trace-capacity overrides (``None`` → the derived worst case).

    ``events`` admits undersized buffers: overflow drops the newest rows
    and counts them in ``dropped_events``; earlier rows are never touched.
    """
    events: int | None = None


# ---------------------------------------------------------------------------
# Result buffers
# ---------------------------------------------------------------------------

class TraceBuffers(NamedTuple):
    """Raw trace arrays as the drivers return them (tensors or numpy).

    Lane-stacked: ``ts [N, C, 8]``, ``ev_* [N, E]``, ``ev_n [N]`` (a single
    lane drops the leading axis).  ``ev_n`` counts every event *attempted*,
    so ``dropped_events = max(0, ev_n - E)`` is exact.
    """
    ts: object          # f32 per-epoch time series, TS_COLUMNS layout
    ev_t: object        # f32 event timestamps
    ev_kind: object     # i32 event kinds (-1 = empty slot)
    ev_task: object     # i32 task id (-1 for scale events)
    ev_vm: object       # i32 VM id
    ev_n: object        # i32 events attempted (write cursor)

    @property
    def dropped_events(self):
        cap = np.shape(self.ev_t)[-1]
        return np.maximum(_host(self.ev_n) - cap, 0)


def _host(x) -> np.ndarray:
    """A tensor or array as host numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(buffers: TraceBuffers) -> TraceBuffers:
    """The buffers copied to host numpy."""
    return TraceBuffers(*(_host(x) for x in buffers))


# ---------------------------------------------------------------------------
# Host-side result wrapper + exports
# ---------------------------------------------------------------------------

class TraceResult:
    """Host-side view over :class:`TraceBuffers` with export surfaces."""

    def __init__(self, buffers: TraceBuffers, label: str = "trace"):
        ts = _host(buffers.ts).astype(np.float32, copy=False)
        if ts.ndim == 2:                       # single lane -> batch of one
            ts = ts[None]
            ev = [_host(x)[None] for x in buffers[1:5]]
            ev_n = _host(buffers.ev_n).reshape(1)
        else:
            ev = [_host(x) for x in buffers[1:5]]
            ev_n = _host(buffers.ev_n).reshape(-1)
        self.ts = ts
        self.ev_t, self.ev_kind, self.ev_task, self.ev_vm = ev
        self.ev_n = ev_n
        self.label = label

    @property
    def n_lanes(self) -> int:
        return self.ts.shape[0]

    @property
    def event_capacity(self) -> int:
        return self.ev_t.shape[-1]

    @property
    def dropped_events(self) -> np.ndarray:
        """Per-lane count of events that overflowed the log (0 = none)."""
        return np.maximum(self.ev_n - self.event_capacity, 0)

    # ---- tabular exports -------------------------------------------------

    def to_table(self) -> dict[str, np.ndarray]:
        """Long-form per-epoch time series: one row per realized epoch."""
        lane_idx, epoch_idx = np.nonzero(self.ts[:, :, 4] > 0.0)
        rows = self.ts[lane_idx, epoch_idx]
        out = {"lane": lane_idx.astype(np.int32),
               "epoch": epoch_idx.astype(np.int32)}
        for ci, name in enumerate(TS_COLUMNS):
            out[name] = rows[:, ci]
        return out

    def to_parquet(self, path) -> None:
        """Write :meth:`to_table` to parquet with the provenance stamp in
        the schema metadata (needs the optional ``pyarrow``)."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        table = pa.table(self.to_table())
        table = table.replace_schema_metadata(
            {**(table.schema.metadata or {}), **parquet_metadata()})
        pq.write_table(table, path)

    def events(self) -> dict[str, np.ndarray]:
        """Event-log rows as columns, empty slots stripped."""
        lane_idx, slot = np.nonzero(self.ev_kind >= 0)
        return {"lane": lane_idx.astype(np.int32),
                "t": self.ev_t[lane_idx, slot],
                "kind": self.ev_kind[lane_idx, slot],
                "task": self.ev_task[lane_idx, slot],
                "vm": self.ev_vm[lane_idx, slot]}

    def counts_by_kind(self, lane: int | None = None) -> dict[str, int]:
        kinds = self.ev_kind if lane is None else self.ev_kind[lane]
        return {name: int(np.sum(kinds == k))
                for k, name in EVENT_NAMES.items()}

    # ---- Chrome / Perfetto export ---------------------------------------

    def to_chrome_trace(self, path=None) -> dict:
        """Chrome trace-event JSON: per-VM tracks of task spans plus
        instant events for kill/redispatch/shed/preempt/scale.

        One complete-event span (``ph: "X"``) per realized task execution
        — a START paired with the FINISH/KILL/PREEMPT that ends it (a
        still-running START at trace end closes at the last event time,
        flagged ``outcome: "unterminated"``).  ``pid`` is the lane,
        ``tid`` the VM track; timestamps are sim-seconds scaled to µs.
        """
        events: list[dict] = []
        us = 1e6
        for lane in range(self.n_lanes):
            valid = self.ev_kind[lane] >= 0
            t_all = self.ev_t[lane][valid]
            k_all = self.ev_kind[lane][valid]
            task_all = self.ev_task[lane][valid]
            vm_all = self.ev_vm[lane][valid]
            open_spans: dict[int, tuple[float, int]] = {}
            interrupted: set[int] = set()
            tracks: set[int] = set()
            last_t = float(t_all[-1]) if t_all.size else 0.0

            def span(task, t0, vm, t1, outcome):
                events.append({
                    "name": f"task {task}", "cat": "task", "ph": "X",
                    "pid": lane, "tid": int(vm),
                    "ts": t0 * us, "dur": max(t1 - t0, 0.0) * us,
                    "args": {"task": int(task), "outcome": outcome}})

            def instant(name, t, vm, task):
                events.append({
                    "name": name, "cat": "event", "ph": "i", "s": "t",
                    "pid": lane, "tid": int(vm), "ts": float(t) * us,
                    "args": {"task": int(task)}})

            for t, k, task, vm in zip(t_all, k_all, task_all, vm_all):
                t, k, task, vm = float(t), int(k), int(task), int(vm)
                tracks.add(vm)
                if k == EV_START:
                    open_spans[task] = (t, vm)
                    if task in interrupted:
                        instant("redispatch", t, vm, task)
                elif k in (EV_FINISH, EV_KILL, EV_PREEMPT):
                    if task in open_spans:
                        t0, vm0 = open_spans.pop(task)
                        span(task, t0, vm0, t,
                             EVENT_NAMES[k] if k != EV_FINISH else "ok")
                    if k == EV_KILL:
                        interrupted.add(task)
                        instant("kill", t, vm, task)
                    elif k == EV_PREEMPT:
                        interrupted.add(task)
                        instant("preempt", t, vm, task)
                elif k == EV_SHED:
                    instant("shed", t, vm, task)
                elif k in (EV_SCALE_OPEN, EV_SCALE_CLOSE):
                    instant(EVENT_NAMES[k], t, vm, task)
            for task, (t0, vm0) in sorted(open_spans.items()):
                span(task, t0, vm0, last_t, "unterminated")
            events.append({"name": "process_name", "ph": "M", "pid": lane,
                           "args": {"name": f"lane {lane}"}})
            for vm in sorted(tracks):
                events.append({"name": "thread_name", "ph": "M",
                               "pid": lane, "tid": int(vm),
                               "args": {"name": f"vm {vm}"}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {**provenance(), "label": self.label,
                             "dropped_events":
                                 int(self.dropped_events.sum())}}
        if path is not None:
            pathlib.Path(path).write_text(json.dumps(doc))
        return doc


# ---------------------------------------------------------------------------
# Run provenance
# ---------------------------------------------------------------------------

def _git_sha() -> str | None:
    try:
        root = pathlib.Path(__file__).resolve().parents[3]
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def provenance() -> dict:
    """Run-provenance stamp: embedded in parquet metadata, Chrome traces
    and RunReports so exported artifacts are self-describing."""
    import torch

    import repro_torch
    cuda = torch.cuda.is_available()
    return {
        "repro_torch_version": getattr(repro_torch, "__version__", "0"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "git_sha": _git_sha(),
    }


def parquet_metadata() -> dict[bytes, bytes]:
    """Provenance as parquet schema metadata (bytes->bytes)."""
    return {b"repro_provenance": json.dumps(provenance()).encode()}


# ---------------------------------------------------------------------------
# Sweep-runtime telemetry (SweepPlan.run(report=True))
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BucketReport:
    """One shape/static bucket the sweep coalescer dispatched."""
    cells: int                       # grid cells routed to this bucket
    pad_tasks: int                   # padded task-axis shape
    pad_vms: int                     # padded VM-axis shape
    backend: str                     # "cuda" | "torch"
    control: bool                    # closed-loop lowering active
    statics: dict                    # static params pinned for the bucket
    split_gain_us: float | None      # cost-model gain that justified the
    #                                  split (None: base shape bucket)
    dispatches: int = 0              # mr_epoch kernel launches
    compact_syncs: int = 0           # active-first order pulls (one per
    #                                  compaction)
    compact_scalar_syncs: int = 0    # still-active count pulls (one per
    #                                  round, plus one per compacted run)
    compactions: int = 0             # working-set gathers
    compact_rounds: int = 0          # chunk steps of the compacted loop
    wall_s: float = 0.0              # wall time executing this bucket


@dataclasses.dataclass
class RunReport:
    """Sweep-runtime telemetry returned by ``SweepPlan.run(report=True)``."""
    n_cells: int
    n_buckets: int
    backend: str
    compact: object                  # the run's compact request (None:
    #                                  dense; "auto" or the pinned K)
    buckets: list[BucketReport]
    compile_cache_hits: int          # kernel libraries already loaded when
    #                                  the run asked for them
    compile_cache_misses: int        # kernel libraries loaded (or built
    #                                  with nvcc) during the run
    encoder_cache_hits: int          # always 0: grid_arrays has no cache
    encoder_cache_misses: int        # always 0 (as above)
    compaction_syncs: int            # order pulls over every bucket
    scalar_syncs: int                # still-active count pulls
    dispatches: int                  # total mr_epoch kernel launches
    cost_model: dict                 # the three coefficients, device and
    #                                  source
    device: str
    provenance: dict
    wall_s: float

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent,
                          default=str)


# ---------------------------------------------------------------------------
# Convenience: trace one scenario end to end
# ---------------------------------------------------------------------------

def trace_scenario(scenario, spec: TraceSpec | None = None,
                   label: str = "trace", device="cuda"):
    """Run one :class:`~repro_torch.core.config.Scenario` with tracing
    on, as a batch of one; returns ``(SimOutput, TraceResult)``.  A
    single-job scenario steps through the ``mr_epoch`` kernel's trace
    build, a multi-job one through the engine body's trace lowering."""
    from . import engine
    enc = engine.from_scenario(scenario)
    batch = engine.scenario_arrays_from_numpy(
        {k: np.asarray(v)[None] for k, v in enc.items()}, device=device)
    out, _, buffers = engine.simulate_batch_arrays(
        batch, trace=True,
        trace_events=None if spec is None else spec.events)
    return out, TraceResult(to_numpy(buffers), label=label)
