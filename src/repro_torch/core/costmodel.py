"""Measured execution-cost model for the adaptive schedule (DESIGN.md §9).

Two decisions of the sweep trade the same measured quantities against each
other: whether a run of cells gets a bucket of its own (``_bucket_groups``)
and how many epochs compacted stepping runs between active-lane checks
(:meth:`CostModel.compact_interval`).

* ``dispatch_us`` — the fixed cost of one bucket dispatch of the port's
  pipeline: derived inputs, ``initial_state``, one ``mr_epoch`` call, the
  ``SimOutput`` and the metrics.  Paying it once more is the cost of a
  split, and of a compaction round's chunk launch.
* ``epoch_lane_us`` — the marginal cost of advancing one lane one event
  epoch per task slot.  Saving lane-epochs is the benefit of a
  smaller-padded bucket and of a compacted batch.
* ``sync_us`` — one blocking pull of a ready device scalar: what each
  compaction round pays for its still-active count.

They are measured once per device (:func:`measure`, the minimum over a few
repetitions: they feed scheduling decisions, so the noise floor is the
statistic) and kept in a small JSON cache keyed by :func:`device_key`, so
later processes skip the measurement.  A pinned calibration makes every
scoring decision deterministic.  Bucket splits and the compaction interval
change ``realized_epochs`` and speed, never a metric.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time

import numpy as np

ENV_PATH = "REPRO_TORCH_COSTMODEL_PATH"
_DEFAULT_PATH = pathlib.Path.home() / ".cache" / "repro-iotsim-torch" / \
    "costmodel.json"

# Schema of the cache file, ``{"schema": N, "models": {device: {...}}}``.
# A file with another (or no) schema is stale: loading it raises and
# saving over it drops its entries.  v2 (the JAX package's numbering)
# carries ``sync_us``.
SCHEMA_VERSION = 2

# the JAX package's conservative coefficients, used when measurement is
# off or fails
_FALLBACK_DISPATCH_US = 1500.0
_FALLBACK_EPOCH_LANE_US = 0.030
_FALLBACK_SYNC_US = 250.0

# clamp of the auto compaction interval: 1 checks every epoch; 64 caps the
# wasted tail of a degenerate calibration
COMPACT_INTERVAL_MIN = 1
COMPACT_INTERVAL_MAX = 64

_CACHE: dict[str, "CostModel"] = {}


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cost coefficients + the scoring rules built on them."""
    dispatch_us: float       # fixed overhead of one bucket dispatch
    epoch_lane_us: float     # us per (lane x epoch x task-slot)
    sync_us: float = _FALLBACK_SYNC_US   # one blocking scalar pull
    device: str = "unknown"
    # "measured", "cache", "fallback" or "static" (built by hand); not a
    # coefficient, so a save/load round trip stays ``==``
    source: str = dataclasses.field(default="static", compare=False)

    @staticmethod
    def est_epochs(pad_t) -> np.ndarray:
        """Expected realized epochs for lanes padded to ``pad_t`` tasks:
        ``t + 2``, half the ``2t + 2`` bound."""
        return np.asarray(pad_t, np.float64) + 2.0

    def cell_cost_us(self, pad_t) -> np.ndarray:
        """Marginal simulation cost of one lane padded to ``pad_t``."""
        t = np.asarray(pad_t, np.float64)
        return self.epoch_lane_us * t * self.est_epochs(t)

    def bucket_cost_us(self, n_cells, pad_t) -> float:
        """Modelled cost of running ``n_cells`` lanes as one bucket."""
        return float(self.dispatch_us
                     + np.asarray(n_cells, np.float64)
                     * self.cell_cost_us(pad_t))

    def split_gain_us(self, n_cells, pad_t, cap_t) -> float:
        """Saving from running ``n_cells`` lanes at ``pad_t`` instead of
        merged up into a ``cap_t``-padded bucket; a split pays iff this
        exceeds ``dispatch_us``."""
        return float(np.asarray(n_cells, np.float64)
                     * (self.cell_cost_us(cap_t) - self.cell_cost_us(pad_t)))

    def compact_interval(self, n_lanes: int, pad_t: int) -> int:
        """Auto compaction interval K (epochs between active-lane checks).

        A round costs ``sync_us + dispatch_us``, paid ``1/K`` per epoch.
        Checking late wastes work on lanes that finish mid-chunk: on a
        tail-heavy grid about ``n / (2t + 2)`` lanes finish per epoch,
        each stepping ``K/2`` epochs of ``t`` slots too many.  Balancing
        the two gives the root below, clamped to
        [:data:`COMPACT_INTERVAL_MIN`, :data:`COMPACT_INTERVAL_MAX`]."""
        retire_rate = max(n_lanes, 1) / (2.0 * max(pad_t, 1) + 2.0)
        per_epoch = max(self.epoch_lane_us * max(pad_t, 1) * retire_rate,
                        1e-9)
        k = np.sqrt(2.0 * (self.sync_us + self.dispatch_us) / per_epoch)
        return int(np.clip(round(k), COMPACT_INTERVAL_MIN,
                           COMPACT_INTERVAL_MAX))

    def to_json(self) -> dict:
        return {"dispatch_us": self.dispatch_us,
                "epoch_lane_us": self.epoch_lane_us,
                "sync_us": self.sync_us}


def fallback_cost_model(device: str = "fallback") -> CostModel:
    return CostModel(dispatch_us=_FALLBACK_DISPATCH_US,
                     epoch_lane_us=_FALLBACK_EPOCH_LANE_US,
                     sync_us=_FALLBACK_SYNC_US, device=device,
                     source="fallback")


def _device(device=None):
    import torch
    return torch.device(device if device is not None else
                        ("cuda" if torch.cuda.is_available() else "cpu"))


def device_key(device=None) -> str:
    """``cuda:<card name>`` for a CUDA device (default: the current card
    when there is one), else ``cpu``."""
    import torch
    dev = _device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


# ---------------------------------------------------------------------------
# Measurement (once per device, persisted)
# ---------------------------------------------------------------------------

def _probe_batch(n: int, n_maps: int, device):
    """``n`` copies of one encoded scenario: a space-shared single-PE VM
    running ``n_maps`` maps and one reduce, one task at a time, so a lane
    takes about one epoch per task (``n_maps + 2``)."""
    from . import engine
    from .config import JOB_SMALL, VM_SMALL, Scenario, SchedPolicy
    sc = Scenario(vms=(VM_SMALL,),
                  jobs=(dataclasses.replace(JOB_SMALL, n_maps=n_maps),),
                  sched_policy=SchedPolicy.SPACE_SHARED)
    enc = engine.from_scenario(sc)
    return engine.scenario_arrays_from_numpy(
        {k: np.broadcast_to(np.asarray(v)[None],
                            (n,) + np.shape(v)).copy()
         for k, v in enc.items()}, device=device)


# the large probe of :func:`measure`: (lanes, maps per lane, k_lo, k_hi)
PROBE_CPU = (64, 47, 4, 44)
PROBE_CUDA = (16384, 47, 4, 44)


def measure(reps: int = 10, device="cuda") -> CostModel:
    """Time the three coefficients on ``device`` (the card unless the
    caller passes ``"cpu"``), each from minima over ``reps``.

    Each timing is the wall time of the port's per-bucket pipeline — the
    derived inputs, ``initial_state``, ``mr_epoch`` with ``epoch_limit=k``
    (the kernel on the card, its plain version on the CPU), the
    ``SimOutput``, ``job_metrics`` and ``scenario_metrics`` — with the
    device synchronised before and after; the two ``k`` of a pair run in
    turns, so drift cancels.  The intercept of a small batch (8 lanes,
    T = 8, k = 1 and 9) gives ``dispatch_us``; the slope of a larger one
    (T = 48, k = 4 and 44) over its lane-epoch slots gives
    ``epoch_lane_us``.

    The kernel stops each lane at its own end, so a lane that finished
    before ``k`` epochs would add nothing to the slope.  The probe lanes
    therefore run their tasks one at a time (space-shared, one PE, one
    epoch per task, ``n_maps + 3`` epochs): the small lanes take 10
    epochs, above k = 9, the large ones 50, above k = 44.  The CPU steps
    64 large lanes.  The card steps lanes in parallel, so a few lanes
    would time one lane's latency, not the cost of a bucket: it steps
    16,384, a real bucket's size, and the slope is the cost per
    lane-epoch slot at that throughput.  On the card the kernel also runs
    while the host still queues the metrics, so the slope pair
    synchronises after the kernel (else its time hides behind the
    host's).  ``sync_us`` is the blocking pull of one ready device
    scalar.  Coefficients keep four significant digits."""
    import torch

    from . import engine
    from ..kernels.mr_sched import megakernel, ops

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def pipeline(batch, k, kernel_sync=False):
        task_vm2, _ = ops.control_derived(batch)
        lanes = ops.kernel_inputs(batch)
        state = megakernel.initial_state(lanes[0], lanes[2], lanes[3],
                                         lanes[4], lanes[9], lanes[10])
        st = megakernel.mr_epoch(*lanes, state=state,
                                 max_pes=ops.batch_max_pes(batch),
                                 epoch_limit=k)
        if kernel_sync:
            sync()
        out = engine._sim_output(batch, st[3], st[4], st[5], st[7][:, 0],
                                 task_vm2)
        return engine.job_metrics(batch, out), \
            engine.scenario_metrics(batch, out)

    def timed(batch, k, kernel_sync):
        sync()
        t0 = time.perf_counter()
        pipeline(batch, k, kernel_sync)
        sync()
        return time.perf_counter() - t0

    def pair_us(batch, k_lo, k_hi, kernel_sync=False):
        for k in (k_lo, k_hi):                   # binds (or builds) it
            timed(batch, k, kernel_sync)
        lo = hi = float("inf")
        for _ in range(reps):
            lo = min(lo, timed(batch, k_lo, kernel_sync))
            hi = min(hi, timed(batch, k_hi, kernel_sync))
        return lo * 1e6, hi * 1e6

    def sync_floor_us():
        best = float("inf")
        for r in range(max(reps, 3) * 3):
            s = torch.arange(256, dtype=torch.int32, device=dev).sum() + r
            sync()
            t0 = time.perf_counter()
            int(s)
            best = min(best, time.perf_counter() - t0)
        return best * 1e6

    def sig(x):
        return float(f"{x:.4g}")

    n_big, big_maps, k_lo, k_hi = PROBE_CUDA if cuda else PROBE_CPU
    t_small_1, t_small_9 = pair_us(_probe_batch(8, 7, dev), 1, 9)
    t_lo, t_hi = pair_us(_probe_batch(n_big, big_maps, dev), k_lo, k_hi,
                         kernel_sync=True)
    slope_small = max((t_small_9 - t_small_1) / 8.0, 0.0)
    dispatch = max(t_small_1 - slope_small, 1.0)
    epoch_lane = max((t_hi - t_lo) / (k_hi - k_lo), 1e-6) \
        / (n_big * (big_maps + 1))
    return CostModel(dispatch_us=sig(dispatch),
                     epoch_lane_us=sig(epoch_lane),
                     sync_us=sig(max(sync_floor_us(), 0.01)),
                     device=device_key(dev), source="measured")


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def _parse_cache(data) -> dict:
    """The device → coefficients mapping of a cache file's contents;
    ``ValueError`` on a stale or foreign format."""
    found = data.get("schema") if isinstance(data, dict) else data
    if not isinstance(data, dict) or found != SCHEMA_VERSION:
        raise ValueError(
            f"costmodel cache: stale or unknown schema (found {found!r}, "
            f"expected {SCHEMA_VERSION}) — cache will be re-measured")
    models = data.get("models")
    if not isinstance(models, dict):
        raise ValueError("costmodel cache: missing 'models' mapping")
    return models


def load_cost_model(path, device: str | None = None) -> CostModel:
    """One device's calibration from a JSON cache file.  With
    ``device=None`` a single-entry file gives its one entry.  A stale
    schema raises ``ValueError``, a missing device ``KeyError``."""
    models = _parse_cache(json.loads(pathlib.Path(path).read_text()))
    if device is None:
        if len(models) != 1:
            raise ValueError(
                f"load_cost_model: {path} holds calibrations for "
                f"{sorted(models)}; pass device= to pick one")
        device = next(iter(models))
    if device not in models:
        raise KeyError(
            f"load_cost_model: no calibration for device {device!r} in "
            f"{path} (have {sorted(models)})")
    entry = models[device]
    return CostModel(dispatch_us=float(entry["dispatch_us"]),
                     epoch_lane_us=float(entry["epoch_lane_us"]),
                     sync_us=float(entry["sync_us"]),
                     device=device, source="cache")


def save_cost_model(model: CostModel, path) -> None:
    """Merge one device's calibration into the cache file under the
    current :data:`SCHEMA_VERSION`; entries of an unreadable or stale file
    are dropped."""
    path = pathlib.Path(path)
    models = {}
    if path.exists():
        try:
            models = _parse_cache(json.loads(path.read_text()))
        except (OSError, ValueError):
            models = {}
    models[model.device] = model.to_json()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schema": SCHEMA_VERSION, "models": models},
                               indent=2) + "\n")


def default_cost_model(path=None, *, allow_measure: bool = True,
                       device=None) -> CostModel:
    """The process-wide cost model of ``device`` (default: the card when
    there is one, else the CPU): cached in memory, then in the JSON file
    at ``path`` (default ``$REPRO_TORCH_COSTMODEL_PATH`` or
    ``~/.cache/repro-iotsim-torch/costmodel.json``), then measured and
    saved.  Never raises: a failed measurement gives the fallback
    coefficients (``source="fallback"``)."""
    dev = _device(device)
    key = device_key(dev)
    if key in _CACHE:
        return _CACHE[key]
    path = pathlib.Path(path or os.environ.get(ENV_PATH, _DEFAULT_PATH))
    model = None
    if path.exists():
        try:
            model = load_cost_model(path, device=key)
        except (OSError, ValueError, KeyError):
            model = None
    if model is None and allow_measure:
        try:
            model = measure(device=dev)
        except Exception:
            model = None
        if model is not None:
            try:
                save_cost_model(model, path)
            except OSError:
                pass
    if model is None:
        model = fallback_cost_model(key)
    _CACHE[key] = model
    return model
