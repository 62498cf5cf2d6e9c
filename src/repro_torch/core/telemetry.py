"""Trace & telemetry: what the open-loop path reads of it.  The in-loop
recorder, ``TraceResult`` and ``RunReport`` are ROADMAP slice A6."""
from __future__ import annotations

import dataclasses

# Per-epoch time-series row layout (one f32 row per realized epoch).
TS_COLUMNS = ("time", "queue_depth", "busy_fraction", "open_vms",
              "active", "failures", "sheds", "preemptions")


def timeseries_capacity(n_tasks: int, n_vms: int, control: bool) -> int:
    """Rows the per-epoch time series needs — the per-lane epoch bound:
    ``2T + 2`` open-loop, ``7T + V + 3`` under control."""
    t, v = int(n_tasks), int(n_vms)
    return 7 * t + v + 3 if control else 2 * t + 2


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Trace-capacity overrides (``None`` → the derived worst case)."""
    events: int | None = None
