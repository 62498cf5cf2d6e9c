"""Cloud elasticity: VM lease windows, arrival processes, pay-as-you-go.

Every VM carries a lease window ``[lease_start, lease_stop)`` and the
scenario a ``spinup_delay``: a VM admits tasks only inside
``[lease_start + spinup_delay, lease_stop)`` (admission gating, never
preemption).  Arrival streams are seeded counter hashes drawn on the host;
billing rounds each VM's realized lease up to the billing granularity
(DESIGN.md §8).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from .storage import _C1, _C3, _INV24, _mix32

_BIG = 1e30     # the engine's +inf stand-in (survives f32 arithmetic)


@dataclass(frozen=True)
class ElasticitySpec:
    """Scenario-level elasticity knobs: the boot delay before a leased VM
    admits work, and the provider's billing unit in seconds."""
    spinup_delay: float = 0.0
    billing_granularity: float = 1.0


class ArrivalProcess(enum.IntEnum):
    """Inter-arrival process family (stable wire constants).

    POISSON — exponential gaps ``-ln(1 - u) / rate``.
    UNIFORM — gaps ``2 u / rate``.
    BURST   — ``burst`` arrivals land together, ``burst / rate`` apart.
    """
    POISSON = 0
    UNIFORM = 1
    BURST = 2


def as_arrival_process(v) -> ArrivalProcess:
    """Coerce a name (``"poisson"``/``"uniform"``/``"burst"``), int, or
    member."""
    if isinstance(v, str):
        try:
            return ArrivalProcess[v.upper()]
        except KeyError:
            raise ValueError(
                f"unknown arrival process {v!r}; known: "
                f"{[p.name.lower() for p in ArrivalProcess]}") from None
    return ArrivalProcess(v)


def arrival_times(n: int, *, rate: float, process=ArrivalProcess.POISSON,
                  seed: int = 0, burst: int = 4) -> np.ndarray:
    """``n`` absolute arrival instants (f32, ascending, first gap counts).

    Draw ``k`` hashes ``(seed, k)`` through the lowbias32 avalanche; gaps
    are summed in float64 and cast once to float32 (host numpy).
    """
    if n < 1:
        raise ValueError(f"arrival_times: need n >= 1, got {n}")
    if not rate > 0.0:
        raise ValueError(f"arrival_times: rate must be > 0, got {rate}")
    process = as_arrival_process(process)
    k = np.arange(n, dtype=np.uint32)
    seed_mix = np.uint32((int(seed) % (1 << 32)) * int(_C3) % (1 << 32))
    h = _mix32(k * _C1 + seed_mix)
    u = (h >> np.uint32(8)).astype(np.float64) * float(_INV24)  # [0, 1)
    if process == ArrivalProcess.POISSON:
        gaps = -np.log1p(-u) / rate
    elif process == ArrivalProcess.UNIFORM:
        gaps = 2.0 * u / rate
    else:                                   # BURST
        if burst < 1:
            raise ValueError(f"arrival_times: burst must be >= 1, "
                             f"got {burst}")
        gaps = np.where(k % np.uint32(burst) == 0, burst / rate, 0.0)
    return np.cumsum(gaps).astype(np.float32)


def billed_lease(vm_start, vm_stop, busy_end, finish_time, granularity):
    """Per-VM billed seconds (float32 tensors, broadcasting).

    The realized lease runs from ``vm_start`` to ``finish_time`` when the
    lease is open-ended (``vm_stop`` at the +inf stand-in), else to
    ``max(vm_stop, busy_end)``; it is clamped at 0 and rounded up to
    ``granularity``.
    """
    end = torch.where(vm_stop >= _BIG / 2, finish_time,
                      torch.maximum(vm_stop, busy_end))
    dur = torch.clamp(end - vm_start, min=0.0)
    g = torch.clamp(granularity, min=1e-9)
    return torch.ceil(dur / g) * g


def encode_lease_stop(stop) -> float:
    """User-facing ``math.inf`` lease stops, clamped to the +inf
    stand-in (``inf`` would turn ``0 * inf`` into NaN downstream)."""
    return float(min(stop, _BIG)) if stop is not None else _BIG


def scenario_windows(scenario):
    """``(avail, close)`` per VM (float64 numpy) for the sequential oracle:
    admission opens at ``lease_start + spinup_delay`` and closes at
    ``lease_stop``.  The array encoders carry the same quantities as
    ``vm_start``/``vm_stop``/``spinup_delay`` in float32."""
    el = scenario.elasticity
    avail = np.array([v.lease_start + el.spinup_delay
                      for v in scenario.vms])
    close = np.array([encode_lease_stop(v.lease_stop)
                      for v in scenario.vms])
    return avail, close
