"""Execution-cost model for the adaptive schedule (DESIGN.md §9).

``_bucket_groups`` splits a grid into shape buckets when the lane-epoch
work a split saves (``split_gain_us``) buys back the extra dispatch it
costs (``dispatch_us``).  This port carries the JAX package's fallback
coefficients only: bucket splits never change a metric, only
``realized_epochs`` and speed.  Measuring the coefficients on the card
with CUDA events, and persisting them, is ROADMAP slice A4.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the JAX package's conservative fallback coefficients
_FALLBACK_DISPATCH_US = 1500.0
_FALLBACK_EPOCH_LANE_US = 0.030


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cost coefficients + the scoring rules built on them."""
    dispatch_us: float       # fixed overhead of one bucket dispatch
    epoch_lane_us: float     # us per (lane x epoch x task-slot)

    @staticmethod
    def est_epochs(pad_t) -> np.ndarray:
        """Expected realized epochs for lanes padded to ``pad_t`` tasks:
        ``t + 2``, half the ``2t + 2`` bound."""
        return np.asarray(pad_t, np.float64) + 2.0

    def cell_cost_us(self, pad_t) -> np.ndarray:
        """Marginal simulation cost of one lane padded to ``pad_t``."""
        t = np.asarray(pad_t, np.float64)
        return self.epoch_lane_us * t * self.est_epochs(t)

    def split_gain_us(self, n_cells, pad_t, cap_t) -> float:
        """Saving from running ``n_cells`` lanes at ``pad_t`` instead of
        merged up into a ``cap_t``-padded bucket; a split pays iff this
        exceeds ``dispatch_us``."""
        return float(np.asarray(n_cells, np.float64)
                     * (self.cell_cost_us(cap_t) - self.cell_cost_us(pad_t)))


def fallback_cost_model() -> CostModel:
    return CostModel(dispatch_us=_FALLBACK_DISPATCH_US,
                     epoch_lane_us=_FALLBACK_EPOCH_LANE_US)


def device_key(device=None) -> str:
    """``cuda:<card name>`` for a CUDA device (default: the current card
    when there is one), else ``cpu``."""
    import torch
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type
