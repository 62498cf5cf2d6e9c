"""Network + storage delay model (paper §4.2.3, §5.3.5, §5.3.7).

The kappa formula for stage-in and shuffle delays, shared by host floats
and torch tensors (DESIGN.md §2.1 explains the calibration:
``kappa_in + kappa_shuffle = 21.25`` reproduces the paper's Table IV), and
the paper's Delay Time and Network Cost of a job.
"""
from __future__ import annotations

from .config import JobSpec, NetworkSpec


def transfer_delay(kappa, data_mb, n_maps, bw_mbps, enabled=1.0):
    """``delay = enabled * kappa * S / ((M + 1) * BW)``.

    Pure arithmetic on its operands, so Python floats and float32 tensors
    run the same op sequence (each op rounds to float32 on tensors).  When
    ``enabled`` is 0 the result is exactly 0.0 even if ``bw_mbps`` is 0:
    the denominator is padded by ``1 - enabled``.
    """
    return (enabled * kappa * data_mb
            / ((n_maps + 1.0) * (bw_mbps + (1.0 - enabled))))


def stage_in_delay(job: JobSpec, net: NetworkSpec) -> float:
    """Delay between job submission and its map tasks becoming ready."""
    return transfer_delay(net.kappa_in, job.data_mb, job.n_maps,
                          net.bw_mbps, 1.0 if net.enabled else 0.0)


def shuffle_delay(job: JobSpec, net: NetworkSpec) -> float:
    """Delay between the last map finishing and reduces becoming ready."""
    return transfer_delay(net.kappa_shuffle, job.data_mb, job.n_maps,
                          net.bw_mbps, 1.0 if net.enabled else 0.0)


def delay_time(job: JobSpec, net: NetworkSpec) -> float:
    """Paper §5.3.5 Delay Time (st_m(nm) + st_r(nr) - ft_m(nm))."""
    return stage_in_delay(job, net) + shuffle_delay(job, net)


def network_cost(job: JobSpec, net: NetworkSpec) -> float:
    """Paper §5.3.7: NetworkCost = DelayTime x NetworkCostPerUnit."""
    return delay_time(job, net) * net.cost_per_unit
