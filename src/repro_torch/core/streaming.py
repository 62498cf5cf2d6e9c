"""Stream-computing layer (the paper's stated future work, §6).

Models a Storm-style topology: sources emit tuples at fixed rates into a
DAG of operators; each operator has a per-tuple service cost (MI) and
runs on a VM with bounded processing rate.  Fluid/queueing semantics:

* operator throughput = min(input rate, service rate),
* queue growth = input − throughput (unstable operators grow unbounded),
* end-to-end latency = queueing (steady-state, via utilization) +
  service along the critical path.

Written on a leading batch axis (:func:`analyze_batch`), so one call
sweeps operator placements and parallelism over thousands of topologies on
the card, answering the same provisioning questions §5 answers for
MapReduce.  Plain tensor ops in a Python loop over the operators, as the
JAX package's two ``fori_loop``s; every sum of products is an elementwise
product summed left to right (never a matmul, whose order and TF32 mode
are the library's), so the card and the CPU give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import _fold


class Topology(NamedTuple):
    """Feed-forward operator DAG, topologically ordered.

    adj[i, j] = fraction of operator i's output routed to operator j
    (row sums ≤ 1).  Sources have ``source_rate > 0`` tuples/s.  Every
    leaf is float32; :func:`analyze_batch` takes a leading batch axis on
    each.
    """
    adj: torch.Tensor            # f32[O, O]
    source_rate: torch.Tensor    # f32[O]
    service_mi: torch.Tensor     # f32[O] MI per tuple
    parallelism: torch.Tensor    # f32[O] replicas of the operator
    vm_mips: torch.Tensor        # f32[O] MIPS per replica


def analyze_batch(topo: Topology) -> dict:
    """Steady-state rates, utilizations, stability and latency of a batch
    of topologies (every leaf ``[B, ...]``), each as :func:`analyze`."""
    adj = topo.adj
    B, O = adj.shape[0], adj.shape[-1]
    f32 = dict(dtype=torch.float32, device=adj.device)
    floor = torch.tensor(1e-9, **f32)
    svc_rate = topo.parallelism * topo.vm_mips / torch.maximum(
        topo.service_mi, floor)                    # tuples/s capacity

    rates = torch.zeros(B, O, **f32)
    for i in range(O):
        inflow = topo.source_rate[:, i] + _fold(rates * adj[:, :, i])
        rates[:, i] = torch.minimum(inflow, svc_rate[:, i])
    inflow = torch.stack([topo.source_rate[:, i] + _fold(rates * adj[:, :, i])
                          for i in range(O)], dim=-1)
    cap = torch.maximum(svc_rate, floor)
    util = inflow / cap
    stable = util <= torch.tensor(1.0 + 1e-6, **f32)
    # M/M/1-style queueing delay per op (capped for near-saturated ops):
    # util / max(svc_rate (1 - util), 1e-9), with util's own division
    # folded into one, as XLA:CPU's simplifier rewrites the batched
    # reference ((a / b) / c -> a / (b c))
    one = torch.tensor(1.0, **f32)
    wait = torch.where(util < torch.tensor(0.999, **f32),
                       inflow / (cap * torch.maximum(svc_rate * (one - util),
                                                     floor)),
                       torch.tensor(float("inf"), **f32))
    service = topo.service_mi / topo.vm_mips
    # end-to-end latency: longest path in the DAG of (wait + service)
    node_cost = wait + service
    zero = torch.zeros((), **f32)
    dist = torch.zeros(B, O, **f32)
    for i in range(O):
        best = torch.where(adj[:, :, i] > 0, dist, zero).amax(dim=-1)
        dist[:, i] = best + node_cost[:, i]
    return {
        "throughput": rates,
        "utilization": util,
        "stable": stable.all(dim=-1),
        "latency_s": dist.amax(dim=-1),
        "bottleneck": torch.argmax(util, dim=-1),
    }


def analyze(topo: Topology) -> dict:
    """Steady-state rates, utilizations, stability and latency of one
    topology (a batch of one through :func:`analyze_batch`)."""
    out = analyze_batch(Topology(*(x[None] for x in topo)))
    return {k: v[0] for k, v in out.items()}


def smart_city_topology(*, cam_rate=2000.0, sensor_rate=5000.0,
                        parallelism=(1, 2, 2, 1, 1),
                        device="cuda") -> Topology:
    """5-op demo: [cam src, sensor src, detect, aggregate, alert]."""
    f32 = dict(dtype=torch.float32, device=device)
    adj = torch.zeros(5, 5, **f32)
    adj[0, 2] = 1.0       # cams -> detect
    adj[1, 3] = 1.0       # sensors -> aggregate
    adj[2, 3] = 0.2       # detections -> aggregate
    adj[3, 4] = 0.05      # aggregates -> alert
    return Topology(
        adj=adj,
        source_rate=torch.tensor([cam_rate, sensor_rate, 0, 0, 0], **f32),
        service_mi=torch.tensor([0.01, 0.005, 0.8, 0.1, 0.5], **f32),
        parallelism=torch.as_tensor(parallelism, **f32),
        vm_mips=torch.full((5,), 1000.0, **f32),
    )
