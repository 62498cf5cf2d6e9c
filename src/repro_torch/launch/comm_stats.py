"""Collective inventory + byte counts of a dry-run cell.

The counterpart of the JAX package's ``launch/hlo_stats.py``.  The port
has no HLO: a cell runs eagerly on ``DTensor``s, and every collective its
redistributions issue is a functional collective op
(``torch.ops._c10d_functional.*``) on local shards, which the dry run's
dispatch mode sees.  :func:`record` turns one such op into a
:class:`Record` (kind under the HLO name, local operand and result bytes,
group size); :func:`collective_stats` sums records into the reference's
``{kind: {"count", "operand_bytes", "result_bytes", "wire_bytes"}}``,
with the same per-algorithm wire multipliers (ring all-reduce moves
2·(k−1)/k · bytes, etc.).  Every collective of the run is a record, each
layer's and each microbatch's: no trip-count correction applies.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import torch


class Record(NamedTuple):
    kind: str                 # the HLO op name, e.g. "all-gather"
    operand_bytes: int        # local input bytes
    result_bytes: int         # local output bytes
    group_size: int
    count: int = 1            # how many such collectives it stands for


# functional collective op name -> (HLO kind, index of the group name arg)
_KINDS = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_reduce": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def record(func, args, out) -> Record | None:
    """The :class:`Record` of one dispatched op, or ``None`` when it is no
    collective (``wait_tensor`` included: its collective is recorded)."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._schema.name.split("::")[-1]
    if name not in _KINDS:
        return None
    kind, gi = _KINDS[name]
    from torch.distributed.distributed_c10d import _resolve_process_group
    k = _resolve_process_group(args[gi]).size()
    return Record(kind, _nbytes(args[0]), _nbytes(out), k)


def collective_stats(records) -> dict:
    """Returns {op_kind: {"count", "operand_bytes", "result_bytes",
    "wire_bytes"}} summed over all records."""
    out: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "result_bytes": 0,
                 "wire_bytes": 0.0})
    for r in records:
        rec = out[r.kind]
        rec["count"] += r.count
        rec["operand_bytes"] += r.count * r.operand_bytes
        rec["result_bytes"] += r.count * r.result_bytes
        rec["wire_bytes"] += r.count * _wire_bytes(
            r.kind, r.operand_bytes, r.result_bytes, r.group_size)
    return dict(out)


def _wire_bytes(kind: str, operand_b: int, result_b: int, k: int) -> float:
    """Per-device wire traffic under ring/bidirectional algorithms."""
    if kind == "collective-permute":     # point-to-point: no replica groups
        return float(operand_b)
    if k <= 1:
        return 0.0
    f = (k - 1) / k
    if kind == "all-gather":
        return f * result_b            # each device receives result minus own
    if kind == "all-reduce":
        return 2.0 * f * operand_b     # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return f * operand_b
    if kind == "all-to-all":
        return f * operand_b
    if kind == "collective-permute":
        return float(operand_b)
    return float(operand_b)


def totals(stats: dict) -> dict:
    return {
        "collective_count": sum(r["count"] for r in stats.values()),
        "collective_operand_bytes": sum(r["operand_bytes"]
                                        for r in stats.values()),
        "collective_wire_bytes": sum(r["wire_bytes"]
                                     for r in stats.values()),
    }
