#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run it from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``)
and ``nvidia-smi``; it imports neither JAX nor the JAX package.  Phases,
each printing one line of numbers:

1. device   — the card's name and power limit (``nvidia-smi``), torch/CUDA.
2. build    — every CUDA kernel of the path, one ``nvcc`` per source, in
              parallel, with ``ptxas`` register/shared-memory lines.
3. kernels  — each kernel against its plain PyTorch version on the card, on
              seeded grids of 2048 lanes at T = 8, 32 and 64 (mixed time- and
              space-shared lanes, all four bindings, LOCALITY on skewed
              placement, elastic lease windows with spinup and priorities,
              the tail-heavy straggler shape): every carry leaf bitwise, and
              a run split at ``epoch_limit`` bitwise against one call.
4. main     — ``SweepPlan.run(device="cuda")`` on 65,536 open-loop cells; the
              kernel's launch count must rise; wall time, scenarios/s, the
              kernel's own time (CUDA events), the plain version's time on
              the same batches and the kernel's bound.
5. cpu      — 2048 cells drawn from every bucket of the main run, stepped
              again by the port on the CPU at the same bucket shapes:
              integer metrics exact, float metrics bitwise.

Then one JSON line describing each kernel, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the result lines; so does a run without a card, or outside a
checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CELLS = 65536          # main path: 32x the largest recorded JAX row (b2048)
KERNEL_LANES = 2048      # lanes per kernel-check grid
KERNEL_TS = (8, 32, 64)  # padded task counts of the kernel-check grids
CPU_CELLS = 2048         # cells re-run on the CPU
TIMING_REPS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores (same)
KINDS = ("mixed_policies", "locality", "elastic", "tailheavy")


def cell_columns(kind: str, n: int, rng, T: int | None = None):
    """Seeded parameter columns for ``n`` cells of one workload kind.

    The recipe of ``benchmarks/sweep_throughput.py:_random_cols`` (the JAX
    package's throughput benchmark), copied here so this script imports
    nothing of that package: ``mixed_policies``, ``locality`` (storage on,
    skewed placement, LOCALITY binding), ``elastic`` (Poisson arrivals,
    lease windows with spinup, priorities, mixed sched policies) and
    ``tailheavy`` (40 maps, space-shared, 1/8 of lanes stragglers on one
    1-PE VM).  ``T`` caps the task count (maps + reduces) for the kernel
    checks: tail-heavy cells then take ``T - 1`` maps.  Every kind fills
    the same column set, so kinds can share one grid.
    """
    from repro_torch.core import elasticity
    max_maps = 20 if T is None else max(1, min(20, T - 1))
    cols = dict(
        n_maps=rng.integers(1, max_maps + 1, n).astype(np.int32),
        n_reduces=np.ones(n, np.int32),
        n_vms=rng.integers(1, 10, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], n).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        vm_cost=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        job_length=rng.choice([362880.0, 725760.0, 1451520.0], n
                              ).astype(np.float32),
        job_data=rng.choice([2e5, 4e5, 8e5], n).astype(np.float32),
        sched_policy=np.zeros(n, np.int32),
        binding_policy=np.zeros(n, np.int32),
        storage_enabled=np.zeros(n, np.float32),
        replication=np.full(n, 3, np.int32),
        placement=np.zeros(n, np.int32),
        block_size_mb=np.full(n, 2048.0, np.float32),
        storage_seed=np.zeros(n, np.int32),
        job_submit=np.zeros(n, np.float32),
        vm_start=np.zeros((n, 9), np.float32),
        vm_stop=np.full((n, 9), 1e30, np.float32),
        spinup_delay=np.zeros(n, np.float32),
        task_prio=np.zeros((n, 21), np.float32),
    )
    if kind == "mixed_policies":
        cols["sched_policy"] = rng.integers(0, 2, n).astype(np.int32)
        cols["binding_policy"] = rng.integers(0, 4, n).astype(np.int32)
    elif kind == "locality":
        cols["binding_policy"] = np.full(n, 3, np.int32)      # LOCALITY
        cols["storage_enabled"] = np.ones(n, np.float32)
        cols["replication"] = rng.integers(1, 4, n).astype(np.int32)
        cols["placement"] = np.ones(n, np.int32)              # SKEWED
        cols["block_size_mb"] = rng.choice([8192.0, 32768.0], n
                                           ).astype(np.float32)
        cols["storage_seed"] = rng.integers(0, 1000, n).astype(np.int32)
    elif kind == "elastic":
        cols["job_submit"] = elasticity.arrival_times(n, rate=0.002, seed=n)
        start = rng.choice([0.0, 500.0, 2000.0], (n, 9)).astype(np.float32)
        cols["vm_start"] = start
        cols["vm_stop"] = np.where(rng.random((n, 9)) < 0.5, 1e30,
                                   start + cols["job_submit"][:, None]
                                   + 40000.0).astype(np.float32)
        cols["spinup_delay"] = rng.choice([0.0, 60.0], n).astype(np.float32)
        cols["task_prio"] = rng.integers(0, 3, (n, 21)).astype(np.float32)
        cols["sched_policy"] = rng.integers(0, 2, n).astype(np.int32)
        cols["binding_policy"] = rng.integers(0, 4, n).astype(np.int32)
    elif kind == "tailheavy":
        strag = rng.random(n) < 1.0 / 8.0
        strag[0] = True
        cols["n_maps"] = np.full(n, 40 if T is None else T - 1, np.int32)
        cols["n_vms"] = np.where(strag, 1, rng.integers(6, 10, n)
                                 ).astype(np.int32)
        cols["vm_pes"] = np.where(strag, 1.0, rng.choice([2.0, 4.0], n)
                                  ).astype(np.float32)
        cols["sched_policy"] = np.ones(n, np.int32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return cols


def mixed_columns(n: int, seed: int, T: int | None = None):
    """``n`` cells, a quarter of each kind, in one column set."""
    rng = np.random.default_rng(seed)
    parts = [cell_columns(k, n // len(KINDS), rng, T) for k in KINDS]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def bits(x):
    """A tensor's raw bits, so equality is bitwise (-0.0 != 0.0)."""
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_kernels(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """Kernel vs plain version on the card; returns the largest absolute
    difference seen (0.0 when every leaf is bitwise equal)."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.kernels.mr_sched import megakernel, ops
    worst, checked = 0.0, 0
    for T in ts:
        cols = mixed_columns(lanes, seed + T, T)
        cols["task_prio"] = np.pad(cols["task_prio"][:, :T],
                                   ((0, 0), (0, max(0, T - 21))))
        batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9,
                                  device=device)
        inputs = ops.kernel_inputs(batch)
        max_pes = ops.batch_max_pes(batch)
        kern = megakernel.mr_epoch(*inputs, max_pes=max_pes)
        plain = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes)
        torch.cuda.synchronize()
        for name, a, b in zip(megakernel.STATE_LEAVES, kern, plain):
            if a.dtype == torch.float32:
                worst = max(worst, float((a - b).abs().max()))
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"T={T}: mr_epoch leaf {name} differs "
                                     "from its plain version")
        # resume: two calls split at epoch_limit against one call
        split = max(1, int(kern[7].max()) // 2)
        first = megakernel.mr_epoch(*inputs, max_pes=max_pes,
                                    epoch_limit=split)
        rest = megakernel.mr_epoch(inputs[0], inputs[1], None, *inputs[3:],
                                   state=first, max_pes=max_pes,
                                   epoch_limit=2 * T + 2 - split)
        for name, a, b in zip(megakernel.STATE_LEAVES, rest, kern):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"T={T}: resumed leaf {name} differs")
        checked += lanes
    return worst, checked


def bucket_batches(cols, pad_tasks, pad_vms, device):
    """The main path's buckets, encoded: ``[(idx, batch, max_pes)]``."""
    from repro_torch.core import sweep
    out = []
    for idx, gcols, statics, tb, vb in sweep._bucket_groups(
            cols, pad_tasks, pad_vms, "auto", None):
        batch = sweep.grid_arrays(gcols, pad_tasks=tb, pad_vms=vb,
                                  static_params=statics, device=device)
        max_pes = max(int(np.ceil(float(np.max(gcols["vm_pes"])))), 1)
        out.append((idx, gcols, statics, tb, vb, batch, max_pes))
    return out


def layer_seconds(buckets, device):
    """Wall seconds of the main path's layers, summed over its buckets:
    encode (``grid_arrays``), step (``epoch_schedule``: derived inputs,
    the kernel, ``SimOutput``) and metrics (``job_metrics`` +
    ``scenario_metrics`` + the copy to the host), the card synchronised
    at each boundary."""
    import torch
    from repro_torch.core import engine, sweep
    from repro_torch.kernels.mr_sched import ops
    enc = step = met = 0.0
    for idx, gcols, statics, tb, vb, _, max_pes in buckets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = sweep.grid_arrays(gcols, pad_tasks=tb, pad_vms=vb,
                                  static_params=statics, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ops.epoch_schedule(batch, max_pes=max_pes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.to_numpy(engine.job_metrics(batch, out))
        engine.to_numpy(engine.scenario_metrics(batch, out))
        t3 = time.perf_counter()
        enc, step, met = enc + t1 - t0, step + t2 - t1, met + t3 - t2
    return enc, step, met


def kernel_bound_ms(batch, n_epochs, max_pes):
    """Least time the card could take for one ``mr_epoch`` call on this
    batch: the larger of its bytes over HBM bandwidth and its operations
    over the fp32 rate.  Bytes: each input read once, each output written
    once (per lane 4 T-wide + 3 scalar + 4 V-wide inputs, 5 T-wide + 3
    scalar carry leaves in and out, 4 bytes each).  Operations, counted
    from the op sequence per realized epoch of a lane: about 32 per task
    slot (rates, event times, the next-event min, completions, release,
    eligibility, starts), 6 per VM, and 6 per task slot per admission step
    on space-shared lanes, times this run's realized epochs per lane."""
    N, T = batch.task_vm.shape
    V = batch.vm_mips.shape[1]
    nbytes = N * (4 * (4 * T + 3 + 4 * V) + 2 * 4 * (5 * T + 3))
    space = (batch.sched_policy != 0).double().cpu().numpy()
    per_epoch = 32.0 * T + 6.0 * V + space * 6.0 * T * max_pes
    ops = float((n_epochs.double().cpu().numpy() * per_epoch).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps):
    import torch
    fn()                                   # warm up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import sweep
    from repro_torch.kernels import _build
    from repro_torch.kernels.mr_sched import megakernel, ops
    dev = torch.device("cuda")
    smi = nvidia_smi()

    # 1. device
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = [ln.strip() for name in built for ln in
             _build.build_log(name).splitlines() if "Used" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
          f"{json.dumps({k: round(v, 2) for k, v in built.items()})} | "
          + " | ".join(ptxas), flush=True)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    worst, checked = phase_kernels(dev)
    print(f"kernels: mr_epoch bitwise == mr_epoch_plain on {checked} lanes "
          f"at T={list(KERNEL_TS)} (+ resume split), max_abs_err {worst}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 4. main path
    cols = mixed_columns(N_CELLS, seed=12)
    # pad_tasks=64 caps the buckets at the next power of two above the
    # 41-task tail-heavy cells, so the grid lands in buckets T = 4 .. 64
    plan = sweep.product(sweep.Axis(("cell",), tuple(
        (i,) for i in range(N_CELLS)), cols)).replace(pad_tasks=64)
    megakernel.mr_epoch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = plan.run(device="cuda")
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = megakernel.mr_epoch.launches
    if launches < 1:
        raise AssertionError("the main path never launched mr_epoch")
    t0 = time.perf_counter()
    again = plan.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in result.metrics:
        if not np.array_equal(result[k], again[k]):
            raise AssertionError(f"main path not repeatable: {k}")
    for k in ("finish_time", "makespan", "utilization"):
        if not np.isfinite(result[k]).all():
            raise AssertionError(f"non-finite {k} in the main path")
    n_ep = result["n_epochs"]
    if not ((n_ep >= 1) & (n_ep <= 2 * 64 + 2)).all():
        raise AssertionError("n_epochs outside [1, 2T+2]")
    compiled, pad_t, pad_v = plan._compiled()
    buckets = bucket_batches(compiled, pad_t, pad_v, dev)
    k_ms = p_ms = b_ms = 0.0
    by_ops = 0.0
    for idx, gcols, statics, tb, vb, batch, max_pes in buckets:
        inputs = ops.kernel_inputs(batch)
        st = megakernel.mr_epoch(*inputs, max_pes=max_pes)
        k_ms += cuda_ms(lambda: megakernel.mr_epoch(*inputs,
                                                    max_pes=max_pes),
                        TIMING_REPS)
        p_ms += cuda_ms(lambda: megakernel.mr_epoch_plain(
            *inputs, max_pes=max_pes), 1)
        bound, by = kernel_bound_ms(batch, st[7][:, 0], max_pes)
        b_ms += bound
        by_ops += bound if by == "operations" else 0.0
    bound_by = "operations" if by_ops >= b_ms / 2 else "bytes"
    enc_s, step_s, met_s = layer_seconds(buckets, dev)
    print(f"main: {N_CELLS} cells in {len(buckets)} buckets (T pads "
          f"{sorted({b[3] for b in buckets})}), wall {wall_first:.3f} s "
          f"first / {wall:.3f} s again, {N_CELLS / wall:.0f} scenarios/s, "
          f"mr_epoch launches {launches}, kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({bound_by}), "
          f"realized_epochs max {int(result['realized_epochs'].max())} | "
          f"layers over buckets: encode {enc_s:.3f} s, step {step_s:.3f} s, "
          f"metrics {met_s:.3f} s", flush=True)

    # 5. the same cells on the CPU
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    n_checked = 0
    share = CPU_CELLS / N_CELLS
    from repro_torch.core.engine import JobMetrics, ScenarioMetrics
    for i, (idx, gcols, statics, tb, vb, batch, max_pes) in enumerate(
            buckets):
        k = max(1, int(round(len(idx) * share)))
        if i == len(buckets) - 1:
            k = max(1, min(len(idx), CPU_CELLS - n_checked))
        pick = np.sort(rng.choice(len(idx), size=min(k, len(idx)),
                                  replace=False))
        sub = {c: v[pick] for c, v in gcols.items()}
        jm, sm, _ = sweep._run_batch(sub, tb, vb, statics, "torch",
                                     torch.device("cpu"), max_pes)
        for f in JobMetrics._fields:
            want = result.metrics[f].reshape(N_CELLS, -1)[idx[pick]]
            if not np.array_equal(want.view(np.int32),
                                  jm[f].view(np.int32)):
                raise AssertionError(f"CPU run differs from the card: {f}")
        for f in ScenarioMetrics._fields:
            want = result.metrics[f].reshape(N_CELLS)[idx[pick]]
            if not np.array_equal(want.view(np.int32),
                                  sm[f].view(np.int32)):
                raise AssertionError(f"CPU run differs from the card: {f}")
        n_checked += len(pick)
    print(f"cpu: {n_checked} cells from {len(buckets)} buckets re-run on "
          f"the CPU, integer metrics exact and float metrics bitwise, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "mr_epoch", "route": "cuda",
        "source": "src/repro_torch/kernels/mr_sched/csrc/mr_epoch.cu",
        "replaces": "src/repro/kernels/mr_sched/megakernel.py:101",
        "launches": launches, "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
