#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run it from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``)
and ``nvidia-smi``; it imports neither JAX nor the JAX package.  Phases,
each printing one line of numbers:

1. device   — the card's name and power limit (``nvidia-smi``), torch/CUDA.
2. build    — every CUDA kernel of the port, one ``nvcc`` per source, in
              parallel, with ``ptxas`` register/shared-memory lines; then
              ``costmodel.default_cost_model()`` on the card (cached in
              ``src/repro_torch/kernels/_build/costmodel.json`` beside the
              kernel builds unless ``$REPRO_TORCH_COSTMODEL_PATH`` names a
              file, else measured):
              its source must be ``measured`` or ``cache``, and its three
              coefficients are printed beside the card's name and power
              limit.  Every later ``run()`` prices with it.
3. kernels  — each kernel against its plain PyTorch version on the card, on
              seeded grids of 2048 lanes at T = 8, 32 and 64: every carry leaf
              bitwise, and a run split at ``epoch_limit`` bitwise against one
              call.  The open-loop ``mr_epoch`` on the open-loop kinds (mixed
              time- and space-shared lanes, all four bindings, LOCALITY on
              skewed placement, elastic lease windows with spinup and
              priorities, the tail-heavy straggler shape); the control
              instantiation on the closed-loop kinds (seeded failures with
              AUTOSCALE, deadlines with SHED/BOOST and preemption, reserve
              fleets, failover onto replica holders), all 15 leaves; and the
              control instantiation on degenerate control data against the
              open-loop kernel on the 8 shared leaves.  Each instantiation
              also on lanes built to stress space-shared admission
              (``tests/mr_stress.py``) at T = 12, 40 and 70, with
              ``max_pes`` at, above and below the largest PE count, and on
              a large fleet (T = 1024, V = 400: a lane takes a block).
4. main     — ``SweepPlan.run(device="cuda")`` on 65,536 open-loop cells; the
              kernel's launch count must rise; every bucket's kernel run
              bitwise its plain version's; wall time, scenarios/s, the
              kernel's device time per grid (CUDA events around each
              launch, the host's work hidden behind a spin kernel; median
              and spread of 5 rounds) with the critical-lane
              epoch latency (per bucket, device time over its largest
              ``n_epochs``) and the card's SM clock and power draw, the
              plain version's time on the same batches, the kernel's bound
              and the per-layer split.
5. cpu      — 2048 cells drawn from every bucket of the main run, stepped
              again by the port on the CPU at the same bucket shapes:
              integer metrics exact, float metrics bitwise.
6. control  — the same for the closed loop: ``SweepPlan.run(device="cuda")``
              on 65,536 closed-loop cells, a quarter of each closed-loop kind;
              the control instantiation's launch count must rise, every
              bucket bitwise the plain version, every lane's
              ``n_epochs`` stays within its epoch bound, and the grid's totals
              of failures, re-dispatches, scale events, shed tasks and
              preemptions must each be > 0.  Then 2048 of its cells bitwise
              on the CPU.
7. trace    — both 65,536-cell grids again, bucket by bucket, through
              ``engine.simulate_batch_arrays(trace=True)`` (the trace
              instantiations; their launch counts must rise): ``SimOutput``
              bitwise the untraced run's, no event dropped, the event counts
              summed over the grid equal to the counts the schedule and the
              metrics give, 2048 cells' trace buffers bitwise the port's CPU
              run, and a closed-loop lane's Chrome trace with one span per
              start; every bucket's trace kernel run bitwise its plain
              version's; traced and untraced wall (median and spread of
              alternating passes), the trace kernels' device time (as in
              phase 4), launches and bound, and the trace's bytes.
8. report   — ``SweepPlan.run(device="cuda", report=True)`` on the open-loop
              grid: metrics bitwise phase 4's, the report's cells add up to
              the grid and its dispatches to the launches counted.
9. compact  — active-lane compaction on the tail-heavy quarter of phase
              4's grid (16,384 cells, T = 64) and on phase 6's 65,536
              closed-loop cells, full size: ``run(compact="auto")`` and
              ``run(compact=4)`` with ``report=True``, every metric,
              ``n_epochs`` and ``realized_epochs`` bitwise the dense
              ``run()`` on the card, the report's census (order pulls ==
              compactions, count pulls == rounds + one per bucket, launches
              == rounds); ``engine.simulate_batch_arrays_compact`` lean and
              ``legacy=True`` on the largest bucket, bitwise the dense
              ``simulate_batch_arrays``; wall times and scenarios/s of
              dense, auto and pinned runs (median and spread of 3 passes
              in turn), recorded, not claimed.
10. schedule — ``ops.schedule`` (the ``mr_schedule`` kernel) on the open-loop
              grid's cells it models (a static fleet, no priorities): its
              makespans against phase 4's at the reference's tolerance
              (rtol 1e-4, atol 1e-2), each bucket's schedule bitwise the
              plain version's; the kernel's device time per grid (as in
              phase 4), launches and bound; then the kernel bitwise its
              plain version on admission-stress lanes (T = 12, 40, 70)
              and on long lanes (T = 2048 on 9 VMs; T = 1024 on 1500
              VMs, whose task sets live in global scratch).

11. lm kernels — ``flash_attention`` and ``wkv6`` against their plain
              versions on the card at stated tolerances (flash: f32 at 2e-6,
              summation order; bf16, the tensor-core path, at 2 bf16 ulps +
              1e-4, its worst case in ulps printed):
              flash on the kernel tests' five shapes in f32 and bf16, yi-6b's
              prefill shape (B 4, S = T = 2048, 32/4 heads, head_dim 128)
              f32 and bf16, causal and with a 512 window, and the prefills
              of phases 16 (mixtral-8x7b: 2 x 8192, 32/8 heads, window
              4096) and 17 (jamba-v0.1-52b: 4 x 2048, 32/8 heads) in f32
              and bf16; wkv6 on the kernel tests' four shapes and rwkv6-3b's (4, 40, 2048, 64) with a
              non-zero initial state, y at 1e-4 and the final state
              bitwise.
12. serve dense — yi-6b at full width (random f32 weights from a seeded
              generator on the card), 4 prompts of 2048 seeded tokens
              through ``prefill(attn_impl="flash")`` and 32 greedy
              ``decode_step``s in bf16: flash's launch count must rise by 32
              per prefill; prefill and decode tokens/s, on layer 0's
              prefill inputs the kernel's device time (``launch_ms``, with
              its TFLOP/s of the function's operations and its share of
              the bound), ``F.scaled_dot_product_attention``'s (timed only,
              never on the path; the kernel's ratio to it) and the float32
              instantiation's the same way, the plain version's
              (``cuda_ms``) and the bound, the kernel in bf16 and f32 first
              held to its plain version on these inputs (FA_TOL); a
              profiled prefill and decode step (device time by kind of kernel).  In f32 activations the
              prefill logits match ``attn_impl="dense"`` and each decode
              step's logits match ``forward`` over prompt + generated
              tokens.
13. serve rwkv — rwkv6-3b the same way: wkv6's count must rise by 32 per
              prefill and 32 per decode step; the kernel's device time
              (``launch_ms``) on layer 0's prefill inputs and on a decode
              step's (T = 1), beside its bound; in f32 the prefill logits
              match the plain ``_wkv_scan`` path on the card, decode matches
              ``forward``.

14. multijob — the engine's own epoch body (no kernel: plain tensor ops
              on the card), which steps every batch with more than one job
              per lane: a 16,384-lane open-loop and a 16,384-lane
              closed-loop batch of the smart-city family
              (``multijob_scenarios``: 2-4 jobs of the paper's sizes per
              lane, staggered submits, mixed fleets of 4-16 VMs, both
              policies, all bindings, storage, lease windows with Poisson
              arrivals; closed loop: failures with AUTOSCALE reserves,
              SHED/BOOST deadlines, preemption), 4,096 distinct scenarios
              each encoded by ``sweep.stack_scenarios`` at T 64, J 4, V 16
              and tiled x4, through ``engine.simulate_batch_arrays``
              untraced and traced: no ``mr_epoch`` launch, traced
              ``SimOutput`` bitwise the untraced one, no event dropped,
              every lane within its epoch bound, metrics finite, under
              control each mechanism fired; ``simulate_batch_arrays_
              compact`` at K = 4 and ``"auto"`` bitwise dense; 2048 lanes
              and their trace buffers bitwise the same body on the CPU.
              Encode, step and metrics wall, lanes/s, realized epochs, step
              ms per epoch and the card's busy share of a profiled window;
              recorded, not claimed.

15. oracle — the port's sequential oracle ``refsim`` (host numpy, no
              device) against the card: (a) Table IV exactly at 3, 6 and 9
              VMs, and the paper's Group 1-4 grids through ``SweepPlan.run``
              (the ``mr_epoch`` kernel) against ``refsim`` at rtol 2e-4,
              each group's stated shape on the card's numbers; (b) 1,024
              seeded single-job ``Scenario``s (``oracle_scenarios``: every
              sched/binding pair, storage, lease windows, and a closed-loop
              quarter with failures, AUTOSCALE, SHED/BOOST deadlines,
              preemption) stacked by ``sweep.stack_scenarios`` and stepped
              by ``mr_epoch`` (open and control), traced and untraced;
              (c) the first 512 open and 512 closed phase-14 scenarios
              through the engine body; both held lane by lane against
              ``refsim`` (``oracle_diff``: unfinished and shed sets equal,
              times and the paper's metrics at rtol 2e-4, atol 1e-2, the
              closed loop's counts and the traced event counts by kind
              exact), the lanes that differ exactly those on which the JAX
              package's own engine and refsim differ (ROADMAP C10); (d)
              ``workload.step_scenario`` at 256 devices (T = 257 on 256
              VMs) through ``mr_epoch`` against ``refsim``, and
              ``simulate_training``'s goodput at 256 devices, sigma 0.2,
              an MTBF; (e) ``streaming.analyze_batch`` on 65,536
              smart-city topologies and 16,384 seeded 32-operator DAGs on
              the card, bitwise the CPU's run, topologies/s.

16. serve moe — mixtral-8x7b at full width (d_model 4096, 32/8 heads,
              d_ff 14336, 8 experts top-2, window 4096), depth cut to 8 of
              32 layers (its f32 parameters: 47.5 GB), 2 prompts of 8192
              seeded tokens (the window bites in the prefill; the 4096-slot
              ring cache wraps while decoding) and 32 greedy steps in bf16:
              flash's count must rise by 8 per prefill and 0 per step;
              tokens/s, ms per step, the wall of one MoE block, flash's
              device time at (2, 8192, 32/8, 128, window 4096) beside its
              bound, the plain version and SDPA with a boolean window mask;
              a profiled prefill and step.  Checks in f32 activations: (a)
              the prefill logits of the kernel path against
              ``attn_impl="chunked"`` at 1e-3, every MoE layer's routing
              compared exactly and flips allowed only at near-ties
              (``compare_routes``, ROADMAP C12: the prompts they touch are
              left out, counted and printed), and the driven kernel path
              against ``prefill``'s own logits; (b) drop-free, prompt 0's
              8192 tokens + 32 steps against ``forward``; (c) ``apply_moe``
              against ``apply_moe_dense`` drop-free on layer-0-style inputs.
17. serve hybrid — jamba-v0.1-52b at full width (Mamba d_inner 8192,
              d_state 16, dt_rank 256; 16 experts top-2), one 8-layer
              period (1 attention, 7 Mamba, 4 MoE sub-blocks; 53.2 GB),
              4 x 2048 tokens and 32 steps: flash's count must rise by 1
              per prefill; the wall of one Mamba mixer (its Python time
              loop) and one MoE block; checks (a)-(c) as phase 16, (b) on
              prompt 0's first 512 tokens.
18. train   — the training path, rwkv6-3b through the ``wkv6`` forward
              kernel (keeping the state every 4 steps) and the
              hand-written ``wkv6_bwd`` kernel: (a) ``wkv6_bwd`` against
              ``wkv6_bwd_plain`` at rwkv6-3b's layer-0 training shape (4,
              512, 40, 64) with zero and non-zero s0 and gs, T = 200, T =
              1, the T around the kept-state interval (3, 4, 5, 69) and T
              = 203 (a multiple of neither 4 nor 64), each with zero and
              non-zero s0 and gs, and head sizes 16 and 32, r/k/v f32 and
              bf16 (gr, gk, gv, gw, gu at 1e-4, gs0 bitwise, a second run
              bitwise), ``WKV6`` against autograd through
              ``wkv6_scan_plain``, the kernel's ptxas report (registers,
              spills) and resident blocks per SM, its device time beside
              its bound and the plain version's, and the forward's serving
              launch beside the one that keeps states; (b) one AdamW step
              at full width, 2 layers, f32, through the kernels against
              the plain wkv6 forward and backward (loss, grad norm,
              parameters, and ``wkv6_bwd`` on layer 0's own inputs); (c)
              the main path: ``train()`` at full width and depth, f32
              parameters, bf16 activations, 4 steps of 4 x 512 seeded
              tokens from a seeded ``init_model``: 64 ``wkv6`` and 32
              ``wkv6_bwd`` launches a step, losses and grad norms finite,
              the first loss near its expected value; ms per step,
              tokens/s, peak memory, a profiled step by kind and the
              optimizer's time; (d) fault tolerance at a reduced rwkv6
              under ``torch.use_deterministic_algorithms(True)``: kill and
              resume, ``NodeFailure`` and replay, a stale ``.tmp``
              checkpoint invisible to ``restore``.

Phase 3 also holds the trace instantiations (every carry and trace leaf,
the carry against the untraced kernel's, and an undersized event log) and
``mr_schedule`` against their plain versions, bitwise, and runs the engine
body (``backend="engine"``) on its single-job grids, open and control,
bitwise the ``mr_epoch`` kernel on every ``SimOutput`` field, its wall
beside the kernel's device time on the same batches.  float32 products run
in full float32 (TF32 off for matmuls and cuDNN).

Then one JSON line describing each kernel, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the result lines; so does a run without a card, or outside a
checkout.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, os.path.join(ROOT, "tests"))   # mr_stress

N_CELLS = 65536          # main path: 32x the largest recorded JAX row (b2048)
KERNEL_LANES = 2048      # lanes per kernel-check grid
KERNEL_TS = (8, 32, 64)  # padded task counts of the kernel-check grids
CPU_CELLS = 2048         # cells re-run on the CPU
TIMING_ROUNDS = 5        # timed passes over a grid's mr_epoch launches
SPIN_CYCLES = 4_000_000  # ~2 ms at 1.98 GHz: the card's lead over the host
STRESS_CASES = ((12, 0), (40, 3), (70, -3))  # (T, max_pes - largest PE)
FLEET = (1024, 400)      # (T, V) of the large-fleet stress lanes
SCHEDULE_LONG = ((2048, 9), (1024, 1500))  # (T, V) of long mr_schedule lanes
TRACE_PASSES = 11        # alternating untraced/traced passes of phase 7
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores (same)
ENGINE_LANES = 16384     # lanes of each phase-14 multi-job batch
# distinct scenarios among them, tiled x4: the host encodes one scenario
# at a time, and 16,384 took 66-74 s per batch on the card's host
ENGINE_DISTINCT = 4096
ENGINE_SHAPE = (64, 4, 16)  # (T, J, V) padding of the phase-14 batches
ENGINE_CPU = 2048        # distinct lanes of each batch re-run on the CPU
ENGINE_PROFILED = 64     # epochs of each batch run under torch.profiler
ORACLE_N = 1024          # phase 15 (b): seeded single-job scenarios
ORACLE_SEED = 16
ORACLE_MULTIJOB = 512    # phase 15 (c): the first phase-14 scenarios
# lanes on which the JAX package's own engine and refsim differ (ROADMAP
# C10), pinned against it on the CPU by tests/test_torch_refsim.py: of the
# phase 15 (b) set, and of the closed-loop multi-job set of (c); the open
# loops differ nowhere
ORACLE_DIVERGENT = (775, 807, 836, 895, 903, 988, 1013)
ORACLE_DIVERGENT_MULTIJOB = (
    6, 7, 10, 12, 15, 18, 26, 30, 35, 56, 73, 75, 77, 78, 97, 98, 99, 108,
    109, 114, 127, 136, 137, 148, 150, 154, 156, 163, 165, 169, 170, 173,
    180, 182, 183, 188, 193, 197, 200, 204, 209, 211, 212, 213, 214, 219,
    234, 240, 242, 247, 250, 260, 264, 277, 283, 288, 292, 294, 296, 300,
    302, 305, 311, 315, 316, 317, 330, 346, 348, 349, 357, 362, 368, 378,
    381, 383, 388, 397, 400, 402, 407, 409, 414, 418, 423, 428, 436, 440,
    445, 446, 447, 458, 460, 475, 480, 493, 497, 502, 510)
PAPER_M = range(1, 21)   # the paper's MapReduce combinations M1R1..M20R1
TABLE_IV = {             # the paper's Table IV network cost per M
    1: 2125.0, 2: 1416.667, 3: 1062.5, 4: 850.0, 5: 708.333, 6: 607.143,
    7: 531.25, 8: 472.222, 9: 425.0, 10: 386.364, 11: 354.167, 12: 326.923,
    13: 303.571, 14: 283.333, 15: 265.625, 16: 250.0, 17: 236.111,
    18: 223.684, 19: 212.5, 20: 202.381,
}
TRAIN_COST = dict(flops=1e14, hbm_bytes=1e11, collective_bytes=1e9)
TRAIN_DEVICES = 256      # phase 15 (d): one lane of 257 tasks on 256 VMs
TRAIN_MTBF_HOURS = 1000.0
STREAM_DAGS = 16384      # phase 15 (e): seeded 32-operator DAGs
KINDS = ("mixed_policies", "locality", "elastic", "tailheavy")
CONTROL_KINDS = ("control", "deadline", "reserves", "failover_locality")
CONTROL_RATE = 0.0005       # per-VM failure rate of the closed-loop kinds
CONTROL_REPAIR = 600.0      # ... and their repair delay (seconds)


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


def control_columns(kind: str, n: int, rng, T: int | None = None):
    """Seeded closed-loop parameter columns for ``n`` cells of one kind.

    ``control`` and ``deadline`` are the recipe of
    ``benchmarks/sweep_throughput.py:_random_cols(control=True)`` and
    ``(deadline=True)``, copied here: the elastic grid plus per-lane
    seeded failure/restore streams (rate 0.0005, repair 600 s), re-dispatch
    after 0 or 30 s and the AUTOSCALE hook (queue 2 or 8, busy 0.5);
    ``deadline`` adds per-task deadlines on half the tasks with SHED or
    BOOST, slack 0 or 120 s and preemption (resume 0 or 1), and counts its
    failure instants from the job's arrival.  ``reserves``
    gives the last one or two VMs of each lane as AUTOSCALE reserves
    (queue 2, busy 0.5) to a space-shared job of 8-20 maps.
    ``failover_locality`` puts the failure streams on the storage grid
    (LOCALITY binding, replication 1-3, skewed placement), so failover
    targets are replica holders, with the last VM an AUTOSCALE reserve:
    a block held only there fails over to a non-holder and pays a
    re-replication fetch.
    Every kind fills the same column set, degenerate where it does not use
    a column.
    """
    from repro_torch.core import control
    base = "elastic" if kind in ("control", "deadline") else (
        "locality" if kind == "failover_locality" else "mixed_policies")
    cols = cell_columns(base, n, rng, T)
    w = cols["task_prio"].shape[1]
    cols.update(
        vm_fail=np.full((n, 9), 1e30, np.float32),
        vm_restore=np.full((n, 9), 1e30, np.float32),
        vm_auto=np.zeros((n, 9), np.float32),
        control_policy=np.zeros(n, np.int32),
        ctl_queue=np.zeros(n, np.float32), ctl_busy=np.zeros(n, np.float32),
        redispatch_delay=np.zeros(n, np.float32),
        task_deadline=np.full((n, w), 1e30, np.float32),
        deadline_policy=np.zeros(n, np.int32),
        deadline_slack=np.zeros(n, np.float32),
        preempt=np.zeros(n, np.int32), preempt_resume=np.zeros(n, np.int32))
    if kind in ("control", "deadline", "failover_locality"):
        f, r = control.failure_times(9 * n, rate=CONTROL_RATE, seed=n,
                                     repair_delay=CONTROL_REPAIR)
        f = np.asarray(f, np.float32).reshape(n, 9)
        r = np.asarray(r, np.float32).reshape(n, 9)
        if kind == "deadline":
            # instants counted from the job's arrival, so failures land
            # while the job runs and re-dispatched tasks contend for full
            # VMs (preemption's trigger); counted from 0, nearly all fall
            # before the Poisson arrivals
            sub = cols["job_submit"][:, None]
            f = np.minimum(f + sub, np.float32(1e30))
            r = np.minimum(r + sub, np.float32(1e30))
        cols["vm_fail"], cols["vm_restore"] = f, r
        cols["redispatch_delay"] = rng.choice([0.0, 30.0], n
                                              ).astype(np.float32)
    if kind in ("control", "deadline"):
        cols["control_policy"] = np.ones(n, np.int32)          # AUTOSCALE
        cols["ctl_queue"] = rng.choice([2.0, 8.0], n).astype(np.float32)
        cols["ctl_busy"] = np.full(n, 0.5, np.float32)
        cols["binding_policy"] = np.zeros(n, np.int32)
    if kind == "deadline":
        dl = (cols["job_submit"][:, None]
              + rng.choice([3000.0, 12000.0, 48000.0], (n, w))
              ).astype(np.float32)
        cols["task_deadline"] = np.where(rng.random((n, w)) < 0.5, 1e30,
                                         dl).astype(np.float32)
        cols["deadline_policy"] = rng.integers(1, 3, n).astype(np.int32)
        cols["deadline_slack"] = rng.choice([0.0, 120.0], n
                                            ).astype(np.float32)
        cols["preempt"] = np.ones(n, np.int32)
        cols["preempt_resume"] = rng.integers(0, 2, n).astype(np.int32)
    elif kind == "reserves":
        hi = 20 if T is None else max(1, min(20, T - 1))
        cols["n_maps"] = rng.integers(min(8, hi), hi + 1, n).astype(np.int32)
        cols["n_vms"] = rng.integers(3, 10, n).astype(np.int32)
        k = rng.integers(1, 3, n)
        cols["vm_auto"] = (np.arange(9)[None, :] >= (cols["n_vms"] - k)[:, None]
                           ).astype(np.float32)
        cols["control_policy"] = np.ones(n, np.int32)
        cols["ctl_queue"] = np.full(n, 2.0, np.float32)
        cols["ctl_busy"] = np.full(n, 0.5, np.float32)
        cols["sched_policy"] = np.ones(n, np.int32)
        cols["binding_policy"] = np.zeros(n, np.int32)
    elif kind == "failover_locality":
        # the last VM is an AUTOSCALE reserve: a block held only there
        # fails over to a non-holder and pays the re-replication fetch
        cols["n_vms"] = np.maximum(cols["n_vms"], 2).astype(np.int32)
        cols["vm_auto"] = (np.arange(9)[None, :]
                           == (cols["n_vms"] - 1)[:, None]).astype(np.float32)
        cols["control_policy"] = np.ones(n, np.int32)
        cols["ctl_queue"] = np.full(n, 2.0, np.float32)
        cols["ctl_busy"] = np.full(n, 0.5, np.float32)
    elif kind != "control":
        raise ValueError(f"unknown kind {kind!r}")
    return cols


def mixed_control_columns(n: int, seed: int, T: int | None = None):
    """``n`` closed-loop cells, a quarter of each kind, in one column set."""
    rng = np.random.default_rng(seed)
    parts = [control_columns(k, n // len(CONTROL_KINDS), rng, T)
             for k in CONTROL_KINDS]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def fit_tasks(cols, T):
    """Cut or pad the per-task columns to ``T`` slots."""
    for name, fill in (("task_prio", 0.0), ("task_deadline", 1e30)):
        if name in cols:
            c = cols[name][:, :T]
            cols[name] = np.pad(c, ((0, 0), (0, T - c.shape[1])),
                                constant_values=fill)
    return cols


MJ_JOB_KINDS = ("JOB_SMALL", "JOB_MEDIUM", "JOB_BIG")
MJ_VM_KINDS = ("small", "medium", "large")
MJ_SHAPES = ("plain", "priority", "storage", "elastic")


def multijob_scenario(core, rng, *, control=False, max_jobs=4, max_maps=12,
             max_reduces=3, vms=(4, 16)):
    """One seeded multi-job scenario of the smart-city family, built from
    ``core``'s config classes (``repro.core`` or ``repro_torch.core``: the
    draws come from ``rng`` alone, so both packages get the same scenario).

    A fleet of mixed VM types runs 2 to ``max_jobs`` MapReduce jobs of the
    paper's Table III sizes (as ``examples/smart_city.py`` Part 1 mixes
    its three IoT feeds), 2 to ``max_maps`` maps and 1 to 3 reduces each,
    submits staggered over 0-1800 s, either scheduling policy, any of the
    four bindings.  A lane takes one of four shapes: plain, per-job
    priorities, storage on (LOCALITY, skewed placement, replication 1-3),
    or lease windows with Poisson job arrivals.  ``control=True`` adds the
    closed loop of Parts 5 and 6: seeded VM failures with AUTOSCALE
    reserves, SHED or BOOST deadlines, preemption."""
    shape = MJ_SHAPES[int(rng.integers(0, len(MJ_SHAPES)))]
    n_jobs = int(rng.integers(2, max_jobs + 1))
    n_vms = int(rng.integers(vms[0], vms[1] + 1))
    submits = np.sort(rng.random(n_jobs) * 1800.0)
    if shape == "elastic":
        submits = core.elasticity.arrival_times(
            n_jobs, rate=1.0 / 600.0, process="poisson",
            seed=int(rng.integers(0, 2**31)))
    jobs = []
    for j in range(n_jobs):
        base = getattr(core, MJ_JOB_KINDS[int(rng.integers(0, 3))])
        kw = dict(name=f"feed{j}", n_maps=int(rng.integers(2, max_maps + 1)),
                  n_reduces=int(rng.integers(1, max_reduces + 1)),
                  submit_time=float(submits[j]))
        if shape == "priority":
            kw["priority"] = float(rng.integers(0, 3))
        if control and rng.random() < 0.7:
            kw["deadline"] = float(submits[j]) + float(
                rng.uniform(3000.0, 15000.0))
        jobs.append(dataclasses.replace(base, **kw))
    fleet = []
    for v in range(n_vms):
        spec = core.VM_TYPES[MJ_VM_KINDS[int(rng.integers(0, 3))]]
        if shape == "elastic":
            spec = dataclasses.replace(
                spec, lease_start=float(rng.choice([0.0, 0.0, 300.0])),
                lease_stop=(math.inf if rng.random() < 0.6
                            else float(rng.uniform(4000.0, 40000.0))))
        fleet.append(spec)
    kw = dict(sched_policy=core.SchedPolicy(int(rng.integers(0, 2))),
              binding_policy=core.BindingPolicy(int(rng.integers(0, 4))))
    if shape == "storage":
        kw["storage"] = core.StorageSpec(
            enabled=True, replication=int(rng.integers(1, 4)),
            placement=core.Placement.SKEWED,
            seed=int(rng.integers(0, 2**31)))
        kw["binding_policy"] = core.BindingPolicy.LOCALITY
    if shape == "elastic":
        kw["elasticity"] = core.ElasticitySpec(
            spinup_delay=float(rng.choice([0.0, 30.0, 120.0])),
            billing_granularity=60.0)
    if control:
        n_res = int(rng.integers(0, min(3, n_vms - 1) + 1))
        for v in range(n_vms - n_res, n_vms):
            fleet[v] = dataclasses.replace(fleet[v], autoscale=True)
        if rng.random() < 0.5:
            kw["sched_policy"] = core.SchedPolicy.SPACE_SHARED
        # reserves only where AUTOSCALE can open them, as in Part 5
        policy = 1 if n_res else int(rng.integers(0, 2))
        kw["control"] = core.ControlSpec(
            policy=core.ControlPolicy(policy),
            failure_rate=float(rng.choice([0.0, 1e-4, 3e-4, 1e-3])),
            failure_seed=int(rng.integers(0, 2**31)),
            repair_delay=float(rng.choice([300.0, 900.0, 3600.0])),
            redispatch_delay=float(rng.choice([0.0, 10.0])),
            queue_threshold=float(rng.choice([1.0, 2.0, 4.0])),
            busy_threshold=float(rng.choice([0.25, 0.5])),
            deadline_policy=core.DeadlinePolicy(int(rng.integers(0, 3))),
            deadline_slack=float(rng.choice([0.0, 300.0, 1200.0])),
            preempt=bool(rng.random() < 0.5),
            preempt_resume=bool(rng.random() < 0.5))
    return core.Scenario(vms=tuple(fleet), jobs=tuple(jobs), **kw)


def multijob_scenarios(core, n, seed, **kw):
    """``n`` seeded scenarios (keyword arguments as
    :func:`multijob_scenario`)."""
    rng = np.random.default_rng(seed)
    return [multijob_scenario(core, rng, **kw) for _ in range(n)]


ORACLE_KINDS = ("policies", "storage", "elastic", "control")
ORACLE_RTOL, ORACLE_ATOL = 2e-4, 1e-2    # the reference's oracle tolerance
ORACLE_FIELDS = ("avg_exec", "max_exec", "min_exec", "makespan",
                 "delay_time", "vm_cost", "network_cost", "map_avg_exec",
                 "reduce_avg_exec")
ORACLE_COUNTS = ("failures_injected", "tasks_redispatched", "scale_events",
                 "shed_tasks", "preemptions")


def oracle_scenario(core, rng, kind, pair):
    """One seeded single-job scenario of phase 15's oracle set, from
    ``core``'s config classes (``repro.core`` or ``repro_torch.core``, the
    same draws).  ``pair`` indexes the 2 x 4 (sched, binding) policy
    pairs; ``kind`` is one of :data:`ORACLE_KINDS`:

    * ``policies`` — a mixed fleet of 1-8 VMs of the paper's three types,
      one job of Table III's sizes with 1-20 maps and 1-3 reduces, network
      delay on or off, submitted at 0 or 500 s (the JAX package's
      ``tests/test_engine_vs_refsim.py`` seeded sweep, widened);
    * ``storage`` — the block store on, replication 1-3, skewed or uniform
      placement, block sizes 1-8 GB (``tests/test_storage.py``);
    * ``elastic`` — lease windows starting at 0, 400 or 1500 s, some
      closing early enough to strand work, spin-up 0 or 90 s, billing by
      the second or the hour (``tests/test_elasticity.py``);
    * ``control`` — the closed loop: seeded VM failures with repair and
      re-dispatch, AUTOSCALE reserves, SHED or BOOST deadlines on a
      contended fleet of 1-PE VMs, preemption armed
      (``tests/test_control.py``, ``tests/test_deadlines.py``).
    """
    sp, bp = divmod(pair % 8, 4)
    n_vms = int(rng.integers(1, 9))
    fleet = [core.VM_TYPES[MJ_VM_KINDS[int(rng.integers(0, 3))]]
             for _ in range(n_vms)]
    base = getattr(core, MJ_JOB_KINDS[int(rng.integers(0, 3))])
    job = dataclasses.replace(
        base, n_maps=int(rng.integers(1, 21)),
        n_reduces=int(rng.integers(1, 4)),
        submit_time=float(rng.choice([0.0, 0.0, 500.0])))
    kw = dict(sched_policy=core.SchedPolicy(sp),
              binding_policy=core.BindingPolicy(bp),
              network=core.NetworkSpec(enabled=bool(rng.random() < 0.8)))
    if kind == "storage":
        kw["storage"] = core.StorageSpec(
            enabled=True,
            block_size_mb=float(rng.choice([1024.0, 2048.0, 4096.0,
                                            8192.0])),
            replication=int(rng.integers(1, 4)),
            placement=core.Placement(int(rng.random() < 0.7)),
            seed=int(rng.integers(0, 2**31)))
    elif kind == "elastic":
        for v in range(n_vms):
            start = float(rng.choice([0.0, 400.0, 1500.0]))
            stop = float(rng.choice([start + 30000.0, math.inf,
                                     start + float(rng.uniform(600.0,
                                                               4000.0))]))
            fleet[v] = dataclasses.replace(fleet[v], lease_start=start,
                                           lease_stop=stop)
        kw["elasticity"] = core.ElasticitySpec(
            spinup_delay=float(rng.choice([0.0, 90.0])),
            billing_granularity=float(rng.choice([1.0, 3600.0])))
    elif kind == "control":
        mech = int(rng.integers(0, 3))
        ctl = dict(failure_rate=float(rng.choice([0.0, 5e-4, 2e-3])),
                   failure_seed=int(rng.integers(0, 2**31)),
                   repair_delay=float(rng.choice([300.0, 900.0])),
                   redispatch_delay=float(rng.choice([0.0, 5.0])),
                   preempt=bool(rng.random() < 0.5),
                   preempt_resume=bool(rng.random() < 0.5))
        if mech == 0:                          # failures
            ctl["failure_rate"] = float(rng.choice([5e-4, 1e-3, 2e-3]))
        elif mech == 1:                        # AUTOSCALE reserves
            n_res = int(rng.integers(1, 3))
            fleet = [core.VM_SMALL] * max(n_vms // 2, 1) + [
                dataclasses.replace(core.VM_SMALL, autoscale=True)] * n_res
            ctl.update(policy=core.ControlPolicy.AUTOSCALE,
                       queue_threshold=float(rng.choice([0.0, 1.0, 2.0])),
                       busy_threshold=float(rng.choice([0.25, 0.5])))
            job = dataclasses.replace(job, n_maps=int(rng.integers(6, 21)))
        else:                                  # deadlines on a contended fleet
            fleet = [core.VM_SMALL] * int(rng.integers(1, 4))
            job = dataclasses.replace(
                job, n_maps=int(rng.integers(4, 21)),
                deadline=job.submit_time + float(rng.uniform(1500.0,
                                                             9000.0)))
            ctl.update(deadline_policy=core.DeadlinePolicy(
                int(rng.integers(1, 3))),
                deadline_slack=float(rng.choice([0.0, 100.0, 600.0])))
        kw["control"] = core.ControlSpec(**ctl)
    return core.Scenario(vms=tuple(fleet), jobs=(job,), **kw)


def oracle_scenarios(core, n, seed):
    """``n`` seeded single-job scenarios, a quarter of each
    :data:`ORACLE_KINDS` in turn (:func:`oracle_scenario`), cycling through
    the 2 x 4 policy pairs; the last quarter is the closed loop."""
    rng = np.random.default_rng(seed)
    q = n // len(ORACLE_KINDS)
    return [oracle_scenario(core, rng, ORACLE_KINDS[min(i // q, 3)], i)
            for i in range(n)]


def _oracle_lane(sc, ref, out, jm, sm, trace, i):
    """The first difference of lane ``i`` from the oracle's result
    ``ref`` (see :func:`oracle_diff`), or ``None``; and the largest
    relative difference of its compared times and metrics."""
    from repro_torch.core import telemetry
    worst = 0.0
    n = sc.total_tasks()
    ref_done = np.array([t.finish < math.inf for t in ref.tasks])
    eng_done = out["finish"][i, :n] < 1e30 / 2
    if not np.array_equal(ref_done, eng_done):
        return (f"unfinished tasks: engine {np.nonzero(~eng_done)[0]}, "
                f"refsim {np.nonzero(~ref_done)[0]}"), worst
    if not np.array_equal([t.shed for t in ref.tasks], out["shed"][i, :n]):
        return "shed sets differ", worst
    pairs = [(f, out[f][i, :n][ref_done],
              [getattr(t, f) for t, d in zip(ref.tasks, ref_done) if d])
             for f in ("start", "finish")]
    if all(d or t.shed for t, d in zip(ref.tasks, ref_done)):
        pairs.append(("finish_time", sm["finish_time"][i], ref.finish_time))
    for ji, jr in enumerate(ref.jobs):
        if all(t.finish < math.inf for t in ref.tasks if t.job == ji):
            pairs += [(f"job {ji} {f}", jm[f][i, ji], getattr(jr, f))
                      for f in ORACLE_FIELDS]
    for label, got, want in pairs:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = np.abs(got - want)
        bad = ~(err <= ORACLE_ATOL + ORACLE_RTOL * np.abs(want))
        if bad.any():
            return (f"{label}: engine {got[bad][:4]} vs refsim "
                    f"{want[bad][:4]}"), worst
        if err.size:
            worst = max(worst, float(np.max(err / np.maximum(np.abs(want),
                                                             1e-30))))
    for f in ORACLE_COUNTS:
        if int(sm[f][i]) != getattr(ref, f):
            return (f"{f}: engine {int(sm[f][i])} vs refsim "
                    f"{getattr(ref, f)}"), worst
    if trace is not None:
        kinds = trace.ev_kind[i, :int(trace.ev_n[i])]
        for k, name in telemetry.EVENT_NAMES.items():
            want = sum(1 for e in ref.events if e[1] == k)
            if int((kinds == k).sum()) != want:
                return (f"{name} events: engine {int((kinds == k).sum())} "
                        f"vs refsim {want}"), worst
    return None, worst


def oracle_diff(scenarios, refs, out, jm, sm, trace=None):
    """Hold an engine run of ``scenarios`` (stacked in order; ``out``,
    ``jm``, ``sm`` the ``SimOutput``, job and scenario metrics as host
    numpy dicts) against the sequential oracle's results ``refs``
    (``refsim.simulate`` of each), at the reference's own tolerances:

    * the tasks the oracle leaves unfinished (stranded, shed) are exactly
      those the engine leaves at the +inf stand-in, the shed sets equal;
    * the other tasks' start and finish at rtol 2e-4, atol 1e-2, and the
      finish time where no task is stranded;
    * every job whose tasks all finished: the paper's nine metrics at the
      same tolerance;
    * the closed loop's counts (failures, re-dispatches, scale events,
      shed tasks, preemptions) exactly;
    * with ``trace`` (host ``TraceBuffers``): the event log's count of each
      kind equal to the oracle's events of that kind (SHED as a count).

    Returns ``(worst, differs)``: the largest relative difference of a
    compared time or metric on the lanes that agree, and ``{lane: first
    difference}`` for the lanes that do not."""
    worst, differs = 0.0, {}
    for i, (sc, ref) in enumerate(zip(scenarios, refs)):
        msg, w = _oracle_lane(sc, ref, out, jm, sm, trace, i)
        if msg is None:
            worst = max(worst, w)
        else:
            differs[i] = msg
    return worst, differs


def bits(x):
    """A tensor's raw bits, so equality is bitwise (-0.0 != 0.0)."""
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def check_stress(device, control=False, trace=False, seed=0):
    """One instantiation against its plain version on ``KERNEL_LANES``
    admission-stress lanes (``tests/mr_stress.py``) per case of
    ``STRESS_CASES`` (one, two and three task-set words per VM;
    ``max_pes`` at, above and below the largest PE count), and on one
    lane of each open-loop stress kind at the large-fleet shape ``FLEET``
    (a lane takes a block of its own; under control the control data is
    degenerate: the control kinds at this size keep the plain version
    busy for minutes, ``tests/test_torch_cuda.py`` runs them); returns
    ``(max_abs_err, lanes checked)``."""
    import torch
    import mr_stress
    from repro_torch.kernels.mr_sched import megakernel as mk
    cases = [(T, d, KERNEL_LANES, mr_stress.V, control)
             for T, d in STRESS_CASES]
    cases.append((FLEET[0], 0, len(mr_stress.OPEN_KINDS), FLEET[1], False))
    worst = 0.0
    for T, pes_delta, n, V, control_kinds in cases:
        lanes, max_pes = mr_stress.stress_lanes(n, T, seed + T,
                                                control_kinds, V)
        x = [torch.tensor(a, device=device)
             for a in lanes[:28 if control else 13 + trace]]
        max_pes = max(1, max_pes + pes_delta)
        kern = mk.mr_epoch(*x, max_pes=max_pes, control=control, trace=trace)
        plain = mk.mr_epoch_plain(*x, max_pes=max_pes, control=control,
                                  trace=trace)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            mk.state_leaves(control, trace), kern, plain,
            f"T={T}, V={V}: {mk.instantiation(control, trace)} on stress "
            "lanes"))
    return worst, sum(c[2] for c in cases)


def phase_kernels(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """Open-loop kernel vs plain version on the card; returns the largest
    absolute difference seen (0.0 when every leaf is bitwise equal)."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.kernels.mr_sched import megakernel, ops
    worst, checked = 0.0, 0
    for T in ts:
        cols = fit_tasks(mixed_columns(lanes, seed + T, T), T)
        batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9,
                                  device=device)
        inputs = ops.kernel_inputs(batch)
        max_pes = ops.batch_max_pes(batch)
        kern = megakernel.mr_epoch(*inputs, max_pes=max_pes)
        plain = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes)
        torch.cuda.synchronize()
        worst = max(worst, compare(megakernel.STATE_LEAVES, kern, plain,
                                   f"T={T}: mr_epoch"))
        # resume: two calls split at epoch_limit against one call
        split = max(1, int(kern[7].max()) // 2)
        first = megakernel.mr_epoch(*inputs, max_pes=max_pes,
                                    epoch_limit=split)
        rest = megakernel.mr_epoch(inputs[0], inputs[1], None, *inputs[3:],
                                   state=first, max_pes=max_pes,
                                   epoch_limit=2 * T + 2 - split)
        compare(megakernel.STATE_LEAVES, rest, kern, f"T={T}: resumed")
        # the control instantiation on degenerate control data is the
        # open loop on the 8 shared leaves
        ctl = megakernel.mr_epoch(*inputs, *ops.control_lane_data(batch),
                                  max_pes=max_pes, control=True)
        compare(megakernel.STATE_LEAVES, ctl[:8], kern,
                f"T={T}: degenerate control")
        checked += lanes
    w, c = check_stress(device, seed=seed)
    return max(worst, w), checked + c


def phase_control_kernels(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """Control instantiation vs its plain version on closed-loop grids;
    returns ``(max_abs_err, lanes checked, totals of hit tasks, scale
    events, shed tasks and evictions)``."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.kernels.mr_sched import megakernel, ops
    worst, checked = 0.0, 0
    totals = np.zeros(4, np.int64)
    for T in ts:
        cols = fit_tasks(mixed_control_columns(lanes, seed + 100 + T, T), T)
        batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9,
                                  device=device)
        inputs = ops.kernel_inputs(batch) + ops.control_lane_data(batch)
        max_pes = ops.batch_max_pes(batch)
        kern = megakernel.mr_epoch(*inputs, max_pes=max_pes, control=True)
        plain = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes,
                                          control=True)
        torch.cuda.synchronize()
        worst = max(worst, compare(megakernel.STATE_LEAVES_CONTROL, kern,
                                   plain, f"T={T}: control mr_epoch"))
        split = max(1, int(kern[7].max()) // 2)
        first = megakernel.mr_epoch(*inputs, max_pes=max_pes,
                                    epoch_limit=split, control=True)
        rest = megakernel.mr_epoch(
            inputs[0], inputs[1], None, *inputs[3:], state=first,
            max_pes=max_pes, control=True,
            epoch_limit=megakernel.default_epoch_limit(T, 9, True) - split)
        compare(megakernel.STATE_LEAVES_CONTROL, rest, kern,
                f"T={T}: control resumed")
        totals += [int(kern[i].sum()) for i in (8, 11, 12, 13)]
        checked += lanes
    w, c = check_stress(device, control=True, seed=seed + 100)
    return max(worst, w), checked + c, totals


def phase_engine_j1(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """The engine body on phase 3's single-job grids (the lane sets of the
    open-loop and control ``mr_epoch`` checks): ``engine.
    simulate_batch_arrays(backend="engine")`` bitwise the kernel path's
    ``SimOutput`` on every field.  Returns one row per grid: ``(T,
    control, engine wall s, mr_epoch device ms, realized epochs)``, the
    kernel timed with :func:`launch_ms` (median of 3)."""
    import torch
    from repro_torch.core import engine, sweep
    from repro_torch.kernels.mr_sched import megakernel, ops
    rows = []
    for control in (False, True):
        for T in ts:
            cols = (mixed_control_columns(lanes, seed + 100 + T, T) if control
                    else mixed_columns(lanes, seed + T, T))
            batch = sweep.grid_arrays(fit_tasks(cols, T), pad_tasks=T,
                                      pad_vms=9, device=device)
            kern, _ = engine.simulate_batch_arrays(batch, control=control)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body, realized = engine.simulate_batch_arrays(
                batch, control=control, backend="engine")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            compare(engine.SimOutput._fields, body, kern,
                    f"T={T}: engine body vs mr_epoch"
                    + (" control" if control else ""))
            inputs = ops.kernel_inputs(batch) + (
                ops.control_lane_data(batch) if control else ())
            max_pes = ops.batch_max_pes(batch)
            k_ms = float(np.median(launch_ms([lambda: megakernel.mr_epoch(
                *inputs, max_pes=max_pes, control=control)] * 3)))
            rows.append((T, control, wall, k_ms, realized))
    return rows


def multijob_batch(control, seed, device):
    """A phase-14 batch: :data:`ENGINE_DISTINCT` seeded smart-city
    scenarios (:func:`multijob_scenarios`) encoded by ``sweep.stack_scenarios``
    at :data:`ENGINE_SHAPE`, tiled to :data:`ENGINE_LANES` lanes."""
    import repro_torch.core as core
    from repro_torch.core import engine, sweep
    T, J, V = ENGINE_SHAPE
    batch = sweep.stack_scenarios(
        multijob_scenarios(core, ENGINE_DISTINCT, seed, control=control),
        device=device, pad_tasks=T, pad_jobs=J, pad_vms=V)
    reps = ENGINE_LANES // ENGINE_DISTINCT
    if reps > 1:
        batch = engine.ScenarioArrays(*(
            x.repeat(reps, *([1] * (x.dim() - 1))) for x in batch))
    return batch


def phase_multijob(dev, control, seed):
    """Phase 14 on one batch: encode, the engine body through
    ``engine.simulate_batch_arrays`` untraced and traced (no ``mr_epoch``
    launch), metrics, compaction at K = 4 and ``"auto"``, and
    :data:`ENGINE_CPU` lanes again on the CPU; every check raises.
    Returns the measurements."""
    import torch
    from repro_torch.core import costmodel, engine
    from repro_torch.kernels.mr_sched import megakernel as mk
    fields = engine.SimOutput._fields
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    batch = multijob_batch(control, seed, dev)
    sync()
    r = dict(encode=time.perf_counter() - t0)
    N, T = batch.task_valid.shape
    before = mk.total_launches()
    t0 = time.perf_counter()
    out, realized = engine.simulate_batch_arrays(batch)
    sync()
    r["step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jm = engine.to_numpy(engine.job_metrics(batch, out))
    sm = engine.to_numpy(engine.scenario_metrics(batch, out))
    r["metrics"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_t, realized_t, buf = engine.simulate_batch_arrays(batch, trace=True)
    sync()
    r["traced"] = time.perf_counter() - t0
    if mk.total_launches() != before:
        raise AssertionError("a multi-job batch launched mr_epoch")
    compare(fields, out_t, out, "multi-job: traced vs untraced")
    if realized_t != realized:
        raise AssertionError("multi-job: traced realized_epochs differ")
    r["events"] = int(buf.ev_n.sum())
    if int((buf.ev_n > buf.ev_t.shape[1]).sum()):
        raise AssertionError("multi-job: the default event log dropped")
    bound = engine._lane_bound(batch) if control else 2 * T + 2
    if bool((out.n_epochs > bound).any()):
        raise AssertionError("multi-job: n_epochs above the lane bound")
    valid = batch.job_valid.cpu().numpy()
    for k, v in jm.items():
        if v.shape != valid.shape or not np.isfinite(v[valid]).all():
            raise AssertionError(f"multi-job: job metric {k} not finite")
    for k, v in sm.items():
        if v.shape != (N,) or not np.isfinite(v).all():
            raise AssertionError(f"multi-job: scenario metric {k}")
    r["totals"] = {k: int(sm[k].sum()) for k in (
        "failures_injected", "tasks_redispatched", "scale_events",
        "shed_tasks", "preemptions")}
    if control:
        idle = [k for k, v in r["totals"].items() if not v > 0]
        if idle:
            raise AssertionError(f"multi-job: the batch never fired {idle}")
    r["compact"] = {}
    cm = costmodel.default_cost_model(device=dev)
    for k in (4, "auto"):
        st = {}
        t0 = time.perf_counter()
        oc, rc = engine.simulate_batch_arrays_compact(batch, k=k, stats=st)
        sync()
        r["compact"][k] = (time.perf_counter() - t0, st)
        compare(fields, oc, out, f"multi-job: compact k={k} vs dense")
        if rc != realized:
            raise AssertionError(f"multi-job: compact k={k} realized")
    r["auto_k"] = cm.compact_interval(N, T)
    # the card's busy share of the first epochs (setup excluded)
    inv, c0 = engine._epoch_setup(batch, control=control)
    wall, kinds = device_breakdown(lambda: engine._drive(
        batch, inv, c0, ENGINE_PROFILED, control=control, trace=False))
    if not kinds:
        raise AssertionError("multi-job: the profiler saw no device time")
    r["profiled"] = (wall, sum(kinds.values()))
    idx = torch.arange(0, ENGINE_DISTINCT,
                       max(1, ENGINE_DISTINCT // ENGINE_CPU),
                       device=dev)[:ENGINE_CPU]
    sub = engine.ScenarioArrays(*(x.index_select(0, idx).cpu()
                                  for x in batch))
    t0 = time.perf_counter()
    oc, _, bc = engine.simulate_batch_arrays(sub, trace=True)
    r["cpu"] = time.perf_counter() - t0
    compare(fields, oc, [x.index_select(0, idx).cpu() for x in out],
            "multi-job: CPU vs card")
    compare(bc._fields, bc, [x.index_select(0, idx).cpu() for x in buf],
            "multi-job: CPU trace vs card")
    r.update(n=N, T=T, realized=realized, n_cpu=len(idx))
    return r


def multijob_line(label, r) -> str:
    """Phase 14's line of numbers for one batch."""
    T, J, V = ENGINE_SHAPE
    c4, ca = r["compact"][4], r["compact"]["auto"]
    return (f"multijob: {label} batch, {r['n']} lanes ({ENGINE_DISTINCT} "
            f"distinct smart-city scenarios tiled x"
            f"{ENGINE_LANES // ENGINE_DISTINCT}, T {T}, J {J}, V {V}) through "
            f"engine.simulate_batch_arrays (engine body, 0 mr_epoch "
            f"launches): encode {r['encode']!r} s, step {r['step']!r} s over "
            f"{r['realized']} realized epochs "
            f"({1e3 * r['step'] / max(r['realized'], 1)!r} ms per epoch), "
            f"metrics {r['metrics']!r} s, "
            f"{r['n'] / (r['step'] + r['metrics'])!r} lanes/s (step + "
            f"metrics); traced {r['traced']!r} s "
            f"({r['traced'] / r['step']!r}x untraced), SimOutput bitwise "
            f"untraced, 0 of {r['events']} events dropped; compact K=4 "
            f"{c4[0]!r} s ({c4[1]['dispatches']} rounds, "
            f"{c4[1]['compactions']} compactions), auto (K {r['auto_k']}) "
            f"{ca[0]!r} s ({ca[1]['dispatches']} rounds, "
            f"{ca[1]['compactions']} compactions), both bitwise dense; "
            f"{r['n_cpu']} lanes and their trace bitwise on the CPU "
            f"({r['cpu']!r} s); profiled first {ENGINE_PROFILED} epochs: "
            f"wall {r['profiled'][0]!r} s, device busy "
            f"{r['profiled'][1]!r} s "
            f"({r['profiled'][1] / r['profiled'][0]!r} of the wall) | "
            + ", ".join(f"{k} {v}" for k, v in r["totals"].items()))


def zero_launches():
    """Set every ``mr_epoch`` instantiation's launch count to 0."""
    from repro_torch.kernels.mr_sched import megakernel as mk
    for c in mk.LAUNCH_COUNTERS:
        setattr(mk.mr_epoch, c, 0)


def phase_oracle_paper(dev):
    """Phase 15 (a): Table IV through the port's ``refsim`` exactly at 3, 6
    and 9 VMs, and the Group 1-4 grids of ``tests/test_paper_validation.
    py`` through ``SweepPlan.run(device=dev)`` (the ``mr_epoch`` kernel),
    every cell against ``refsim`` at rtol 2e-4 (atol 1e-2) on makespan,
    network cost and the execution times, each group's stated shape on
    the engine's numbers.  Returns the measurements."""
    import torch
    from repro_torch.core import paper_scenario, refsim
    from repro_torch.core.sweep import axis, product
    from repro_torch.kernels.mr_sched import megakernel as mk
    r = dict(cells=0, refsim_s=0.0, worst=0.0)
    for v in (3, 6, 9):
        for m, want in TABLE_IV.items():
            got = refsim.simulate(paper_scenario(n_maps=m, n_vms=v)) \
                .job().network_cost
            if not abs(got - want) <= 5e-4:
                raise AssertionError(f"Table IV M{m} V{v}: {got} != {want}")
    ms = list(PAPER_M)
    plans = {
        "G1": (product(axis("network_delay", [True, False]),
                       axis("n_maps", ms)),
               lambda nd, m: dict(network_delay=nd, n_maps=m)),
        "G2": (product(axis("n_vms", [3, 6, 9]), axis("n_maps", ms)),
               lambda v, m: dict(n_vms=v, n_maps=m)),
        "G3": (product(axis("vm", ["small", "medium", "large"]),
                       axis("n_maps", ms)),
               lambda vm, m: dict(vm=vm, n_maps=m)),
        "G4": (product(axis("job", ["small", "medium", "big"]), n_maps=10),
               lambda job: dict(job=job, n_maps=10)),
    }
    res = {}
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g, (plan, _) in plans.items():
        res[g] = plan.run(device=dev)
    torch.cuda.synchronize()
    r["wall"] = time.perf_counter() - t0
    r["launches"] = mk.mr_epoch.launches
    if r["launches"] < len(plans):
        raise AssertionError("phase 15 (a) did not launch mr_epoch")
    for g, (plan, kw) in plans.items():
        for idx in np.ndindex(*plan.shape):
            labels = [plan.dims[k].labels[i][0] for k, i in enumerate(idx)]
            t0 = time.perf_counter()
            ref = refsim.simulate(paper_scenario(**kw(*labels))).job()
            r["refsim_s"] += time.perf_counter() - t0
            for f in ("makespan", "network_cost", "avg_exec", "max_exec",
                      "min_exec", "map_avg_exec", "reduce_avg_exec"):
                got, want = float(res[g][f][idx]), getattr(ref, f)
                if not abs(got - want) <= ORACLE_ATOL + ORACLE_RTOL * abs(
                        want):
                    raise AssertionError(f"{g} {labels} {f}: engine {got} "
                                         f"vs refsim {want}")
                r["worst"] = max(r["worst"], abs(got - want) / max(
                    abs(want), 1e-30))
            r["cells"] += 1
    # each group's stated shape, on the engine's numbers
    g1 = res["G1"]
    avg, mx, mn = (g1[f][0] for f in ("avg_exec", "max_exec", "min_exec"))
    if not (np.allclose(avg[:3], mx[:3], rtol=1e-6)
            and np.allclose(avg[:3], mn[:3], rtol=1e-6)):
        raise AssertionError("G1: avg == max == min fails for M <= V")
    if not (avg[0] > avg[1] > avg[2]
            and avg[5:].max() - avg[5:].min() < 0.10 * avg[0]):
        raise AssertionError("G1: execution time does not drop then flatten")
    if not mx[19] - mn[19] < mx[3] - mn[3]:
        raise AssertionError("G1: the max-min spread does not narrow")
    gaps = g1["makespan"][0][[0, 4, 19]] - g1["makespan"][1][[0, 4, 19]]
    if not (gaps[0] > gaps[1] > gaps[2] > 0
            and abs(gaps[0] - 2125.0) <= 1e-3 * 2125.0):
        raise AssertionError(f"G1: network delay gaps {gaps}")
    mavg = res["G2"]["map_avg_exec"]
    if not all(np.allclose(mavg[:, m], mavg[0, m], rtol=1e-6)
               for m in range(3)):
        raise AssertionError("G2: map phase differs across VMs for M <= 3")
    r["red6"] = float(np.mean(1 - mavg[1] / mavg[0]))
    r["red9"] = float(np.mean(1 - mavg[2] / mavg[0]))
    if not (abs(r["red6"] - 0.40) <= 0.03 and abs(r["red9"] - 0.50) <= 0.03):
        raise AssertionError(f"G2: reductions {r['red6']}, {r['red9']}")
    nc = res["G2"]["network_cost"]     # f32 schedules: equal to 1e-6
    if not np.allclose(nc, nc[0], rtol=1e-6, atol=0.0):
        raise AssertionError("G2: network cost varies with the VM count")
    small, med, large = res["G3"]["avg_exec"].mean(axis=1)
    r["med"], r["large"] = float(1 - med / small), float(1 - large / small)
    if not (abs(r["med"] - 0.60) <= 0.05 and abs(r["large"] - 0.80) <= 0.05):
        raise AssertionError(f"G3: reductions {r['med']}, {r['large']}")
    cost = res["G4"]["vm_cost"]
    r["cost"] = (float(cost[1] / cost[0]), float(cost[2] / cost[0]))
    if not (abs(r["cost"][0] - 2) <= 2e-6 and abs(r["cost"][1] - 4) <= 4e-6):
        raise AssertionError(f"G4: cost ratios {r['cost']}")
    return r


def phase_oracle_set(dev, scenarios, divergent, **pad):
    """Phase 15 (b) and (c): ``scenarios`` through the port's ``refsim`` on
    the host and, stacked by ``sweep.stack_scenarios``, through
    ``engine.simulate_batch_arrays`` on ``dev`` untraced and traced (the
    ``mr_epoch`` kernel for single-job lanes, the engine body for
    multi-job ones; the launch counts zeroed just before and read just
    after the untraced run), traced bitwise untraced, every lane held to
    the oracle by :func:`oracle_diff` with the trace's event counts.  The
    lanes that differ must be exactly ``divergent``: the lanes on which the
    JAX package's own engine and ``refsim`` differ (ROADMAP C10, pinned on
    the CPU by ``tests/test_torch_refsim.py``).  Returns the
    measurements."""
    import collections

    import torch
    from repro_torch.core import engine, refsim, sweep, telemetry
    from repro_torch.kernels.mr_sched import megakernel as mk
    r = dict(n=len(scenarios))
    t0 = time.perf_counter()
    refs = [refsim.simulate(s) for s in scenarios]
    r["refsim_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = sweep.stack_scenarios(scenarios, device=dev, **pad)
    torch.cuda.synchronize()
    r["encode_s"] = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    out, r["realized"] = engine.simulate_batch_arrays(batch)
    torch.cuda.synchronize()
    r["step_s"] = time.perf_counter() - t0
    r["launches"] = mk.total_launches()
    out_t, _, buf = engine.simulate_batch_arrays(batch, trace=True)
    compare(engine.SimOutput._fields, out_t, out, "oracle: traced vs "
            "untraced")
    tb = telemetry.to_numpy(buf)
    if (tb.ev_n > tb.ev_t.shape[1]).any():
        raise AssertionError("oracle: the event log dropped events")
    r["shape"] = tuple(batch.task_valid.shape) + (batch.job_valid.shape[1],
                                                 batch.vm_valid.shape[1])
    jm = engine.to_numpy(engine.job_metrics(batch, out))
    sm = engine.to_numpy(engine.scenario_metrics(batch, out))
    r["worst"], differs = oracle_diff(scenarios, refs, engine.to_numpy(out),
                                      jm, sm, tb)
    if sorted(differs) != sorted(divergent):
        extra = {i: differs[i] for i in sorted(set(differs) - set(divergent))}
        gone = sorted(set(divergent) - set(differs))
        raise AssertionError(f"oracle: lanes differ from refsim beyond the "
                             f"reference's own divergence: {extra}; pinned "
                             f"lanes that now agree: {gone}")
    r["differs"] = collections.Counter(m.split(":")[0]
                                       for m in differs.values())
    r["totals"] = {k: int(sm[k].sum()) for k in ORACLE_COUNTS}
    r["events"] = int(tb.ev_n.sum())
    return r


def oracle_line(label, r, smi) -> str:
    """Phase 15's line for one scenario set."""
    N, T, J, V = r["shape"]
    held = r["n"] - sum(r["differs"].values())
    return (f"oracle: {label}, {r['n']} scenarios (T {T}, J {J}, V {V}) on "
            f"{smi}: refsim {r['refsim_s']!r} s on the host "
            f"({r['n'] / r['refsim_s']!r} scenarios/s), encode "
            f"{r['encode_s']!r} s, engine step {r['step_s']!r} s "
            f"({r['realized']} realized epochs, mr_epoch launches "
            f"{r['launches']}); {held} lanes held to refsim at rtol "
            f"{ORACLE_RTOL}, atol {ORACLE_ATOL} (worst relative difference "
            f"{r['worst']!r}), counts exact, {r['events']} traced events "
            f"matching refsim's by kind, traced bitwise untraced; "
            f"{sum(r['differs'].values())} lanes differ exactly as the "
            f"reference's own engine and refsim do (C10), by first "
            f"difference {dict(r['differs'])} | "
            + ", ".join(f"{k} {v}" for k, v in r["totals"].items()))


def phase_oracle_training(dev):
    """Phase 15 (d): ``workload.step_scenario`` at 256 devices, sigma 0 (one
    lane of T = 257 tasks on 256 VMs), through the ``mr_epoch`` kernel on
    ``dev`` against the port's ``refsim``; ``simulate_training`` at 256
    devices with sigma 0.2 and an MTBF on the host.  Returns the
    measurements."""
    import torch
    from repro_torch.core import (ChipSpec, StepCost, engine, refsim, sweep,
                                  workload)
    from repro_torch.kernels.mr_sched import megakernel as mk
    chip = ChipSpec()
    cost = StepCost(**TRAIN_COST)
    sc, mult = workload.step_scenario(cost, chip, TRAIN_DEVICES)
    if mult is not None:
        raise AssertionError("sigma 0 gave straggler multipliers")
    ref = refsim.simulate(sc)
    batch = sweep.stack_scenarios([sc], device=dev)
    zero_launches()
    t0 = time.perf_counter()
    out, _ = engine.simulate_batch_arrays(batch)
    torch.cuda.synchronize()
    r = dict(step_s=time.perf_counter() - t0, launches=mk.mr_epoch.launches,
             T=int(batch.task_valid.shape[1]),
             V=int(batch.vm_valid.shape[1]))
    if r["launches"] != 1:
        raise AssertionError("the training step did not launch mr_epoch")
    jm = engine.to_numpy(engine.job_metrics(batch, out))
    sm = engine.to_numpy(engine.scenario_metrics(batch, out))
    r["worst"], differs = oracle_diff([sc], [ref], engine.to_numpy(out), jm,
                                      sm)
    if differs:
        raise AssertionError(f"training step vs refsim: {differs}")
    r["makespan"], r["ref_makespan"] = float(jm["makespan"][0, 0]), \
        ref.job().makespan
    t0 = time.perf_counter()
    r["train"] = workload.simulate_training(
        cost, chip, n_devices=TRAIN_DEVICES, n_steps=1000,
        straggler_sigma=0.2, mtbf_hours=TRAIN_MTBF_HOURS, seed=3)
    r["train_s"] = time.perf_counter() - t0
    t = r["train"]
    if not (0.0 < t["goodput"] <= 1.0 and t["expected_failures"] > 0
            and t["step_seconds"] >= t["ideal_step_seconds"]):
        raise AssertionError(f"simulate_training: {t}")
    return r


def streaming_dags(n, seed, n_ops=32, n_src=4):
    """``n`` seeded random feed-forward operator DAGs as numpy leaves of a
    :class:`~repro_torch.core.streaming.Topology` (topologically ordered):
    ``n_src`` sources at 10-2000 tuples/s, every other operator fed by 1-3
    earlier ones with weights 0.05-1 (each row scaled to sum at most 1),
    services of 1e-3-1 MI per tuple, parallelism 1-8 and the MIPS of the
    paper's three VM types."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n_ops, n_ops), np.float32)
    rows = np.arange(n)
    for j in range(n_src, n_ops):
        k = rng.integers(1, 4, n)
        order = rng.random((n, j)).argsort(axis=1)
        for s in range(min(3, j)):
            pick = k > s
            adj[rows[pick], order[pick, s], j] = rng.uniform(
                0.05, 1.0, int(pick.sum()))
    adj /= np.maximum(adj.sum(axis=2, dtype=np.float32), 1.0)[:, :, None]
    src = np.zeros((n, n_ops), np.float32)
    src[:, :n_src] = rng.uniform(10.0, 2000.0, (n, n_src))
    return (adj, src,
            rng.uniform(1e-3, 1.0, (n, n_ops)).astype(np.float32),
            rng.integers(1, 9, (n, n_ops)).astype(np.float32),
            rng.choice([250.0, 500.0, 1000.0], (n, n_ops)).astype(np.float32))


def smart_city_grid(device):
    """Phase 15 (e)'s smart-city batch: parallelism 1-16 on each of detect,
    aggregate and alert times 16 camera rates (250-4000 tuples/s): 65,536
    topologies of ``streaming.smart_city_topology``'s five operators."""
    import torch
    from repro_torch.core import streaming
    base = streaming.smart_city_topology(device=device)
    p = torch.arange(1, 17, dtype=torch.float32, device=device)
    cam = 250.0 * p
    grid = torch.cartesian_prod(p, p, p, cam)
    n = grid.shape[0]
    par = base.parallelism.repeat(n, 1)
    par[:, 2:5] = grid[:, :3]
    src = base.source_rate.repeat(n, 1)
    src[:, 0] = grid[:, 3]
    return streaming.Topology(
        adj=base.adj.repeat(n, 1, 1), source_rate=src,
        service_mi=base.service_mi.repeat(n, 1), parallelism=par,
        vm_mips=base.vm_mips.repeat(n, 1))


def phase_streaming(dev):
    """Phase 15 (e): ``streaming.analyze_batch`` on the card on the
    smart-city grid and on :data:`STREAM_DAGS` seeded 32-operator DAGs,
    each bitwise the same batch run on the CPU (``stable`` and
    ``bottleneck`` exact); the second of two runs timed.  Returns
    ``{name: (topologies, seconds, stable share)}``."""
    import torch
    from repro_torch.core import streaming
    batches = {
        "smart-city": smart_city_grid(dev),
        "dag32": streaming.Topology(*(
            torch.from_numpy(x).to(dev)
            for x in streaming_dags(STREAM_DAGS, seed=16))),
    }
    r = {}
    for name, topo in batches.items():
        streaming.analyze_batch(topo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = streaming.analyze_batch(topo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = streaming.analyze_batch(streaming.Topology(
            *(x.cpu() for x in topo)))
        for k, v in want.items():
            if not torch.equal(bits(got[k].cpu()), bits(v)):
                raise AssertionError(f"streaming {name}: {k} differs from "
                                     f"the CPU run")
        r[name] = (topo.adj.shape[0], wall,
                   float(want["stable"].float().mean()))
    return r


def vm_valid_lane(batch):
    """The open-loop trace's one control tensor."""
    import torch
    return batch.vm_valid.to(torch.int32).contiguous()


def phase_trace_kernels(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """Trace instantiations vs their plain versions on the lane sets of
    the phase-3 checks: all carry and trace leaves bitwise, the carry
    bitwise the untraced kernel's, and a run with an event log of half the
    median event count: kernel == plain, carry and time series == the full
    log's run, the kept rows its first rows, ``ev_n`` its count.  Returns
    ``(max_abs_err open, max_abs_err control, lanes checked, events,
    events dropped in the undersized runs)``."""
    import torch
    from repro_torch.core import engine, sweep
    from repro_torch.kernels.mr_sched import megakernel as mk, ops
    worst, checked, events, dropped = [0.0, 0.0], 0, 0, 0
    for T in ts:
        for control in (False, True):
            cols = (mixed_control_columns(lanes, seed + 100 + T, T) if control
                    else mixed_columns(lanes, seed + T, T))
            batch = sweep.grid_arrays(fit_tasks(cols, T), pad_tasks=T,
                                      pad_vms=9, device=device)
            inputs = ops.kernel_inputs(batch) + (
                ops.control_lane_data(batch) if control
                else (vm_valid_lane(batch),))
            max_pes = ops.batch_max_pes(batch)
            names = mk.state_leaves(control, True)
            what = f"T={T}: {mk.instantiation(control, True)}"
            kern = mk.mr_epoch(*inputs, max_pes=max_pes, control=control,
                               trace=True)
            plain = mk.mr_epoch_plain(*inputs, max_pes=max_pes,
                                      control=control, trace=True)
            torch.cuda.synchronize()
            worst[control] = max(worst[control],
                                 compare(names, kern, plain, what))
            n_carry = len(names) - len(mk.TRACE_LEAVES)
            untraced = mk.mr_epoch(*inputs[:len(inputs) - (not control)],
                                   max_pes=max_pes, control=control)
            compare(names, kern[:n_carry], untraced, f"{what} vs untraced")
            # an undersized event log
            ev_n = kern[-1][:, 0]
            E = max(1, int(ev_n.float().median()) // 2)
            st0 = mk.initial_state(
                inputs[0], inputs[2], inputs[3], inputs[4], inputs[9],
                inputs[10], inputs[16] if control else None,
                *engine._trace_caps(T, 9, control, True, E))
            small = mk.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                                control=control, trace=True)
            small_plain = mk.mr_epoch_plain(*inputs, state=st0,
                                            max_pes=max_pes, control=control,
                                            trace=True)
            compare(names, small, small_plain, f"{what}, E={E}")
            compare(names[:n_carry + 1], small[:n_carry + 1],
                    kern[:n_carry + 1], f"{what}, E={E} vs full log")
            compare(names[n_carry + 1:], small[n_carry + 1:-1],
                    [x[:, :E].contiguous() for x in kern[n_carry + 1:-1]],
                    f"{what}, E={E}: kept rows")
            if not torch.equal(small[-1], kern[-1]):
                raise AssertionError(f"{what}, E={E}: ev_n differs")
            over = (ev_n - E).clamp(min=0)
            if not int(over.sum()) > 0:
                raise AssertionError(f"{what}: the small log never overflowed")
            events += int(ev_n.sum())
            dropped += int(over.sum())
            checked += lanes
    for control in (False, True):
        w, c = check_stress(device, control, True, seed + 100 * control)
        worst[control] = max(worst[control], w)
        checked += c
    return worst[0], worst[1], checked, events, dropped


def phase_schedule_kernel(device, lanes=KERNEL_LANES, ts=KERNEL_TS, seed=0):
    """``mr_schedule`` vs its plain version on the phase-3 open-loop lane
    sets with both sched policies mixed; returns ``(max_abs_err, lanes)``."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.kernels.mr_sched import kernel, ops
    worst, checked = 0.0, 0
    for T in ts:
        cols = fit_tasks(mixed_columns(lanes, seed + T, T), T)
        cols["sched_policy"] = np.random.default_rng(seed + 200 + T).integers(
            0, 2, lanes).astype(np.int32)
        batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9, device=device)
        inputs = ops.kernel_inputs(batch)[:9]
        kern = kernel.mr_schedule(*inputs)
        plain = kernel.mr_schedule_plain(*inputs)
        torch.cuda.synchronize()
        worst = max(worst, compare(("start", "finish"), kern, plain,
                                   f"T={T}: mr_schedule"))
        checked += lanes
    return worst, checked


def compare(names, got, want, what):
    """Raise unless every leaf is bitwise equal; the largest absolute
    difference of the float leaves (0.0 when equal)."""
    import torch
    worst = 0.0
    for name, a, b in zip(names, got, want):
        if a.dtype == torch.float32:
            worst = max(worst, float((a - b).abs().max()))
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: leaf {name} differs")
    return worst


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


def layer_seconds(buckets, device, control=False):
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
        out = ops.epoch_schedule(batch, max_pes=max_pes, control=control)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.to_numpy(engine.job_metrics(batch, out))
        engine.to_numpy(engine.scenario_metrics(batch, out))
        t3 = time.perf_counter()
        enc, step, met = enc + t1 - t0, step + t2 - t1, met + t3 - t2
    return enc, step, met


def kernel_bound_ms(batch, n_epochs, max_pes, control=False, trace=None):
    """Least time the card could take for one ``mr_epoch`` call on this
    batch: the larger of its bytes over HBM bandwidth and its operations
    over the fp32 rate.  Bytes: each input read once, each output written
    once, 4 bytes each, at the padded widths the call is given.  Open
    loop, per lane: 4 T-wide + 3 scalar + 4 V-wide inputs, 5 T-wide + 3
    scalar carry leaves in and out.  Control: 8 T-wide + 11 scalar + 6
    V-wide inputs, 8 T-wide + 2 V-wide + 5 scalar carry leaves in and out.
    Operations, counted from the op sequence per realized epoch of a lane
    over its valid tasks and real VMs only (padding needs no work): open
    loop about 32 per task (rates, event times, the next-event min,
    completions, release, eligibility, starts), 6 per VM, and 6 per task
    per admission step on space-shared lanes; control about 100 per task
    (the same, plus the hook's counts, down-window gates, SHED/BOOST
    predicates, kills and the preemption extrema), 20 per VM, and 8 per
    task per admission step (the urgency tier); times this run's realized
    epochs per lane.

    ``trace=(C, E)``: a trace instantiation with C time-series rows and E
    event rows per lane.  Its bytes add the six trace leaves in and out
    (``C * 8 + 4 * E + 1`` words each way) and, on the open loop, the
    ``vm_valid`` input; its operations add the event log's ballot passes,
    about 4 per slot and pass (2 task passes open loop; 5 task and 2 VM
    passes under control)."""
    N, T = batch.task_vm.shape
    V = batch.vm_mips.shape[1]
    space = (batch.sched_policy != 0).double().cpu().numpy()
    nt = batch.task_valid.sum(dim=1).double().cpu().numpy()
    nv = batch.vm_valid.sum(dim=1).double().cpu().numpy()
    if control:
        nbytes = N * (4 * (8 * T + 11 + 6 * V) + 2 * 4 * (8 * T + 2 * V + 5))
        per_epoch = 100.0 * nt + 20.0 * nv + space * 8.0 * nt * max_pes
    else:
        nbytes = N * (4 * (4 * T + 3 + 4 * V) + 2 * 4 * (5 * T + 3))
        per_epoch = 32.0 * nt + 6.0 * nv + space * 6.0 * nt * max_pes
    if trace is not None:
        C, E = trace
        nbytes += N * (2 * 4 * (C * 8 + 4 * E + 1) + (0 if control else 4 * V))
        per_epoch = per_epoch + (20.0 * nt + 8.0 * nv if control
                                 else 8.0 * nt)
    ops = float((n_epochs.double().cpu().numpy() * per_epoch).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def spread(xs):
    """``median (min, max)`` of a list of readings, unrounded."""
    return f"{float(np.median(xs))!r} ({float(min(xs))!r}, " \
        f"{float(max(xs))!r})"


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


def cuda_once(fn):
    """``(ms, result)`` of one call of ``fn``, timed with CUDA events."""
    import torch
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def gpu_sample():
    """``(SM clock MHz, power draw W)`` of the card now (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    clock, power = (float(x) for x in out.split(","))
    return clock, power


def launch_ms(launches):
    """Device time of each closure of ``launches`` (each launches one
    kernel), in ms: CUDA events around the launch, queued behind a spin
    kernel (``torch.cuda._sleep``) that keeps the card busy while the host
    checks the arguments, allocates the outputs and issues the launch, so
    that none of this host work is counted.  A reading is kept only if the
    spin was still running when the closing event had been queued; else
    the launch is timed again behind a spin twice as long, and after three
    tries the run fails."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = []
    for f in launches:
        for attempt in range(3):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES << attempt)
            t0.record()
            f()
            t1.record()
            covered = not t0.query()
            torch.cuda.synchronize()
            if covered:
                break
        else:
            raise AssertionError("the host's work on a launch outlasted a "
                                 f"{SPIN_CYCLES << 2}-cycle spin three times")
        out.append(t0.elapsed_time(t1))
    return out


def kernel_times(launches, max_epochs):
    """Device time of a grid's kernels (``mr_epoch`` or ``mr_schedule``):
    ``launches`` holds one closure per bucket, each launching its kernel
    once on prepared inputs, and ``max_epochs`` each bucket's largest
    realized epoch count.
    A round times every closure with :func:`launch_ms` and sums the
    kernels' device times; ``TIMING_ROUNDS`` rounds after a warm-up pass.
    Returns ``ms``, the grid's device time in each round; ``epoch_ns``,
    each bucket's critical-lane epoch latency (its median device time over
    the rounds over its largest ``n_epochs``); ``clock`` and ``power``, an
    ``nvidia-smi`` sample after each round."""
    import torch
    for f in launches:
        f()
    torch.cuda.synchronize()
    res = dict(ms=[], buckets=[], clock=[], power=[])
    for _ in range(TIMING_ROUNDS):
        per = launch_ms(launches)
        clock, power = gpu_sample()
        res["ms"].append(sum(per))
        res["buckets"].append(per)
        res["clock"].append(clock)
        res["power"].append(power)
    med = np.median(np.asarray(res.pop("buckets")), axis=0)
    res["epoch_ns"] = list(med / np.asarray(max_epochs, np.float64) * 1e6)
    return res


def times_line(what, r):
    """The readings of :func:`kernel_times`, median (min, max), as a
    line."""
    return (f"kernel time: {what}: device {spread(r['ms'])} ms per grid "
            f"over {len(r['ms'])} rounds, critical-lane epoch latency "
            f"{spread(r['epoch_ns'])} ns over {len(r['epoch_ns'])} buckets, "
            f"SM clock {spread(r['clock'])} MHz, power draw "
            f"{spread(r['power'])} W")


def sweep_plan(cols, pad_tasks=None):
    """A one-axis plan over the cells of a column set."""
    from repro_torch.core import sweep
    n = len(cols["n_maps"])
    return sweep.product(sweep.Axis(("cell",), tuple(
        (i,) for i in range(n)), cols)).replace(pad_tasks=pad_tasks)


def phase_main(cols, dev, control=False, pad_tasks=None):
    """Drive ``SweepPlan.run(device=dev)`` on the grid twice (the
    kernels' launch counts zeroed just before the first run and read just
    after it), check its results, hold the kernel bitwise against its plain
    version on every bucket, then time the kernel (:func:`kernel_times`),
    its plain version and the layers bucket by bucket.  Returns the measurements."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.mr_sched import megakernel, ops
    n = len(cols["n_maps"])
    plan = sweep_plan(cols, pad_tasks)
    megakernel.mr_epoch.launches = 0
    megakernel.mr_epoch.control_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = plan.run(device=dev)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = (megakernel.mr_epoch.launches,
                megakernel.mr_epoch.control_launches)
    if launches[int(control)] < 1:
        raise AssertionError("the main path never launched its mr_epoch "
                             "instantiation")
    t0 = time.perf_counter()
    again = plan.run(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in result.metrics:
        if not np.array_equal(result[k], again[k]):
            raise AssertionError(f"main path not repeatable: {k}")
    for k in ("finish_time", "makespan", "utilization"):
        if not np.isfinite(result[k]).all():
            raise AssertionError(f"non-finite {k} in the main path")
    compiled, pad_t, pad_v = plan._compiled()
    buckets = bucket_batches(compiled, pad_t, pad_v, dev)
    p_ms = b_ms = by_ops = worst = 0.0
    runs, max_epochs = [], []
    leaves = megakernel.state_leaves(control)
    for idx, gcols, statics, tb, vb, batch, max_pes in buckets:
        inputs = ops.kernel_inputs(batch)
        if control:
            inputs = inputs + ops.control_lane_data(batch)
        st0 = megakernel.initial_state(
            inputs[0], inputs[2], inputs[3], inputs[4], inputs[9],
            inputs[10], inputs[16] if control else None)
        st = megakernel.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                                 control=control)
        bound = (engine._lane_bound(batch) if control
                 else torch.full_like(st[7][:, 0], 2 * tb + 2))
        if not ((st[7][:, 0] >= 1) & (st[7][:, 0] <= bound)).all():
            raise AssertionError(f"n_epochs outside [1, lane bound] at "
                                 f"T={tb}")
        if not np.array_equal(result["n_epochs"].reshape(-1)[idx],
                              st[7][:, 0].cpu().numpy()):
            raise AssertionError("the kernel's n_epochs differ from the run")
        ms, plain = cuda_once(lambda: megakernel.mr_epoch_plain(
            *inputs, state=st0, max_pes=max_pes, control=control))
        p_ms += ms
        worst = max(worst, compare(leaves, st, plain,
                                   f"T={tb}: main-path bucket"))
        runs.append(lambda inputs=inputs, st0=st0, max_pes=max_pes:
                    megakernel.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                                        control=control))
        max_epochs.append(int(st[7].max()))
        bound_ms, by = kernel_bound_ms(batch, st[7][:, 0], max_pes, control)
        b_ms += bound_ms
        by_ops += bound_ms if by == "operations" else 0.0
    times = kernel_times(runs, max_epochs)
    layers = layer_seconds(buckets, dev, control)
    return dict(result=result, buckets=buckets, launches=launches, plan=plan,
                wall_first=wall_first, wall=wall, times=times,
                k_ms=float(np.median(times["ms"])), p_ms=p_ms,
                worst=worst, b_ms=b_ms, bound_by="operations"
                if by_ops >= b_ms / 2 else "bytes", layers=layers, n=n)


def trace_identities(batch, out, buf, control):
    """Event counts of one traced bucket, checked against what its schedule
    says; returns the per-kind totals.  Each realized epoch has its row;
    the time series' kill/shed/eviction columns sum to those kinds'
    events; every finish is a FINISH event; open loop every start is a
    START event, under control there are at least as many STARTs as
    FINISHes and as tasks holding a start (a task is killed or evicted
    between its STARTs), and every re-dispatched task was killed or evicted
    at least once."""
    import torch
    from repro_torch.core import telemetry
    kinds = buf.ev_kind
    count = {name: int((kinds == k).sum())
             for k, name in telemetry.EVENT_NAMES.items()}
    valid = batch.task_valid
    if not torch.equal((buf.ts[:, :, 4] > 0).sum(dim=1, dtype=torch.int32),
                       out.n_epochs):
        raise AssertionError("time-series rows differ from n_epochs")
    cols = buf.ts.sum(dim=1)
    for col, name in ((5, "kill"), (6, "shed"), (7, "preempt")):
        if int(cols[:, col].sum()) != count[name]:
            raise AssertionError(f"time-series {name} column != events")
    finished = int((valid & (out.finish < 5e29)).sum())
    started = int((valid & (out.start < 5e29)).sum())
    if count["finish"] != finished:
        raise AssertionError("FINISH events != finished tasks")
    if not control and count["start"] != started:
        raise AssertionError("START events != started tasks")
    if control:
        hit = int((valid & out.hit).sum())
        if not (count["start"] >= max(finished, started)
                and hit <= count["kill"] + count["preempt"]):
            raise AssertionError("START/kill/preempt counts inconsistent")
    return count


def phase_traced(m, dev, control=False, seed=7):
    """Drive ``engine.simulate_batch_arrays(trace=True)`` over the main
    run's buckets (launch counts zeroed just before, read just after),
    check it, time it against the untraced driver (``TRACE_PASSES``
    alternating untraced and traced passes), hold the trace kernel bitwise
    against its plain version on every bucket (from a prepared carry),
    time the trace kernel (:func:`kernel_times`), the untraced kernel from the same carry and the plain version,
    and re-run ``CPU_CELLS`` cells on the CPU."""
    import torch
    from repro_torch.core import engine, telemetry
    from repro_torch.kernels.mr_sched import megakernel as mk, ops
    buckets, result, n = m["buckets"], m["result"], m["n"]
    for c in mk.LAUNCH_COUNTERS:
        setattr(mk.mr_epoch, c, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced = [engine.simulate_batch_arrays(b[5], control=control,
                                           max_pes=b[6], trace=True)
              for b in buckets]
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = (mk.mr_epoch.trace_launches,
                mk.mr_epoch.control_trace_launches)
    if launches[int(control)] != len(buckets) or mk.mr_epoch.launches \
            or mk.mr_epoch.control_launches:
        raise AssertionError(f"traced path launches {launches}, "
                             f"{len(buckets)} buckets")
    walls = ([], [])                      # untraced, traced
    plain_out = None
    for _ in range(TRACE_PASSES):
        for tr in (False, True):
            t0 = time.perf_counter()
            outs = [engine.simulate_batch_arrays(
                b[5], control=control, max_pes=b[6], trace=tr)[0]
                for b in buckets]
            torch.cuda.synchronize()
            walls[tr].append(time.perf_counter() - t0)
            plain_out = plain_out or outs
        del outs
    ratios = [t / u for u, t in zip(*walls)]
    totals = dict.fromkeys(telemetry.EVENT_NAMES.values(), 0)
    nbytes = 0
    p_ms = b_ms = by_ops = worst = 0.0
    runs, untraced_runs, max_epochs = [], [], []
    names = mk.state_leaves(control, True)
    chrome = None
    rng = np.random.default_rng(seed)
    n_cpu = 0
    for i, ((idx, gcols, statics, tb, vb, batch, max_pes), (out, _, buf),
            want) in enumerate(zip(buckets, traced, plain_out)):
        for f, a, b in zip(out._fields, out, want):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"traced SimOutput.{f} differs at T={tb}")
        if int(torch.as_tensor(buf.dropped_events).sum()):
            raise AssertionError(f"events dropped at T={tb}")
        for k, v in trace_identities(batch, out, buf, control).items():
            totals[k] += v
        nbytes += sum(x.numel() * x.element_size() for x in buf)
        if control and chrome is None:
            kills = (buf.ev_kind == telemetry.EV_KILL).sum(dim=1)
            if int(kills.max()) > 0:
                lane = int(kills.argmax())
                tr = telemetry.TraceResult(telemetry.to_numpy(
                    telemetry.TraceBuffers(*(x[lane] for x in buf))))
                doc = tr.to_chrome_trace()
                spans = sum(e["ph"] == "X" for e in doc["traceEvents"])
                if spans != tr.counts_by_kind(0)["start"]:
                    raise AssertionError("Chrome trace: spans != STARTs")
                chrome = (spans, tr.counts_by_kind(0)["kill"])
        # the trace kernel alone from a prepared carry: bitwise its plain
        # version; its times and bound
        inputs = ops.kernel_inputs(batch) + (
            ops.control_lane_data(batch) if control
            else (vm_valid_lane(batch),))
        caps = (buf.ts.shape[1], buf.ev_t.shape[1])
        st0 = mk.initial_state(inputs[0], inputs[2], inputs[3], inputs[4],
                               inputs[9], inputs[10],
                               inputs[16] if control else None, *caps)
        kern = mk.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                           control=control, trace=True)
        ms, plain = cuda_once(lambda: mk.mr_epoch_plain(
            *inputs, state=st0, max_pes=max_pes, control=control,
            trace=True))
        p_ms += ms
        worst = max(worst, compare(names, kern, plain,
                                   f"T={tb}: traced main-path bucket"))
        n_carry = len(st0) - len(mk.TRACE_LEAVES)
        runs.append(lambda inputs=inputs, st0=st0, max_pes=max_pes:
                    mk.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                                control=control, trace=True))
        untraced_runs.append(
            lambda inputs=inputs[:len(inputs) - (not control)],
            st=st0[:n_carry], max_pes=max_pes:
            mk.mr_epoch(*inputs, state=st, max_pes=max_pes,
                        control=control))
        max_epochs.append(int(out.n_epochs.max()))
        bound_ms, by = kernel_bound_ms(batch, out.n_epochs, max_pes, control,
                                       caps)
        b_ms += bound_ms
        by_ops += bound_ms if by == "operations" else 0.0
        # CPU_CELLS cells of every bucket's share on the CPU
        k = max(1, int(round(len(idx) * CPU_CELLS / n)))
        if i == len(buckets) - 1:
            k = max(1, min(len(idx), CPU_CELLS - n_cpu))
        pick = torch.as_tensor(np.sort(rng.choice(len(idx), min(k, len(idx)),
                                                  replace=False)))
        sub = engine.ScenarioArrays(*(x[pick.to(x.device)].cpu()
                                      for x in batch))
        c_out, _, c_buf = engine.simulate_batch_arrays(
            sub, control=control, max_pes=max_pes, trace=True)
        for f, a, b in zip(c_buf._fields, c_buf, buf):
            if not torch.equal(bits(a), bits(b[pick.to(b.device)].cpu())):
                raise AssertionError(f"CPU trace differs from the card: {f}")
        for f, a, b in zip(c_out._fields, c_out, out):
            if not torch.equal(bits(a), bits(b[pick.to(b.device)].cpu())):
                raise AssertionError(f"CPU traced {f} differs from the card")
        n_cpu += len(pick)
    # the event counts against the grid's metrics
    if control:
        for kind, metric in (("shed", "shed_tasks"),
                             ("preempt", "preemptions")):
            if totals[kind] != int(result[metric].sum()):
                raise AssertionError(f"{kind} events != {metric}")
        if totals["scale_open"] + totals["scale_close"] \
                != int(result["scale_events"].sum()):
            raise AssertionError("scale events != scale_events")
        if chrome is None:
            raise AssertionError("no closed-loop lane was killed")
    times = kernel_times(runs, max_epochs)
    u_times = kernel_times(untraced_runs, max_epochs)
    return dict(launches=launches, wall_first=wall_first,
                wall_untraced=walls[0], wall_traced=walls[1], ratios=ratios,
                totals=totals, nbytes=nbytes, times=times,
                k_ms=float(np.median(times["ms"])),
                u_ms=float(np.median(u_times["ms"])), p_ms=p_ms,
                worst=worst, b_ms=b_ms,
                bound_by="operations" if by_ops >= b_ms / 2 else "bytes",
                chrome=chrome, n_cpu=n_cpu)


def phase_report(m, dev):
    """``SweepPlan.run(report=True)`` on a main grid: metrics bitwise the
    main run's, the report's cells add up, its dispatches are the launches
    counted."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.kernels.mr_sched import megakernel as mk
    result, n = m["result"], m["n"]
    plan = m["plan"]
    before = mk.total_launches()
    torch.cuda.synchronize()
    res, rep = plan.run(device=dev, report=True)
    torch.cuda.synchronize()
    for k in result.metrics:
        if not np.array_equal(result[k], res[k]):
            raise AssertionError(f"run(report=True) changed {k}")
    if sum(b.cells for b in rep.buckets) != n or rep.n_cells != n:
        raise AssertionError("report cells do not add up to the grid")
    if rep.dispatches != mk.total_launches() - before \
            or rep.dispatches != sum(b.dispatches for b in rep.buckets):
        raise AssertionError("report dispatches != launches counted")
    return rep


COMPACT_K = 4            # the pinned compaction interval of phase 9
COMPACT_PASSES = 3       # timed passes of each path in phase 9


def phase_costmodel(dev):
    """``costmodel.default_cost_model()`` on the card: cached in the
    checkout beside the kernel builds (``src/repro_torch/kernels/_build/
    costmodel.json`` unless ``$REPRO_TORCH_COSTMODEL_PATH`` names another
    file), else measured now.  It must come from the card (``measured``
    or ``cache``), never from the fallback constants."""
    from repro_torch.core import costmodel
    os.environ.setdefault(costmodel.ENV_PATH, os.path.join(
        ROOT, "src", "repro_torch", "kernels", "_build",
        "costmodel.json"))
    t0 = time.perf_counter()
    cm = costmodel.default_cost_model(device=dev)
    if cm.source not in ("measured", "cache"):
        costmodel.measure(device=dev)       # raises what the default hid
        raise AssertionError(f"cost model source {cm.source!r}")
    if cm.device != costmodel.device_key(dev) or not (
            cm.dispatch_us > 0 and cm.epoch_lane_us > 0 and cm.sync_us > 0):
        raise AssertionError(f"cost model not of this card: {cm}")
    return cm, time.perf_counter() - t0


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def phase_compact(plan, dev, control=False):
    """``run(compact="auto")`` and ``run(compact=COMPACT_K)`` on a grid
    against its dense ``run()`` on the card (the ``mr_epoch`` launch
    counts zeroed just before each run and read just after): every metric,
    per-lane ``n_epochs`` and ``realized_epochs`` bitwise; the report's
    census (order pulls == compactions, count pulls == rounds + one per
    bucket, launches == rounds); then ``engine.simulate_batch_arrays_
    compact(legacy=True)`` and the lean loop on the grid's largest bucket,
    bitwise the dense ``simulate_batch_arrays``, the legacy loop with the
    lean loop's compactions and rounds and a mask pull per round.  Wall
    times: ``COMPACT_PASSES`` passes of each path in turn."""
    import torch
    from repro_torch.core import engine, sweep
    from repro_torch.kernels.mr_sched import megakernel as mk
    counter = "control_launches" if control else "launches"

    def run(**kw):
        for c in mk.LAUNCH_COUNTERS:
            setattr(mk.mr_epoch, c, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plan.run(device=dev, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, getattr(mk.mr_epoch, counter)

    dense, _, _ = run()
    walls = {"dense": [], "auto": [], "pinned": []}
    reps = {}
    for _ in range(COMPACT_PASSES):
        for name, kw in (("dense", {}), ("auto", {"compact": "auto"}),
                         ("pinned", {"compact": COMPACT_K})):
            out, wall, launches = run(report=True, **kw)
            walls[name].append(wall)
            res, rep = out
            if launches < 1:
                raise AssertionError(f"{name}: mr_epoch never launched")
            for k in dense.metrics:
                if not same_bits(dense[k], res[k]):
                    raise AssertionError(f"run({kw}) differs from the "
                                         f"dense run: {k}")
            if kw:
                rounds = sum(b.compact_rounds for b in rep.buckets)
                if rep.compaction_syncs != sum(b.compactions
                                               for b in rep.buckets):
                    raise AssertionError(f"{name}: syncs != compactions")
                if rep.scalar_syncs != rounds + rep.n_buckets:
                    raise AssertionError(f"{name}: scalar syncs != rounds "
                                         "+ one per bucket")
                if rep.dispatches != rounds or launches != rounds:
                    raise AssertionError(f"{name}: launches != rounds")
            reps[name] = rep
    # the legacy and lean loops on the largest bucket
    cols, pad_t, pad_v = plan._compiled()
    groups = sweep._bucket_groups(cols, pad_t, pad_v, "auto", None,
                                  device=dev)
    idx, gcols, statics, tb, vb = max(groups, key=lambda g: len(g[0]))
    batch = sweep.grid_arrays(gcols, pad_tasks=tb, pad_vms=vb,
                              static_params=statics, device=dev)
    want, rz = engine.simulate_batch_arrays(batch, control=control)
    loops = {}
    for legacy in (False, True):
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, grz = engine.simulate_batch_arrays_compact(
            batch, k=COMPACT_K, control=control, legacy=legacy, stats=st)
        torch.cuda.synchronize()
        loops[legacy] = (st, time.perf_counter() - t0)
        for name, a, b in zip(engine.SimOutput._fields, want, got):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"legacy={legacy}: {name} differs")
        if grz != rz:
            raise AssertionError(f"legacy={legacy}: realized_epochs")
    lean, legacy = loops[False][0], loops[True][0]
    if not (lean["syncs"] == lean["compactions"] > 0
            and lean["scalar_syncs"] == lean["dispatches"] + 1
            and legacy["compactions"] == lean["compactions"]
            and legacy["dispatches"] == lean["dispatches"]
            and legacy["syncs"] >= legacy["dispatches"]):
        raise AssertionError(f"bucket census: lean {lean}, legacy {legacy}")
    from repro_torch.core import costmodel
    k_auto = costmodel.default_cost_model(device=dev).compact_interval(
        len(idx), tb)
    return dict(n=plan.size, walls=walls, reps=reps, bucket=(len(idx), tb),
                loops=loops, realized=int(dense["realized_epochs"].max()),
                k_auto=k_auto)


def compact_line(label, r) -> str:
    n = r["n"]
    med = {k: float(np.median(v)) for k, v in r["walls"].items()}
    auto, pinned = r["reps"]["auto"], r["reps"]["pinned"]
    (lean, t_lean), (legacy, t_legacy) = r["loops"][False], r["loops"][True]
    return (
        f"compact: {label}, {n} cells in {auto.n_buckets} buckets: every "
        f"metric, n_epochs and realized_epochs (max {r['realized']}) "
        f"bitwise the dense run's for compact='auto' and "
        f"compact={COMPACT_K}; wall median (min, max) of "
        f"{COMPACT_PASSES} passes: dense {spread(r['walls']['dense'])} s "
        f"({n / med['dense']:.0f} scenarios/s), auto "
        f"{spread(r['walls']['auto'])} s ({n / med['auto']:.0f} "
        f"scenarios/s, {med['auto'] / med['dense']!r} of dense), "
        f"k={COMPACT_K} {spread(r['walls']['pinned'])} s "
        f"({n / med['pinned']:.0f} scenarios/s, "
        f"{med['pinned'] / med['dense']!r} of dense) | census auto: "
        f"launches {auto.dispatches}, order pulls {auto.compaction_syncs}, "
        f"count pulls {auto.scalar_syncs}; k={COMPACT_K}: launches "
        f"{pinned.dispatches}, order pulls {pinned.compaction_syncs}, count "
        f"pulls {pinned.scalar_syncs} | largest bucket ({r['bucket'][0]} "
        f"cells, T={r['bucket'][1]}, auto K {r['k_auto']}), "
        f"k={COMPACT_K}: lean loop "
        f"{t_lean!r} s {json.dumps(lean)}, legacy loop {t_legacy!r} s "
        f"{json.dumps(legacy)}, both bitwise simulate_batch_arrays")


def phase_schedule(m, dev):
    """``ops.schedule`` over the main grid's cells ``mr_schedule`` models
    (a static fleet: lease windows ``[0, 1e30)``, no spin-up, zero
    priorities), bucket by bucket (the launch count zeroed just before and
    read just after); their makespans against the main run's at the
    reference's tolerance, each bucket's ``(start, finish)`` bitwise the
    plain version's; the kernel's device time per grid
    (:func:`kernel_times`; a bucket's epochs counted as its lanes' most
    distinct event instants, a lower bound), the plain version's time and
    the bound; then :func:`check_schedule_lanes`."""
    import torch
    from repro_torch.kernels.mr_sched import kernel, ops
    compiled, pad_t, pad_v = m["plan"]._compiled()
    static = ((compiled["vm_start"] == 0).all(axis=1)
              & (compiled["vm_stop"] >= 1e30).all(axis=1)
              & (compiled["spinup_delay"] == 0)
              & (compiled["task_prio"] == 0).all(axis=1))
    cells = np.nonzero(static)[0]
    cols = {k: v[cells] for k, v in compiled.items()}
    buckets = bucket_batches(cols, pad_t, pad_v, dev)
    kernel.mr_schedule.launches = 0
    torch.cuda.synchronize()
    outs = [ops.schedule(b[5]) for b in buckets]
    torch.cuda.synchronize()
    launches = kernel.mr_schedule.launches
    if launches != len(buckets):
        raise AssertionError("ops.schedule did not launch mr_schedule")
    want = m["result"]["makespan"].reshape(-1)[cells]
    p_ms = b_ms = by_ops = worst = 0.0
    parts = np.zeros(2)                     # bytes, operations (ms)
    runs, max_epochs = [], []
    for (idx, gcols, statics, tb, vb, batch, _), (start, finish) in zip(
            buckets, outs):
        valid = batch.task_valid
        last = torch.where(valid, finish, torch.zeros_like(finish)).amax(1)
        span = (last - batch.job_submit[:, 0]).cpu().numpy()
        if not np.isfinite(span).all():
            raise AssertionError("non-finite mr_schedule makespan")
        np.testing.assert_allclose(span, want[idx], rtol=1e-4, atol=1e-2)
        inputs = ops.kernel_inputs(batch)[:9]
        ms, plain = cuda_once(lambda: kernel.mr_schedule_plain(*inputs))
        p_ms += ms
        worst = max(worst, compare(("start", "finish"), (start, finish),
                                   plain,
                                   f"T={tb}: mr_schedule on the main path"))
        runs.append(lambda inputs=inputs: kernel.mr_schedule(*inputs))
        epochs = event_instants(valid, start, finish)
        max_epochs.append(int(epochs.max()))
        bound_ms, by, part = schedule_bound_ms(batch, epochs)
        parts += part
        b_ms += bound_ms
        by_ops += bound_ms if by == "operations" else 0.0
    times = kernel_times(runs, max_epochs)
    w, checked = check_schedule_lanes(dev)
    return dict(n=len(cells), buckets=len(buckets), launches=launches,
                times=times, k_ms=float(np.median(times["ms"])), p_ms=p_ms,
                b_ms=b_ms, worst=max(worst, w), checked=checked, parts=parts,
                bound_by="operations" if by_ops >= b_ms / 2 else "bytes")


def check_schedule_lanes(device, seed=0):
    """``mr_schedule`` against its plain version on ``KERNEL_LANES``
    admission-stress lanes (``mr_stress.schedule_lanes``) at each T of
    ``STRESS_CASES``, and on one lane of each stress kind at each shape
    of ``SCHEDULE_LONG`` (T = 2048 on 9 VMs; 1500 VMs, whose task sets
    live in global scratch); returns ``(max_abs_err, lanes checked)``."""
    import torch
    import mr_stress
    from repro_torch.kernels.mr_sched import kernel
    cases = [(T, KERNEL_LANES, mr_stress.V) for T, _ in STRESS_CASES]
    cases += [(T, 2 * len(mr_stress.SCHEDULE_KINDS), V)
              for T, V in SCHEDULE_LONG]
    worst = 0.0
    for T, n, V in cases:
        x = [torch.tensor(a, device=device)
             for a in mr_stress.schedule_lanes(n, T, seed + T + V, V)]
        kern = kernel.mr_schedule(*x)
        plain = kernel.mr_schedule_plain(*x)
        torch.cuda.synchronize()
        worst = max(worst, compare(("start", "finish"), kern, plain,
                                   f"T={T}, V={V}: mr_schedule on stress "
                                   "lanes"))
    return worst, sum(c[1] for c in cases)


def event_instants(valid, start, finish):
    """Distinct instants among each lane's valid starts and finishes: the
    least number of epochs that lane realizes (each live epoch starts or
    finishes a task at its instant)."""
    import torch
    never = torch.full_like(start, 1e30)
    inst = torch.cat([torch.where(valid, start, never),
                      torch.where(valid, finish, never)], dim=1
                     ).sort(dim=1).values
    new = torch.ones_like(inst, dtype=torch.bool)
    new[:, 1:] = inst[:, 1:] != inst[:, :-1]
    return (new & (inst < 5e29)).sum(dim=1)


def schedule_bound_ms(batch, epochs):
    """Least time the card could take for one ``mr_schedule`` call: the
    larger of its bytes over HBM bandwidth and its operations over the
    fp32 rate.  Bytes, per lane: 5 T-wide + 2 scalar + 2 V-wide inputs,
    2 T-wide outputs, 4 bytes each, at the padded widths.  Operations per
    realized epoch of a lane, over its valid tasks and real VMs only:
    about 30 per task (rates, event times, the min, completions,
    eligibility, starts), 6 per VM, and on space-shared lanes 4 per
    ordered pair of tasks on one VM (the admission rank).  ``epochs``:
    each lane's :func:`event_instants`.  Returns the bound, what bounds
    it, and both times ``(bytes ms, operations ms)``."""
    import torch
    N, T = batch.task_vm.shape
    V = batch.vm_mips.shape[1]
    nbytes = N * 4 * (5 * T + 2 + 2 * V + 2 * T)
    valid = batch.task_valid
    onehot = (batch.task_vm[:, :, None] == torch.arange(
        V, device=valid.device)) & valid[:, :, None]
    pairs = (onehot.sum(dim=1).double() ** 2).sum(dim=1)
    space = (batch.sched_policy != 0).double()
    nt = valid.sum(dim=1).double()
    nv = batch.vm_valid.sum(dim=1).double()
    ops_n = float((epochs.double() * (30.0 * nt + 6.0 * nv
                                      + space * 4.0 * pairs)).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_n / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), \
        1e3 * np.array([t_bytes, t_ops])


def phase_cpu(m, control=False, seed=5):
    """Re-run ``CPU_CELLS`` cells drawn from every bucket of a main run on
    the CPU at the same bucket shapes; every metric must be bitwise the
    card's.  Returns the cell count."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.engine import JobMetrics, ScenarioMetrics
    result, buckets, n = m["result"], m["buckets"], m["n"]
    rng = np.random.default_rng(seed)
    n_checked = 0
    share = CPU_CELLS / n
    for i, (idx, gcols, statics, tb, vb, batch, max_pes) in enumerate(
            buckets):
        k = max(1, int(round(len(idx) * share)))
        if i == len(buckets) - 1:
            k = max(1, min(len(idx), CPU_CELLS - n_checked))
        pick = np.sort(rng.choice(len(idx), size=min(k, len(idx)),
                                  replace=False))
        sub = {c: v[pick] for c, v in gcols.items()}
        jm, sm, _ = sweep._run_batch(sub, tb, vb, statics, "torch",
                                     torch.device("cpu"), max_pes, control)
        for f in JobMetrics._fields:
            want = result.metrics[f].reshape(n, -1)[idx[pick]]
            if not np.array_equal(want.view(np.int32),
                                  jm[f].view(np.int32)):
                raise AssertionError(f"CPU run differs from the card: {f}")
        for f in ScenarioMetrics._fields:
            want = result.metrics[f].reshape(n)[idx[pick]]
            if not np.array_equal(want.view(np.int32),
                                  sm[f].view(np.int32)):
                raise AssertionError(f"CPU run differs from the card: {f}")
        n_checked += len(pick)
    return n_checked


# ---------------------------------------------------------------------------
# Phases 11-13, 16, 17: the LM serving path (flash_attention, wkv6; MoE
# and Mamba in plain tensor ops)
# ---------------------------------------------------------------------------

LM_BATCH = 4             # requests served at once
LM_PROMPT = 2048         # prompt tokens per request
LM_DECODE = 32           # greedy decode steps after the prefill
LM_ROUNDS = 11           # launch_ms rounds of wkv6's prefill and decode
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM, dense bf16 tensor cores (same)
FA_CHECK_SHAPES = [
    # (B, S, T, Hq, Hkv, Dh, causal, window, dtypes)
    # the five FA_SHAPES of tests/test_kernels.py, float32 and bfloat16
    (2, 128, 128, 4, 2, 32, True, None, ("float32", "bfloat16")),
    (1, 256, 256, 8, 8, 16, True, 64, ("float32", "bfloat16")),
    (2, 64, 64, 4, 1, 32, False, None, ("float32", "bfloat16")),
    (1, 128, 128, 2, 2, 64, True, None, ("float32", "bfloat16")),
    (1, 96, 96, 2, 1, 8, True, 32, ("float32", "bfloat16")),
    # yi-6b's prefill, and a sliding window at head_dim 128; in float32
    # too (the CUDA-core instantiation), at 2e-6 (|o| ~ 0.03-0.06 here)
    (4, 2048, 2048, 32, 4, 128, True, None, ("float32", "bfloat16")),
    (4, 2048, 2048, 32, 4, 128, True, 512, ("float32", "bfloat16")),
    # the prefills that phases 16 and 17 serve: mixtral-8x7b's windowed
    # (2 x 8192, 32/8 heads, window 4096) and jamba-v0.1-52b's (GQA 4)
    (2, 8192, 8192, 32, 8, 128, True, 4096, ("float32", "bfloat16")),
    (4, 2048, 2048, 32, 8, 128, True, None, ("float32", "bfloat16")),
]
# (B, H, T, hs): the four WKV_SHAPES of tests/test_kernels.py and rwkv6-3b's
# prefill, each with a non-zero initial state, r/k/v in float32 and bfloat16
WKV_CHECK_SHAPES = [(2, 3, 96, 16), (1, 2, 64, 8), (2, 1, 40, 4),
                    (1, 4, 128, 32), (4, 40, 2048, 64)]
# Kernel against plain version: flash 2e-6 (atol = rtol) in float32
# (summation order, tests/test_kernels.py's tolerance); in bfloat16 2 bf16
# ulps of |want| + 1e-4 (the output's rounding after the tensor cores'
# summation order and the hi/lo split of p; the 1e-4 floor is for outputs
# that cancel near zero); wkv6 1e-4 (atol = rtol) on y, which both forms
# return in float32 whatever the inputs' type (the kernel adds y's sum in
# partial sums over row groups), and its final state bitwise (the same
# elementwise multiply and add per entry in both).
FA_TOL = {"float32": 2e-6, "bfloat16": (2, 1e-4)}   # bf16: (ulps, atol)
WKV_TOL = 1e-4
# f32-activation serving checks at full width (atol = rtol): the same
# function through paths whose float32 sums run in other orders (flash
# tiles vs the dense scores; the plain scan vs the wkv6 kernel; a decode
# step's (B, 1) products vs the forward's (B, S)), compounded over 32
# layers, on logits of order 1.
LM_F32_TOL = 1e-3


def _close(got, want, tol):
    """``(largest |got - want|, largest |got - want| / (tol + tol |want|))``;
    raises unless the second is <= 1 and ``got`` is finite."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    share = float((diff / (tol + tol * want.abs())).max())
    if not share <= 1.0 or not bool(got.isfinite().all()):
        raise AssertionError(f"max |diff| {float(diff.max())} above "
                             f"tol {tol} (share {share})")
    return float(diff.max()), share


def _close_ulps(got, want, ulps, atol):
    """bf16: ``(largest |got - want|, largest (|got - want| - atol)^+ in
    bf16 ulps of |want|)``; raises unless the second is <= ``ulps`` and
    ``got`` is finite."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import bf16_ulp
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    over = (diff - atol).clamp_min(0.0)
    beyond = torch.where(over > 0, over / bf16_ulp(want),
                         torch.zeros_like(over))
    worst = float(beyond.max())
    if not worst <= ulps or not bool(got.isfinite().all()):
        raise AssertionError(f"max |diff| {float(diff.max())}: "
                             f"{worst} bf16 ulps beyond atol {atol} (tol "
                             f"{ulps} ulps)")
    return float(diff.max()), worst


def _worst(a, b):
    return (max(a[0], b[0]), max(a[1], b[1]))


def phase_lm_kernels(dev, seed=0):
    """Both LM kernels against their plain versions on the card (phase
    10); returns the largest differences ``({dtype: flash}, wkv6)`` and
    the bf16 flash cases' worst ulps beyond the atol floor."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rwkv6 import kernel as wk
    rng = np.random.default_rng(seed)
    worst_fa = {"float32": 0.0, "bfloat16": 0.0}
    worst_ulps = 0.0
    for B, S, T, Hq, Hkv, Dh, causal, window, dts in FA_CHECK_SHAPES:
        base = [rng.standard_normal(s).astype(np.float32) for s in
                ((B, S, Hq, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh))]
        for dt in dts:
            q, k, v = (torch.from_numpy(a).to(dev, getattr(torch, dt))
                       for a in base)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            try:
                if dt == "bfloat16":
                    err, ulps = _close_ulps(got, want, *FA_TOL[dt])
                    worst_ulps = max(worst_ulps, ulps)
                else:
                    err = _close(got, want, FA_TOL[dt])[0]
                worst_fa[dt] = max(worst_fa[dt], err)
            except AssertionError as e:
                raise AssertionError(f"flash_attention {dt} "
                                     f"{(B, S, T, Hq, Hkv, Dh, causal, window)}"
                                     f": {e}") from None
    worst_wkv = 0.0
    for B, H, T, hs in WKV_CHECK_SHAPES:
        r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)).astype(
            np.float32) for _ in range(3))
        w = rng.uniform(0.45, 0.95, (B, T, H, hs)).astype(np.float32)
        u = (0.3 * rng.standard_normal((H, hs))).astype(np.float32)
        s0 = (0.2 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
        w, u, s0 = (torch.from_numpy(a).to(dev) for a in (w, u, s0))
        for dt in (torch.float32, torch.bfloat16):
            rkv = [torch.from_numpy(a).to(dev, dt) for a in (r, k, v)]
            got = wk.wkv6_scan(*rkv, w, u, s0)
            want = wk.wkv6_scan_plain(*rkv, w, u, s0)
            try:
                worst_wkv = max(worst_wkv, _close(got[0], want[0],
                                                  WKV_TOL)[0])
            except AssertionError as e:
                raise AssertionError(f"wkv6 {dt} {(B, H, T, hs)} y: {e}"
                                     ) from None
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"wkv6 {dt} {(B, H, T, hs)}: the final "
                                     f"state differs from the plain version's")
    return worst_fa, worst_wkv, worst_ulps


def flash_bound_ms(q, k, causal, window):
    """The least time for flash attention on these shapes: q, k, v read
    and o written once at the HBM rate, against the attended (q, k) pairs'
    operations (QKᵀ and PV, 2 Dh each) at the dense bf16 tensor-core peak.
    Returns ``(ms, bound_by, bytes ms, operations ms)``."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qpos, kpos = np.arange(S)[:, None], np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    nbytes = q.element_size() * (2 * B * S * Hq * Dh + 2 * B * T * Hkv * Dh)
    ops = 4.0 * Dh * int(ok.sum()) * B * Hq
    return _bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)


def wkv6_bound_ms(r, w, s0):
    """The least time for the WKV6 recurrence on these inputs: r, k, v, w,
    u and s0 read and y and the state written once at the HBM rate,
    against the float32 operations the function needs at the fp32 rate.
    Per step and state entry that is 5: the y sum Σ_i r_i S_ij (multiply,
    add) and the update w_i S_ij + k_i v_j (two multiplies, an add).  The
    u term factors as v_j Σ_i r_i u_i k_i, so it costs 5 per step and
    column, not per entry: r·u·k (2), the sum over i (1), times v_j and
    into y_j (2)."""
    B, T, H, hs = r.shape
    nbytes = (3 * r.numel() * r.element_size() + w.numel() * w.element_size()
              + 4 * H * hs + 2 * 4 * s0.numel() + 4 * r.numel())
    ops = 5.0 * B * H * T * (hs * hs + hs)
    return _bound(nbytes, ops, FP32_OPS_PER_S)


def _bound(nbytes, ops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            1e3 * t_bytes, 1e3 * t_ops)


# Phases 12, 13, 16, 17: (depth cut or None, prompts, tokens per prompt)
SERVE = {
    "yi-6b": (None, LM_BATCH, LM_PROMPT),
    "rwkv6-3b": (None, LM_BATCH, LM_PROMPT),
    # 8 of 32 layers: 1.451 B f32 parameters a layer (46.4 GB) + 1.05 GB
    # of embedding and head; 2 x 8192 tokens, so the 4096 window bites in
    # the prefill and the 4096-slot ring cache wraps while decoding
    "mixtral-8x7b": (8, 2, 8192),
    # one 8-layer period (1 attention, 7 Mamba, 4 MoE, 4 dense MLP):
    # 12.76 B f32 parameters (51.0 GB) + 2.15 GB of embedding and head
    "jamba-v0.1-52b": (8, LM_BATCH, LM_PROMPT),
}
# Routing near-tie (ROADMAP C12): a top-k decision whose relative gap
# (p_j - p_j+1) / p_j, j <= k, is below this on the plain path may flip
# between two f32 paths that differ only in attention's summation order;
# the same size as the logits' tolerance LM_F32_TOL.
ROUTE_NEAR_TIE = 1e-3
# ... and at most this many such flips in a phase's compared prompts (C12):
# more is a kernel at fault, not summation order.
ROUTE_MAX_FLIPS = 4
# apply_moe against apply_moe_dense, drop-free, f32 (atol = rtol): the same
# routing by construction; the grouped and the per-expert products sum
# their 4096- and 14336-term dot products in other orders (outputs ~1).
MOE_DENSE_TOL = 1e-4
DROP_FREE_PROMPT = {"mixtral-8x7b": 8192, "jamba-v0.1-52b": 512}


def serve_config(name):
    """``(cfg, prompts, tokens per prompt)`` of a serve phase: the
    registry's config, depth cut only here."""
    from repro_torch import configs
    layers, batch, S = SERVE[name]
    cfg = configs.get(name)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return cfg, batch, S


def _serve(params, cfg, prompt, attn_impl):
    """Prefill the prompts, then ``LM_DECODE`` greedy decode steps (argmax
    over the real vocabulary).  Returns the logits of each step (prefill
    first), the generated tokens and the prefill and decode walls (card
    synchronised)."""
    import torch
    from repro_torch.models import decode_step, prefill
    S = prompt.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, state = prefill(params, cfg, prompt, _cache_len(cfg, S),
                        attn_impl=attn_impl)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, toks = [lg], []
    for i in range(LM_DECODE):
        tok = lg[:, :cfg.vocab].argmax(dim=-1)
        toks.append(tok)
        lg, state = decode_step(params, cfg, tok, state, S + i)
        logits.append(lg)
    torch.cuda.synchronize()
    return logits, torch.stack(toks, dim=1), t1 - t0, \
        time.perf_counter() - t1


def device_breakdown(fn):
    """Run ``fn`` once under ``torch.profiler``; returns its wall (card
    synchronised, profiler on) and the device seconds of its kernels (the
    profiler's device events, each counted once) by kind: the port's two
    LM kernels by name, ``matmul`` (cuBLAS/CUTLASS products), ``copy``
    (casts, copies, memcpy/memset) and ``other`` (elementwise, reductions,
    indexing, sorts).  Empty when the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("flash_attention" if "flash_attention" in name else
                "wkv6_bwd" if "wkv6_bwd_kernel" in name else
                "wkv6" if "wkv6_kernel" in name else
                "matmul" if any(t in name for t in (
                    "gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas"))
                else "copy" if "copy" in name or "memset" in name
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total * 1e-6
    return wall, kinds


def _fmt_breakdown(wall, kinds):
    busy = sum(kinds.values())
    if not busy:
        return f"wall {wall:.4f} s, device time not measured (the " \
               f"profiler saw no device event)"
    return (f"wall {wall:.4f} s, device busy {busy:.4f} s ("
            f"{busy / wall:.3f} of the wall): "
            + ", ".join(f"{k} {v:.4f} s" for k, v in
                        sorted(kinds.items(), key=lambda kv: -kv[1])))


def _check_decode(params, cfg, prompt, logits, gen, attn_impl):
    """Each decode step's logits against ``forward`` over prompt +
    generated tokens at its position, and the prefill's at the prompt's
    last; returns the worst ``_close`` pair."""
    from repro_torch.models import forward
    import torch
    S = prompt.shape[1]
    full = forward(params, cfg, torch.cat([prompt, gen], dim=1),
                   attn_impl=attn_impl)
    worst = _close(logits[0], full[:, S - 1], LM_F32_TOL)
    for i, lg in enumerate(logits[1:]):
        worst = _worst(worst, _close(lg, full[:, S + i], LM_F32_TOL))
    return worst


def sync_wall(fn):
    """Seconds of one call of ``fn``, card synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _sub(params, i):
    """Layer 0's parameters of sub-block ``i`` of the stack (views)."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda a: a[0], params["stack"][f"sub{i}"])


def _first(cfg, key, kind):
    """The first sub-block of the period whose ``key`` is ``kind``."""
    from repro_torch.models import stacks
    return next(i for i, e in enumerate(stacks._pattern_period(cfg))
                if e[key] == kind)


def routing(p, h, cfg):
    """One MoE layer's decisions on its input h (B, S, D): each token's
    experts (N, k) and whether each assignment is kept (N, k), and the
    smallest relative gap between consecutive probabilities among its
    first k + 1 (N,), on the host.  The experts and the ``keep`` flags are
    ``moe._route``'s and ``moe._dispatch``'s own."""
    import torch
    from repro_torch.models import moe
    k = cfg.moe.top_k
    xf = h.reshape(-1, h.shape[-1])
    N = xf.shape[0]
    _, idx = moe._route(p, xf, cfg)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[0]
    top = top[:, :k + 1]
    margin = ((top[:, :-1] - top[:, 1:]) / top[:, :-1]).amin(dim=-1)
    order, _, keep, _ = moe._dispatch(idx[None], cfg.moe.n_experts,
                                      moe.capacity(cfg, N))
    kept = torch.empty_like(keep[0])
    kept[order[0]] = keep[0]
    return (idx.cpu().numpy(), kept.reshape(N, k).cpu().numpy(),
            margin.cpu().numpy())


def drive_prefill(params, cfg, prompt, impl):
    """The prefill's forward, sub-block by sub-block as
    ``stacks.prefill_stack`` runs it (without the decode state): the last
    position's logits and each MoE layer's :func:`routing`."""
    from repro_torch.models import model, stacks
    from repro_torch.models.layers import apply_norm, lm_head
    x = model._embed(params, cfg, prompt)
    period = stacks._pattern_period(cfg)
    routes = []
    for li in range(stacks._n_periods(params["stack"])):
        for i, entry in enumerate(period):
            p = stacks._layer(params["stack"][f"sub{i}"], li)
            h = apply_norm(p["norm1"], x, cfg)
            x = x + stacks._apply_mixer(p["mixer"], h, cfg, entry, None,
                                        impl)
            h = apply_norm(p["norm2"], x, cfg)
            if entry["mlp"] == "moe":
                routes.append(routing(p["mlp"], h, cfg))
            x = x + stacks._apply_mlp_block(p["mlp"], h, cfg, entry)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_head(params["embed"], x[:, -1:], cfg)[:, 0], routes


def compare_routes(kernel, plain, S):
    """Rule C12 over the MoE layers in order, kernel path against plain
    path, for prompts of ``S`` tokens.  A token whose experts differ in a
    prompt still compared is a flip: it fails unless its plain-path margin
    is below ``ROUTE_NEAR_TIE``, and leaves its prompt out of the logits
    comparison; so does a token whose experts agree and whose ``keep``
    moved (capacity is shared by the whole batch).  More than
    ``ROUTE_MAX_FLIPS`` near-tie flips fail.  Differences in a prompt
    already left out are counted, not judged.  Returns the counts, the
    smallest plain-path margin and the prompts left out."""
    out = dict(flips=0, flip_margin=None, moved=0, downstream=0,
               margin=float("inf"), left_out=set())
    for layer, ((ik, kk, _), (ip, kp, mp)) in enumerate(zip(kernel, plain)):
        out["margin"] = min(out["margin"], float(mp.min()))
        seq = np.arange(ik.shape[0]) // S
        live = ~np.isin(seq, sorted(out["left_out"]))
        differs = (ik != ip).any(axis=1)
        bad = differs & live & (mp >= ROUTE_NEAR_TIE)
        if bad.any():
            t = int(np.flatnonzero(bad)[0])
            raise AssertionError(
                f"MoE layer {layer}: token {t} routed to {ip[t].tolist()} on "
                f"the plain path and {ik[t].tolist()} on the kernel path "
                f"with a relative margin of {float(mp[t])!r} (near-tie "
                f"limit {ROUTE_NEAR_TIE})")
        flip = differs & live
        moved = ~differs & live & (kk != kp).any(axis=1)
        if moved.any() and not differs.any():
            raise AssertionError(f"MoE layer {layer}: keep differs where "
                                 f"every token's experts agree")
        out["flips"] += int(flip.sum())
        if out["flips"] > ROUTE_MAX_FLIPS:
            raise AssertionError(
                f"MoE layer {layer}: {out['flips']} near-tie flips so far, "
                f"more than the {ROUTE_MAX_FLIPS} allowed")
        if flip.any():
            worst = float(mp[flip].max())
            out["flip_margin"] = max(out["flip_margin"] or 0.0, worst)
        out["moved"] += int(moved.sum())
        out["downstream"] += int((differs & ~live).sum())
        out["left_out"] |= {int(s) for s in seq[flip | moved]}
    return out


def kept_prompts(routes, B):
    """The prompts of ``B`` that rule C12 leaves in the logits comparison
    (``routes`` from :func:`compare_routes`); raises when none is left."""
    kept = [b for b in range(B) if b not in routes["left_out"]]
    if not kept:
        raise AssertionError(f"routing differences left all {B} prompts "
                             f"out of the logits comparison")
    return kept


def flash_times(q, k, v, window):
    """Times of flash at these inputs: the device time per launch
    (``launch_ms``, ``LM_ROUNDS`` rounds each) of the bf16 kernel,
    ``F.scaled_dot_product_attention`` (causal; with a window, an explicit
    boolean mask) with ``enable_gqa`` and the float32 instantiation; the
    plain version by ``cuda_ms`` (its thousands of launches fill the
    stream's queue behind a spin, which then blocks the host); and the
    largest |SDPA - kernel|.  Before timing, the bf16 kernel and the
    float32 instantiation are held to the plain version on these inputs
    at ``FA_TOL``; a disagreement raises."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(           # noqa
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(S, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(           # noqa
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    run = lambda: fa.flash_attention(q, k, v, causal=True,      # noqa
                                     window=window)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32 = lambda: fa.flash_attention(q32, k32, v32, causal=True,  # noqa
                                     window=window)
    plain = lambda x: fa.flash_attention_plain(                 # noqa
        *x, causal=True, window=window)
    shape = (tuple(q.shape), tuple(k.shape), window)
    try:
        out = {"err_bf16": _close_ulps(run(), plain((q, k, v)),
                                       *FA_TOL["bfloat16"]),
               "err_f32": _close(f32(), plain((q32, k32, v32)),
                                 FA_TOL["float32"])}
    except AssertionError as e:
        raise AssertionError(f"flash_attention at the served shape "
                             f"{shape}: {e}") from None
    out["lib_err"] = float((lib().transpose(1, 2).float()
                            - run().float()).abs().max())
    for key, fn in (("k", run), ("lib", lib), ("f32", f32)):
        fn()                                # warm up
        ts = [launch_ms([fn])[0] for _ in range(LM_ROUNDS)]
        out[f"{key}_times"] = ts
        out[f"{key}_ms"] = float(np.median(ts))
    out["p_ms"] = cuda_ms(lambda: plain((q, k, v)), 3)
    torch.cuda.empty_cache()
    return out


def phase_serve(name, dev, seed):
    """Serve the prompts of :data:`SERVE` (seeded tokens) through
    ``prefill`` and ``LM_DECODE`` greedy ``decode_step``s of the full-width
    config ``name`` (random weights from a seeded generator on the card,
    depth cut as stated there): phases 12 (yi-6b), 13 (rwkv6-3b), 16
    (mixtral-8x7b) and 17 (jamba-v0.1-52b).  Returns the measurements."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.models import (LM, attention, decode_step, moe,
                                    prefill, ssm)
    from repro_torch.models.layers import apply_norm, embed_tokens
    cfg, batch, S = serve_config(name)
    pattern = cfg.block_pattern()
    n_attn = sum(e["mixer"] == "attn" for e in pattern)
    rwkv = cfg.family == "ssm"
    routed = cfg.moe is not None
    impl = "auto" if rwkv else "flash"
    counter = wk.wkv6_scan if rwkv else fa.flash_attention
    out = {"cfg": cfg, "batch": batch, "S": S}
    qkv = None                  # layer 0's attention inputs, when timed
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        lm = LM(cfg, generator=torch.Generator(dev).manual_seed(seed),
                device=dev)
        params = lm.params
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in lm.parameters())
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, S))).to(dev)

        # warm-up (cuBLAS handles, allocator) on a short prompt
        prefill(params, cfg, prompt[:, :64], 66, attn_impl=impl)
        # the main path, bf16 activations: counts zeroed just before
        fa.flash_attention.launches = 0
        wk.wkv6_scan.launches = 0
        logits, gen, out["prefill_s"], out["decode_s"] = _serve(
            params, cfg, prompt, impl)
        out["launches"] = counter.launches
        out["other_launches"] = (fa.flash_attention.launches if rwkv
                                 else wk.wkv6_scan.launches)
        per_prefill = cfg.n_layers if rwkv else n_attn
        per_step = cfg.n_layers if rwkv else 0
        want = per_prefill + LM_DECODE * per_step
        if out["launches"] != want or out["other_launches"]:
            raise AssertionError(
                f"{name}: {counter.__name__} launched {out['launches']} "
                f"times (want {want}: {per_prefill} per prefill, {per_step}"
                f" per decode step), the other kernel "
                f"{out['other_launches']}")
        out["per_prefill"] = per_prefill
        if not all(bool(lg.isfinite().all()) for lg in logits):
            raise AssertionError(f"{name}: non-finite bf16 logits")
        out["gen"] = gen[0, :8].tolist()
        del logits

        # layer-0-style inputs: the embedded prompt through a sub-block's
        # first norm (its attention, Mamba or MoE parameters)
        x0 = embed_tokens(params["embed"], prompt, cfg)
        if rwkv:
            p0 = _sub(params, 0)
            h = apply_norm(p0["norm1"], x0, cfg)
            r, k, v, _, w = ssm._tmix_proj(p0["mixer"], h, ssm._shift(h),
                                           cfg)
            u = p0["mixer"]["u"].float()
            H, hs = ssm._rwkv_dims(cfg)
            s0 = torch.zeros((batch, H, hs, hs), device=dev)
            # a decode step's inputs are contiguous (B, 1, H, hs) products
            r1, k1, v1, w1 = (x[:, :1].contiguous() for x in (r, k, v, w))
            run = lambda: wk.wkv6_scan(r, k, v, w, u, s0)            # noqa
            plain = lambda: wk.wkv6_scan_plain(r, k, v, w, u, s0)    # noqa
            step = lambda: wk.wkv6_scan(r1, k1, v1, w1, u, s0)       # noqa
            out["lib_ms"] = None
            out["bound"] = wkv6_bound_ms(r, w, s0)
            run(), step()                          # warm up
            rounds = [launch_ms([run, step]) for _ in range(LM_ROUNDS)]
            out["k_times"], out["step_times"] = (list(x) for x in
                                                 zip(*rounds))
            out["k_ms"] = float(np.median(out["k_times"]))
            out["step_ms"] = float(np.median(out["step_times"]))
            out["p_ms"] = cuda_ms(plain, 1)
            del r, k, v, w, r1, k1, v1, w1
        elif name in ("yi-6b", "mixtral-8x7b"):
            # flash at its prefill shape, timed once the weights are freed
            p0 = _sub(params, 0)
            h = apply_norm(p0["norm1"], x0, cfg)
            pos = torch.arange(S, device=dev)[None, :]
            qkv = attention._qkv(p0["mixer"], h, cfg, pos)
            out["bound"] = flash_bound_ms(qkv[0], qkv[1], True, cfg.window)
        if routed:
            # one Mamba mixer and one MoE block on layer-0-style inputs
            if cfg.mamba is not None:
                pm = _sub(params, _first(cfg, "mixer", "mamba"))
                h = apply_norm(pm["norm1"], x0, cfg)
                out["mamba_s"] = sync_wall(
                    lambda: ssm.apply_mamba(pm["mixer"], h, cfg))
            pe = _sub(params, _first(cfg, "mlp", "moe"))
            h = apply_norm(pe["norm2"], x0, cfg)
            out["moe_s"] = sync_wall(lambda: moe.apply_moe(pe["mlp"], h,
                                                           cfg))
        del h, x0

        # where one prefill and one decode step spend the card's time
        box = {}
        out["prof_prefill"] = device_breakdown(lambda: box.update(
            st=prefill(params, cfg, prompt, _cache_len(cfg, S),
                       attn_impl=impl)[1]))
        out["prof_decode"] = device_breakdown(lambda: decode_step(
            params, cfg, gen[:, 0], box["st"], S))
        del box

        # float32 activations: the same weights, checked
        cfg32 = cfg.replace(dtype="float32")
        if routed:
            check_routed(out, params, cfg32, prompt, name)
        else:
            logits32, gen32, _, _ = _serve(params, cfg32, prompt, impl)
            if rwkv:
                ssm.wkv6_scan = wk.wkv6_scan_plain
                try:
                    ref, _ = prefill(params, cfg32, prompt, S)
                finally:
                    ssm.wkv6_scan = wk.wkv6_scan
            else:
                ref, _ = prefill(params, cfg32, prompt, S,
                                 attn_impl="dense")
            out["prefill_err"] = _close(logits32[0], ref, LM_F32_TOL)
            del ref
            out["decode_err"] = _check_decode(
                params, cfg32, prompt, logits32, gen32,
                "auto" if rwkv else "dense")
            out["logit_max"] = max(float(lg.abs().max()) for lg in logits32)
            del logits32
        del lm, params
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    if qkv is not None:
        with torch.inference_mode():
            out.update(flash_times(*qkv, cfg.window))
        del qkv
        torch.cuda.empty_cache()
    return out


def _cache_len(cfg, S):
    """The decode cache of a prompt of ``S`` tokens and ``LM_DECODE``
    steps (the window's size where the config has one)."""
    from repro_torch import configs
    return configs.decode_cache_len(cfg, S + LM_DECODE)


def check_routed(out, params, cfg32, prompt, name):
    """Checks (a)-(c) of phases 16 and 17, in float32 activations, into
    ``out``: (a) the prefill logits of the kernel path (flash's float32
    instantiation) against the plain path (``attn_impl="chunked"``) under
    rule C12, the kernel path's also against ``prefill``'s own; (b) a
    drop-free prefill of prompt 0 (:data:`DROP_FREE_PROMPT` tokens) and
    ``LM_DECODE`` steps against ``forward``; (c) ``apply_moe`` against
    ``apply_moe_dense``, drop-free, on prompt 0's layer-0-style inputs."""
    import dataclasses
    import torch
    from repro_torch.models import moe, prefill
    from repro_torch.models.layers import apply_norm, embed_tokens
    B, S = prompt.shape
    lg_k, routes_k = drive_prefill(params, cfg32, prompt, "flash")
    lg_p, routes_p = drive_prefill(params, cfg32, prompt, "chunked")
    ref, _ = prefill(params, cfg32, prompt, _cache_len(cfg32, S),
                     attn_impl="flash")
    out["drive_bitwise"] = bool(torch.equal(ref, lg_k))
    out["drive_err"] = _close(lg_k, ref, 1e-6)
    del ref
    rc = out["routes"] = compare_routes(routes_k, routes_p, S)
    out["n_routes"] = len(routes_k) * routes_k[0][0].shape[0]
    kept = kept_prompts(rc, B)
    out["prefill_err"] = _close(lg_k[kept], lg_p[kept], LM_F32_TOL)
    out["logit_max"] = float(torch.maximum(lg_k.abs().max(),
                                           lg_p.abs().max()))
    del lg_k, lg_p, routes_k, routes_p

    m = cfg32.moe
    free = cfg32.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    p0 = prompt[:1, :DROP_FREE_PROMPT[name]]
    logits, gen, _, _ = _serve(params, free, p0, "flash")
    out["decode_err"] = _check_decode(params, free, p0, logits, gen,
                                      "flash")
    out["drop_free_tokens"] = p0.shape[1]
    del logits

    pe = _sub(params, _first(free, "mlp", "moe"))
    h = apply_norm(pe["norm2"], embed_tokens(params["embed"], prompt[:1],
                                             free), free)
    out["dense_err"] = _close(moe.apply_moe(pe["mlp"], h, free),
                              moe.apply_moe_dense(pe["mlp"], h, free),
                              MOE_DENSE_TOL)
    out["dense_tokens"] = h.shape[1]
    del h


def _flash_readings(r) -> str:
    """flash's launch_ms readings of a serve phase, as text."""
    bound, bound_by, b_bytes, b_ops = r["bound"]
    rate = b_ops / r["k_ms"] * BF16_TENSOR_OPS_PER_S / 1e12
    return (f"vs flash_attention_plain on these inputs: bf16 max |diff| "
            f"{r['err_bf16'][0]} ({r['err_bf16'][1]:.3f} ulps beyond "
            f"{FA_TOL['bfloat16'][1]}, tol {FA_TOL['bfloat16'][0]}), f32 "
            f"max |diff| {r['err_f32'][0]} (share of tol "
            f"{FA_TOL['float32']}: {r['err_f32'][1]:.3f}); "
            f"kernel {r['k_ms']:.4f} ms device per launch (launch_ms, "
            f"median (min, max) of {len(r['k_times'])}: "
            f"{spread(r['k_times'])}; {rate:.1f} TFLOP/s of the "
            f"function's operations, {bound / r['k_ms']:.4f} of the "
            f"bound), plain {r['p_ms']:.4f} ms (cuda_ms), "
            f"F.scaled_dot_product_attention("
            + ("is_causal" if r["cfg"].window is None
               else f"boolean window mask {r['cfg'].window}")
            + f", enable_gqa) {r['lib_ms']:.4f} ms device "
            f"({spread(r['lib_times'])}; kernel / SDPA "
            f"{r['k_ms'] / r['lib_ms']:.2f}; max |SDPA - kernel| "
            f"{r['lib_err']}), f32 instantiation {r['f32_ms']:.4f} ms "
            f"device ({spread(r['f32_times'])}), bound {bound:.4f} ms "
            f"({bound_by}; bytes {b_bytes:.4f} ms, operations "
            f"{b_ops:.4f} ms), kernel / bound {r['k_ms'] / bound:.2f}")


def _serve_head(label, name, r) -> str:
    from repro_torch import configs
    cfg = r["cfg"]
    ntok = r["batch"] * r["S"]
    full = configs.get(name).n_layers
    depth = ("" if cfg.n_layers == full
             else f" (depth cut to {cfg.n_layers} of {full} layers)")
    return (f"{label}: {name} at full width{depth}, "
            f"{r['param_bytes'] / 1e9:.2f} GB of f32 parameters drawn in "
            f"{r['init_s']:.2f} s; {r['batch']} x {r['S']}-token prompts "
            f"+ {LM_DECODE} greedy steps, bf16: prefill "
            f"{r['prefill_s']:.4f} s = {ntok / r['prefill_s']:.0f} "
            f"tokens/s, decode {r['decode_s']:.4f} s = "
            f"{r['batch'] * LM_DECODE / r['decode_s']:.1f} tokens/s "
            f"({1e3 * r['decode_s'] / LM_DECODE:.2f} ms per step), first "
            f"tokens {r['gen']}; peak {r['peak_gb']:.2f} GB allocated "
            f"before the kernel timings; ")


def _prof_tail(r) -> str:
    return (f" | profiled bf16 prefill: {_fmt_breakdown(*r['prof_prefill'])}"
            f"; one decode step: {_fmt_breakdown(*r['prof_decode'])}")


def serve_line(label, name, r) -> str:
    """Phase 12's or 13's line of numbers, from ``phase_serve``'s result."""
    kname = "flash_attention" if name == "yi-6b" else "wkv6"
    if name == "yi-6b":
        kernel = _flash_readings(r)
    else:
        bound, bound_by, b_bytes, b_ops = r["bound"]
        rate = b_ops / r["k_ms"] * FP32_OPS_PER_S / 1e12
        kernel = (f"kernel {r['k_ms']:.4f} ms device per launch (launch_ms,"
                  f" median (min, max) of {len(r['k_times'])}: "
                  f"{spread(r['k_times'])}; {rate:.1f} TFLOP/s of the "
                  f"function's operations, {bound / r['k_ms']:.4f} of the "
                  f"bound), plain {r['p_ms']:.4f} ms, one decode step's "
                  f"launch (T = 1) {r['step_ms']:.4f} ms device "
                  f"({spread(r['step_times'])}), bound {bound:.4f} ms "
                  f"({bound_by}; bytes {b_bytes:.4f} ms, operations "
                  f"{b_ops:.4f} ms), kernel / bound {r['k_ms'] / bound:.2f}")
    return (_serve_head(label, name, r)
            + f"{kname} launches {r['launches']} (other LM kernel "
            f"{r['other_launches']}); on layer 0's prefill inputs: {kernel}"
            f" | f32 activations: prefill logits vs "
            + ("attn_impl='dense'" if name == "yi-6b"
               else "the plain _wkv_scan path")
            + f" max |diff| {r['prefill_err'][0]} (share of tol "
            f"{r['prefill_err'][1]:.3f}), each decode step and the prefill "
            f"vs forward over prompt + generated tokens max |diff| "
            f"{r['decode_err'][0]} (share {r['decode_err'][1]:.3f}), max "
            f"|logit| {r['logit_max']:.4f}, tol {LM_F32_TOL}"
            + _prof_tail(r))


def routed_line(label, name, r) -> str:
    """Phase 16's or 17's line of numbers, from ``phase_serve``'s result."""
    cfg, rc = r["cfg"], r["routes"]
    walls = (f"one MoE block {r['moe_s']:.4f} s"
             + (f", one Mamba mixer {r['mamba_s']:.4f} s ({r['S']} steps "
                f"of its time loop)" if "mamba_s" in r else ""))
    flash = (f"; flash at ({r['batch']}, {r['S']}, {cfg.n_heads}/"
             f"{cfg.n_kv_heads}, {cfg.head_dim}, window {cfg.window}) on "
             f"layer 0's prefill inputs: {_flash_readings(r)}"
             if "k_ms" in r else "")
    pe = r["prefill_err"]
    left = sorted(rc["left_out"])
    kept = [b for b in range(r["batch"]) if b not in rc["left_out"]]
    return (_serve_head(label, name, r)
            + f"flash_attention launches {r['launches']} ({r['per_prefill']}"
            f" per prefill, 0 per decode step; wkv6 {r['other_launches']})"
            f"; wall on layer-0-style inputs, card synchronised: {walls}"
            f"{flash} | f32 activations: (a) kernel path (flash f32) vs "
            f"plain path (chunked), {r['n_routes']} routings: smallest "
            f"top-k margin {rc['margin']!r}, near-tie flips {rc['flips']} "
            f"(at most {ROUTE_MAX_FLIPS}; largest margin among them "
            f"{rc['flip_margin']!r}, limit {ROUTE_NEAR_TIE}), keep moved "
            f"{rc['moved']}, differences in left-out prompts "
            f"{rc['downstream']}, prompts left out {left}; prefill logits "
            f"of prompts {kept} max |diff| {pe[0]} (share of tol "
            f"{pe[1]:.3f}), max |logit| {r['logit_max']:.4f}, tol {LM_F32_TOL}; the "
            f"driven kernel path vs prefill's logits max |diff| "
            f"{r['drive_err'][0]} (bitwise {r['drive_bitwise']}) | (b) "
            f"drop-free (capacity_factor = n_experts / top_k): prompt 0's "
            f"{r['drop_free_tokens']} tokens + {LM_DECODE} steps vs forward"
            f" max |diff| {r['decode_err'][0]} (share "
            f"{r['decode_err'][1]:.3f}) | (c) apply_moe vs apply_moe_dense,"
            f" drop-free, {r['dense_tokens']} tokens, f32: max |diff| "
            f"{r['dense_err'][0]} (share of tol {MOE_DENSE_TOL}: "
            f"{r['dense_err'][1]:.3f})" + _prof_tail(r))


# ---------------------------------------------------------------------------
# Phase 18: training rwkv6-3b through wkv6 and wkv6_bwd
# ---------------------------------------------------------------------------

TRAIN_ARCH = "rwkv6-3b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512   # (c): 4 x 512 tokens a step
TRAIN_STEPS = 4                   # (c): train() steps at full depth
TRAIN_CUT = 2                     # (b): layers at full width, f32
TRAIN_LR = 1e-3


def wkv_bwd_check_shapes(K):
    """Phase 18 (a)'s (B, H, T, hs, s0 and gs non-zero): rwkv6-3b's layer-0
    training shape as the model calls it (s0 zeros, the final state unused)
    and with both non-zero, T = 200 and T = 1; the T around the forward's
    kept-state interval K (``kernel.CHUNK``: K - 1, K, K + 1, 64 + K + 1)
    and T = 203, a multiple of neither K nor 64, each with zero and
    non-zero s0 and gs; the smaller head sizes.  r/k/v go in float32 and
    bfloat16 each."""
    return ([(4, 40, 512, 64, False), (4, 40, 512, 64, True),
             (2, 8, 200, 64, True), (2, 8, 1, 64, True)]
            + [(2, 8, T, 64, nz) for T in (K - 1, K, K + 1, 64 + K + 1, 203)
               for nz in (False, True)]
            + [(2, 3, 77, 16, True), (1, 4, 130, 32, True)])


# wkv6_bwd against wkv6_bwd_plain (atol = rtol): gr, gk, gw, gv are hs-term
# sums over a row or a column taken in another order (the kernel adds in
# index order, torch's reductions in a tree), gu a sum over B x T terms;
# the state's gradient G evolves by elementwise ops only, so gs0 is
# compared bitwise.  WKV6 against autograd through wkv6_scan_plain the
# same.
WKV_BWD_TOL = 1e-4
# (b) kernel path against the plain wkv6 forward and backward, one AdamW
# step in float32.  The loss at rtol 1e-5.  The grad norm at rtol 5e-4: at
# the first steps of a sequence the state is nearly empty, a head's y has a
# variance of 1e-8 to 1e-6 against the group norm's eps of 1e-5, and the
# norm's backward there turns y's summation-order difference (~1e-7
# relative) into gradient differences of up to 1.4e-3 relative at t = 0
# and 1; the grad norm moved by 8.1e-5 relative on an H100 (700 W),
# while wkv6_bwd and wkv6_bwd_plain on the same inputs and gy agree to
# ~1e-7 relative, which is checked at TRAIN_WKV_RTOL on layer 0's own call
# (norms of the differences over the norms).  The parameters at atol 1e-6,
# rtol 1e-5 but for at most TRAIN_BEYOND of them, all within 2.2 lr: AdamW
# divides each gradient element by its own RMS, so a gradient near zero
# can move its weight by up to lr either way (tests/test_torch_train.py
# measures the same on the CPU).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 5e-4
TRAIN_WKV_RTOL = 1e-5
TRAIN_BEYOND = 1e-4


def _plain_wkv6():
    """wkv6's plain forward and backward on the card, as an autograd
    Function: the reference path of phase 18 (b)."""
    import torch
    from repro_torch.kernels.rwkv6 import kernel as wk

    class PlainWKV6(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u, s0):
            ctx.save_for_backward(r, k, v, w, u, s0)
            return wk.wkv6_scan_plain(r, k, v, w, u, s0)

        @staticmethod
        def backward(ctx, gy, gs):
            r, k, v, w, u, s0 = ctx.saved_tensors
            g = wk.wkv6_bwd_plain(r, k, v, w, u, s0, gy, gs)
            return (g[0].to(r.dtype), g[1].to(k.dtype), g[2].to(v.dtype),
                    g[3], g[4], None if s0 is None else g[5])

    def scan(r, k, v, w, u, s0=None):
        return PlainWKV6.apply(r, k, v, w.float(), u.float(), s0)
    return scan


def wkv6_bwd_bound_ms(r, gs):
    """The least time for wkv6's gradient on these inputs: r, k, v, w, gy,
    u, the initial state s0 and gs read and gr, gk, gv, gw (float32), gu
    and gs0 written once at the HBM rate, against 14 float32 operations
    per step and state entry at the fp32 rate: 3 in the replay of the
    state (k v, w S, +), 10 in the walk (G S, G v and gy S: a multiply and
    an add each; k G; w G + r gy: three) and 1 in the column sum of k G
    (the per-step row terms, r u k, gy·v and the u terms, are O(hs) and
    left out).  The states the forward keeps are not counted: the replay's
    operations already stand for them, and how many are kept is the
    design's choice, not the function's."""
    B, T, H, hs = r.shape
    n = r.numel()
    nbytes = (3 * n * r.element_size() + 2 * 4 * n + 4 * H * hs
              + 4 * B * H * hs * hs + (0 if gs is None else 4 * gs.numel())
              + 4 * 4 * n + 4 * H * hs + 4 * B * H * hs * hs)
    ops = 14.0 * B * H * T * hs * hs
    return _bound(nbytes, ops, FP32_OPS_PER_S)


def ptxas_report(library, entry):
    """``{mangled name: its ptxas lines}`` (registers; stack frame and
    spills) of a built library's entry functions whose name holds
    ``entry``."""
    from repro_torch.kernels import _build
    out, name = {}, None
    for ln in _build.build_log(library).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and entry in name and ("Used" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.replace("ptxas info", "")
                                            .strip(" :"))
    return out


def _wkv_grad_inputs(B, H, T, hs, nonzero, rng, dev):
    import torch
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.45, 0.95, (B, T, H, hs)).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hs))).astype(np.float32)
    gy = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    gs = (0.5 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)           # noqa: E731
    return ([r, k, v], t(w), t(u), t(s0) if nonzero else None, t(gy),
            t(gs) if nonzero else None)


def phase_train_kernels(dev, seed=0):
    """Phase 18 (a): ``wkv6_bwd`` against ``wkv6_bwd_plain`` on the card
    (``wkv_bwd_check_shapes``, r/k/v float32 and bfloat16), bitwise the
    same on a second run, ``WKV6`` against ``torch.autograd`` through
    ``wkv6_scan_plain``; then the kernel's device time at rwkv6-3b's
    training shape (bf16, as the model calls it) beside its bound and the
    plain version's, and the forward's with and without the kept
    states."""
    import torch
    from repro_torch.kernels.rwkv6 import kernel as wk
    rng = np.random.default_rng(seed)
    worst, share, cases = 0.0, 0.0, 0
    shapes = wkv_bwd_check_shapes(wk.CHUNK)
    for B, H, T, hs, nonzero in shapes:
        rkv, w, u, s0, gy, gs = _wkv_grad_inputs(B, H, T, hs, nonzero, rng,
                                                 dev)
        for dt in (torch.float32, torch.bfloat16):
            r, k, v = (torch.from_numpy(a).to(dev, dt) for a in rkv)
            _, _, s_chk = wk.wkv6_fwd(r, k, v, w, u, s0)
            got = wk.wkv6_bwd(r, k, v, w, u, s_chk, gy, gs)
            again = wk.wkv6_bwd(r, k, v, w, u, s_chk, gy, gs)
            want = wk.wkv6_bwd_plain(r, k, v, w, u, s0, gy, gs)
            what = f"wkv6_bwd {dt} {(B, H, T, hs)} s0/gs {nonzero}"
            for name, a, b, c in zip(("gr", "gk", "gv", "gw", "gu"), got,
                                     want, again):
                try:
                    e, sh = _close(a, b, WKV_BWD_TOL)
                except AssertionError as err:
                    raise AssertionError(f"{what} {name}: {err}") from None
                worst, share = max(worst, e), max(share, sh)
                if not torch.equal(a, c):
                    raise AssertionError(f"{what} {name}: a second run "
                                         f"differs (not deterministic)")
            if not (torch.equal(got[5], want[5])
                    and torch.equal(got[5], again[5])):
                raise AssertionError(f"{what}: gs0 is not the plain "
                                     f"version's bit for bit")
            cases += 1
    # WKV6 (kernel forward + backward) against autograd through the plain
    # forward, on the card
    rkv, w, u, s0, gy, gs = _wkv_grad_inputs(2, 8, 200, 64, True, rng, dev)
    xs = [torch.from_numpy(a).to(dev) for a in rkv] + [w, u, s0]
    xs = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(wk.wkv6_scan(*xs), xs, (gy, gs))
    want = torch.autograd.grad(wk.wkv6_scan_plain(*xs), xs, (gy, gs))
    auto = (0.0, 0.0)
    for name, a, b in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        try:
            auto = _worst(auto, _close(a, b, WKV_BWD_TOL))
        except AssertionError as err:
            raise AssertionError(f"WKV6 vs autograd {name}: {err}") from None
    # device times at the training shape: the model's call (bf16 r/k/v,
    # zero s0, final state unused)
    B, H, T, hs = TRAIN_BATCH, 40, TRAIN_SEQ, 64
    rkv, w, u, _, gy, _ = _wkv_grad_inputs(B, H, T, hs, False, rng, dev)
    r, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in rkv)
    s0 = torch.zeros((B, H, hs, hs), device=dev)
    _, _, s_chk = wk.wkv6_fwd(r, k, v, w, u, s0)
    bwd = lambda: wk.wkv6_bwd(r, k, v, w, u, s_chk, gy)        # noqa: E731
    fwd_keep = lambda: wk.wkv6_fwd(r, k, v, w, u, s0)          # noqa: E731
    fwd = lambda: wk.wkv6_scan(r, k, v, w, u, s0)              # noqa: E731
    bwd(), fwd_keep(), fwd()                                   # warm up
    rounds = [launch_ms([bwd, fwd, fwd_keep]) for _ in range(LM_ROUNDS)]
    b_t, f_t, k_t = (list(x) for x in zip(*rounds))
    ptxas = {("bf16" if "bfloat16" in name else "f32"): " / ".join(lines)
             for name, lines in ptxas_report("wkv6_bwd", "Li64E").items()}
    occupancy = {dt: wk.bwd_occupancy(t, 64) for dt, t in
                 (("bf16", torch.bfloat16), ("f32", torch.float32))}
    return dict(cases=cases, shapes=[x[:4] for x in shapes], chunk=wk.CHUNK,
                worst=worst, share=share, auto=auto,
                ptxas=ptxas, occupancy=occupancy,
                b_times=b_t, b_ms=float(np.median(b_t)), f_times=f_t,
                k_times=k_t,
                p_ms=cuda_ms(lambda: wk.wkv6_bwd_plain(r, k, v, w, u, s0,
                                                       gy), 1),
                bound=wkv6_bwd_bound_ms(r, None))


def _train_cfg(layers=None, dtype=None):
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def _train_opt():
    from repro_torch.train import OptConfig
    return OptConfig(lr=TRAIN_LR, warmup_steps=10)


def phase_train_cut(dev, seed=1):
    """Phase 18 (b): one AdamW step of rwkv6-3b at full width, depth cut to
    ``TRAIN_CUT`` layers, float32 activations, through the kernels against
    the same step with wkv6's plain forward and backward."""
    import torch
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.models import init_model, ssm
    from repro_torch.models.layers import tree_items
    from repro_torch.train import data, make_train_step, optimizer
    cfg = _train_cfg(TRAIN_CUT, "float32")
    ocfg = _train_opt().replace(total_steps=1)
    params = init_model(cfg, torch.Generator(dev).manual_seed(seed), dev)
    twin, calls = {}, []

    def recording(r, k, v, w, u, s0=None):
        # the kernel path's wkv6 calls: inputs, and gy by a hook on y
        y, s = wk.wkv6_scan(r, k, v, w, u, s0)
        c = {"in": [x.detach() for x in (r, k, v, w, u, s0)]}
        if y.requires_grad:
            y.register_hook(lambda g: c.__setitem__("gy", g.detach()))
        calls.append(c)
        return y, s
    batch = data.batch_at(data.DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                          seed=seed), 0, device=dev)
    step = make_train_step(cfg, ocfg, device=dev)
    out = {}
    for path in ("kernel", "plain"):
        p = init_model(cfg, torch.Generator(dev).manual_seed(seed), dev) \
            if path == "plain" else params
        counts = (wk.wkv6_scan.launches, wk.wkv6_bwd.launches)
        ssm.wkv6_scan = _plain_wkv6() if path == "plain" else recording
        try:
            p, _, m = step(p, optimizer.init(p), batch)
        finally:
            ssm.wkv6_scan = wk.wkv6_scan
        grew = (wk.wkv6_scan.launches - counts[0],
                wk.wkv6_bwd.launches - counts[1])
        want = (2 * TRAIN_CUT, TRAIN_CUT) if path == "kernel" else (0, 0)
        if grew != want:
            raise AssertionError(f"phase 18 (b) {path} path: wkv6 / "
                                 f"wkv6_bwd launched {grew}, want {want}")
        out[path] = (float(m["loss"]), float(m["grad_norm"]))
        lr = float(m["lr"])
        twin[path] = p
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)
            and abs(gk - gp) <= TRAIN_GNORM_RTOL * abs(gp)):
        raise AssertionError(f"phase 18 (b): loss {lk} / {lp}, grad norm "
                             f"{gk} / {gp} beyond rtol {TRAIN_LOSS_RTOL} / "
                             f"{TRAIN_GNORM_RTOL}")
    # wkv6_bwd against wkv6_bwd_plain on layer 0's own call and gy
    c = next(c for c in calls if "gy" in c)
    r, k, v, w, u, s0 = c["in"]
    _, _, s_chk = wk.wkv6_fwd(r, k, v, w, u, s0)
    got = wk.wkv6_bwd(r, k, v, w, u, s_chk, c["gy"])
    want = wk.wkv6_bwd_plain(r, k, v, w, u, s0, c["gy"])
    in_situ = max(float((a - b).norm() / b.norm()) for a, b in zip(got,
                                                                   want))
    if not in_situ <= TRAIN_WKV_RTOL:
        raise AssertionError(f"phase 18 (b): wkv6_bwd on layer 0's inputs "
                             f"differs from its plain version by "
                             f"{in_situ} (relative)")
    worst, beyond, total = 0.0, 0, 0
    plain = dict(tree_items(twin["plain"]))
    for path, a in tree_items(twin["kernel"]):
        diff = (a - plain[path]).abs()
        lim = 1e-6 + 1e-5 * plain[path].abs()
        beyond += int((diff > lim).sum())
        total += a.numel()
        worst = max(worst, float(diff.max()))
    if worst > 2.2 * lr or beyond > TRAIN_BEYOND * total:
        raise AssertionError(f"phase 18 (b): parameters differ by up to "
                             f"{worst}, {beyond} of {total} beyond tol")
    return dict(loss=(lk, lp), gnorm=(gk, gp), worst=worst, beyond=beyond,
                total=total, lr=lr, in_situ=in_situ)


def phase_train(dev, seed=0):
    """Phase 18 (c), the main path: ``train()`` of rwkv6-3b at full width
    and depth (bf16 activations, f32 parameters, AdamW), ``TRAIN_STEPS``
    steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` seeded tokens from a seeded
    ``init_model``, the launch counts zeroed just before; then one step
    profiled and the optimizer's time on a second copy."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.models import init_model
    from repro_torch.train import (TrainConfig, data, make_train_step,
                                   optimizer, train)
    cfg = _train_cfg()
    tc = TrainConfig(steps=TRAIN_STEPS, seed=seed, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH, opt=_train_opt())
    marks = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    wk.wkv6_scan.launches = 0
    wk.wkv6_bwd.launches = 0
    t0 = time.perf_counter()
    h = train(cfg, tc, fault_hook=lambda s: marks.append(
        time.perf_counter()), device=dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    out = dict(fwd=wk.wkv6_scan.launches, bwd=wk.wkv6_bwd.launches,
               flash=fa.flash_attention.launches, wall=marks[-1] - t0,
               init_s=marks[0] - t0, steps=list(np.diff(marks)),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss=h["loss"], gnorm=h["grad_norm"], layers=cfg.n_layers)
    want = (2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS, 0)
    if (out["fwd"], out["bwd"], out["flash"]) != want:
        raise AssertionError(f"phase 18 (c): wkv6 / wkv6_bwd / flash "
                             f"launched {(out['fwd'], out['bwd'], out['flash'])}"
                             f", want {want}")
    if not all(math.isfinite(x) for x in h["loss"] + h["grad_norm"]):
        raise AssertionError(f"phase 18 (c): non-finite loss or grad norm "
                             f"{h['loss']} {h['grad_norm']}")
    # at init the head's logits have variance d_model 0.02^2: the expected
    # first loss is ln(vocab) + d_model 0.02^2 / 2
    out["loss0_want"] = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    if not abs(h["loss"][0] - out["loss0_want"]) < 0.5:
        raise AssertionError(f"phase 18 (c): first loss {h['loss'][0]}, "
                             f"want {out['loss0_want']} +- 0.5")
    del h
    torch.cuda.empty_cache()
    # one step profiled, one with the optimizer timed alone
    params = init_model(cfg, torch.Generator(dev).manual_seed(seed), dev)
    opt_state = optimizer.init(params)
    batch = data.batch_at(data.DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                          seed=seed), 0, device=dev)
    step = make_train_step(cfg, tc.opt.replace(total_steps=TRAIN_STEPS),
                           device=dev)
    out["prof"] = device_breakdown(lambda: step(params, opt_state, batch))
    update = optimizer.update
    box = {}

    def timed(*a, **kw):
        box["s"] = sync_wall(lambda: box.update(r=update(*a, **kw)))
        return box["r"]
    optimizer.update = timed
    try:
        out["step_s"] = sync_wall(lambda: step(params, opt_state, batch))
    finally:
        optimizer.update = update
    out["opt_s"] = box["s"]
    del params, opt_state, box
    torch.cuda.empty_cache()
    return out


def phase_train_faults(dev, seed=2):
    """Phase 18 (d): fault tolerance on the card at a reduced rwkv6 config,
    under ``torch.use_deterministic_algorithms(True)`` for the phase (any
    nondeterministic op on the step raises): a run killed at step 6 and
    resumed against the uninterrupted run (rtol 1e-5, the reference's),
    a ``NodeFailure`` at step 7 restored from step 4 and replayed (rtol
    1e-6), and a ``.tmp`` directory left behind invisible to ``restore``.
    Checkpoints go to a temporary directory in the build directory."""
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.models import init_model
    from repro_torch.train import (NodeFailure, OptConfig, TrainConfig,
                                   checkpoint, optimizer, train)
    cfg = configs.get(TRAIN_ARCH).reduced(dtype="float32")

    def tc(ckpt=None):
        return TrainConfig(steps=12, seed=seed, seq_len=64, global_batch=4,
                           opt=OptConfig(lr=3e-3, warmup_steps=2),
                           ckpt_dir=ckpt, ckpt_every=4)

    class Abort(Exception):
        pass

    def kill(s):
        if s == 6:
            raise Abort

    armed = {"on": True}

    def fail(s):
        if s == 7 and armed["on"]:
            armed["on"] = False
            raise NodeFailure("injected")

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=_build.BUILD_DIR)
    env0 = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    det0 = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    bwd0 = wk.wkv6_bwd.launches
    try:
        clean = train(cfg, tc(), device=dev)["loss"]
        a, b = os.path.join(root, "kill"), os.path.join(root, "fail")
        try:
            train(cfg, tc(a), fault_hook=kill, device=dev)
            raise AssertionError("phase 18 (d): the kill did not happen")
        except Abort:
            pass
        resumed = train(cfg, tc(a), device=dev)
        failed = train(cfg, tc(b), fault_hook=fail, device=dev)
        os.makedirs(os.path.join(b, "step_00000099.tmp"))
        latest = checkpoint.latest_step(b)
        like = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
        restored = checkpoint.restore(b, (like, optimizer.init(like)),
                                      device=dev)[0]
    finally:
        torch.use_deterministic_algorithms(det0)
        if env0 is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env0
        shutil.rmtree(root, ignore_errors=True)
    if resumed["resumed_at"] != 4 * (6 // 4):
        raise AssertionError(f"phase 18 (d): resumed at "
                             f"{resumed['resumed_at']}")
    r_tail = clean[resumed["resumed_at"]:]
    if not np.allclose(resumed["loss"], r_tail, rtol=1e-5, atol=0):
        raise AssertionError(f"phase 18 (d): resumed losses "
                             f"{resumed['loss']} vs {r_tail}")
    if failed["restarts"] != 1 or not np.allclose(
            failed["loss"][-5:], clean[-5:], rtol=1e-6, atol=0):
        raise AssertionError(f"phase 18 (d): replayed losses "
                             f"{failed['loss']} vs {clean}")
    if latest != 12 or restored != 12:
        raise AssertionError(f"phase 18 (d): a .tmp directory is visible "
                             f"(latest step {latest}, restored {restored})")
    return dict(resumed_at=resumed["resumed_at"],
                resume_bitwise=resumed["loss"] == r_tail,
                replay_bitwise=failed["loss"][-5:] == clean[-5:],
                replayed=len(failed["loss"]) - len(clean),
                bwd=wk.wkv6_bwd.launches - bwd0, loss=(clean[0], clean[-1]))


def train_kernels_line(a) -> str:
    """Phase 18 (a)'s line of numbers."""
    bound, bound_by, b_bytes, b_ops = a["bound"]
    return (
        f"train kernels: wkv6_bwd vs wkv6_bwd_plain on {a['cases']} cases "
        f"((B, H, T, hs) {a['shapes']}, r/k/v f32 "
        f"and bf16; rwkv6-3b's training shape with zero and with non-zero "
        f"s0 and gs): gr, gk, gv, gw, gu max |diff| {a['worst']} (share of "
        f"tol {WKV_BWD_TOL}: {a['share']:.3f}), gs0 bitwise, a second run "
        f"bitwise; WKV6 vs autograd through wkv6_scan_plain on the card "
        f"max |diff| {a['auto'][0]} (share {a['auto'][1]:.3f}) | at "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}, 40, 64) bf16: wkv6_bwd "
        f"{a['b_ms']:.4f} ms device per launch (launch_ms of the wrapper: "
        f"the kernel and gu's sum over the batch; median (min, max) of "
        f"{len(a['b_times'])}: {spread(a['b_times'])}; "
        f"{b_ops / a['b_ms'] * FP32_OPS_PER_S / 1e12:.2f} TFLOP/s of the "
        f"counted operations), plain {a['p_ms']:.4f} ms (cuda_ms), bound "
        f"{bound:.4f} ms ({bound_by}; bytes {b_bytes:.4f} ms, operations "
        f"{b_ops:.4f} ms), kernel / bound {a['b_ms'] / bound:.2f}; the "
        f"forward at this shape: serving launch (no kept states) "
        f"{spread(a['f_times'])} ms, keeping the state every "
        f"{a['chunk']} steps {spread(a['k_times'])} ms | wkv6_bwd at head "
        f"size 64, ptxas: {a['ptxas']}; resident on the card: "
        f"{a['occupancy']}")


def train_cut_line(b) -> str:
    """Phase 18 (b)'s line of numbers."""
    return (
        f"train cut: {TRAIN_ARCH} at full width, {TRAIN_CUT} layers, f32 "
        f"activations, one AdamW step on {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, wkv6 + wkv6_bwd kernels vs their plain versions: loss "
        f"{b['loss'][0]!r} / {b['loss'][1]!r} (rtol {TRAIN_LOSS_RTOL}), "
        f"grad norm {b['gnorm'][0]!r} / {b['gnorm'][1]!r} (rtol "
        f"{TRAIN_GNORM_RTOL}: the group norm at a sequence's first steps); "
        f"wkv6_bwd vs wkv6_bwd_plain on layer 0's own inputs and gy: "
        f"largest relative difference {b['in_situ']!r} (tol "
        f"{TRAIN_WKV_RTOL}); parameters max "
        f"|diff| {b['worst']!r}, {b['beyond']} of {b['total']} beyond atol "
        f"1e-6 + rtol 1e-5 (at most {TRAIN_BEYOND} of them, "
        f"all within 2.2 lr = {2.2 * b['lr']!r})")


def train_line(c) -> str:
    """Phase 18 (c)'s line of numbers."""
    per = c["steps"][1:]
    step_s = float(np.median(per))
    ntok = TRAIN_BATCH * TRAIN_SEQ
    wall, kinds = c["prof"]
    busy = sum(kinds.values())
    shares = ", ".join(f"{k} {kinds.get(k, 0.0) / busy:.3f}" for k in
                       ("matmul", "copy", "wkv6", "wkv6_bwd", "other")) \
        if busy else "not measured"
    return (
        f"train: {TRAIN_ARCH} at full width and depth ({c['layers']} "
        f"layers), f32 parameters, bf16 activations, AdamW, train() for "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: init "
        f"{c['init_s']:.2f} s, first step {c['steps'][0]:.4f} s, then "
        f"{spread(per)} s per step = {ntok / step_s:.0f} tokens/s; losses "
        f"{c['loss']} (first vs ln(vocab) + d_model 0.02^2 / 2 = "
        f"{c['loss0_want']:.4f}), grad norms {c['gnorm']}; peak "
        f"{c['peak_gb']:.2f} GB allocated; wkv6 launches {c['fwd']} "
        f"({c['fwd'] // TRAIN_STEPS} per step), wkv6_bwd {c['bwd']} "
        f"({c['bwd'] // TRAIN_STEPS} per step), flash {c['flash']} | one "
        f"step profiled: {_fmt_breakdown(wall, kinds)}; device busy "
        f"{busy / step_s:.3f} of an unprofiled step's wall ({step_s:.4f} "
        f"s); shares of the device time: {shares} (f32 -> bf16 casts are "
        f"copy) | another step {c['step_s']:.4f} s, its optimizer.update "
        f"{c['opt_s']:.4f} s (card synchronised)")


def train_faults_line(d) -> str:
    """Phase 18 (d)'s line of numbers."""
    return (
        f"train faults: reduced {TRAIN_ARCH} on the card under "
        f"torch.use_deterministic_algorithms(True), 12 steps, checkpoints "
        f"every 4: killed at step 6, resumed at {d['resumed_at']}, losses "
        f"== the uninterrupted run's at rtol 1e-5 (bitwise "
        f"{d['resume_bitwise']}); NodeFailure at step 7, restored and "
        f"{d['replayed']} steps replayed, the last 5 losses at rtol 1e-6 "
        f"(bitwise {d['replay_bitwise']}); a .tmp directory invisible to "
        f"restore; loss {d['loss'][0]:.4f} -> {d['loss'][1]:.4f}, "
        f"wkv6_bwd launches {d['bwd']}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.mr_sched import megakernel as mk
    dev = torch.device("cuda")
    smi = nvidia_smi()
    # float32 products in full float32: the LM checks compare float32
    # paths, and rwkv6's decay LoRA product is float32 by design
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = [f"{name}: {ln.strip()}" for name in built for ln in
             _build.build_log(name).splitlines() if "Used" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per library "
          f"{json.dumps({k: round(v, 2) for k, v in built.items()})} | "
          + " | ".join(ptxas), flush=True)
    spills = [ln for ln in ptxas if "spill" in ln
              and not ln.endswith("0 bytes spill stores, 0 bytes spill loads")]
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")
    cm, cm_s = phase_costmodel(dev)
    from repro_torch.core import costmodel
    n, maps = costmodel.PROBE_CUDA[:2]
    floor = 2e-6 / (n * (maps + 1))          # twice the noise floor
    print(f"costmodel: default_cost_model() on {smi}: source {cm.source}, "
          f"dispatch_us {cm.dispatch_us!r}, epoch_lane_us "
          f"{cm.epoch_lane_us!r} ("
          + ("above" if cm.epoch_lane_us > floor else "near")
          + f" the floor of a slope lost in the noise), sync_us "
          f"{cm.sync_us!r} ({cm.device}, {cm_s:.2f} s; file "
          f"{os.environ['REPRO_TORCH_COSTMODEL_PATH']})", flush=True)

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    worst, checked = phase_kernels(dev)
    print(f"kernels: mr_epoch bitwise == mr_epoch_plain on {checked} lanes "
          f"at T={list(KERNEL_TS)} and stress lanes, a (T, V) = {FLEET} "
          f"fleet among them (+ resume split; control instantiation "
          f"on degenerate data == open loop on 8 leaves), max_abs_err "
          f"{worst}, {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    worst_c, checked_c, tot = phase_control_kernels(dev)
    print(f"kernels: mr_epoch control bitwise == mr_epoch_plain(control="
          f"True) on all 15 leaves, {checked_c} closed-loop lanes at "
          f"T={list(KERNEL_TS)} and stress lanes, a (T, V) = {FLEET} fleet "
          f"among them (+ resume split), max_abs_err {worst_c} | "
          f"hit tasks {tot[0]}, scale events {tot[1]}, shed {tot[2]}, "
          f"evictions {tot[3]}, {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    worst_to, worst_tc, checked_t, n_ev, n_drop = phase_trace_kernels(dev)
    print(f"kernels: mr_epoch_trace and mr_epoch_control_trace bitwise == "
          f"mr_epoch_plain(trace=True) on every carry and trace leaf, "
          f"{checked_t} lanes (open loop and closed loop at T="
          f"{list(KERNEL_TS)} and stress lanes, a (T, V) = {FLEET} fleet "
          f"among them), carry == the untraced kernels'; undersized "
          f"event logs (half the median count) bitwise plain, kept rows == "
          f"the full log's first rows, {n_drop} of {n_ev} events dropped and "
          f"counted; max_abs_err {worst_to} / {worst_tc}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    worst_s, checked_s = phase_schedule_kernel(dev)
    print(f"kernels: mr_schedule bitwise == mr_schedule_plain on {checked_s} "
          f"lanes at T={list(KERNEL_TS)}, both sched policies mixed, "
          f"max_abs_err {worst_s}, {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    rows = phase_engine_j1(dev)
    print(f"kernels: engine body (backend=\"engine\") bitwise == mr_epoch on "
          f"every SimOutput field, {KERNEL_LANES} lanes per grid at T="
          f"{list(KERNEL_TS)}, open and control | "
          + "; ".join(f"{'control' if c else 'open'} T={T}: engine wall "
                      f"{w!r} s over {e} epochs, mr_epoch device {k!r} ms "
                      f"({1e3 * w / k!r}x)" for T, c, w, k, e in rows)
          + f", {time.perf_counter() - t0:.2f} s", flush=True)

    # 4. main path, open loop.  pad_tasks=64 caps the buckets at the next
    # power of two above the 41-task tail-heavy cells (T = 4 .. 64)
    m = phase_main(mixed_columns(N_CELLS, seed=12), dev, pad_tasks=64)
    if int(m["result"]["n_epochs"].max()) > 2 * 64 + 2:
        raise AssertionError("n_epochs above 2T+2")
    enc_s, step_s, met_s = m["layers"]
    print(f"main: {N_CELLS} cells in {len(m['buckets'])} buckets (T pads "
          f"{sorted({b[3] for b in m['buckets']})}), wall "
          f"{m['wall_first']:.3f} s first / {m['wall']:.3f} s again, "
          f"{N_CELLS / m['wall']:.0f} scenarios/s, mr_epoch launches "
          f"{m['launches'][0]}, kernel {m['k_ms']!r} ms (device median), "
          f"every bucket bitwise plain, plain "
          f"{m['p_ms']:.3f} ms, bound {m['b_ms']:.4f} ms ({m['bound_by']}), "
          f"realized_epochs max {int(m['result']['realized_epochs'].max())}"
          f" | layers over buckets: encode {enc_s:.3f} s, step "
          f"{step_s:.3f} s, metrics {met_s:.3f} s", flush=True)
    print(times_line("mr_epoch, open-loop grid", m["times"]), flush=True)

    # 5. the same cells on the CPU
    t0 = time.perf_counter()
    n_checked = phase_cpu(m)
    print(f"cpu: {n_checked} cells from {len(m['buckets'])} buckets re-run "
          f"on the CPU, integer metrics exact and float metrics bitwise, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 6. main path, closed loop, and 2048 of its cells on the CPU
    c = phase_main(mixed_control_columns(N_CELLS, seed=13), dev,
                   control=True)
    res = c["result"]
    worst_t = max(b[3] for b in c["buckets"])
    ep_max = int(res["realized_epochs"].max())
    if ep_max > 7 * worst_t + 9 + 3:
        raise AssertionError("realized_epochs above 7T+V+3")
    mech = {k: float(res[k].sum()) for k in (
        "failures_injected", "tasks_redispatched", "scale_events",
        "shed_tasks", "preemptions")}
    idle = [k for k, v in mech.items() if not v > 0]
    if idle:
        raise AssertionError(f"the closed-loop grid never fired {idle}")
    enc_s, step_s, met_s = c["layers"]
    print(f"control: {N_CELLS} closed-loop cells in {len(c['buckets'])} "
          f"buckets (T pads {sorted({b[3] for b in c['buckets']})}), wall "
          f"{c['wall_first']:.3f} s first / {c['wall']:.3f} s again, "
          f"{N_CELLS / c['wall']:.0f} scenarios/s, mr_epoch control "
          f"launches {c['launches'][1]} (open loop {c['launches'][0]}), "
          f"kernel {c['k_ms']!r} ms (device median), every bucket bitwise "
          f"plain, plain {c['p_ms']:.3f} ms, bound "
          f"{c['b_ms']:.4f} ms ({c['bound_by']}), realized_epochs max "
          f"{ep_max} (7T+V+3 = {7 * worst_t + 12}) | "
          + ", ".join(f"{k} {int(v)}" for k, v in mech.items())
          + f" | layers over buckets: encode {enc_s:.3f} s, step "
          f"{step_s:.3f} s, metrics {met_s:.3f} s", flush=True)
    print(times_line("mr_epoch_control, closed-loop grid", c["times"]),
          flush=True)
    t0 = time.perf_counter()
    n_checked = phase_cpu(c, control=True)
    print(f"cpu: {n_checked} closed-loop cells from {len(c['buckets'])} "
          f"buckets re-run on the CPU, integer metrics exact and float "
          f"metrics bitwise, {time.perf_counter() - t0:.2f} s", flush=True)

    # 7. the traced path on both grids
    traced = {}
    for name, grid, control in (("open", m, False), ("closed", c, True)):
        t = traced[name] = phase_traced(grid, dev, control)
        print(f"trace: {name}-loop grid, {grid['n']} cells in "
              f"{len(grid['buckets'])} buckets through "
              f"engine.simulate_batch_arrays(trace=True): first traced pass "
              f"{t['wall_first']:.4f} s; {TRACE_PASSES} alternating passes, "
              f"median (min, max): traced {spread(t['wall_traced'])} s, "
              f"untraced {spread(t['wall_untraced'])} s, traced/untraced "
              f"{spread(t['ratios'])}, trace kernel share of the median "
              f"traced wall "
              f"{t['k_ms'] / 1e3 / np.median(t['wall_traced']):.4f}, "
              f"{mk.instantiation(control, True)} launches "
              f"{t['launches'][int(control)]}, "
              f"kernel {t['k_ms']!r} ms (device median; untraced kernel "
              f"from the same carry {t['u_ms']!r} ms), every bucket bitwise "
              f"plain, plain {t['p_ms']:.3f} ms, bound "
              f"{t['b_ms']:.4f} ms "
              f"({t['bound_by']}), trace bytes {t['nbytes']} | SimOutput "
              f"bitwise untraced, 0 dropped, events "
              f"{json.dumps(t['totals'])} match the schedule"
              + (" and the metrics' shed/preempt/scale counts; Chrome trace "
                 f"of a killed lane: {t['chrome'][0]} spans == STARTs"
                 if control else "")
              + f" | {t['n_cpu']} cells' trace buffers bitwise on the CPU",
              flush=True)
        print(times_line(f"{mk.instantiation(control, True)}, {name}-loop "
                         "grid", t["times"]), flush=True)

    # 8. run(report=True) on the open-loop grid
    rep = phase_report(m, dev)
    print(f"report: run(report=True) on {rep.n_cells} open-loop cells, "
          f"metrics bitwise phase 4's; {rep.n_buckets} buckets, cells add up, "
          f"dispatches {rep.dispatches} == launches counted, library binds "
          f"{rep.compile_cache_misses} / hits {rep.compile_cache_hits}, "
          f"wall {rep.wall_s:.3f} s, device {rep.device}", flush=True)

    # 9. active-lane compaction on the open-loop grid's tail-heavy quarter
    # and on the closed-loop grid, against their dense runs
    compiled = m["plan"]._compiled()[0]
    tail = {k: v[3 * N_CELLS // 4:] for k, v in compiled.items()}
    tail_plan = sweep_plan(tail, pad_tasks=64)
    print(compact_line("open-loop grid's tail-heavy quarter",
                       phase_compact(tail_plan, dev)), flush=True)
    print(compact_line("closed-loop grid",
                       phase_compact(c["plan"], dev, control=True)),
          flush=True)

    # 10. mr_schedule on the cells it models
    s = phase_schedule(m, dev)
    print(f"schedule: ops.schedule on the {s['n']} open-loop cells with a "
          f"static fleet and no priorities, {s['buckets']} buckets: makespan "
          f"== phase 4's at rtol 1e-4, atol 1e-2, every bucket bitwise "
          f"mr_schedule_plain; mr_schedule launches "
          f"{s['launches']}, kernel {s['k_ms']!r} ms (device median), plain "
          f"{s['p_ms']:.3f} ms, bound {s['b_ms']:.4f} ms ({s['bound_by']}; "
          f"summed over the buckets, bytes {s['parts'][0]:.4f} ms, "
          f"operations {s['parts'][1]:.4f} ms) | bitwise plain on "
          f"{s['checked']} stress lanes (T={[t for t, _ in STRESS_CASES]}; "
          f"(T, V) = {list(SCHEDULE_LONG)}), max_abs_err {s['worst']}",
          flush=True)
    print(times_line("mr_schedule, static-fleet cells (epochs: distinct "
                     "event instants)", s["times"]), flush=True)

    # 11. the LM kernels against their plain versions
    t0 = time.perf_counter()
    worst_fa, worst_wkv, worst_ulps = phase_lm_kernels(dev)
    n_fa = sum(len(c[-1]) for c in FA_CHECK_SHAPES)
    print(f"lm kernels: flash_attention vs flash_attention_plain on {n_fa} "
          f"cases (tests' FA_SHAPES in f32 and bf16, yi-6b's prefill "
          f"(4, 2048, 32/4 heads, 128) f32 and bf16 causal, and with window "
          f"512, mixtral's (2, 8192, 32/8, 128, window 4096) and jamba's "
          f"(4, 2048, 32/8, 128) prefills f32 and bf16), max_abs_err {worst_fa}, bf16 worst {worst_ulps:.3f} "
          f"ulps beyond the {FA_TOL['bfloat16'][1]} floor (tol: f32 "
          f"{FA_TOL['float32']}, bf16 {FA_TOL['bfloat16'][0]} ulps + "
          f"{FA_TOL['bfloat16'][1]}); wkv6 vs "
          f"wkv6_scan_plain "
          f"on {2 * len(WKV_CHECK_SHAPES)} cases (tests' WKV_SHAPES and "
          f"rwkv6-3b's (4, 40, 2048, 64), non-zero s0, r/k/v f32 and bf16), "
          f"y max_abs_err {worst_wkv} (tol {WKV_TOL}), final state bitwise, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 12. and 13. serving yi-6b and rwkv6-3b at full width
    lm = {}
    for label, name in (("serve dense", "yi-6b"), ("serve rwkv", "rwkv6-3b")):
        r = lm[name] = phase_serve(name, dev, seed=0)
        print(serve_line(label, name, r), flush=True)

    # 14. multi-job scenarios through the engine body
    for label, control, seed in (("open-loop", False, 14),
                                 ("closed-loop", True, 15)):
        print(multijob_line(label, phase_multijob(dev, control, seed)),
              flush=True)

    # 15. the sequential oracle against the card
    import repro_torch.core as core
    o = phase_oracle_paper(dev)
    print(f"oracle: (a) on {smi} (refsim on the host's numpy "
          f"{np.__version__}): Table IV exact through refsim at 3, 6, 9 "
          f"VMs; Groups 1-4 ({o['cells']} cells) through SweepPlan.run in "
          f"{o['wall']!r} s, mr_epoch launches {o['launches']}, every cell "
          f"== refsim at rtol {ORACLE_RTOL} on makespan, network cost and "
          f"exec times (worst relative difference {o['worst']!r}; refsim "
          f"{o['refsim_s']!r} s on the host); shapes hold: G2 map-phase "
          f"reduction 3->6 VMs {o['red6']!r}, 3->9 {o['red9']!r}; G3 "
          f"medium {o['med']!r}, large {o['large']!r}; G4 cost x"
          f"{o['cost'][0]!r}, x{o['cost'][1]!r}", flush=True)
    scs = oracle_scenarios(core, ORACLE_N, ORACLE_SEED)
    q = 3 * ORACLE_N // 4
    for label, part, pins in (
            ("(b) single-job open loop", scs[:q], ()),
            ("(b) single-job closed loop", scs[q:],
             [i - q for i in ORACLE_DIVERGENT])):
        print(oracle_line(label, phase_oracle_set(dev, part, pins), smi),
              flush=True)
    T, J, V = ENGINE_SHAPE
    for label, control, seed, pins in (
            ("(c) multi-job open loop", False, 14, ()),
            ("(c) multi-job closed loop", True, 15,
             ORACLE_DIVERGENT_MULTIJOB)):
        r = phase_oracle_set(
            dev, multijob_scenarios(core, ORACLE_MULTIJOB, seed,
                                    control=control),
            pins, pad_tasks=T, pad_jobs=J, pad_vms=V)
        if r["launches"]:
            raise AssertionError("a multi-job set launched mr_epoch")
        print(oracle_line(label, r, smi), flush=True)
    d = phase_oracle_training(dev)
    t = d["train"]
    print(f"oracle: (d) on {smi}: workload.step_scenario at "
          f"{TRAIN_DEVICES} devices, sigma 0 (T {d['T']}, V {d['V']}) "
          f"through mr_epoch ({d['launches']} launch, {d['step_s']!r} s): "
          f"makespan {d['makespan']!r} s vs refsim {d['ref_makespan']!r} s "
          f"(worst relative difference {d['worst']!r}); simulate_training "
          f"at {TRAIN_DEVICES} devices, sigma 0.2, MTBF "
          f"{TRAIN_MTBF_HOURS} h on the host ({d['train_s']!r} s): step "
          f"{t['step_seconds']!r} s, straggler slowdown "
          f"{t['straggler_slowdown']!r}, expected failures "
          f"{t['expected_failures']!r}, goodput {t['goodput']!r}",
          flush=True)
    e = phase_streaming(dev)
    print(f"oracle: (e) on {smi}: streaming.analyze_batch bitwise the CPU "
          f"run (stable, bottleneck exact) | "
          + "; ".join(f"{k}: {n} topologies in {w!r} s, {n / w!r} "
                      f"topologies/s, stable share {st!r}"
                      for k, (n, w, st) in e.items()), flush=True)

    # 16. and 17. serving MoE (mixtral-8x7b) and hybrid (jamba-v0.1-52b)
    # at full width, depth cut to what 80 GB holds in f32
    torch.cuda.empty_cache()
    for label, name in (("serve moe", "mixtral-8x7b"),
                        ("serve hybrid", "jamba-v0.1-52b")):
        print(routed_line(label, name, phase_serve(name, dev, seed=0)),
              flush=True)

    # 18. training rwkv6-3b through wkv6 and wkv6_bwd (the weights of
    # phase 17 freed first)
    torch.cuda.empty_cache()
    ta = phase_train_kernels(dev)
    print(train_kernels_line(ta), flush=True)
    print(train_cut_line(phase_train_cut(dev)), flush=True)
    trn = phase_train(dev)
    print(train_line(trn), flush=True)
    print(train_faults_line(phase_train_faults(dev)), flush=True)

    src = "src/repro_torch/kernels/mr_sched/csrc/"
    to, tc = traced["open"], traced["closed"]
    yi, rw = lm["yi-6b"], lm["rwkv6-3b"]
    print(json.dumps({"kernels": [{
        "name": "mr_epoch", "route": "cuda", "source": src + "mr_epoch.cu",
        "replaces": "src/repro/kernels/mr_sched/megakernel.py:101",
        "launches": m["launches"][0], "max_abs_err": max(worst, m["worst"]),
        "ms": m["k_ms"],
        "plain_ms": m["p_ms"], "bound_ms": m["b_ms"],
        "bound_by": m["bound_by"], "library_ms": None}, {
        "name": "mr_epoch_control", "route": "cuda",
        "source": src + "mr_epoch_control.cu",
        "replaces": "src/repro/kernels/mr_sched/megakernel.py:101",
        "launches": c["launches"][1], "max_abs_err": max(worst_c,
                                                         c["worst"]),
        "ms": c["k_ms"], "plain_ms": c["p_ms"], "bound_ms": c["b_ms"],
        "bound_by": c["bound_by"], "library_ms": None}, {
        "name": "mr_epoch_trace", "route": "cuda",
        "source": src + "mr_epoch.cu",
        "replaces": "src/repro/kernels/mr_sched/megakernel.py:101",
        "launches": to["launches"][0], "max_abs_err": max(worst_to,
                                                          to["worst"]),
        "ms": to["k_ms"], "plain_ms": to["p_ms"], "bound_ms": to["b_ms"],
        "bound_by": to["bound_by"], "library_ms": None}, {
        "name": "mr_epoch_control_trace", "route": "cuda",
        "source": src + "mr_epoch_control.cu",
        "replaces": "src/repro/kernels/mr_sched/megakernel.py:101",
        "launches": tc["launches"][1], "max_abs_err": max(worst_tc,
                                                          tc["worst"]),
        "ms": tc["k_ms"], "plain_ms": tc["p_ms"], "bound_ms": tc["b_ms"],
        "bound_by": tc["bound_by"], "library_ms": None}, {
        "name": "mr_schedule", "route": "cuda",
        "source": src + "mr_schedule.cu",
        "replaces": "src/repro/kernels/mr_sched/kernel.py:30",
        "launches": s["launches"], "max_abs_err": max(worst_s, s["worst"]),
        "ms": s["k_ms"],
        "plain_ms": s["p_ms"], "bound_ms": s["b_ms"],
        "bound_by": s["bound_by"], "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "launches": yi["launches"], "max_abs_err": max(worst_fa.values()),
        "ms": yi["k_ms"], "plain_ms": yi["p_ms"], "bound_ms": yi["bound"][0],
        "bound_by": yi["bound"][1], "library_ms": yi["lib_ms"]}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:33",
        "launches": rw["launches"], "max_abs_err": worst_wkv,
        "ms": rw["k_ms"], "plain_ms": rw["p_ms"], "bound_ms": rw["bound"][0],
        "bound_by": rw["bound"][1], "library_ms": None}, {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/models/ssm.py:208",
        "launches": trn["bwd"], "max_abs_err": ta["worst"],
        "ms": ta["b_ms"], "plain_ms": ta["p_ms"], "bound_ms": ta["bound"][0],
        "bound_by": ta["bound"][1], "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
