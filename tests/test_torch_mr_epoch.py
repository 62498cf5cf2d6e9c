"""The port's ``mr_epoch`` against the JAX package's Pallas kernel.

Seeded lanes (made by the JAX encoder, so both kernels read the same bits)
go through JAX ``mr_epoch(..., interpret=True)`` and the port's
``mr_epoch_plain`` on the CPU; all 8 carry leaves must be bitwise equal,
across tiles, both sched policies, the four bindings, LOCALITY on skewed
placement, elastic lease windows with spinup and priorities, the tail-heavy
straggler shape, and a run resumed at ``epoch_limit``; and, untraced and
traced, on lanes built to stress space-shared admission (``mr_stress``),
which the port decides by per-task rank where the Pallas kernel scans.
The CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import mr_stress
from repro.core import elasticity as jel
from repro.core import sweep as jsweep
from repro.kernels.mr_sched import megakernel as jmk
from repro.kernels.mr_sched import ops as jops
from repro_torch.kernels.mr_sched import megakernel as tmk

V = 9


def _params(kind, n, T, seed):
    rng = np.random.default_rng(seed)
    p = dict(
        n_maps=rng.integers(1, T - 1, n).astype(np.int32),
        n_reduces=rng.integers(1, 3, n).astype(np.int32),
        n_vms=rng.integers(1, V + 1, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], n).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        vm_cost=rng.choice([1.0, 2.0], n).astype(np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        job_data=rng.choice([2e5, 4e5, 8e5], n).astype(np.float32),
        sched_policy=rng.integers(0, 2, n).astype(np.int32),
        binding_policy=rng.integers(0, 4, n).astype(np.int32),
    )
    if kind in ("mixed", "locality"):
        p["storage_enabled"] = (rng.random(n) < 0.7).astype(np.float32)
        p["replication"] = rng.integers(1, 4, n).astype(np.int32)
        p["placement"] = rng.integers(0, 2, n).astype(np.int32)
        p["block_size_mb"] = rng.choice([8192.0, 32768.0], n
                                        ).astype(np.float32)
        p["storage_seed"] = rng.integers(0, 1000, n).astype(np.int32)
    if kind == "locality":
        p["binding_policy"] = np.full(n, 3, np.int32)
        p["placement"] = np.ones(n, np.int32)
    if kind == "elastic":
        p["job_submit"] = jel.arrival_times(n, rate=0.002, seed=seed)
        start = rng.choice([0.0, 500.0, 2000.0], (n, V)).astype(np.float32)
        p["vm_start"] = start
        p["vm_stop"] = np.where(rng.random((n, V)) < 0.5, 1e30,
                                start + p["job_submit"][:, None]
                                + rng.choice([3000.0, 40000.0], (n, 1))
                                ).astype(np.float32)
        p["spinup_delay"] = rng.choice([0.0, 60.0], n).astype(np.float32)
        p["task_prio"] = rng.integers(0, 3, (n, T)).astype(np.float32)
        p["sched_policy"] = np.ones(n, np.int32)
    if kind == "tailheavy":
        strag = rng.random(n) < 1.0 / 8.0
        strag[0] = True
        p["n_maps"] = np.full(n, T - 1, np.int32)
        p["n_reduces"] = np.ones(n, np.int32)
        p["n_vms"] = np.where(strag, 1, rng.integers(6, V + 1, n)
                              ).astype(np.int32)
        p["vm_pes"] = np.where(strag, 1.0, rng.choice([2.0, 4.0], n)
                               ).astype(np.float32)
        p["sched_policy"] = np.ones(n, np.int32)
        p["binding_policy"] = np.zeros(n, np.int32)
    return p


def _lanes(kind, n=64, T=16, seed=0):
    """The 13 mr_epoch lane-data arrays (numpy) of a seeded grid, derived
    by the JAX package's own wrapper code, plus ``max_pes``."""
    b = jsweep.grid_arrays(_params(kind, n, T, seed), pad_tasks=T,
                           pad_vms=V)
    task_len, ready0, shuffle = jops._derived_inputs(b)
    arrs = (task_len, b.task_vm, ready0, b.task_is_reduce.astype(np.int32),
            b.task_valid.astype(np.int32), shuffle[:, None], b.vm_mips,
            b.vm_pes, b.sched_policy[:, None], b.vm_start, b.vm_stop,
            b.spinup_delay[:, None], b.task_prio)
    dtypes = (np.float32, np.int32, np.float32, np.int32, np.int32,
              np.float32, np.float32, np.float32, np.int32, np.float32,
              np.float32, np.float32, np.float32)
    lanes = tuple(np.ascontiguousarray(np.asarray(a, d))
                  for a, d in zip(arrs, dtypes))
    return lanes, max(int(np.ceil(lanes[7].max())), 1)


def _jax(lanes, max_pes, **kw):
    return tuple(np.asarray(x) for x in jmk.mr_epoch(
        *lanes, max_pes=max_pes, interpret=True, **kw))


def _torch(lanes, max_pes, state=None, **kw):
    st = None if state is None else tuple(torch.tensor(x) for x in state)
    out = tmk.mr_epoch_plain(*(None if x is None else torch.tensor(x)
                               for x in lanes),
                             state=st, max_pes=max_pes, **kw)
    return tuple(x.numpy() for x in out)


def _assert_bitwise(want, got, what):
    assert len(want) == len(got) == 8
    for name, a, b in zip(tmk.STATE_LEAVES, want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{what}: leaf {name}")


@pytest.mark.parametrize("kind,tile,T", [
    ("mixed", 8, 16), ("locality", 16, 16), ("elastic", 64, 16),
    ("tailheavy", 32, 24)])
def test_plain_matches_pallas_bitwise(kind, tile, T):
    lanes, max_pes = _lanes(kind, T=T, seed=T + tile)
    want = _jax(lanes, max_pes, tile=tile)
    got = _torch(lanes, max_pes)
    _assert_bitwise(want, got, kind)
    assert want[7].max() > 2            # lanes took real event epochs


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("T,pes_delta", [(12, 0), (12, 3), (12, -3),
                                         (40, 0)])
def test_plain_matches_pallas_on_admission_stress(T, pes_delta, trace):
    """One VM for all tasks, index ties, -0.0 beside 0.0, VMs with 0,
    fractional and exactly ``max_pes`` PEs, priorities at the scan's
    sentinels, tasks bound outside [0, V); ``max_pes`` at, above and
    below the largest PE count (the scan's precondition broken)."""
    lanes, max_pes = mr_stress.stress_lanes(24, T, seed=T + pes_delta)
    max_pes = max(1, max_pes + pes_delta)
    kw = dict(trace=True, vm_valid=lanes[13]) if trace else {}
    want = _jax(lanes[:13], max_pes, tile=8, **kw)
    got = _torch(lanes[:13] + ((lanes[13],) if trace else ()), max_pes,
                 trace=trace)
    _assert_bitwise(want[:8], got[:8], f"stress T={T}")
    if trace:
        np.testing.assert_array_equal(got[8].view(np.int32),
                                      want[8].view(np.int32), err_msg="ts")
    assert (want[3] < 5e29).sum() > 4 * 24          # tasks were admitted


def test_resume_split_matches_pallas_and_one_call():
    lanes, max_pes = _lanes("elastic", T=16, seed=3)
    full = _torch(lanes, max_pes)
    split = int(full[7].max()) // 2
    j1 = _jax(lanes, max_pes, tile=16, epoch_limit=split)
    t1 = _torch(lanes, max_pes, epoch_limit=split)
    _assert_bitwise(j1, t1, "first chunk")
    # the second call gets the rest of the 2T+2 budget: lanes stranded
    # behind a closed lease run to the budget, as in the one call
    rest = 2 * 16 + 2 - split
    resumed = _torch((lanes[0], lanes[1], None) + lanes[3:], max_pes,
                     state=t1, epoch_limit=rest)
    _assert_bitwise(full, resumed, "resumed")
    assert (t1[7] <= split).all() and (full[7] > split).any()
    assert (full[7] == 2 * 16 + 2).any()    # the grid strands some lanes


def test_wrapper_takes_plain_version_on_cpu():
    lanes, max_pes = _lanes("mixed", n=16, T=8, seed=9)
    before = tmk.mr_epoch.launches
    got = tmk.mr_epoch(*(torch.tensor(x) for x in lanes),
                       max_pes=max_pes)
    assert tmk.mr_epoch.launches == before     # no kernel launched
    _assert_bitwise(_torch(lanes, max_pes), tuple(x.numpy() for x in got),
                    "wrapper")


def test_kernel_shared_memory_layout():
    # the C source's lane_smem_bytes and the wrapper's agree, at one, two
    # and three task-set words per VM, with the VMs' task sets in shared
    # memory and in global scratch
    src = (tmk.__file__.rsplit("/", 1)[0] + "/csrc/mr_epoch.cu")
    text = open(src).read()
    assert "const int vw = shared_sets ? V * W : 0;" in text
    assert "(53 * T + 20 * V + 4 * vw + 12 * W + 15) / 16 * 16" in text
    for T, Vv in ((8, 1), (64, 16), (70, 9)):
        W = (T + 31) // 32
        for shared in (True, False):
            vw = Vv * W if shared else 0
            want = (53 * T + 20 * Vv + 4 * vw + 12 * W + 15) // 16 * 16
            assert tmk.lane_smem_bytes(T, Vv, shared_sets=shared) == want
            assert tmk.lane_smem_bytes(T, Vv, trace=True,
                                       shared_sets=shared) == want
    assert tmk.block_layout(64, 16) == (2, True)
    with pytest.raises(ValueError):
        tmk.block_layout(8192, 16)


# The per-lane shared memory of the kernels' first design, which kept
# no per-VM task sets: bytes per task, per VM and fixed, against a 200 KB
# limit.  Every shape it took must still be taken.
_FIRST_LANE_BYTES = {(False, False): (60, 20, 4), (False, True): (60, 20, 4),
                     (True, False): (91, 50, 8), (True, True): (93, 52, 8)}
_FIRST_LIMIT = 200 * 1024


def _first_design_takes(T, Vv, control, trace):
    per_t, per_v, fixed = _FIRST_LANE_BYTES[(control, trace)]
    return (per_t * T + per_v * Vv + fixed + 15) // 16 * 16 <= _FIRST_LIMIT


def _largest(fits):
    """The largest T >= 1 with ``fits(T)`` (fits is monotone), or 0."""
    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("Vv", [1, 9, 41, 53, 256, 400, 512, 1024])
@pytest.mark.parametrize("control,trace", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_block_layout_takes_every_shape_of_the_first_design(control, trace,
                                                            Vv):
    first = _largest(lambda T: _first_design_takes(T, Vv, control, trace))
    ceiling = _largest(lambda T: tmk.lane_smem_bytes(
        T, Vv, control, trace, shared_sets=False) <= tmk.SMEM_PER_BLOCK)
    assert ceiling >= first > 0
    ts = sorted({1, 8, 64, 1024, first // 2, first - 1, first, ceiling})
    for T in ts:
        if not _first_design_takes(T, Vv, control, trace) and T != ceiling:
            continue
        lanes, shared = tmk.block_layout(T, Vv, control, trace)
        assert 1 <= lanes <= 2
        with_sets = tmk.lane_smem_bytes(T, Vv, control, trace)
        # the sets stay in shared memory while the lane fits with them
        assert shared == (with_sets <= tmk.SMEM_PER_BLOCK)
        per_lane = tmk.lane_smem_bytes(T, Vv, control, trace, shared)
        assert lanes * per_lane <= tmk.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tmk.block_layout(ceiling + 1, Vv, control, trace)
