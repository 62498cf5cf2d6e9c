"""The port's ``mr_schedule`` against the JAX package.

* ``mr_schedule_plain`` against the Pallas ``mr_schedule`` in interpret
  mode, on the reference's own seeded grids (``tests/test_kernels.py``:
  ``_random_batch``, made by the JAX encoder), both sched policies and all
  bindings mixed: ``start`` and ``finish`` bitwise.
* The same on lanes built to stress space-shared admission
  (``mr_stress.schedule_lanes``: one VM, ties and signed zeros in the
  ready times, fractional and zero PE counts, tasks bound out of range).
* The port's ``ops.schedule`` against the engine oracle ``schedule_ref``
  at the reference's tolerance (rtol 1e-4, atol 1e-2, as
  ``tests/test_kernels.py`` holds the Pallas kernel), and the paper's Table
  IV delay time.

The CUDA kernel itself is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import mr_stress
from repro.core import sweep as jsweep
from repro.kernels.mr_sched import kernel as jk
from repro.kernels.mr_sched import ops as jops
from repro.kernels.mr_sched.ref import schedule_ref
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.mr_sched import kernel as tk
from repro_torch.kernels.mr_sched import ops as tops


def _params(n, seed, mixed):
    """``tests/test_kernels.py:_random_batch``'s recipe (+ LOCALITY)."""
    rng = np.random.default_rng(seed)
    p = dict(
        n_maps=rng.integers(1, 21, n).astype(np.int32),
        n_reduces=rng.integers(1, 3, n).astype(np.int32),
        n_vms=rng.integers(1, 10, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], n).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        vm_cost=np.ones(n, np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        job_data=rng.choice([2e5, 4e5], n).astype(np.float32),
    )
    if mixed:
        p["sched_policy"] = rng.integers(0, 2, n).astype(np.int32)
        p["binding_policy"] = rng.integers(0, 4, n).astype(np.int32)
    return p


def _batches(n, seed, mixed):
    p = _params(n, seed, mixed)
    return (jsweep.grid_arrays(p, pad_tasks=23, pad_vms=9),
            tsweep.grid_arrays(p, pad_tasks=23, pad_vms=9, device="cpu"))


@pytest.mark.parametrize("seed,mixed,tile", [(8, False, 8), (32, False, 32),
                                              (108, True, 8),
                                              (132, True, 32)])
def test_plain_matches_pallas_bitwise(seed, mixed, tile):
    jb, tb = _batches(32, seed, mixed)
    js, jf = jops.schedule(jb, tile=tile)
    ts, tf = tops.schedule(tb)
    for name, a, b in (("start", js, ts), ("finish", jf, tf)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.view(np.int32), err_msg=name)
    valid = np.asarray(jb.task_valid)
    assert (np.asarray(jf)[valid] < 1e29).all()        # every task finished


def test_plain_matches_pallas_on_kernel_inputs():
    """The kernel functions themselves, on the JAX wrapper's inputs."""
    jb, _ = _batches(16, 3, True)
    task_len, ready0, shuffle = jops._derived_inputs(jb)
    args = (np.asarray(task_len, np.float32), np.asarray(jb.task_vm),
            np.asarray(ready0, np.float32),
            np.asarray(jb.task_is_reduce).astype(np.int32),
            np.asarray(jb.task_valid).astype(np.int32),
            np.asarray(shuffle, np.float32)[:, None],
            np.asarray(jb.vm_mips), np.asarray(jb.vm_pes),
            np.asarray(jb.sched_policy)[:, None])
    want = jk.mr_schedule(*args, tile=4, interpret=True)
    got = tk.mr_schedule_plain(*(torch.tensor(x) for x in args))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      np.asarray(a).view(np.int32))
    # the default sched_policy is all time-shared, as in the reference
    want = jk.mr_schedule(*args[:8], tile=4, interpret=True)
    got = tk.mr_schedule_plain(*(torch.tensor(x) for x in args[:8]))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      np.asarray(a).view(np.int32))


@pytest.mark.parametrize("seed,mixed", [(8, False), (132, True)])
def test_schedule_matches_engine_oracle(seed, mixed):
    jb, tb = _batches(32, seed, mixed)
    s_ref, f_ref = schedule_ref(jb)
    s, f = tops.schedule(tb)
    valid = np.asarray(jb.task_valid)
    for got, want in ((s, s_ref), (f, f_ref)):
        np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                                   np.where(valid, np.asarray(want), 0),
                                   rtol=1e-4, atol=1e-2)


def test_schedule_reproduces_paper_delay():
    """Kernel schedule -> the paper's Table IV delay time, end to end."""
    batch = tsweep.product(tsweep.axis("n_maps", range(1, 11))).arrays(
        device="cpu")
    s, f = tops.schedule(batch)
    s, f = s.numpy(), f.numpy()
    valid = batch.task_valid.numpy()
    red = batch.task_is_reduce.numpy()
    for i, m in enumerate(range(1, 11)):
        is_red, is_map = red[i] & valid[i], ~red[i] & valid[i]
        delay = s[i][is_map].max() + s[i][is_red].max() - f[i][is_map].max()
        assert delay == pytest.approx(4250.0 / (m + 1), rel=1e-4)


def test_wrapper_takes_plain_version_on_cpu_and_never_falls_back():
    _, tb = _batches(8, 5, True)
    before = tk.mr_schedule.launches
    lanes = tops.kernel_inputs(tb)[:9]
    want = tk.mr_schedule_plain(*lanes)
    got = tk.mr_schedule(*lanes)
    assert tk.mr_schedule.launches == before          # no kernel launched
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs tensors on the card"):
        tops.schedule(tb, backend="cuda")
    with pytest.raises(ValueError, match="J=1"):
        jobs2 = tsweep.grid_arrays(_params(2, 1, False), pad_tasks=23,
                                   pad_vms=9, device="cpu")
        tops.schedule(jobs2._replace(
            job_length=jobs2.job_length.repeat(1, 2)))


@pytest.mark.parametrize("T", [12, 40])
def test_plain_matches_pallas_on_admission_stress(T):
    lanes = mr_stress.schedule_lanes(20, T, seed=T)
    want = jk.mr_schedule(*lanes, tile=4, interpret=True)
    got = tk.mr_schedule_plain(*(torch.tensor(x) for x in lanes))
    for name, a, b in zip(("start", "finish"), want, got):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      np.asarray(a).view(np.int32),
                                      err_msg=name)
    assert (np.asarray(want[1])[lanes[4] != 0] < 1e29).any()


def test_kernel_shared_memory_layout():
    # the C source's lane_smem_bytes and the wrapper's agree, at one, two
    # and three task-set words per VM, with the VMs' task sets in shared
    # memory and in global scratch
    src = tk.__file__.rsplit("/", 1)[0] + "/csrc/mr_schedule.cu"
    text = open(src).read()
    assert "const int vw = shared_sets ? V * W : 0;" in text
    assert "(36 * T + 20 * V + 4 * vw + 12 * W + 15) / 16 * 16" in text
    for T, V in ((8, 1), (64, 16), (70, 9)):
        W = (T + 31) // 32
        for shared in (True, False):
            vw = V * W if shared else 0
            assert tk.lane_smem_bytes(T, V, shared) \
                == (36 * T + 20 * V + 4 * vw + 12 * W + 15) // 16 * 16
    assert tk.block_layout(64, 9) == (2, True)
    assert tk.block_layout(2048, 9) == (2, True)
    assert tk.block_layout(2048, 700) == (2, False)


def _first_design_launches(T, V):
    """Whether the first design of the kernel launched this shape: 4 lanes
    of ``43 T + 24 V + 4`` bytes in the block's 232,448."""
    return 4 * ((43 * T + 24 * V + 4 + 15) // 16 * 16) <= 232_448


@pytest.mark.parametrize("V", [1, 9, 100, 400, 1024, 2400])
def test_block_layout_takes_every_shape_of_the_first_design(V):
    first = max(T for T in range(1, 1400) if _first_design_launches(T, V))
    ceiling = max(T for T in range(1, 7000)
                  if tk.lane_smem_bytes(T, V, False) <= 232_448)
    assert ceiling >= first
    if V == 9:
        assert first == 1346 and ceiling >= 2048
    for T in sorted({1, 8, 64, first // 2, first, ceiling}):
        lanes, shared = tk.block_layout(T, V)
        assert shared == (tk.lane_smem_bytes(T, V) <= 232_448)
        assert 1 <= lanes <= 2
        assert lanes * tk.lane_smem_bytes(T, V, shared) <= 232_448
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tk.block_layout(ceiling + 1, V)
