"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one).  This file imports nothing of JAX, so on a machine with a
card and no JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX).  The kernel is held
against its plain PyTorch version on the card, bit for bit, and the sweep
path on the card against the same path on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sweep
from repro_torch.kernels.mr_sched import megakernel, ops


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _cols(n, T, seed):
    rng = np.random.default_rng(seed)
    return dict(
        n_maps=rng.integers(1, T, n).astype(np.int32),
        n_reduces=np.ones(n, np.int32),
        n_vms=rng.integers(1, 10, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], (n, 9)).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], (n, 9)).astype(np.float32),
        vm_cost=np.ones(n, np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        job_data=rng.choice([2e5, 8e5], n).astype(np.float32),
        sched_policy=rng.integers(0, 2, n).astype(np.int32),
        binding_policy=rng.integers(0, 4, n).astype(np.int32),
        storage_enabled=(rng.random(n) < 0.5).astype(np.float32),
        placement=np.ones(n, np.int32),
        job_submit=(rng.random(n) * 1e3).astype(np.float32),
        vm_start=rng.choice([0.0, 500.0], (n, 9)).astype(np.float32),
        vm_stop=np.where(rng.random((n, 9)) < 0.5, 1e30, 3e4
                         ).astype(np.float32),
        spinup_delay=rng.choice([0.0, 60.0], n).astype(np.float32),
        task_prio=rng.integers(0, 3, (n, T)).astype(np.float32))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 32, 64])
def test_kernel_matches_plain_on_card(T):
    dev = _card()
    batch = sweep.grid_arrays(_cols(512, T, T), pad_tasks=T, pad_vms=9,
                              device=dev)
    inputs = ops.kernel_inputs(batch)
    max_pes = ops.batch_max_pes(batch)
    before = megakernel.mr_epoch.launches
    got = megakernel.mr_epoch(*inputs, max_pes=max_pes)
    assert megakernel.mr_epoch.launches == before + 1
    want = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes)
    for name, a, b in zip(megakernel.STATE_LEAVES, want, got):
        assert torch.equal(_bits(a), _bits(b)), name
    split = max(1, int(got[7].max()) // 2)
    first = megakernel.mr_epoch(*inputs, max_pes=max_pes, epoch_limit=split)
    rest = megakernel.mr_epoch(inputs[0], inputs[1], None, *inputs[3:],
                               state=first, max_pes=max_pes,
                               epoch_limit=2 * T + 2 - split)
    for name, a, b in zip(megakernel.STATE_LEAVES, got, rest):
        assert torch.equal(_bits(a), _bits(b)), f"resumed {name}"


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    dev = _card()
    batch = sweep.grid_arrays(_cols(8, 8, 1), pad_tasks=8, pad_vms=9,
                              device=dev)
    inputs = list(ops.kernel_inputs(batch))
    bad = list(inputs)
    bad[1] = bad[1].to(torch.int64)                      # task_vm dtype
    with pytest.raises(TypeError):
        megakernel.mr_epoch(*bad)
    bad = list(inputs)
    bad[6] = bad[6].t().contiguous().t()                 # non-contiguous
    with pytest.raises(ValueError):
        megakernel.mr_epoch(*bad)
    bad = list(inputs)
    bad[12] = bad[12].cpu()                              # prio on the CPU
    with pytest.raises(ValueError):
        megakernel.mr_epoch(*bad)


@pytest.mark.cuda
def test_sweep_on_card_matches_cpu():
    dev = _card()
    cols = _cols(384, 24, 7)
    plan = sweep.product(sweep.Axis(("cell",), tuple(
        (i,) for i in range(384)), cols))
    before = megakernel.mr_epoch.launches
    card = plan.run(device=dev)
    assert megakernel.mr_epoch.launches > before
    cpu = plan.run(device="cpu")
    for k in cpu.metric_names:
        np.testing.assert_array_equal(card[k].view(np.int32),
                                      cpu[k].view(np.int32), err_msg=k)
