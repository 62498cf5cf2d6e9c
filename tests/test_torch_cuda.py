"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one).  This file imports nothing of JAX, so on a machine with a
card and no JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX).  The four
instantiations of ``mr_epoch`` (open loop and control, untraced and traced)
and ``mr_schedule`` are held against their plain PyTorch versions on the
card, bit for bit, and the sweep and traced paths on the card against the
same paths on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import control, engine, sweep
from repro_torch.kernels.mr_sched import kernel, megakernel, ops


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


def _control_cols(n, T, seed):
    """Closed-loop columns: failures with re-dispatch, AUTOSCALE with a
    reserve, deadlines with SHED/BOOST, preemption."""
    rng = np.random.default_rng(seed)
    cols = _cols(n, T, seed)
    cols["sched_policy"] = (rng.random(n) < 0.75).astype(np.int32)
    f, r = control.failure_times(9 * n, rate=0.002, seed=seed,
                                 repair_delay=600.0)
    sub = cols["job_submit"][:, None]
    cols["vm_fail"] = (np.asarray(f).reshape(n, 9) + sub).astype(np.float32)
    cols["vm_restore"] = (np.asarray(r).reshape(n, 9) + sub
                          ).astype(np.float32)
    cols["vm_auto"] = (np.arange(9)[None, :] == (cols["n_vms"] - 1)[:, None]
                       ) & (cols["n_vms"] > 1)[:, None]
    cols["vm_auto"] = cols["vm_auto"].astype(np.float32)
    cols["control_policy"] = rng.integers(0, 2, n).astype(np.int32)
    cols["ctl_queue"] = rng.choice([2.0, 8.0], n).astype(np.float32)
    cols["ctl_busy"] = np.full(n, 0.5, np.float32)
    cols["redispatch_delay"] = rng.choice([0.0, 30.0], n).astype(np.float32)
    dl = sub + rng.choice([300.0, 1200.0, 4800.0], (n, T))
    cols["task_deadline"] = np.where(rng.random((n, T)) < 0.5, 1e30, dl
                                     ).astype(np.float32)
    cols["deadline_policy"] = rng.integers(0, 3, n).astype(np.int32)
    cols["deadline_slack"] = rng.choice([0.0, 120.0], n).astype(np.float32)
    cols["preempt"] = rng.integers(0, 2, n).astype(np.int32)
    cols["preempt_resume"] = rng.integers(0, 2, n).astype(np.int32)
    return cols


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 32, 64])
def test_control_kernel_matches_plain_on_card(T):
    dev = _card()
    batch = sweep.grid_arrays(_control_cols(512, T, T), pad_tasks=T,
                              pad_vms=9, device=dev)
    inputs = ops.kernel_inputs(batch) + ops.control_lane_data(batch)
    max_pes = ops.batch_max_pes(batch)
    before = (megakernel.mr_epoch.launches,
              megakernel.mr_epoch.control_launches)
    got = megakernel.mr_epoch(*inputs, max_pes=max_pes, control=True)
    assert (megakernel.mr_epoch.launches,
            megakernel.mr_epoch.control_launches) == (before[0],
                                                      before[1] + 1)
    want = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes, control=True)
    for name, a, b in zip(megakernel.STATE_LEAVES_CONTROL, want, got):
        assert torch.equal(_bits(a), _bits(b)), name
    assert got[8].any() and got[12].any()      # kills and sheds happened
    split = max(1, int(got[7].max()) // 2)
    first = megakernel.mr_epoch(*inputs, max_pes=max_pes, control=True,
                                epoch_limit=split)
    rest = megakernel.mr_epoch(
        inputs[0], inputs[1], None, *inputs[3:], state=first,
        max_pes=max_pes, control=True,
        epoch_limit=megakernel.default_epoch_limit(T, 9, True) - split)
    for name, a, b in zip(megakernel.STATE_LEAVES_CONTROL, got, rest):
        assert torch.equal(_bits(a), _bits(b)), f"resumed {name}"


@pytest.mark.cuda
def test_control_kernel_on_degenerate_data_is_the_open_loop():
    dev = _card()
    batch = sweep.grid_arrays(_cols(512, 32, 3), pad_tasks=32, pad_vms=9,
                              device=dev)
    inputs = ops.kernel_inputs(batch)
    max_pes = ops.batch_max_pes(batch)
    open_ = megakernel.mr_epoch(*inputs, max_pes=max_pes)
    ctl = megakernel.mr_epoch(*inputs, *ops.control_lane_data(batch),
                              max_pes=max_pes, control=True)
    for name, a, b in zip(megakernel.STATE_LEAVES, open_, ctl[:8]):
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.cuda
def test_control_sweep_on_card_matches_cpu():
    dev = _card()
    cols = _control_cols(384, 24, 5)
    plan = sweep.product(sweep.Axis(("cell",), tuple(
        (i,) for i in range(384)), cols))
    before = megakernel.mr_epoch.control_launches
    card = plan.run(device=dev)
    assert megakernel.mr_epoch.control_launches > before
    cpu = plan.run(device="cpu")
    for k in cpu.metric_names:
        np.testing.assert_array_equal(card[k].view(np.int32),
                                      cpu[k].view(np.int32), err_msg=k)
    assert card["failures_injected"].sum() > 0


def _trace_inputs(batch, control_):
    """Lane data of a trace instantiation: the control tensors, or the
    open loop's vm_valid."""
    return ops.kernel_inputs(batch) + (
        ops.control_lane_data(batch) if control_
        else (batch.vm_valid.to(torch.int32).contiguous(),))


@pytest.mark.cuda
@pytest.mark.parametrize("control_", [False, True])
@pytest.mark.parametrize("T", [8, 32])
def test_trace_kernel_matches_plain_on_card(T, control_):
    dev = _card()
    cols = _control_cols(512, T, T + 50) if control_ else _cols(512, T, T)
    batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9, device=dev)
    inputs = _trace_inputs(batch, control_)
    max_pes = ops.batch_max_pes(batch)
    name = "control_trace_launches" if control_ else "trace_launches"
    before = getattr(megakernel.mr_epoch, name)
    got = megakernel.mr_epoch(*inputs, max_pes=max_pes, control=control_,
                              trace=True)
    assert getattr(megakernel.mr_epoch, name) == before + 1
    want = megakernel.mr_epoch_plain(*inputs, max_pes=max_pes,
                                     control=control_, trace=True)
    names = megakernel.state_leaves(control_, True)
    for leaf, a, b in zip(names, want, got):
        assert torch.equal(_bits(a), _bits(b)), leaf
    n_carry = len(names) - len(megakernel.TRACE_LEAVES)
    untraced = megakernel.mr_epoch(*inputs[:len(inputs) - (not control_)],
                                   max_pes=max_pes, control=control_)
    for leaf, a, b in zip(names, untraced, got[:n_carry]):
        assert torch.equal(_bits(a), _bits(b)), f"untraced {leaf}"
    # an undersized event log keeps the first rows and counts the rest
    E = 3
    st0 = megakernel.initial_state(
        inputs[0], inputs[2], inputs[3], inputs[4], inputs[9], inputs[10],
        inputs[16] if control_ else None,
        *engine._trace_caps(T, 9, control_, True, E))
    small = megakernel.mr_epoch(*inputs, state=st0, max_pes=max_pes,
                                control=control_, trace=True)
    small_plain = megakernel.mr_epoch_plain(*inputs, state=st0,
                                            max_pes=max_pes,
                                            control=control_, trace=True)
    for leaf, a, b in zip(names, small_plain, small):
        assert torch.equal(_bits(a), _bits(b)), f"E={E} {leaf}"
    for leaf, a, b in zip(names[n_carry + 1:], got[n_carry + 1:-1],
                          small[n_carry + 1:-1]):
        assert torch.equal(_bits(a[:, :E]), _bits(b)), f"kept {leaf}"
    assert torch.equal(got[-1], small[-1]) and int(got[-1].max()) > E


@pytest.mark.cuda
def test_traced_driver_on_card_matches_cpu():
    dev = _card()
    cols = _control_cols(256, 16, 9)
    card = sweep.grid_arrays(cols, pad_tasks=16, pad_vms=9, device=dev)
    cpu = sweep.grid_arrays(cols, pad_tasks=16, pad_vms=9, device="cpu")
    out, _, buf = engine.simulate_batch_arrays(card, control=True,
                                               trace=True)
    c_out, _, c_buf = engine.simulate_batch_arrays(cpu, control=True,
                                                   trace=True)
    for f, a, b in zip(buf._fields, buf, c_buf):
        assert torch.equal(_bits(a.cpu()), _bits(b)), f
    for f, a, b in zip(out._fields, out, c_out):
        assert torch.equal(_bits(a.cpu()), _bits(b)), f
    assert int((buf.ev_kind == 2).sum()) > 0          # kills were logged


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 32, 64])
def test_schedule_kernel_matches_plain_on_card(T):
    dev = _card()
    batch = sweep.grid_arrays(_cols(512, T, T + 30), pad_tasks=T, pad_vms=9,
                              device=dev)
    inputs = ops.kernel_inputs(batch)[:9]
    before = kernel.mr_schedule.launches
    got = kernel.mr_schedule(*inputs)
    assert kernel.mr_schedule.launches == before + 1
    want = kernel.mr_schedule_plain(*inputs)
    for name, a, b in zip(("start", "finish"), want, got):
        assert torch.equal(_bits(a), _bits(b)), name
    got = ops.schedule(batch)
    assert kernel.mr_schedule.launches == before + 2
    for name, a, b in zip(("start", "finish"), want, got):
        assert torch.equal(_bits(a), _bits(b)), f"ops.schedule {name}"
