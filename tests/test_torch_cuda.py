"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one).  This file imports nothing of JAX, so on a machine with a
card and no JAX it runs alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX).  The four
instantiations of ``mr_epoch`` (open loop and control, untraced and traced)
and ``mr_schedule`` are held against their plain PyTorch versions on the
card, bit for bit (``mr_epoch`` also on lanes built to stress admission,
``mr_stress``), and the sweep and traced paths on the card against the
same paths on the CPU; compacted stepping (``run(compact=...)``,
``simulate_batch_arrays_compact``) on the card bit for bit against the dense
run, open loop, closed loop and traced, and ``costmodel.measure()`` on the
card.  The LM kernels (``flash_attention``, ``wkv6``) are
held against their plain versions (flash: float32 at 2e-6, summation
order; bfloat16 at 2 bf16 ulps + 1e-4, the tensor-core path; wkv6's y at
1e-4 and its final state bitwise), and the reduced yi-6b and rwkv6-3b
serving paths on the card against the same paths on the CPU, and so the
MoE and Mamba families (mixtral, llama4-scout, jamba; ``apply_moe`` with
dropped assignments, ``apply_mamba`` and ``mamba_step``).  The engine
body (multi-job lanes) runs on the card bit for bit as on the CPU, and as
``mr_epoch`` on single-job lanes.  Single-job lanes on the card hold to the
port's sequential oracle (``refsim``) at the reference's tolerances, and
``streaming.analyze_batch`` on the card is bitwise its CPU run.  The
``wkv6_bwd`` kernel is held against ``wkv6_bwd_plain`` (1e-4; gs0 and a
second launch bitwise; the gradient bitwise from run to run at the
training shape), the forward's kept states bitwise the plain scan's,
``WKV6`` against autograd through the plain scan, and three AdamW steps
of a reduced rwkv6 on the card against the CPU.
"""
import numpy as np
import pytest
import torch

import mr_stress
from repro_torch import configs
from repro_torch.core import control, costmodel, engine, sweep
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.mr_sched import kernel, megakernel, ops
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.models import decode_step, init_model, prefill
from repro_torch.models.layers import tree_map


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
    # one pinned calibration: the same buckets on both devices
    cm = costmodel.fallback_cost_model()
    before = megakernel.mr_epoch.launches
    card = plan.run(device=dev, cost_model=cm)
    assert megakernel.mr_epoch.launches > before
    cpu = plan.run(device="cpu", cost_model=cm)
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
    cm = costmodel.fallback_cost_model()
    before = megakernel.mr_epoch.control_launches
    card = plan.run(device=dev, cost_model=cm)
    assert megakernel.mr_epoch.control_launches > before
    cpu = plan.run(device="cpu", cost_model=cm)
    for k in cpu.metric_names:
        np.testing.assert_array_equal(card[k].view(np.int32),
                                      cpu[k].view(np.int32), err_msg=k)
    assert card["failures_injected"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("control_,trace", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_compacted_equals_dense_on_card(control_, trace):
    dev = _card()
    T = 32
    cols = _control_cols(512, T, 11) if control_ else _cols(512, T, 11)
    batch = sweep.grid_arrays(cols, pad_tasks=T, pad_vms=9, device=dev)
    dense = engine.simulate_batch_arrays(batch, control=control_,
                                         trace=trace)
    for k, legacy in ((1, False), (4, False), (4, True)):
        st = {}
        before = megakernel.total_launches()
        comp = engine.simulate_batch_arrays_compact(
            batch, k=k, control=control_, trace=trace, legacy=legacy,
            stats=st)
        assert megakernel.total_launches() - before == st["dispatches"]
        assert st["compactions"] > 0
        if not legacy:
            assert st["syncs"] == st["compactions"]
            assert st["scalar_syncs"] == st["dispatches"] + 1
        for name, a, b in zip(engine.SimOutput._fields, dense[0], comp[0]):
            assert torch.equal(_bits(a), _bits(b)), f"k={k} {name}"
        assert dense[1] == comp[1]
        if trace:
            for name, a, b in zip(dense[2]._fields, dense[2], comp[2]):
                assert torch.equal(_bits(a), _bits(b)), f"k={k} {name}"


@pytest.mark.cuda
def test_run_compact_on_card_matches_dense():
    dev = _card()
    cols = _control_cols(384, 24, 9)
    plan = sweep.product(sweep.Axis(("cell",), tuple(
        (i,) for i in range(384)), cols))
    cm = costmodel.fallback_cost_model()
    dense = plan.run(device=dev, cost_model=cm)
    for compact in ("auto", 2):
        res, rep = plan.run(device=dev, cost_model=cm, compact=compact,
                            report=True)
        for k in dense.metric_names:
            np.testing.assert_array_equal(res[k].view(np.int32),
                                          dense[k].view(np.int32),
                                          err_msg=f"{compact}: {k}")
        assert rep.compaction_syncs == sum(b.compactions
                                           for b in rep.buckets)
        assert rep.scalar_syncs == rep.dispatches + rep.n_buckets


@pytest.mark.cuda
def test_measure_on_card():
    dev = _card()
    before = megakernel.mr_epoch.launches
    cm = costmodel.measure(reps=3, device=dev)
    assert megakernel.mr_epoch.launches > before
    assert cm.source == "measured"
    assert cm.device == costmodel.device_key(dev) \
        == f"cuda:{torch.cuda.get_device_name(dev)}"
    assert cm.dispatch_us > 0 and cm.sync_us > 0
    # well above the floor that stands in for a slope lost in the noise
    n, maps, _, k_hi = costmodel.PROBE_CUDA
    assert cm.epoch_lane_us > 2e-6 / (n * (maps + 1))
    assert 1 <= cm.compact_interval(2048, 32) <= 64
    # the probe lanes outlast the largest chunk the slope times
    out = ops.epoch_schedule(costmodel._probe_batch(2, maps, dev))
    assert int(out.n_epochs.min()) > k_hi


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
@pytest.mark.parametrize("control_,trace", [(False, False), (True, False),
                                            (False, True), (True, True)])
@pytest.mark.parametrize("T,pes_delta", [(12, 0), (40, 3), (70, -3)])
def test_kernels_match_plain_on_admission_stress(T, pes_delta, control_,
                                                 trace):
    # one, two and three task-set words per VM; max_pes at, above and
    # below the largest PE count
    dev = _card()
    lanes, max_pes = mr_stress.stress_lanes(256, T, seed=T,
                                            control=control_)
    max_pes = max(1, max_pes + pes_delta)
    x = [torch.tensor(a, device=dev)
         for a in lanes[:28 if control_ else 13 + trace]]
    counter = ("control_" if control_ else "") + ("trace_" if trace else "") \
        + "launches"
    before = getattr(megakernel.mr_epoch, counter)
    got = megakernel.mr_epoch(*x, max_pes=max_pes, control=control_,
                              trace=trace)
    assert getattr(megakernel.mr_epoch, counter) == before + 1
    want = megakernel.mr_epoch_plain(*x, max_pes=max_pes, control=control_,
                                     trace=trace)
    for leaf, a, b in zip(megakernel.state_leaves(control_, trace), want,
                          got):
        assert torch.equal(_bits(a), _bits(b)), leaf


@pytest.mark.cuda
@pytest.mark.parametrize("control_,trace", [(False, False), (True, False),
                                            (False, True), (True, True)])
@pytest.mark.parametrize("T,V", [(1024, 400), (512, 3000)])
def test_kernels_match_plain_on_a_large_fleet(T, V, control_, trace):
    # (1024, 400): a lane takes a block of its own with its VMs' task sets
    # in shared memory; (512, 3000): the task sets live in global scratch
    dev = _card()
    shared = megakernel.block_layout(T, V, control_, trace)[1]
    assert shared == ((T, V) == (1024, 400))
    kinds = mr_stress.CONTROL_KINDS if control_ else mr_stress.OPEN_KINDS
    lanes, max_pes = mr_stress.stress_lanes(len(kinds), T, seed=T + V,
                                            control=control_, V=V)
    x = [torch.tensor(a, device=dev)
         for a in lanes[:28 if control_ else 13 + trace]]
    got = megakernel.mr_epoch(*x, max_pes=max_pes, control=control_,
                              trace=trace)
    want = megakernel.mr_epoch_plain(*x, max_pes=max_pes, control=control_,
                                     trace=trace)
    for leaf, a, b in zip(megakernel.state_leaves(control_, trace), want,
                          got):
        assert torch.equal(_bits(a), _bits(b)), leaf
    assert int((got[4] < 5e29).sum()) > T       # tasks finished


@pytest.mark.cuda
def test_kernels_raise_value_error_past_their_ceiling():
    dev = _card()
    for T, control_ in ((4352, False), (2873, True)):
        lanes, max_pes = mr_stress.stress_lanes(1, T, seed=1,
                                                control=control_, V=9)
        x = [torch.tensor(a, device=dev) for a in lanes[:28 if control_
                                                        else 13]]
        with pytest.raises(ValueError, match="bytes of shared memory"):
            megakernel.mr_epoch(*x, max_pes=max_pes, control=control_)
    x = [torch.tensor(a, device=dev)
         for a in mr_stress.schedule_lanes(1, 6386, seed=1, V=9)]
    before = kernel.mr_schedule.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        kernel.mr_schedule(*x)
    assert kernel.mr_schedule.launches == before


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


def _same(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x.cpu(), y.cpu()), f"{what}: {f}"


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["open", "control"])
def test_engine_body_on_card_matches_cpu_and_mr_epoch(control):
    """The engine body (no kernel: plain tensor ops) on the card: multi-job
    lanes bitwise the same body on the CPU, traced too; single-job lanes
    bitwise the ``mr_epoch`` kernel."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    import repro_torch.core as core
    dev = _card()
    scs = chip_smoke.multijob_scenarios(core, 256, 5, control=control,
                                        max_maps=6, vms=(2, 8))
    tb = sweep.stack_scenarios(scs, device="cpu", pad_tasks=40, pad_vms=8)
    cpu = engine.simulate_batch_arrays(tb, trace=True)
    before = megakernel.total_launches()
    card = engine.simulate_batch_arrays(
        engine.ScenarioArrays(*(x.to(dev) for x in tb)), trace=True)
    assert megakernel.total_launches() == before
    _same(cpu[0], card[0], "SimOutput")
    _same(cpu[2], card[2], "trace")
    assert cpu[1] == card[1]
    one = engine.ScenarioArrays(*(x.to(dev) for x in sweep.stack_scenarios(
        [s.replace(jobs=s.jobs[:1]) for s in scs], device="cpu",
        pad_tasks=16, pad_vms=8)))
    kern, rk = engine.simulate_batch_arrays(one, control=control)
    body, rb = engine.simulate_batch_arrays(one, control=control,
                                            backend="engine")
    _same(kern, body, "single-job lanes")
    assert rk == rb


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [12, 40, 70])
def test_schedule_kernel_matches_plain_on_admission_stress(T):
    # one, two and three task-set words per VM
    dev = _card()
    x = [torch.tensor(a, device=dev)
         for a in mr_stress.schedule_lanes(256, T, seed=T)]
    before = kernel.mr_schedule.launches
    got = kernel.mr_schedule(*x)
    assert kernel.mr_schedule.launches == before + 1
    want = kernel.mr_schedule_plain(*x)
    for name, a, b in zip(("start", "finish"), want, got):
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.cuda
@pytest.mark.parametrize("T,V", [(2048, 9), (1024, 1500)])
def test_schedule_kernel_matches_plain_on_long_lanes(T, V):
    # (2048, 9): task sets in shared memory; (1024, 1500): in global
    # scratch
    dev = _card()
    assert kernel.block_layout(T, V)[1] == (V == 9)
    x = [torch.tensor(a, device=dev)
         for a in mr_stress.schedule_lanes(10, T, seed=T + V, V=V)]
    got = kernel.mr_schedule(*x)
    want = kernel.mr_schedule_plain(*x)
    for name, a, b in zip(("start", "finish"), want, got):
        assert torch.equal(_bits(a), _bits(b)), name
    assert int((got[1] < 5e29).sum()) > T       # tasks finished


# ---------------------------------------------------------------------------
# LM kernels
# ---------------------------------------------------------------------------

FA_SHAPES = [(2, 128, 128, 4, 2, 32, True, None),
             (1, 256, 256, 8, 8, 16, True, 64),
             (2, 64, 64, 4, 1, 32, False, None),       # non-causal MQA
             (1, 128, 128, 2, 2, 64, True, None),
             (1, 96, 96, 2, 1, 8, True, 32),
             (1, 200, 200, 4, 2, 128, True, None),     # ragged 64-tiles
             (2, 320, 320, 4, 1, 128, True, 100),      # window, head_dim 128
             (2, 100, 260, 4, 2, 64, False, None),     # S < T
             (1, 192, 72, 2, 2, 32, False, None),      # S > T
             (1, 80, 80, 2, 1, 12, True, None),        # head_dim padded to 16
             # the Dh-80 and Dh-160 instantiations
             (2, 256, 256, 8, 2, 160, True, None),     # stablelm-12b's GQA 4
             (1, 200, 260, 4, 2, 160, False, None),    # ragged, S < T
             (1, 320, 320, 4, 1, 160, True, 100),      # window, head_dim 160
             (1, 64, 64, 2, 1, 150, True, None),       # bf16 padded to 152
             (2, 192, 192, 4, 4, 80, False, None),     # hubert: non-causal
             (1, 100, 100, 2, 1, 72, True, None),      # 72 in the 80 tiles
             # odd GQA groups: llama4-scout's 40/8 (5), and 3 at 80
             (1, 200, 200, 10, 2, 128, True, None),
             (1, 96, 96, 6, 2, 80, False, None)]
# bf16 against the plain version: 2 bf16 ulps of |want| + 1e-4 (the hi/lo
# split of p and the tensor cores' summation order, near outputs that
# cancel); float32 2e-6 (summation order).
BF16_ULPS, BF16_ATOL, F32_TOL = 2, 1e-4, 2e-6


def _assert_flash_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
        return
    want = want.float()
    diff = (got.float() - want).abs()
    tol = BF16_ULPS * fa_kernel.bf16_ulp(want) + BF16_ATOL
    assert bool((diff <= tol).all()), \
        f"max |diff| {float(diff.max())}, share {float((diff / tol).max())}"


def _fa_inputs(shape, dtype, dev, seed):
    B, S, T, Hq, Hkv, Dh, _, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(dev, dtype) for sh in ((B, S, Hq, Dh), (B, T, Hkv, Dh),
                                       (B, T, Hkv, Dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(shape, dtype):
    dev = _card()
    B, S, T, Hq, Hkv, Dh, causal, window = shape
    q, k, v = _fa_inputs(shape, dtype, dev, S + Dh)
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_kernel.flash_attention.launches == before + 1
    want = fa_kernel.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    _assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_refuses_head_dims_above_160_on_card(dtype):
    # 160 is the largest instantiation: above it the wrapper raises before
    # any launch, and never takes the plain version
    dev = _card()
    q, k, v = _fa_inputs((1, 64, 64, 2, 1, 168, True, None), dtype, dev, 0)
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="1 .. 160"):
        fa_kernel.flash_attention(q, k, v)
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["fused", "misaligned", "odd_stride"])
def test_flash_kernel_reads_strided_views_on_card(layout, dtype,
                                                  monkeypatch):
    """q, k, v as views of one fused projection (read through their
    strides), at a pointer 2 bytes off 16, and with a row stride that is
    not a multiple of 16 bytes: the same result as contiguous inputs,
    never through the plain version."""
    dev = _card()
    B, S, Hq, Hkv, Dh = 2, 96, 4, 2, 32
    width = (Hq + 2 * Hkv) * Dh + (1 if layout == "odd_stride" else 0)
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.standard_normal(B * S * width + 1)
                            .astype(np.float32)).to(dev, dtype)
    off = 1 if layout == "misaligned" else 0
    fused = flat[off:off + B * S * width].view(B, S, width)
    q = fused[..., :Hq * Dh].view(B, S, Hq, Dh)
    k = fused[..., Hq * Dh:(Hq + Hkv) * Dh].view(B, S, Hkv, Dh)
    v = fused[..., (Hq + Hkv) * Dh:(Hq + 2 * Hkv) * Dh].view(B, S, Hkv, Dh)
    if layout == "misaligned" and dtype == torch.bfloat16:
        assert q.data_ptr() % 16 == 2
    want = fa_kernel.flash_attention(*(x.contiguous() for x in (q, k, v)))

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(fa_kernel, "flash_attention_plain", refuse)
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v)
    assert fa_kernel.flash_attention.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("T", [0, 1, 77])
@pytest.mark.parametrize("hs", wkv_kernel.HEAD_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain_on_card(hs, dtype, T, with_s0):
    dev = _card()
    B, H = 2, 3
    rng = np.random.default_rng(hs)
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal((B, T, H, hs))
                                .astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.45, 0.95, (B, T, H, hs))
                         .astype(np.float32)).to(dev)
    u = torch.from_numpy((0.3 * rng.standard_normal((H, hs)))
                         .astype(np.float32)).to(dev)
    s0 = (torch.from_numpy((0.2 * rng.standard_normal((B, H, hs, hs)))
                           .astype(np.float32)).to(dev) if with_s0 else None)
    before = wkv_kernel.wkv6_scan.launches
    y, s = wkv_kernel.wkv6_scan(r, k, v, w, u, s0)
    assert wkv_kernel.wkv6_scan.launches == before + 1
    y2, s2 = wkv_kernel.wkv6_scan_plain(r, k, v, w, u, s0)
    # y: the kernel sums each column in partial sums over row groups;
    # the state: the same elementwise multiply and add per entry, bitwise
    torch.testing.assert_close(y, y2, atol=1e-4, rtol=1e-4)
    assert torch.equal(s, s2)


@pytest.mark.cuda
def test_lm_kernels_never_take_the_plain_path_on_card(monkeypatch):
    dev = _card()

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(fa_kernel, "flash_attention_plain", refuse)
    monkeypatch.setattr(wkv_kernel, "wkv6_scan_plain", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((1, 64, 2, 16), device=dev, dtype=dtype)
        fa_kernel.flash_attention(x, x, x)
    w = torch.full((1, 8, 2, 16), 0.5, device=dev)
    u = torch.zeros((2, 16), device=dev)
    wkv_kernel.wkv6_scan(w, w, w, w, u)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(torch.zeros((1, 8, 2, 256), device=dev),
                                  torch.zeros((1, 8, 2, 256), device=dev),
                                  torch.zeros((1, 8, 2, 256), device=dev))
    with pytest.raises(ValueError):
        wkv_kernel.wkv6_scan(*(torch.zeros((1, 4, 2, 12), device=dev),) * 4,
                             torch.zeros((2, 12), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yi-6b", "rwkv6-3b", "mixtral-8x7b",
                                  "llama4-scout-17b-a16e", "jamba-v0.1-52b"])
def test_serving_on_card_matches_cpu(name):
    dev = _card()
    cfg = configs.get(name).reduced(dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 14)))
    counts = (fa_kernel.flash_attention.launches,
              wkv_kernel.wkv6_scan.launches)
    out = {}
    for where, params in (("cpu", cpu), ("card", card)):
        t = toks.to(params["final_norm"]["scale"].device)
        lg, st = prefill(params, cfg, t[:, :12], 14, attn_impl="flash")
        lgs = [lg]
        for pos in (12, 13):
            lg, st = decode_step(params, cfg, t[:, pos], st, pos)
            lgs.append(lg)
        out[where] = [x.cpu() for x in lgs]
    # f32 end to end; the kernels' summation order differs (1e-5, as the
    # CPU parity tests)
    for a, b in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    grew = (fa_kernel.flash_attention.launches - counts[0],
            wkv_kernel.wkv6_scan.launches - counts[1])
    n_attn = sum(e["mixer"] == "attn" for e in cfg.block_pattern())
    assert grew == ((0, 3 * cfg.n_layers) if name == "rwkv6-3b"
                    else (n_attn, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-scout-17b-a16e",
                                  "jamba-v0.1-52b"])
def test_moe_on_card_matches_cpu(name):
    """``apply_moe`` with dropped assignments on the card: the routing and
    the ``keep`` set exact, the output at 1e-5 (f32, the products'
    summation order), as the same call on the CPU."""
    from repro_torch.models import moe
    dev = _card()
    cfg = configs.get(name).reduced(dtype="float32")
    rng = np.random.default_rng(3)
    decls = moe.moe_decls(cfg)
    cpu = {k: torch.from_numpy((0.3 * rng.standard_normal(p.shape))
                               .astype(np.float32)) for k, p in decls.items()}
    cpu["router"][0, 0] += 1.0                # expert 0 overflows
    x = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model))
                         .astype(np.float32))
    x[..., 0] = 3.0
    out = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        p = {k: v.to(d) for k, v in cpu.items()}
        xd = x.to(d)
        _, idx = moe._route(p, xd.reshape(-1, cfg.d_model), cfg)
        C = moe.capacity(cfg, xd.shape[0] * xd.shape[1])
        keep = moe._dispatch(idx[None], cfg.moe.n_experts, C)[2]
        out[where] = [t.cpu() for t in (moe.apply_moe(p, xd, cfg), idx,
                                        keep)]
    assert not out["cpu"][2].all()
    torch.testing.assert_close(out["card"][0], out["cpu"][0], atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(out["card"][1], out["cpu"][1])
    assert torch.equal(out["card"][2], out["cpu"][2])


@pytest.mark.cuda
def test_mamba_on_card_matches_cpu():
    """``apply_mamba`` with its state, then ``mamba_step``, on the card as
    on the CPU (f32 at 1e-5: the products' summation order)."""
    from repro_torch.models import ssm
    dev = _card()
    cfg = configs.get("jamba-v0.1-52b").reduced(dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    p_cpu = tree_map(lambda a: a[0], cpu["stack"]["sub0"]["mixer"])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    out = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        p = tree_map(lambda a: a.to(d), p_cpu)
        y, st = ssm.apply_mamba(p, x[:, :32].to(d), cfg, return_state=True)
        ys = [y]
        for t in range(32, 40):
            y, st = ssm.mamba_step(p, x[:, t:t + 1].to(d), st, cfg)
            ys.append(y)
        out[where] = [torch.cat(ys, dim=1).cpu(), st["h"].cpu(),
                      st["conv"].cpu()]
    for a, b in zip(out["card"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)




def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["open", "control"])
def test_card_holds_to_the_oracle(part):
    """A seeded set of phase 15 (b)'s single-job scenarios (64 of the open
    kinds, 64 of the closed-loop quarter) through ``mr_epoch`` on the card,
    traced, against the port's ``refsim``: the lanes that differ are the
    pinned lanes where the reference's own engine and refsim differ
    (ROADMAP C10)."""
    import repro_torch.core as core
    from repro_torch.core import refsim, telemetry
    chip_smoke = _chip_smoke()
    dev = _card()
    scs = chip_smoke.oracle_scenarios(core, chip_smoke.ORACLE_N,
                                      chip_smoke.ORACLE_SEED)
    lo = 0 if part == "open" else 3 * chip_smoke.ORACLE_N // 4
    scs = scs[lo:lo + 64]
    batch = sweep.stack_scenarios(scs, device=dev)
    before = megakernel.total_launches()
    out, _, buf = engine.simulate_batch_arrays(batch, trace=True)
    assert megakernel.total_launches() == before + 1
    host = lambda t: {k: v.cpu().numpy()                   # noqa: E731
                      for k, v in t._asdict().items()}
    worst, differs = chip_smoke.oracle_diff(
        scs, [refsim.simulate(s) for s in scs], host(out),
        host(engine.job_metrics(batch, out)),
        host(engine.scenario_metrics(batch, out)), telemetry.to_numpy(buf))
    assert sorted(differs) == [i - lo for i in chip_smoke.ORACLE_DIVERGENT
                               if lo <= i < lo + 64]
    assert worst < chip_smoke.ORACLE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smart-city", "dag32"])
def test_streaming_on_card_matches_cpu(kind):
    """``streaming.analyze_batch`` on the card, bitwise its CPU run."""
    from repro_torch.core import streaming
    chip_smoke = _chip_smoke()
    dev = _card()
    if kind == "smart-city":
        topo = chip_smoke.smart_city_grid(dev)
    else:
        topo = streaming.Topology(*(torch.from_numpy(x).to(dev) for x in
                                    chip_smoke.streaming_dags(1024, 5)))
    got = streaming.analyze_batch(topo)
    want = streaming.analyze_batch(streaming.Topology(
        *(x.cpu() for x in topo)))
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        g = got[k].cpu()
        if v.dtype == torch.float32:
            g, v = g.view(torch.int32), v.view(torch.int32)
        assert torch.equal(g, v), k


# ---------------------------------------------------------------------------
# training: the wkv6 backward kernel and a train step on the card
# ---------------------------------------------------------------------------

def _wkv_grad_case(B, H, T, hs, dtype, nonzero, dev, seed=0):
    rng = np.random.default_rng(seed + T + hs)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    r, k, v = (t(0.5 * rng.standard_normal((B, T, H, hs))).to(dtype)
               for _ in range(3))
    w = t(rng.uniform(0.45, 0.95, (B, T, H, hs)))
    u = t(0.3 * rng.standard_normal((H, hs)))
    gy = t(rng.standard_normal((B, T, H, hs)))
    s0 = t(0.2 * rng.standard_normal((B, H, hs, hs))) if nonzero else None
    gs = t(0.5 * rng.standard_normal((B, H, hs, hs))) if nonzero else None
    return r, k, v, w, u, s0, gy, gs


_K = wkv_kernel.CHUNK     # the forward keeps the state every _K steps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 40, 512, 64, False),
                                   (4, 40, 512, 64, True),
                                   (2, 8, 200, 64, True), (2, 8, 1, 64, True),
                                   (2, 3, 0, 16, True)]
                         + [(2, 3, 77, hs, True) for hs in (4, 8, 16, 32)]
                         + [(2, 8, T, 64, nz) for T in (_K - 1, _K, _K + 1,
                                                        64 + _K + 1, 203)
                            for nz in (False, True)]
                         + [(2, 3, _K + 1, hs, True) for hs in (4, 8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_matches_plain_on_card(shape, dtype):
    """``wkv6_bwd`` against ``wkv6_bwd_plain`` (chip_smoke phase 18 (a)'s
    shapes, every head size, T = 0, the T around the kept-state interval
    and T = 203, a multiple of neither it nor 64): gr, gk, gv, gw, gu at
    1e-4 (hs-term sums in another order), gs0 bitwise (G evolves by
    elementwise ops), and a second launch bitwise the first."""
    dev = _card()
    B, H, T, hs, nonzero = shape
    r, k, v, w, u, s0, gy, gs = _wkv_grad_case(B, H, T, hs, dtype, nonzero,
                                               dev)
    y, s, s_chk = wkv_kernel.wkv6_fwd(r, k, v, w, u, s0)
    y2, s2 = wkv_kernel.wkv6_scan(r, k, v, w, u, s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)  # keeping changes nothing
    before = wkv_kernel.wkv6_bwd.launches
    got = wkv_kernel.wkv6_bwd(r, k, v, w, u, s_chk, gy, gs)
    again = wkv_kernel.wkv6_bwd(r, k, v, w, u, s_chk, gy, gs)
    assert wkv_kernel.wkv6_bwd.launches == before + 2
    want = wkv_kernel.wkv6_bwd_plain(r, k, v, w, u, s0, gy, gs)
    for a, b, c in zip(got[:5], want[:5], again[:5]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        assert torch.equal(a, c)
    assert torch.equal(got[5], want[5]) and torch.equal(got[5], again[5])


@pytest.mark.cuda
def test_wkv6_gradient_is_deterministic_at_the_training_shape():
    """rwkv6-3b's layer call (4, 40, 512, 64) as the model makes it under
    grad: bf16 r/k/v, no initial state, the final state unused.  Two
    passes through ``WKV6`` (the forward keeping its states, the backward
    kernel, gu's sum over the batch, the casts back to bf16) give the same
    bits."""
    dev = _card()
    r, k, v, w, u, _, gy, _ = _wkv_grad_case(4, 40, 512, 64, torch.bfloat16,
                                             False, dev)
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    before = wkv_kernel.wkv6_bwd.launches
    runs = [torch.autograd.grad(wkv_kernel.wkv6_scan(*xs)[0], xs, gy)
            for _ in range(2)]
    assert wkv_kernel.wkv6_bwd.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 69, 64), (2, 3, 13, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_fwd_kept_states_are_the_plain_scans_states(shape, dtype):
    """``wkv6_fwd``'s ``s_chk`` holds, bit for bit, the state that
    ``wkv6_scan_plain`` reaches after every multiple of ``CHUNK`` steps
    (S_0 = s0 first): the states the backward replays from."""
    dev = _card()
    B, H, T, hs = shape
    r, k, v, w, u, s0, _, _ = _wkv_grad_case(B, H, T, hs, dtype, True, dev)
    _, _, s_chk = wkv_kernel.wkv6_fwd(r, k, v, w, u, s0)
    assert s_chk.shape == (B, H, -(-T // _K), hs, hs)
    for n in range(s_chk.shape[2]):
        t = n * _K
        _, want = wkv_kernel.wkv6_scan_plain(r[:, :t], k[:, :t], v[:, :t],
                                             w[:, :t], u, s0)
        assert torch.equal(s_chk[:, :, n], want), n


@pytest.mark.cuda
def test_wkv6_function_on_card_is_deterministic_and_matches_autograd():
    dev = _card()
    r, k, v, w, u, s0, gy, gs = _wkv_grad_case(2, 8, 200, 64, torch.float32,
                                               True, dev)
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    counts = (wkv_kernel.wkv6_scan.launches, wkv_kernel.wkv6_bwd.launches)
    runs = [torch.autograd.grad(wkv_kernel.wkv6_scan(*xs), xs, (gy, gs))
            for _ in range(2)]
    assert (wkv_kernel.wkv6_scan.launches - counts[0],
            wkv_kernel.wkv6_bwd.launches - counts[1]) == (2, 2)
    want = torch.autograd.grad(wkv_kernel.wkv6_scan_plain(*xs), xs,
                               (gy, gs))
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_wkv6_grad_never_takes_the_plain_path_on_card(monkeypatch):
    dev = _card()

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(wkv_kernel, "wkv6_scan_plain", refuse)
    monkeypatch.setattr(wkv_kernel, "wkv6_bwd_plain", refuse)
    r, k, v, w, u, s0, gy, gs = _wkv_grad_case(1, 2, 9, 16, torch.bfloat16,
                                               True, dev)
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    grads = torch.autograd.grad(wkv_kernel.wkv6_scan(*xs), xs, (gy, gs))
    assert [g.dtype for g in grads] == [x.dtype for x in xs]


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """Three AdamW steps of a reduced rwkv6 through ``make_train_step`` on
    the card (wkv6 and wkv6_bwd) against the same steps on the CPU (the
    plain versions), f32: losses and grad norms at rtol 1e-5, parameters
    at atol 2e-5, rtol 1e-5 with at most 1 in 100 beyond 1e-7.  AdamW
    normalises each gradient element by its own RMS (as
    ``tests/test_torch_train.py``), and the group norm after the WKV
    amplifies the two devices' summation orders at a sequence's first
    steps, where a head's output variance is below its eps (chip_smoke
    phase 18 (b)): measured 275 of 129,024 beyond 1e-7 on an H100."""
    from repro_torch.train import OptConfig, data, make_train_step, optimizer
    from repro_torch.models.layers import tree_items
    dev = _card()
    cfg = configs.get("rwkv6-3b").reduced(dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(dev), cpu)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    dcfg = data.DataConfig(cfg.vocab, 32, 2, seed=0)
    states = {"cpu": optimizer.init(cpu), "card": optimizer.init(card)}
    trees = {"cpu": cpu, "card": card}
    bwd0 = wkv_kernel.wkv6_bwd.launches
    for s in range(3):
        batch = data.batch_at(dcfg, s, device="cpu")
        m = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            step = make_train_step(cfg, ocfg, device=d)
            trees[where], states[where], m[where] = step(
                trees[where], states[where], batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m["card"][key]),
                                       float(m["cpu"][key]), rtol=1e-5)
    assert wkv_kernel.wkv6_bwd.launches - bwd0 == 3 * cfg.n_layers
    want = dict(tree_items(trees["cpu"]))
    beyond = total = 0
    for path, leaf in tree_items(trees["card"]):
        got = leaf.cpu().numpy()
        np.testing.assert_allclose(got, want[path].numpy(), atol=2e-5,
                                   rtol=1e-5, err_msg=str(path))
        beyond += int((np.abs(got - want[path].numpy()) > 1e-7).sum())
        total += got.size
    assert beyond <= total // 100
