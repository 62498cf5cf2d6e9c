"""The port's engine epoch body (multi-job lanes) against the JAX engine.

Seeded scenarios, most of them multi-job (``chip_smoke.
multijob_scenarios``: the smart-city family, open and closed loop, from
one numpy generator for both packages), go through the JAX engine
(``jax.vmap`` of ``engine.simulate_arrays``, its batched driver on the open
loop, its compacted driver, ``engine.simulate``, ``sweep.simulate_batch``,
``telemetry.trace_scenario``) and through the port on the CPU.  Schedules,
``n_epochs``, ``realized_epochs``, every integer and 14 of the 15 control
leaves are bitwise (floats compared as int32 views), and so are the trace
buffers; ``work_lost`` and the sum-based metrics are held at rtol 1e-6
(ROADMAP C5).  Under control the reference's batched driver lets a
finished lane move with its batch mates (ROADMAP C6), so closed-loop
results are held against ``jax.vmap(simulate_arrays)`` only.

The body is also held bitwise against ``mr_epoch``'s plain version on
single-job grids and on the admission-stress lanes of ``tests/
mr_stress.py`` whose semantics the engine shares, compacted runs against
dense ones, and a lane-chunked run against an unchunked one.
"""
import dataclasses
import functools
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import mr_stress
import repro.core as jcore
import repro_torch.core as tcore
from repro.core import engine as jengine
from repro.core import sweep as jsweep
from repro.core import telemetry as jtel
from repro_torch.core import engine as tengine
from repro_torch.core import sweep as tsweep
from repro_torch.core import telemetry as ttel
from repro_torch.core.util import fma32
from repro_torch.kernels.mr_sched import megakernel as tmk
from test_torch_engine import _scenario_pair, assert_metrics_match
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import multijob_scenarios  # noqa: E402

_BIG = 1e30
PAD = dict(pad_tasks=32, pad_jobs=4, pad_vms=6)
MJ = dict(max_maps=5, vms=(2, 6))        # multijob_scenario at test size
OUT_FIELDS = tengine.SimOutput._fields
TRACE_FIELDS = ttel.TraceBuffers._fields


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine body is hundreds of small ops per epoch: one thread each
    keeps them from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    x = np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_out(want, got, what, fields=OUT_FIELDS):
    """Every field bitwise, ``work_lost`` at rtol 1e-6 (C5)."""
    for f in fields:
        a, b = _bits(getattr(want, f)), _bits(getattr(got, f))
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        if f == "work_lost":
            np.testing.assert_allclose(b.view(np.float32),
                                       a.view(np.float32), rtol=1e-6,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


def _assert_same(want, got, what, fields=None):
    for f in fields or want._fields:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


def _stack(scs_j, **pad):
    """A JAX scenario list stacked by each package (the port's on the
    CPU); the encodings are held bitwise."""
    jb = jsweep.stack_scenarios(scs_j) if not pad else jax.tree.map(
        lambda *x: np.stack(x),
        *[jengine.from_scenario(s, **pad) for s in scs_j])
    tb = tsweep.stack_scenarios([_scenario_pair(s) for s in scs_j],
                                device="cpu", **pad)
    for f in jengine.ScenarioArrays._fields:
        np.testing.assert_array_equal(_bits(getattr(tb, f)),
                                      _bits(getattr(jb, f)), err_msg=f)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _multijob(control: bool, n: int = 40, seed: int = 3):
    return _stack(multijob_scenarios(jcore, n, seed, control=control, **MJ),
                  **PAD)


def _jax_lanes(jb, control, trace=False, trace_events=None):
    """The reference's per-lane meaning: ``jax.vmap(simulate_arrays)``."""
    fn = functools.partial(jengine.simulate_arrays, control=control,
                           trace=trace, trace_events=trace_events)
    return jax.jit(jax.vmap(fn))(jb)


@functools.lru_cache(maxsize=None)
def _jax_multijob(control: bool, trace: bool):
    return _jax_lanes(_multijob(control)[0], control, trace)


# ---------------------------------------------------------------------------
# The engine body against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("control", [False, True], ids=["open", "control"])
@pytest.mark.parametrize("trace", [False, True], ids=["", "trace"])
def test_engine_body_matches_vmapped_reference(control, trace):
    jb, tb = _multijob(control)
    want = _jax_multijob(control, trace)
    got = tengine.simulate_arrays(tb, control=control, trace=trace)
    if trace:
        (want, wtr), (got, gtr) = want, got
        _assert_same(wtr, gtr, "trace")
        assert int(np.asarray(gtr.ev_n).max()) <= gtr.ev_t.shape[1]
    _assert_out(want, got, f"control={control} trace={trace}")
    assert (tb.job_valid.sum(dim=1) > 1).all()
    if control:
        # every mechanism fires somewhere in the batch
        assert got.hit.any() and got.shed.any() and (got.n_scale > 0).any()
        assert (got.n_evict > 0).any()


@pytest.mark.parametrize("trace", [False, True], ids=["", "trace"])
def test_open_loop_batch_matches_batched_reference(trace):
    """On the open loop a finished lane is a fixed point, so the
    reference's batched driver is the per-lane one; its realized epoch
    count is the port's."""
    jb, tb = _multijob(False)
    want = jengine.simulate_batch_arrays(jb, control=False, trace=trace)
    got = tengine.simulate_batch_arrays(tb, trace=trace)
    _assert_out(want[0], got[0], "batched")
    assert got[1] == int(want[1])
    if trace:
        _assert_same(want[2], got[2], "batched trace")


def test_multi_job_heterogeneous_simulate():
    """test_engine_vs_refsim.py's multi-job case, engine side."""
    c = jcore
    jobs = (dataclasses.replace(c.JOB_SMALL, n_maps=5),
            dataclasses.replace(c.JOB_MEDIUM, n_maps=3, n_reduces=2,
                                submit_time=500.0))
    sc = c.Scenario(vms=(c.VM_SMALL, c.VM_SMALL, c.VM_MEDIUM), jobs=jobs)
    want = jengine.simulate(sc)
    got = tengine.simulate(_scenario_pair(sc), device="cpu")
    assert got.makespan.shape == (1, 2)
    assert_metrics_match({k: np.asarray(v)[None] for k, v in
                          want._asdict().items()}, tengine.to_numpy(got),
                         "multi-job")


def test_padding_invariance():
    """Extra task, job and VM padding changes no bit of the schedule, nor
    of the reference's padded run."""
    c = jcore
    jobs = (dataclasses.replace(c.JOB_SMALL, n_maps=5),
            dataclasses.replace(c.JOB_BIG, n_maps=2, submit_time=300.0))
    sc = c.Scenario(vms=(c.VM_SMALL, c.VM_LARGE), jobs=jobs,
                    sched_policy=c.SchedPolicy.SPACE_SHARED)
    base = tengine.simulate_arrays(_stack([sc])[1])
    jb, tb = _stack([sc], pad_tasks=32, pad_jobs=4, pad_vms=8)
    padded = tengine.simulate_arrays(tb)
    _assert_out(_jax_lanes(jb, False), padded, "padded vs reference")
    n = sc.total_tasks()
    for f in ("start", "finish", "ready", "exec_time"):
        np.testing.assert_array_equal(_bits(getattr(padded, f)[:, :n]),
                                      _bits(getattr(base, f)), err_msg=f)
    for f in ("n_epochs", "finish_time"):
        np.testing.assert_array_equal(_bits(getattr(padded, f)),
                                      _bits(getattr(base, f)), err_msg=f)


def test_sweep_grid_simulate_batch():
    """test_engine_vs_refsim.py's sweep grid through
    ``sweep.simulate_batch``, engine side."""
    want = jsweep.simulate_batch(jsweep.product(
        jsweep.axis("n_maps", range(1, 11)),
        jsweep.axis("n_vms", (3, 6))).arrays())
    got = tsweep.simulate_batch(tsweep.product(
        tsweep.axis("n_maps", range(1, 11)),
        tsweep.axis("n_vms", (3, 6))).arrays(device="cpu"))
    assert_metrics_match(want._asdict(), tengine.to_numpy(got), "grid")


def test_stack_scenarios_simulate_batch():
    """``sweep.simulate_batch(stack_scenarios(...))`` on single-job lanes
    (the ``mr_epoch`` path) and on multi-job lanes (the engine body)."""
    scs = [jcore.paper_scenario(n_maps=m) for m in (1, 4, 9)]
    multi = [dataclasses.replace(s, jobs=s.jobs + (dataclasses.replace(
        s.jobs[0], n_maps=2, submit_time=700.0),)) for s in scs]
    for lanes in (scs, multi):
        jb, tb = _stack(lanes)
        assert_metrics_match(jsweep.simulate_batch(jb)._asdict(),
                             tengine.to_numpy(tsweep.simulate_batch(tb)),
                             f"J={tb.job_valid.shape[1]}")


def _storage_scenario(seed, sp, plc):
    """A multi-job LOCALITY scenario on a skewed or uniform block store."""
    rng = np.random.default_rng(seed)
    c = jcore
    vms = tuple(c.VM_TYPES[k] for k in rng.choice(list(c.VM_TYPES), 5))
    jobs = tuple(dataclasses.replace(
        c.JOB_MEDIUM, name=f"j{i}", n_maps=int(rng.integers(2, 7)),
        n_reduces=int(rng.integers(1, 3)), submit_time=400.0 * i)
        for i in range(3))
    return c.Scenario(
        vms=vms, jobs=jobs, sched_policy=sp,
        binding_policy=c.BindingPolicy.LOCALITY,
        storage=c.StorageSpec(enabled=True, replication=2, placement=plc,
                              seed=seed, block_size_mb=4096.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_storage_lane_batched_and_port_bitwise(seed):
    """test_storage.py's locality parity, engine side: per-lane, batched
    and the port's engine body bitwise, on multi-job lanes."""
    c = jcore
    scs = [_storage_scenario(10 + seed, sp, plc)
           for sp in c.SchedPolicy for plc in c.Placement]
    scs.append(scs[0].replace(binding_policy=c.BindingPolicy.ROUND_ROBIN))
    jb, tb = _stack(scs, pad_tasks=24, pad_jobs=3, pad_vms=5)
    lane = _jax_lanes(jb, False)
    both, _ = jengine.simulate_batch_arrays(jb)
    _assert_same(lane, both, "reference batched")
    got, _ = tengine.simulate_batch_arrays(tb)
    _assert_out(lane, got, "port")
    assert tb.storage_enabled.bool().all()


def test_elastic_lane_batched_and_port_bitwise():
    """test_elasticity.py's lease-window parity, engine side, on
    multi-job lanes with Poisson arrivals and a spin-up delay."""
    c = jcore
    rng = np.random.default_rng(4)
    scs = []
    for i in range(6):
        vms = tuple(dataclasses.replace(
            c.VM_TYPES[k], lease_start=float(rng.choice([0.0, 200.0])),
            lease_stop=float(rng.choice([math.inf, 9000.0])))
            for k in rng.choice(list(c.VM_TYPES), 4))
        submits = c.elasticity.arrival_times(3, rate=1 / 500.0, seed=i)
        jobs = tuple(dataclasses.replace(
            c.JOB_SMALL, name=f"j{j}", n_maps=int(rng.integers(2, 6)),
            submit_time=float(t), priority=float(j % 2))
            for j, t in enumerate(submits))
        scs.append(c.Scenario(
            vms=vms, jobs=jobs, sched_policy=c.SchedPolicy(i % 2),
            elasticity=c.ElasticitySpec(spinup_delay=60.0)))
    jb, tb = _stack(scs, pad_tasks=24, pad_jobs=3, pad_vms=4)
    lane = _jax_lanes(jb, False)
    got, _ = tengine.simulate_batch_arrays(tb)
    _assert_out(lane, got, "elastic")
    assert (np.asarray(lane.finish) >= _BIG / 2).any()     # stranded tasks


def test_priority_jobs_win_the_shared_vm():
    """test_elasticity.py: the high-priority job's tasks take the shared
    space-shared VM first although submitted second, as in the
    reference."""
    c = jcore
    lo = dataclasses.replace(c.JOB_SMALL, n_maps=3, priority=0.0)
    hi = dataclasses.replace(c.JOB_SMALL, n_maps=3, priority=5.0)
    sc = c.Scenario(vms=(c.VM_SMALL,), jobs=(lo, hi),
                    sched_policy=c.SchedPolicy.SPACE_SHARED)
    jb, tb = _stack([sc])
    got = tengine.simulate_arrays(tb)
    _assert_out(_jax_lanes(jb, False), got, "priorities")
    start = got.start[0].numpy()
    hi_maps, lo_maps = start[4:7], start[0:3]
    assert hi_maps.max() < lo_maps.min()


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------

def _stranding(scs):
    """``scs`` plus a lane whose leases close early (stranded tasks)."""
    base = scs[-1]
    return scs + [base.replace(
        vms=tuple(dataclasses.replace(v, lease_stop=500.0)
                  for v in base.vms),
        elasticity=jcore.ElasticitySpec())]


def _two_job(sc, submit=400.0):
    return sc.replace(jobs=sc.jobs + (dataclasses.replace(
        sc.jobs[0], n_maps=3, submit_time=submit),))


def test_degenerate_control_bitwise_every_mode():
    """test_control.py's degenerate identity on multi-job lanes: with no
    closed-loop input the control lowering, the compacted runs and the
    reference's per-lane control run all give the open loop's schedule."""
    c = jcore
    scs = _stranding([_two_job(c.paper_scenario(n_maps=6, n_reduces=2,
                                                n_vms=3)),
                      _two_job(c.paper_scenario(
                          n_maps=8, n_reduces=2, n_vms=4,
                          sched_policy=c.SchedPolicy.SPACE_SHARED))])
    jb, tb = _stack(scs)
    assert not tengine._control_active(tb)
    ref, _ = tengine.simulate_batch_arrays(tb, control=False)
    assert (ref.finish[2] >= _BIG / 2).any(), "no stranded lane"
    on, _ = tengine.simulate_batch_arrays(tb, control=True)
    _assert_same(ref, on, "control=True")
    _assert_out(_jax_lanes(jb, True), on, "reference control=True")
    for k in (1, 4, "auto"):
        comp, _ = tengine.simulate_batch_arrays_compact(tb, k=k,
                                                        control=True)
        _assert_same(ref, comp, f"compact k={k}")


def _failure_scenario(seed, sp):
    c = jcore
    sc = c.paper_scenario(n_maps=6, n_reduces=2, n_vms=4, sched_policy=sp)
    return _two_job(sc).replace(control=c.ControlSpec(
        failure_rate=0.002, failure_seed=seed, repair_delay=300.0,
        redispatch_delay=5.0))


def test_failures_and_stranding_compact_like_dense():
    """test_control.py's failure lanes beside a plain and a stranded lane,
    multi-job: dense and compacted runs bitwise, per-lane the reference's,
    and the stranded lane's open-loop bound exactly."""
    c = jcore
    scs = [_failure_scenario(seed, sp)
           for seed, sp in zip([7, 11, 23, 5], list(c.SchedPolicy) * 2)]
    scs = _stranding(scs + [_two_job(c.paper_scenario(
        n_maps=8, n_reduces=2, n_vms=4,
        sched_policy=c.SchedPolicy.SPACE_SHARED))])
    jb, tb = _stack(scs)
    T = tb.task_valid.shape[1]
    ref, realized = tengine.simulate_batch_arrays(tb, control=True)
    _assert_out(_jax_lanes(jb, True), ref, "per-lane reference")
    assert ref.hit.any()
    assert (ref.finish[5] >= _BIG / 2).any()
    assert int(ref.n_epochs[5]) == 2 * T + 2
    for k in (1, 4, "auto"):
        comp, r = tengine.simulate_batch_arrays_compact(tb, k=k,
                                                        control=True)
        _assert_same(ref, comp, f"k={k}")
        assert r == realized


def _autoscale_scenario(sp):
    c = jcore
    vms = (c.VMSpec("base", mips=250.0), c.VMSpec("base", mips=250.0),
           c.VMSpec("res", mips=250.0, autoscale=True),
           c.VMSpec("res", mips=250.0, autoscale=True))
    jobs = (c.JobSpec("j", length_mi=362_880.0, data_mb=200_000.0,
                      n_maps=12, n_reduces=2),
            c.JobSpec("k", length_mi=362_880.0, data_mb=200_000.0,
                      n_maps=6, n_reduces=1, submit_time=900.0))
    return c.Scenario(vms=vms, jobs=jobs, sched_policy=sp,
                      control=c.ControlSpec(
                          policy=c.ControlPolicy.AUTOSCALE,
                          queue_threshold=2.0, busy_threshold=0.5))


def test_autoscale_engine_bitwise():
    """test_control.py's autoscale lanes, two jobs each: the port's body,
    dense and compacted, bitwise the reference's per-lane run; reserves
    open and close."""
    jb, tb = _stack([_autoscale_scenario(sp) for sp in jcore.SchedPolicy])
    lane = _jax_lanes(jb, True)
    got, _ = tengine.simulate_batch_arrays(tb, control=True)
    _assert_out(lane, got, "autoscale")
    comp, _ = tengine.simulate_batch_arrays_compact(tb, k=1, control=True)
    _assert_same(got, comp, "compact k=1")
    assert (got.n_scale >= 2).all()
    assert (got.vm_open[:, 2:4] < _BIG / 2).any()


def _overload(dlpol, *, preempt=False, resume=False, slack=0.0,
              sp=None, spacing=120.0,
              deadlines=(4000.0, 4600.0, 5200.0, 5800.0, 6400.0)):
    """test_deadlines.py's five staggered jobs on two small VMs."""
    c = jcore
    jobs = tuple(c.JobSpec(f"j{i}", length_mi=362_880.0, data_mb=200_000.0,
                           n_maps=3, n_reduces=1, submit_time=spacing * i,
                           priority=float(i % 3), deadline=deadlines[i])
                 for i in range(5))
    return c.Scenario(vms=(c.VM_SMALL,) * 2, jobs=jobs,
                      network=c.NetworkSpec(enabled=False),
                      sched_policy=sp or c.SchedPolicy.SPACE_SHARED,
                      control=c.ControlSpec(deadline_policy=dlpol,
                                            deadline_slack=slack,
                                            preempt=preempt,
                                            preempt_resume=resume))


def test_degenerate_deadline_bitwise_multi_job_staggered():
    """test_deadlines.py: staggered multi-job arrivals armed with
    degenerate deadline data stay the open loop, dense and compacted."""
    c = jcore
    plain = _overload(c.DeadlinePolicy.NONE, deadlines=(math.inf,) * 5)
    plain = plain.replace(jobs=tuple(
        dataclasses.replace(j, priority=0.0) for j in plain.jobs))
    armed = plain.replace(control=dataclasses.replace(
        plain.control, deadline_policy=c.DeadlinePolicy.SHED,
        deadline_slack=100.0, preempt=True, preempt_resume=True))
    jb, tb = _stack([plain, armed])
    a = tengine.simulate_arrays(_stack([plain])[1], control=False)
    b = tengine.simulate_arrays(_stack([armed])[1], control=True)
    _assert_same(a, b, "armed multi-job")
    both, _ = tengine.simulate_batch_arrays(tb, control=True)
    comp, _ = tengine.simulate_batch_arrays_compact(tb, k=2, control=True)
    _assert_same(both, comp, "compact multi-job")
    _assert_out(_jax_lanes(jb, True), both, "reference")
    for f in ("start", "finish", "ready"):
        np.testing.assert_array_equal(_bits(getattr(both, f)[0]),
                                      _bits(getattr(both, f)[1]))


_OVERLOADS = {
    "shed": dict(dlpol=1),
    "boost": dict(dlpol=2, slack=600.0),
    "preempt": dict(dlpol=0, preempt=True),
    "shed-preempt-resume": dict(dlpol=1, preempt=True, resume=True),
}


@pytest.mark.parametrize("name", list(_OVERLOADS))
def test_overload_matches_reference(name):
    """Sustained overload under SHED, BOOST and preemption (the closed
    loop's degradation policies), time- and space-shared."""
    kw = dict(_OVERLOADS[name])
    kw["dlpol"] = jcore.DeadlinePolicy(kw["dlpol"])
    scs = [_overload(sp=sp, **kw) for sp in jcore.SchedPolicy]
    jb, tb = _stack(scs)
    want = _jax_lanes(jb, True, trace=True)
    got = tengine.simulate_arrays(tb, control=True, trace=True)
    _assert_out(want[0], got[0], name)
    _assert_same(want[1], got[1], f"{name} trace")
    assert got[0].shed.any() or (got[0].n_evict > 0).any() \
        or name == "boost"


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def _fail_scenario():
    c = jcore
    sc = _two_job(c.paper_scenario(n_maps=6, n_reduces=2, n_vms=4,
                                   sched_policy=c.SchedPolicy.SPACE_SHARED))
    return sc.replace(control=c.ControlSpec(
        failure_rate=0.002, failure_seed=7, repair_delay=300.0,
        redispatch_delay=5.0))


def test_trace_bitwise_every_path():
    """test_telemetry.py: traced == untraced, and the buffers agree across
    the port's dense and compacted drivers and the reference's per-lane
    one, on failure, autoscale and stranded multi-job lanes."""
    c = jcore
    scs = _stranding([_fail_scenario(), _autoscale_scenario(
        c.SchedPolicy.SPACE_SHARED)])
    jb, tb = _stack(scs)
    ref, _ = tengine.simulate_batch_arrays(tb, control=True)
    out, _, buf = tengine.simulate_batch_arrays(tb, control=True,
                                                trace=True)
    _assert_same(ref, out, "traced")
    lane_out, lane_buf = _jax_lanes(jb, True, trace=True)
    _assert_out(lane_out, out, "reference traced")
    _assert_same(lane_buf, buf, "reference buffers")
    for k in (1, 3, "auto"):
        for legacy in (False, True):
            co, _, cb = tengine.simulate_batch_arrays_compact(
                tb, k=k, control=True, trace=True, legacy=legacy)
            _assert_same(ref, co, f"compact k={k} legacy={legacy}")
            _assert_same(buf, cb, f"compact k={k} legacy={legacy} buffers")


def test_trace_open_loop_identity():
    """test_telemetry.py: the open-loop trace leaves the schedule alone
    and logs one START and one FINISH per task."""
    sc = _two_job(jcore.paper_scenario(n_maps=6, n_reduces=2, n_vms=3))
    jb, tb = _stack([sc])
    base = tengine.simulate_arrays(tb, control=False)
    out, buf = tengine.simulate_arrays(tb, control=False, trace=True)
    _assert_same(base, out, "open-loop traced")
    want = _jax_lanes(jb, False, trace=True)[1]
    _assert_same(want, buf, "open-loop buffers")
    tr = ttel.TraceResult(ttel.to_numpy(buf))
    n = int(tb.task_valid.sum())
    counts = tr.counts_by_kind(0)
    assert counts["start"] == n and counts["finish"] == n
    assert sum(counts.values()) == 2 * n


_TRACE_CASES = {
    "shed": lambda: _overload(jcore.DeadlinePolicy.SHED),
    "preempt": lambda: _overload(jcore.DeadlinePolicy.NONE, preempt=True),
    "failures": _fail_scenario,
    "autoscale": lambda: _autoscale_scenario(jcore.SchedPolicy.TIME_SHARED),
}


@pytest.mark.parametrize("name", list(_TRACE_CASES))
def test_trace_scenario_matches_reference(name):
    """``telemetry.trace_scenario`` on multi-job scenarios: the port's
    SimOutput and TraceResult (events, counts, time series) equal the
    reference's."""
    sc = _TRACE_CASES[name]()
    want_out, want = jtel.trace_scenario(sc)
    got_out, got = ttel.trace_scenario(_scenario_pair(sc), device="cpu")
    _assert_out(jax.tree.map(lambda x: np.asarray(x)[None], want_out),
                got_out, name)
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)),
                                      err_msg=f"{name}: {f}")
    assert got.counts_by_kind(0) == want.counts_by_kind(0)
    assert int(got.dropped_events[0]) == 0


def test_undersized_event_log_drops_only_the_newest():
    """test_telemetry.py's overflow case: an event log of 4 rows keeps the
    first 4 events, counts the rest, and leaves the schedule alone."""
    jb, tb = _stack([_fail_scenario()])
    base = tengine.simulate_arrays(tb, control=True)
    _, full = tengine.simulate_arrays(tb, control=True, trace=True)
    assert int(full.ev_n[0]) > 4
    out, tiny = tengine.simulate_arrays(tb, control=True, trace=True,
                                        trace_events=4)
    _assert_same(base, out, "overflowed")
    _assert_same(_jax_lanes(jb, True, trace=True, trace_events=4)[1], tiny,
                 "reference")
    for f in ("ev_t", "ev_kind", "ev_task", "ev_vm"):
        np.testing.assert_array_equal(_bits(getattr(tiny, f)),
                                      _bits(getattr(full, f)[:, :4]),
                                      err_msg=f)
    assert int(tiny.ev_n[0]) == int(full.ev_n[0])
    tr = ttel.TraceResult(ttel.to_numpy(tiny))
    assert int(tr.dropped_events[0]) == int(full.ev_n[0]) - 4


def test_to_table_multi_job_long_form():
    """test_sweep_api.py: multi-job cells expand to one row per (cell,
    job); the values are the reference's."""
    scs = [jcore.paper_scenario(n_maps=1)]
    sc2 = jcore.Scenario(jobs=(scs[0].jobs[0], dataclasses.replace(
        scs[0].jobs[0], submit_time=500.0)))
    lanes = [sc2, sc2.replace(jobs=tuple(
        dataclasses.replace(j, n_maps=2) for j in sc2.jobs))]
    jb, tb = _stack(lanes)
    tables = []
    for sweep, batch in ((jsweep, jb), (tsweep, tb)):
        jm = sweep.simulate_batch(batch)
        out, _ = sweep.simulate_batch_arrays(batch)
        res = sweep.SweepResult(
            axis_names=(("cell",),), axis_labels=(((0,), (1,)),),
            metrics={"makespan": np.asarray(jm.makespan),
                     "finish_time": np.asarray(out.finish_time)}, n_jobs=2)
        tables.append(res.to_table())
    want, got = tables
    assert got["job"].tolist() == [0, 1, 0, 1]
    assert got["cell"].tolist() == [0, 0, 1, 1]
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# The engine body against mr_epoch's plain version (J = 1)
# ---------------------------------------------------------------------------

def _single_job(control, n=48, seed=21):
    scs = [dataclasses.replace(s, jobs=s.jobs[:1]) for s in
           multijob_scenarios(tcore, n, seed, control=control,
                              max_maps=12, vms=(2, 6))]
    return tsweep.stack_scenarios(scs, device="cpu", pad_tasks=16,
                                  pad_vms=6)


@pytest.mark.parametrize("control", [False, True], ids=["open", "control"])
@pytest.mark.parametrize("trace", [False, True], ids=["", "trace"])
def test_engine_body_matches_mr_epoch_on_single_job_lanes(control, trace):
    tb = _single_job(control)
    kern = tengine.simulate_batch_arrays(tb, trace=trace)
    body = tengine.simulate_batch_arrays(tb, trace=trace, backend="engine")
    _assert_same(kern[0], body[0], "SimOutput")
    assert kern[1] == body[1]
    if trace:
        _assert_same(kern[2], body[2], "trace")


# admission-stress kinds whose semantics the engine body shares: it has no
# max_pes cap (the calls pass the largest PE count), admits every
# priority, and reads a binding outside [0, V) as the reference's gathers
# do, not as the kernel's "no free PE"
STRESS_SHARED = ("one_vm", "ties", "signed_zero", "pes_edge",
                 "urgent_preempt", "failover")


def _stress_setup(lanes, control, trace):
    """The engine body's setup for ``mr_epoch`` lane data: a one-job
    batch whose per-task lengths, readiness, failover slot and refetch
    are the lanes' own."""
    t = [torch.as_tensor(x) for x in lanes]
    d = dict(zip(mr_stress._ORDER, t))
    N, T = d["task_vm"].shape
    V = d["vm_mips"].shape[1]
    z = torch.zeros(N)
    one = torch.ones((N, 1))
    col = {k: d[k][:, 0] for k in (
        "sched", "spinup", "ctl_policy", "ctl_queue", "ctl_busy",
        "redispatch", "dl_policy", "dl_slack", "preempt", "preempt_resume")}
    sc = tengine.ScenarioArrays(
        task_job=torch.zeros((N, T), dtype=torch.int32),
        task_is_reduce=d["is_red"] != 0, task_vm=d["task_vm"],
        task_valid=d["valid"] != 0, task_mult=d["task_len"],
        job_length=one, job_data=one * 0, job_n_maps=one.int(),
        job_n_reduces=one.int(), job_submit=one * 0,
        job_reduce_factor=one, job_valid=one.bool(), vm_mips=d["vm_mips"],
        vm_pes=d["vm_pes"], vm_cost=torch.ones_like(d["vm_mips"]),
        vm_valid=d["vm_valid"] != 0, net_enabled=z, net_bw=z + 1,
        kappa_in=z, kappa_shuffle=z, net_cost_per_unit=z,
        sched_policy=col["sched"], binding_policy=z.int(),
        block_vm=torch.full((N, T, V), -1, dtype=torch.int32),
        block_size=torch.zeros((N, T)), storage_enabled=z,
        vm_start=d["vm_start"], vm_stop=d["vm_stop"],
        spinup_delay=col["spinup"], bill_gran=z + 1, task_prio=d["prio"],
        vm_fail=d["vm_fail"], vm_restore=d["vm_restore"],
        vm_auto=d["vm_auto"] != 0, control_policy=col["ctl_policy"],
        ctl_queue=col["ctl_queue"], ctl_busy=col["ctl_busy"],
        redispatch_delay=col["redispatch"],
        task_deadline=d["task_deadline"], deadline_policy=col["dl_policy"],
        deadline_slack=col["dl_slack"], preempt=col["preempt"],
        preempt_resume=col["preempt_resume"])
    caps = tengine._trace_caps(T, V, control, trace, None)
    inv, c0 = tengine._epoch_setup(sc, control=control, trace=caps)
    inv = inv._replace(shuffle=d["shuffle"])
    c0 = c0._replace(rem=d["task_len"].clone(), ready=d["ready0"].clone())
    if control:
        vm_idx2, vm_in2 = tengine._slot(d["task_vm2"], V)
        inv = inv._replace(
            task_len=d["task_len"], task_vm2=d["task_vm2"], vm_idx2=vm_idx2,
            vm_in2=vm_in2, task_pes2=tengine._at(d["vm_pes"], vm_idx2),
            refetch=d["refetch"], fail2=tengine._at(d["vm_fail"], vm_idx2),
            rest2=tengine._at(d["vm_restore"], vm_idx2))
    return sc, inv, c0, t


@pytest.mark.parametrize("control", [False, True], ids=["open", "control"])
@pytest.mark.parametrize("trace", [False, True], ids=["", "trace"])
def test_engine_body_matches_mr_epoch_on_stress_lanes(control, trace):
    kinds = mr_stress.CONTROL_KINDS if control else mr_stress.OPEN_KINDS
    lanes, max_pes = mr_stress.stress_lanes(96, 24, 5, control)
    keep = np.array([kinds[i % len(kinds)] in STRESS_SHARED
                     for i in range(96)])
    lanes = tuple(x[keep] for x in lanes)
    sc, inv, c0, t = _stress_setup(lanes, control, trace)
    T, V = sc.task_valid.shape[1], sc.vm_mips.shape[1]
    c = tengine._drive(sc, inv, c0, 7 * T + V + 3, control=control,
                       trace=trace)
    want = tmk.mr_epoch_plain(*t[:28 if control else 13 + trace],
                              max_pes=max_pes, control=control, trace=trace)
    names = tmk.state_leaves(control, trace)
    got = dict(c._asdict(), n_epochs=c.epoch)
    if trace:
        got.update(tengine._engine_trace(c)._asdict())
    for name, w in zip(names, want):
        g = got[name]
        g = g.reshape(w.shape) if g.dim() < 2 or name == "ts" else g
        np.testing.assert_array_equal(_bits(g.to(w.dtype)), _bits(w),
                                      err_msg=name)
    assert c.running.any() or (c.finish < _BIG / 2).any()


# ---------------------------------------------------------------------------
# Lanes are independent: chunks, compaction, batch mates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("control", [False, True], ids=["open", "control"])
def test_lane_chunked_run_equals_one_pass(control, monkeypatch):
    _, tb = _multijob(control)
    one = tengine.simulate_batch_arrays(tb, trace=True)
    T = tb.task_valid.shape[1]
    monkeypatch.setattr(tengine, "LANE_BUDGET", 7 * T * T)
    assert len(list(tengine._lane_chunks(tb))) == 6
    chunked = tengine.simulate_batch_arrays(tb, trace=True)
    _assert_same(one[0], chunked[0], "chunked")
    _assert_same(one[2], chunked[2], "chunked trace")
    assert one[1] == chunked[1]
    comp = tengine.simulate_batch_arrays_compact(tb, k=3, trace=True)
    _assert_same(one[0], comp[0], "chunked compact")
    _assert_same(one[2], comp[2], "chunked compact trace")


@pytest.mark.parametrize("k", [1, 4, "auto"])
def test_compact_matches_dense_and_reference(k):
    """Compacted runs are the dense run bit for bit (lean and legacy
    loops), and on the open loop the reference's compacted driver's; the
    census adds up."""
    for control in (False, True):
        jb, tb = _multijob(control)
        dense, realized = tengine.simulate_batch_arrays(tb)
        for legacy in (False, True):
            st = {}
            got, r = tengine.simulate_batch_arrays_compact(
                tb, k=k, legacy=legacy, stats=st)
            _assert_same(dense, got, f"k={k} legacy={legacy}")
            assert r == realized
            if not legacy:
                assert st["syncs"] == st["compactions"]
                assert st["scalar_syncs"] == st["dispatches"] + 1
    jb, tb = _multijob(False)
    want, wr = jengine.simulate_batch_arrays_compact(
        jb, k=k, control=False,
        cost_model=jcore.costmodel.fallback_cost_model())
    got, r = tengine.simulate_batch_arrays_compact(tb, k=k)
    _assert_out(want, got, "reference compact")
    assert r == int(wr)


def test_lane_result_does_not_depend_on_batch_mates():
    """ROADMAP C6 for the engine body: under control a two-job lane
    alone, beside a long lane and beside the whole closed-loop batch gives
    the same bits, the reference's per-lane ``simulate_arrays``."""
    jb, tb = _multijob(True)
    want = _jax_multijob(True, False)
    n_epochs = np.asarray(want.n_epochs)
    reserves = tb.vm_auto.any(dim=1).numpy()
    lane = int(np.argmin(np.where(reserves, n_epochs, 1 << 30)))
    long_ = int(np.argmax(n_epochs))
    assert n_epochs[long_] > n_epochs[lane]
    for idx in ([lane], [lane, long_], list(range(len(n_epochs)))):
        sub = tengine.ScenarioArrays(*(x[idx] for x in tb))
        got = tengine.simulate_arrays(sub, control=True)
        pos = idx.index(lane)
        one = tengine.SimOutput(*(x[pos:pos + 1] for x in got))
        _assert_out(jax.tree.map(lambda x: np.asarray(x)[lane:lane + 1],
                                 want), one, f"batch {len(idx)}")


# ---------------------------------------------------------------------------
# XLA:CPU's fused multiply-adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [473.02246, 3375000.0])
def test_engine_tie_window_is_fused(x):
    """The reference's XLA lowering rounds ``t_next + 1e-6 * max(t_next,
    1)`` once.  Two one-map jobs on their own 1-MIPS VMs finish at ``x``
    and at ``y``, the larger of the fused and the twice-rounded threshold
    at ``t_next = x`` (they differ there): the second map completes in
    the first epoch only under the fused one's verdict."""
    x = np.float32(x)
    fused = np.float32(fma32(torch.tensor([1e-6]), torch.tensor([x]),
                             torch.tensor([x]))[0])
    unfused = np.float32(x + np.float32(1e-6) * x)
    assert fused != unfused
    y = max(fused, unfused)
    c = jcore
    vm = c.VMSpec("v", mips=1.0, pes=1)
    jobs = tuple(c.JobSpec(n, length_mi=float(v), data_mb=1.0, n_maps=1,
                           n_reduces=1) for n, v in (("a", x), ("b", y)))
    sc = c.Scenario(vms=(vm,) * 4, jobs=jobs,
                    network=c.NetworkSpec(enabled=False))
    jb, tb = _stack([sc])
    want = _jax_lanes(jb, False)
    assert np.asarray(want.finish)[0, 2] == (x if y <= fused else y)
    _assert_out(want, tengine.simulate_arrays(tb), "tie window")


def test_engine_fluid_advance_is_fused(monkeypatch):
    """The reference's XLA lowering rounds ``rem - (t_next - time) * r``
    once: the port with that site rounded twice leaves the reference on
    the closed-loop batch."""
    jb, tb = _multijob(True)
    want = _jax_multijob(True, False)
    fused = tengine.fma32
    calls = [0]

    def advance_unfused(a, b, c):
        # each epoch calls fma32 for the tie window, then the advance
        i, calls[0] = calls[0], calls[0] + 1
        return a * b + c if i % 2 else fused(a, b, c)

    monkeypatch.setattr(tengine, "fma32", advance_unfused)
    got = tengine.simulate_arrays(tb, control=True)
    assert calls[0] > 0
    differs = [f for f in ("start", "finish", "ready")
               if not np.array_equal(_bits(getattr(got, f)),
                                     _bits(getattr(want, f)))]
    assert differs, "the twice-rounded advance still matches"
