"""The port's traced path against the JAX package.

* Capacities: the port's time-series and event-log capacity formulas are
  the reference's.
* The kernel's trace lowering: the port's ``mr_epoch_plain(trace=True)``
  against the Pallas ``mr_epoch(trace=True)`` in interpret mode at
  ``tile=1``, open loop and control, on seeded lanes (made by the JAX
  encoder, so both read the same bits) that include stranded lanes (lease
  windows that close before the work is done): every carry leaf and the
  time series ``ts`` bitwise, but the control carry's ``work_lost``
  (a float sum over tasks, ROADMAP C5: rtol 1e-6).
* The traced driver: the port's ``engine.simulate_batch_arrays(trace=
  True)`` against ``jax.vmap`` of the reference's ``engine.simulate_arrays(
  trace=True)`` (the per-lane meaning, ROADMAP C6) on single-job failure,
  autoscale, stranded and deadline SHED + preemption lanes: all six trace
  leaves bitwise, and the traced ``SimOutput`` bitwise the untraced one.
* The ops entry point: the port's ``ops.epoch_schedule(trace=True)``
  time series against the JAX ``ops.epoch_schedule(trace=True)`` in
  interpret mode at ``tile=1``, bitwise, open loop and control.
* Overflow: an undersized event log keeps the first rows bitwise and
  counts the rest in ``dropped_events``.
* The refsim oracle: per-kind event counts exact, event times at rtol 2e-4
  (atol 1e-2), SHED counts only — the reference's own tolerances
  (``tests/test_telemetry.py``) — against the JAX package's ``refsim`` and
  against the port's, whose events are the reference's bit for bit.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import refsim
from repro.core import sweep as jsweep
from repro.core import telemetry as jtel
from repro.core.config import SchedPolicy, VMSpec, JobSpec
from repro.core.config import Scenario as JScenario
from repro.core.config import paper_scenario as jpaper
from repro.core.control import ControlPolicy as JControlPolicy
from repro.core.control import ControlSpec as JControlSpec
from repro.core.elasticity import ElasticitySpec as JElasticitySpec
from repro.kernels.mr_sched import megakernel as jmk
from repro.kernels.mr_sched import ops as jops
from repro_torch.core import config as tconfig
from repro_torch.core import control as tcontrol
from repro_torch.core import elasticity as telasticity
from repro_torch.core import engine as tengine
from repro_torch.core import refsim as trefsim
from repro_torch.core import sweep as tsweep
from repro_torch.core import telemetry as ttel
from repro_torch.kernels.mr_sched import megakernel as tmk
from repro_torch.kernels.mr_sched import ops as tops

import test_torch_control as tcc
import test_torch_mr_epoch as tme

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

V = 9
TRACE_FIELDS = ttel.TraceBuffers._fields


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def test_capacity_formulas():
    for T, Vv in ((1, 1), (8, 9), (21, 9), (64, 16)):
        for control in (False, True):
            assert ttel.timeseries_capacity(T, Vv, control) \
                == jtel.timeseries_capacity(T, Vv, control)
            assert ttel.event_capacity(T, Vv, control) \
                == jtel.event_capacity(T, Vv, control)
            assert tengine._trace_caps(T, Vv, control, True, None) \
                == jengine._trace_caps(T, Vv, control, True, None)
            assert tengine._trace_caps(T, Vv, control, True, 5) \
                == jengine._trace_caps(T, Vv, control, True, 5)
    assert tengine._trace_caps(8, 9, True, False, None) is None
    assert ttel.event_capacity(10, 4, True) == 11 * 10 + 2 * 4


# ---------------------------------------------------------------------------
# The kernel's trace lowering against the Pallas kernel (interpret, tile=1)
# ---------------------------------------------------------------------------

def _open_lanes(kind, n, T, seed):
    lanes, max_pes = tme._lanes(kind, n=n, T=T, seed=seed)
    b = jsweep.grid_arrays(tme._params(kind, n, T, seed), pad_tasks=T,
                           pad_vms=V)
    return lanes + (np.asarray(b.vm_valid).astype(np.int32),), max_pes


def _stranded_lanes(lanes):
    """Close every lease of the first four lanes at 500 s, so their work
    is stranded and they run to their epoch bound."""
    lanes = list(lanes)
    i_stop = 10                                   # vm_stop
    stop = lanes[i_stop].copy()
    stop[:4] = np.minimum(stop[:4], 500.0)
    lanes[i_stop] = stop
    return tuple(lanes)


@pytest.mark.parametrize("kind", ["mixed", "elastic", "tailheavy"])
def test_plain_trace_matches_pallas_open_loop(kind):
    lanes, max_pes = _open_lanes(kind, 24, 12, 40 + len(kind))
    lanes = _stranded_lanes(lanes)
    want = jmk.mr_epoch(*lanes[:13], vm_valid=lanes[13], max_pes=max_pes,
                        interpret=True, tile=1, trace=True)
    got = tmk.mr_epoch_plain(*(torch.tensor(x) for x in lanes),
                             max_pes=max_pes, trace=True)
    assert len(got) == 8 + 6 and len(want) == 8 + 1
    for name, a, b in zip(tmk.STATE_LEAVES + ("ts",), want, got[:9]):
        _assert_bitwise(a, b.numpy(), f"{kind}: {name}")
    # the stranded lanes never finish, and their rows fill up to n_epochs
    fin = np.asarray(want[4])
    assert (fin[:4] >= 5e29).any(), "no stranded lane"
    ts = np.asarray(want[8]).reshape(24, -1, 8)
    n_ep = np.asarray(want[7])[:, 0]
    np.testing.assert_array_equal((ts[:, :, 4] > 0).sum(axis=1), n_ep)


@pytest.mark.parametrize("kind", tcc.KINDS)
def test_plain_trace_matches_pallas_control(kind):
    lanes, max_pes = tcc._lanes(kind, n=24, T=12, seed=50 + len(kind))
    lanes = _stranded_lanes(lanes)
    want = jmk.mr_epoch(*lanes, max_pes=max_pes, interpret=True, tile=1,
                        control=True, trace=True)
    got = tmk.mr_epoch_plain(*(torch.tensor(x) for x in lanes),
                             max_pes=max_pes, control=True, trace=True)
    assert len(got) == 15 + 6 and len(want) == 15 + 1
    tcc._assert_carry(tuple(np.asarray(x) for x in want[:15]),
                      tuple(x.numpy() for x in got[:15]), kind)
    _assert_bitwise(want[15], got[15].numpy(), f"{kind}: ts")
    n_ep = np.asarray(want[7])[:, 0]
    ts = np.asarray(want[15]).reshape(24, -1, 8)
    np.testing.assert_array_equal((ts[:, :, 4] > 0).sum(axis=1), n_ep)


def test_plain_trace_resume_split_equals_one_call():
    lanes, max_pes = tcc._lanes("deadline", n=32, T=12, seed=9)
    t = tuple(torch.tensor(x) for x in lanes)
    full = tmk.mr_epoch_plain(*t, max_pes=max_pes, control=True, trace=True)
    split = int(full[7].max()) // 2
    first = tmk.mr_epoch_plain(*t, max_pes=max_pes, control=True, trace=True,
                               epoch_limit=split)
    rest = tmk.mr_epoch_plain(t[0], t[1], None, *t[3:], state=first,
                              max_pes=max_pes, control=True, trace=True)
    for name, a, b in zip(tmk.state_leaves(True, True), full, rest):
        _assert_bitwise(a.numpy(), b.numpy(), f"resumed {name}")


# ---------------------------------------------------------------------------
# The traced driver against jax.vmap(engine.simulate_arrays(trace=True))
# ---------------------------------------------------------------------------

def _recipes(port: bool) -> dict:
    """The single-job scenarios of the reference telemetry tests
    (``tests/test_telemetry.py``: ``_fail_scenario``, ``_scale_scenario``,
    ``_stranded`` and the open-loop parity case), in one package."""
    if port:
        cfg, ctl, el = tconfig, tcontrol, telasticity
        VM, Job, Sc, SP = cfg.VMSpec, cfg.JobSpec, cfg.Scenario, \
            cfg.SchedPolicy
        Spec, Pol, Elast, mk = (ctl.ControlSpec, ctl.ControlPolicy,
                                el.ElasticitySpec, cfg.paper_scenario)
    else:
        VM, Job, Sc, SP = VMSpec, JobSpec, JScenario, SchedPolicy
        Spec, Pol, Elast, mk = (JControlSpec, JControlPolicy,
                                JElasticitySpec, jpaper)

    def fail(sp):
        return mk(n_maps=6, n_reduces=2, n_vms=4, sched_policy=sp).replace(
            control=Spec(failure_rate=0.002, failure_seed=7,
                         repair_delay=300.0, redispatch_delay=5.0))

    def scale(sp):
        vms = (VM("base", mips=250.0), VM("base", mips=250.0),
               VM("res", mips=250.0, autoscale=True),
               VM("res", mips=250.0, autoscale=True))
        job = Job("j", length_mi=362_880.0, data_mb=200_000.0, n_maps=12,
                  n_reduces=2)
        return Sc(vms=vms, jobs=(job,), sched_policy=sp,
                  control=Spec(policy=Pol.AUTOSCALE, queue_threshold=2.0,
                               busy_threshold=0.5))

    base = mk(n_maps=6, n_reduces=2, n_vms=3, sched_policy=SP.SPACE_SHARED)
    stranded = base.replace(
        vms=tuple(dataclasses.replace(v, lease_stop=500.0)
                  for v in base.vms), elasticity=Elast())
    return {"open-loop": mk(n_maps=6, n_reduces=2, n_vms=3),
            "failures": fail(SP.SPACE_SHARED),
            "failures-ts": fail(SP.TIME_SHARED),
            "autoscale": scale(SP.SPACE_SHARED),
            "autoscale-ts": scale(SP.TIME_SHARED),
            "stranded": stranded}


_BATCH = ("failures", "failures-ts", "autoscale", "stranded")


def _scenarios():
    """Failure, autoscale and stranded scenarios, in both packages."""
    return tuple(tuple(_recipes(port)[k] for k in _BATCH)
                 for port in (False, True))


def _both_batches(cols, T):
    return (jsweep.grid_arrays(cols, pad_tasks=T, pad_vms=V),
            tsweep.grid_arrays(cols, pad_tasks=T, pad_vms=V, device="cpu"))


@functools.lru_cache(maxsize=None)
def _per_lane_reference(control, trace_events):
    """``jax.vmap`` of the reference's per-lane traced driver, jitted."""
    return jax.jit(jax.vmap(functools.partial(
        jengine.simulate_arrays, control=control, trace=True,
        trace_events=trace_events)))


def _check_traced_driver(jb, tb, control, what, trace_events=None):
    j_out, j_tb = _per_lane_reference(control, trace_events)(jb)
    out, realized, tb_ = tengine.simulate_batch_arrays(
        tb, control=control, trace=True, trace_events=trace_events)
    for f in TRACE_FIELDS:
        _assert_bitwise(getattr(j_tb, f), getattr(tb_, f).numpy(),
                        f"{what}: {f}")
    plain, realized0 = tengine.simulate_batch_arrays(tb, control=control)
    assert realized == realized0
    for f, a, b in zip(tengine.SimOutput._fields, plain, out):
        assert torch.equal(a, b), f"{what}: traced {f} differs"
    np.testing.assert_array_equal(out.n_epochs.numpy(),
                                  np.asarray(j_out.n_epochs))
    return out, j_tb, tb_


def test_traced_driver_matches_reference_on_scenarios():
    jsc, tsc = _scenarios()
    jb = jsweep.stack_scenarios(jsc)
    tb = tsweep.stack_scenarios(tsc, device="cpu")
    for f in tengine.ScenarioArrays._fields:
        _assert_bitwise(getattr(jb, f), getattr(tb, f).numpy(), f)
    out, _, t_tb = _check_traced_driver(jb, tb, True, "scenarios")
    tr = ttel.TraceResult(ttel.to_numpy(t_tb))
    assert (tr.dropped_events == 0).all()
    assert tr.counts_by_kind(0)["kill"] > 0          # failures fired
    assert tr.counts_by_kind(2)["scale_open"] > 0    # a reserve opened
    assert (tb.task_valid[3] & (out.finish[3] >= 5e29)).any()  # stranded


@pytest.mark.parametrize("kind", ["deadline", "control", "reserves",
                                  "failover_locality"])
def test_traced_driver_matches_reference_on_grids(kind):
    """The closed-loop kinds of ``chip_smoke.py`` (deadline: SHED/BOOST
    and preemption over failures), at T = 12."""
    rng = np.random.default_rng(21)
    cols = chip_smoke.fit_tasks(chip_smoke.control_columns(kind, 24, rng,
                                                           12), 12)
    jb, tb = _both_batches(cols, 12)
    _, j_tb, _ = _check_traced_driver(jb, tb, True, kind)
    kinds = np.asarray(j_tb.ev_kind)
    if kind == "deadline":
        assert (kinds == jtel.EV_SHED).any() or \
            (kinds == jtel.EV_PREEMPT).any()
    assert (kinds == jtel.EV_START).any()


def test_traced_driver_matches_reference_open_loop():
    cols = chip_smoke.fit_tasks(chip_smoke.mixed_columns(32, 4, 12), 12)
    jb, tb = _both_batches(cols, 12)
    _check_traced_driver(jb, tb, False, "open loop")


@pytest.mark.parametrize("control", [False, True])
def test_epoch_schedule_trace_matches_pallas(control):
    """``ops.epoch_schedule(trace=True)``: ``(SimOutput, ts)`` with ``ts``
    bitwise the Pallas trace lowering's, its ``SimOutput`` the untraced
    one's."""
    if control:
        jsc, tsc = _scenarios()
        jb = jsweep.stack_scenarios(jsc)
        tb = tsweep.stack_scenarios(tsc, device="cpu")
    else:
        cols = chip_smoke.fit_tasks(chip_smoke.mixed_columns(8, 6, 12), 12)
        jb, tb = _both_batches(cols, 12)
    _, want = jops.epoch_schedule(jb, tile=1, interpret=True,
                                  control=control, trace=True)
    out, ts = tops.epoch_schedule(tb, control=control, trace=True)
    _assert_bitwise(want, ts.numpy(), f"control={control}: ts")
    plain = tops.epoch_schedule(tb, control=control)
    for f, a, b in zip(tengine.SimOutput._fields, plain, out):
        assert torch.equal(a, b), f"traced {f} differs"


def test_event_overflow_drops_only_the_newest_rows():
    jsc, tsc = _scenarios()
    tb = tsweep.stack_scenarios(tsc, device="cpu")
    out, _, full = tengine.simulate_batch_arrays(tb, control=True,
                                                 trace=True)
    n_ev = full.ev_n.numpy()
    cap = 4
    assert (n_ev > cap).all(), "a lane too quiet to overflow"
    out2, _, tiny = tengine.simulate_batch_arrays(tb, control=True,
                                                  trace=True,
                                                  trace_events=cap)
    for a, b in zip(out, out2):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tiny.dropped_events, n_ev - cap)
    np.testing.assert_array_equal(tiny.ev_n.numpy(), n_ev)
    for f in ("ev_t", "ev_kind", "ev_task", "ev_vm"):
        _assert_bitwise(getattr(full, f).numpy()[:, :cap],
                        getattr(tiny, f).numpy(), f)
    _assert_bitwise(full.ts.numpy(), tiny.ts.numpy(), "ts")
    # and as the reference drops them
    jb = jsweep.stack_scenarios(jsc)
    _check_traced_driver(jb, tb, True, "overflow", trace_events=cap)


# ---------------------------------------------------------------------------
# The refsim oracle's events (the J = 1 cases of test_telemetry.py)
# ---------------------------------------------------------------------------

def _parity_cases():
    ref, port = _recipes(False), _recipes(True)
    return [(k, (ref[k], port[k])) for k in ("open-loop", "failures",
                                              "failures-ts", "autoscale",
                                              "autoscale-ts")]


@pytest.mark.parametrize("name,pair", _parity_cases(),
                         ids=[n for n, _ in _parity_cases()])
def test_trace_matches_refsim_events(name, pair):
    jsc, tsc = pair
    _, tr = ttel.trace_scenario(tsc, device="cpu")
    assert int(tr.dropped_events[0]) == 0
    jref, tref = refsim.simulate(jsc), trefsim.simulate(tsc)
    assert len(tref.events) == len(jref.events)
    for a, b in zip(jref.events, tref.events):
        assert np.float64(a[0]).tobytes() == np.float64(b[0]).tobytes() \
            and tuple(a[1:]) == tuple(b[1:]), f"{name}: {a} != {b}"
    for ref in (jref, tref):
        _check_trace_against(name, tr, ref)


def _check_trace_against(name, tr, ref):
    """The reference telemetry tests' event checks of one oracle run."""
    refc: dict[int, int] = {}
    for (_, k, _, _) in ref.events:
        refc[k] = refc.get(k, 0) + 1
    got = tr.counts_by_kind(0)
    for k, kname in ttel.EVENT_NAMES.items():
        assert got[kname] == refc.get(k, 0), f"{name}: {kname}"
    ev = tr.events()
    for k in ttel.EVENT_NAMES:
        if k == ttel.EV_SHED:
            continue                       # counts only (epoch-quantized)
        et = np.sort(ev["t"][ev["kind"] == k])
        rt = np.sort([t for (t, kk, _, _) in ref.events if kk == k])
        np.testing.assert_allclose(et, rt, rtol=2e-4, atol=1e-2,
                                   err_msg=f"{name}: {ttel.EVENT_NAMES[k]}")
    es = sorted((int(k), int(t), int(v))
                for k, t, v in zip(ev["kind"], ev["task"], ev["vm"])
                if k != ttel.EV_SHED)
    rs = sorted((int(k), int(t), int(v)) for (_, k, t, v) in ref.events
                if k != ttel.EV_SHED)
    assert es == rs, f"{name}: (kind, task, vm) rows differ"
    ts = tr.ts[0]
    act = ts[:, 4] > 0
    assert (np.diff(ts[act, 0]) >= -1e-6).all()
    assert int(ts[:, 5].sum()) == refc.get(ttel.EV_KILL, 0)
