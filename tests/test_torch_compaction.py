"""Active-lane compaction and the measured cost model of the port against
the JAX package.

The same seeded inputs (the JAX encoder's batch, copied bit for bit) go
through the JAX package's XLA ``engine.simulate_batch_arrays_compact`` and
dense ``simulate_batch_arrays``, and through the port's
``engine.simulate_batch_arrays_compact`` / ``ops.epoch_schedule_compact``
(the plain ``mr_epoch`` on the CPU):

* per policy combination, on a storage grid and on an elastic grid with
  stranded lanes, for K in {1, 4, "auto"}: every ``SimOutput`` field and
  ``realized_epochs`` exact against the reference, and the port's compacted
  run bitwise its dense run;
* closed loop (the control and deadline compaction cases of
  ``test_control.py`` and ``test_deadlines.py``): against the reference's
  per-lane ``simulate_arrays`` (never its batched engine, ROADMAP C6), with
  ``work_lost`` and the sums over tasks at rtol 1e-6 (ROADMAP C5); the C6
  repro lane compacted beside its long batch mate equals itself alone;
* traced compaction bitwise the port's dense trace;
* ``_take_lanes``/``_put_lanes`` round trips, the lean loop's sync census
  against the legacy loop, refused ``k``/``floor``/``compact`` values;
* the cost model: save/load, stale schemas, scoring and bucket partitions
  equal to the reference's for the same coefficients, the clamp, and a
  measurement on the CPU;
* ``run(compact=...)`` and ``run(stream_to=, chunk=)`` against the
  reference's and against ``SweepResult.to_table``.

Both packages price with the same pinned coefficients wherever buckets or
the compaction interval could differ; the port's cost cache lives under
each test's ``tmp_path`` (``torch_costpin``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import costmodel as jcost
from repro.core import engine as jengine
from repro.core import sweep as jsweep
from repro_torch.core import costmodel as tcost
from repro_torch.core import engine as tengine
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.mr_sched import ops as tops

import test_torch_control as tcc
from test_torch_sweep import assert_results_match
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)

_BIG = 1e30
KS = [1, 4, "auto"]
ALL_POLICIES = [(sp, bp) for sp in jconfig.SchedPolicy
                for bp in jconfig.BindingPolicy]
COEFFS = dict(dispatch_us=800.0, epoch_lane_us=0.05, sync_us=120.0)
JPIN = jcost.CostModel(**COEFFS, device="pinned")
TPIN = tcost.CostModel(**COEFFS, device="pinned")
ORDER_SENSITIVE = tcc.ORDER_SENSITIVE


# ---------------------------------------------------------------------------
# Grids (the reference suite's generators) and comparisons
# ---------------------------------------------------------------------------

def _random_params(n, seed, mixed_policies=True):
    rng = np.random.default_rng(seed)
    params = dict(
        n_maps=rng.integers(1, 21, n).astype(np.int32),
        n_reduces=rng.integers(1, 3, n).astype(np.int32),
        n_vms=rng.integers(1, 10, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], n).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        vm_cost=rng.choice([1.0, 2.0], n).astype(np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        job_data=rng.choice([2e5, 4e5], n).astype(np.float32))
    if mixed_policies:
        params["sched_policy"] = rng.integers(0, 2, n).astype(np.int32)
        params["binding_policy"] = rng.integers(0, 3, n).astype(np.int32)
    return params


def _storage_params(n, seed):
    rng = np.random.default_rng(seed)
    params = _random_params(n, seed)
    params.update(
        binding_policy=rng.integers(0, 4, n).astype(np.int32),
        storage_enabled=rng.integers(0, 2, n).astype(np.float32),
        replication=rng.integers(1, 4, n).astype(np.int32),
        placement=rng.integers(0, 2, n).astype(np.int32),
        block_size_mb=rng.choice([1024.0, 8192.0], n).astype(np.float32),
        storage_seed=rng.integers(0, 100, n).astype(np.int32))
    return params


def _elastic_params(n, seed):
    """Lease windows that close before some tasks become eligible: the
    grid has stranded lanes (asserted where used)."""
    rng = np.random.default_rng(seed)
    params = _random_params(n, seed)
    params.update(
        job_submit=rng.choice([0.0, 400.0], n).astype(np.float32),
        spinup_delay=rng.choice([0.0, 120.0], n).astype(np.float32),
        vm_start=rng.choice([0.0, 800.0], (n, 9)).astype(np.float32),
        vm_stop=rng.choice([900.0, 40000.0, _BIG], (n, 9)
                           ).astype(np.float32),
        task_prio=rng.integers(0, 3, (n, 23)).astype(np.float32))
    return params


def _port(jb):
    """The port's copy of a JAX batch, bit for bit, on the CPU."""
    return tengine.scenario_arrays_from_numpy(
        {f: np.asarray(getattr(jb, f)) for f in jengine.ScenarioArrays._fields},
        device="cpu")


def _pair(params, T=23, V=9):
    jb = jsweep.grid_arrays(params, pad_tasks=T, pad_vms=V)
    return jb, _port(jb)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_ref(want, got, what):
    """Port ``SimOutput`` against the reference's: bitwise, ``work_lost``
    at rtol 1e-6 (ROADMAP C5)."""
    for f in tengine.SimOutput._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, (what, f)
        if f == "work_lost":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(_bits(b), _bits(a),
                                          err_msg=f"{what}: {f}")


def _assert_same(want, got, what):
    """Two port results (tuples of tensors), bit for bit."""
    names = getattr(want, "_fields", range(len(want)))
    for name, a, b in zip(names, want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}"


# ---------------------------------------------------------------------------
# Open loop: compacted == the reference's compacted == the port's dense
# ---------------------------------------------------------------------------

def _check_open(params, k, what):
    jb, tb = _pair(params)
    jdense, jrz = jax.jit(jengine.simulate_batch_arrays)(jb)
    dense, rz = tengine.simulate_batch_arrays(tb)
    comp, crz = tengine.simulate_batch_arrays_compact(tb, k=k,
                                                      cost_model=TPIN)
    jcomp, jcrz = jengine.simulate_batch_arrays_compact(jb, k=k,
                                                        cost_model=JPIN)
    _assert_same(dense, comp, f"{what}: port dense vs compact")
    _assert_ref(jcomp, comp, f"{what}: reference compact vs port compact")
    _assert_ref(jdense, comp, f"{what}: reference dense vs port compact")
    assert crz == rz == int(jcrz) == int(jrz), what
    return jdense, comp


@pytest.mark.parametrize("sp,bp", ALL_POLICIES,
                         ids=[f"{sp.name}-{bp.name}"
                              for sp, bp in ALL_POLICIES])
def test_compact_matches_reference_per_policy(sp, bp):
    n = 24
    params = _random_params(n, seed=10 * int(sp) + int(bp),
                            mixed_policies=False)
    params["sched_policy"] = np.full(n, int(sp), np.int32)
    params["binding_policy"] = np.full(n, int(bp), np.int32)
    for k in KS:
        _check_open(params, k, f"{sp.name}/{bp.name} k={k}")


@pytest.mark.parametrize("k", KS, ids=[f"k{k}" for k in KS])
def test_compact_matches_reference_storage_grid(k):
    _check_open(_storage_params(48, seed=11), k, f"storage k={k}")


@pytest.mark.parametrize("k", KS, ids=[f"k{k}" for k in KS])
def test_compact_matches_reference_elastic_stranded(k):
    params = _elastic_params(48, seed=23)
    jdense, comp = _check_open(params, k, f"elastic k={k}")
    stranded = np.asarray(jdense.finish) >= _BIG / 2
    assert (stranded & np.asarray(_pair(params)[0].task_valid)).any(), \
        "the grid should strand lanes"
    np.testing.assert_array_equal(comp.finish.numpy() >= _BIG / 2, stranded)


@pytest.mark.parametrize("k", KS, ids=[f"k{k}" for k in KS])
def test_ops_compact_equals_dense_and_counts(k):
    _, tb = _pair(_random_params(64, seed=7))
    dense = tops.epoch_schedule(tb)
    st = {}
    comp, rz = tops.epoch_schedule_compact(tb, k=k, cost_model=TPIN,
                                           stats=st)
    _assert_same(dense, comp, f"ops k={k}")
    assert rz == int(dense.n_epochs.max())
    assert st["syncs"] == st["compactions"]
    assert st["scalar_syncs"] == st["dispatches"] + 1
    if k == 1:
        assert st["compactions"] > 0, "the grid must compact"


# ---------------------------------------------------------------------------
# The two host loops, donation, the census
# ---------------------------------------------------------------------------

def test_lean_loop_sync_census():
    """The lean loop pulls the order once per compaction and one scalar
    per round (plus the first check); the legacy loop pulls the whole
    mask every round, for the same compactions and chunk steps."""
    _, tb = _pair(_random_params(64, seed=7))
    st, stl = {}, {}
    lean, r1 = tengine.simulate_batch_arrays_compact(tb, k=1, stats=st)
    legacy, r2 = tengine.simulate_batch_arrays_compact(tb, k=1, stats=stl,
                                                       legacy=True)
    assert st["compactions"] > 0, "the grid must compact"
    assert st["syncs"] == st["compactions"]
    assert st["scalar_syncs"] == st["dispatches"] + 1
    assert stl["compactions"] == st["compactions"]
    assert stl["dispatches"] == st["dispatches"]
    assert stl["syncs"] > st["syncs"]
    assert stl["syncs"] >= stl["dispatches"]
    _assert_same(lean, legacy, "lean vs legacy")
    assert r1 == r2


def test_donated_store_is_bitwise_and_leaves_the_batch_alone():
    """In-place scatters touch only the loop's own store: donation on and
    off and the legacy loop agree bit for bit, and a second run over the
    same batch tensors is the same."""
    _, tb = _pair(_elastic_params(48, seed=23))
    before = [x.clone() for x in tb]
    lean, r1 = tengine.simulate_batch_arrays_compact(tb, k=2)
    off, r2 = tengine.simulate_batch_arrays_compact(tb, k=2, donate=False)
    legacy, r3 = tengine.simulate_batch_arrays_compact(tb, k=2, legacy=True)
    again, r4 = tengine.simulate_batch_arrays_compact(tb, k=2)
    for what, other in (("donate off", off), ("legacy", legacy),
                        ("repeat", again)):
        _assert_same(lean, other, what)
    assert r1 == r2 == r3 == r4
    for name, a, b in zip(tengine.ScenarioArrays._fields, before, tb):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# Closed loop: the control and deadline compaction cases
# ---------------------------------------------------------------------------

def _per_lane(jb):
    return jax.vmap(lambda sc: jengine.simulate_arrays(sc, control=True)
                    )(jb)


def _stranding_scenarios():
    """``test_control.py``'s stranding batch: two paper scenarios and one
    whose leases close before every task can start."""
    cfg = jconfig
    scs = [cfg.paper_scenario(n_maps=6, n_reduces=2, n_vms=3),
           cfg.paper_scenario(n_maps=8, n_reduces=2, n_vms=4,
                              sched_policy=cfg.SchedPolicy.SPACE_SHARED)]
    strand = scs[1].replace(
        vms=tuple(dataclasses.replace(v, lease_stop=500.0)
                  for v in scs[1].vms),
        elasticity=cfg.ElasticitySpec())
    return scs + [strand]


def _failure_scenario(seed, sp):
    sc = jconfig.paper_scenario(n_maps=6, n_reduces=2, n_vms=4,
                                sched_policy=sp)
    return sc.replace(control=jconfig.ControlSpec(
        failure_rate=0.002, failure_seed=seed, repair_delay=300.0,
        redispatch_delay=5.0))


def _armed(scs):
    """``test_deadlines.py``'s degenerate arming: SHED/BOOST, preemption
    and resume switched on, with no finite deadline."""
    return [sc.replace(control=dataclasses.replace(
        sc.control, deadline_policy=pol, deadline_slack=100.0,
        preempt=pre, preempt_resume=pre))
        for sc, pol, pre in zip(scs, (jconfig.DeadlinePolicy.SHED,
                                      jconfig.DeadlinePolicy.BOOST,
                                      jconfig.DeadlinePolicy.BOOST),
                                (True, True, False))]


def _autoscale_scenario(sp):
    cfg = jconfig
    vms = (cfg.VMSpec("base", mips=250.0), cfg.VMSpec("base", mips=250.0),
           cfg.VMSpec("res", mips=250.0, autoscale=True),
           cfg.VMSpec("res", mips=250.0, autoscale=True))
    job = cfg.JobSpec("j", length_mi=362_880.0, data_mb=200_000.0,
                      n_maps=12, n_reduces=2)
    return cfg.Scenario(vms=vms, jobs=(job,), sched_policy=sp,
                        control=cfg.ControlSpec(
                            policy=cfg.ControlPolicy.AUTOSCALE,
                            queue_threshold=2.0, busy_threshold=0.5))


def _control_cases():
    sps = list(jconfig.SchedPolicy)
    plain = jconfig.paper_scenario(n_maps=8, n_reduces=2, n_vms=4,
                                   sched_policy=jconfig.SchedPolicy
                                   .SPACE_SHARED)
    strand = _stranding_scenarios()[2]
    return {
        "degenerate_control": _stranding_scenarios(),
        "degenerate_deadline": _armed(_stranding_scenarios()),
        "failures_with_stranded": [
            _failure_scenario(seed, sp)
            for seed, sp in zip([7, 11, 23, 5], sps * 2)] + [plain, strand],
        "autoscale": [_autoscale_scenario(sp) for sp in sps],
    }


@pytest.mark.parametrize("case", sorted(_control_cases()))
def test_control_compact_matches_per_lane_reference(case):
    jb = jsweep.stack_scenarios(_control_cases()[case])
    tb = _port(jb)
    want = _per_lane(jb)
    dense, rz = tengine.simulate_batch_arrays(tb, control=True)
    _assert_ref(want, dense, f"{case}: dense")
    for k in KS:
        for legacy in (False, True):
            comp, crz = tengine.simulate_batch_arrays_compact(
                tb, k=k, control=True, cost_model=TPIN, legacy=legacy)
            _assert_same(dense, comp, f"{case} k={k} legacy={legacy}")
            assert crz == rz
        comp, crz = tops.epoch_schedule_compact(tb, k=k, control=True,
                                                cost_model=TPIN)
        _assert_same(dense, comp, f"{case} ops k={k}")
    if case.startswith("degenerate"):
        # degenerate control data: the open loop, epoch counts included
        jopen, _ = jax.jit(jengine.simulate_batch_arrays)(jb)
        _assert_ref(jopen, dense, f"{case}: open loop")


@pytest.mark.parametrize("kind", tcc.KINDS)
def test_control_grid_compact_matches_per_lane_reference(kind):
    """The closed-loop kinds of ``test_torch_control.py`` (failures with
    AUTOSCALE, deadlines with SHED/BOOST and preemption, reserve fleets,
    failover onto replica holders), compacted at K = 1 and 3."""
    jb = tcc._plan(jsweep, kind, 48, 16, 11).arrays()
    tb = _port(jb)
    want = _per_lane(jb)
    dense, rz = tengine.simulate_batch_arrays(tb, control=True)
    for k in (1, 3):
        st = {}
        comp, crz = tengine.simulate_batch_arrays_compact(
            tb, k=k, control=True, stats=st)
        _assert_same(dense, comp, f"{kind} k={k}")
        _assert_ref(want, comp, f"{kind} k={k}")
        assert crz == rz and st["compactions"] > 0


def test_c6_lane_compacted_beside_a_long_mate_is_itself_alone():
    """ROADMAP C6: the short lane of the repro, compacted out of a batch
    with its 40-times-longer mate, keeps the result it has alone, which
    is the reference's per-lane ``simulate_arrays``."""
    short_j, long_j = tcc._c6_scenarios()
    enc = [jengine.from_scenario(s, pad_tasks=16) for s in (short_j, long_j)]
    want = jengine.simulate_arrays(enc[0], control=True)

    def batch(encs):
        return tengine.scenario_arrays_from_numpy(
            {k: np.stack([np.asarray(getattr(e, k)) for e in encs])
             for k in jengine.ScenarioArrays._fields}, device="cpu")

    alone, _ = tengine.simulate_batch_arrays(batch(enc[:1]))
    paired = batch(enc)
    for k in (1, 2):
        st = {}
        comp, _ = tengine.simulate_batch_arrays_compact(paired, k=k,
                                                        floor=1, stats=st)
        assert st["compactions"] > 0, "the short lane must leave the set"
        _assert_same(tuple(x[:1] for x in alone),
                     tuple(x[:1] for x in comp), f"C6 k={k}")
    one = type(want)(*(np.asarray(x)[None] for x in want))
    _assert_ref(one, alone, "C6 per-lane reference")
    assert int(alone.n_scale[0]) == 3


@pytest.mark.parametrize("grid", ["failure", "overload"])
def test_control_sweep_compact_matches_dense_and_per_lane(grid):
    """``test_control.py``'s failure grid and ``test_deadlines.py``'s
    overload grid through ``run(compact=...)``: every metric the dense
    run's bit for bit and the reference's per-lane metrics."""
    def plan(sw):
        if grid == "failure":
            return (sw.product(sw.axis("vm_mips", [250.0, 500.0]),
                               sw.axis("sched_policy",
                                       list(jconfig.SchedPolicy)),
                               n_maps=6, n_reduces=2, n_vms=4,
                               redispatch_delay=5.0)
                    .failures(4, rate=0.002, n_vms=4, seed=7,
                              repair_delay=300.0))
        dl = [np.array([400.0] * 4 + [900.0] * 4 + [1200.0] * 2,
                       np.float32),
              np.array([250.0] * 8 + [2000.0] * 2, np.float32)]
        pr = np.array([0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 0.0, 1.0, 0.0, 0.0],
                      np.float32)
        return (sw.product(
            sw.axis("task_deadline", dl), sw.axis("deadline_policy",
                                                  [0, 1, 2]),
            sw.axis("preempt", [0, 1]),
            sw.axis("sched_policy", list(jconfig.SchedPolicy)),
            n_maps=8, n_reduces=2, n_vms=2, task_prio=pr,
            deadline_slack=100.0, preempt_resume=1, net_enabled=0.0,
            redispatch_delay=5.0)
            .failures(2, rate=0.002, n_vms=2, seed=7, repair_delay=200.0))

    jb = plan(jsweep).arrays()
    out = _per_lane(jb)
    jm = jax.vmap(jengine.job_metrics)(jb, out)
    sm = jax.vmap(jengine.scenario_metrics)(jb, out)
    tplan = plan(tsweep)
    dense = tplan.run(device="cpu", cost_model=TPIN)
    for compact in (1, 4):
        got = tplan.run(device="cpu", compact=compact, cost_model=TPIN)
        for f in dense.metric_names:
            np.testing.assert_array_equal(_bits(got[f]), _bits(dense[f]),
                                          err_msg=f"compact={compact}: {f}")
    for name, v in list(jm._asdict().items()) + list(sm._asdict().items()):
        a = np.asarray(v)
        a = a[:, 0] if a.ndim == 2 else a
        tcc._assert_metric(a.reshape(dense[name].shape), dense[name], name,
                           grid)
    assert (dense["failures_injected"] > 0).any()


# ---------------------------------------------------------------------------
# Traced compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("control", [False, True])
def test_traced_compact_equals_dense_trace(control):
    if control:
        tb = _port(tcc._plan(jsweep, "control", 32, 16, 5).arrays())
    else:
        _, tb = _pair(_random_params(48, seed=7))
    for events in (None, 6):
        out, rz, buf = tengine.simulate_batch_arrays(
            tb, control=control, trace=True, trace_events=events)
        for k in (1, 4):
            st = {}
            comp, crz, cbuf = tengine.simulate_batch_arrays_compact(
                tb, k=k, control=control, trace=True, trace_events=events,
                stats=st)
            assert st["compactions"] > 0 or k > 1
            _assert_same(out, comp, f"trace k={k} events={events}")
            _assert_same(buf, cbuf, f"buffers k={k} events={events}")
            assert crz == rz
        if events is not None:
            assert (buf.ev_n > events).any(), "the log must overflow"
    dense, ts = tops.epoch_schedule(tb, control=control, trace=True)
    comp, rz, cts = tops.epoch_schedule_compact(tb, k=3, control=control,
                                                trace=True)
    _assert_same(dense, comp, "ops trace")
    assert torch.equal(ts, cts)


# ---------------------------------------------------------------------------
# _take_lanes / _put_lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_take_put_roundtrip_identity(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 33))
    m = int(rng.integers(1, n + 1))
    tree = (torch.tensor(rng.normal(size=(n, int(rng.integers(1, 5))))
                         .astype(np.float32)),
            torch.tensor(rng.integers(-5, 9, size=(n, 1)).astype(np.int32)),
            None,
            torch.tensor(rng.integers(0, 2, size=(n, 3)) != 0))
    idx = torch.tensor(rng.permutation(n)[:m])
    sub = tengine._take_lanes(tree, idx)
    assert sub[2] is None and all(x.shape[0] == m for x in sub if x is not
                                  None)
    back = tengine._put_lanes(tree, idx, sub)
    for a, b in zip(tree, back):
        assert (a is None and b is None) or torch.equal(a, b)
    # the in-place form gives the same tensors and writes into its store
    store = tuple(None if x is None else x.clone() for x in tree)
    changed = tuple(None if x is None else x.index_select(0, idx).roll(1, 0)
                    for x in tree)
    want = tengine._put_lanes(store, idx, changed)
    got = tengine._put_lanes_donated(store, idx, changed)
    for a, b, s in zip(want, got, store):
        assert (a is None and b is None) or (torch.equal(a, b) and b is s)


def test_take_put_roundtrip_real_carry():
    """The property on a traced control carry, gathered out of order."""
    tb = _port(tcc._plan(jsweep, "reserves", 12, 8, 2).arrays())
    _, step, _, lanes, _ = tops._prepare(tb, None, None, True, True, None,
                                         "test")
    c0 = tops._initial(tb, lanes, True, True, None)
    idx = torch.tensor(np.random.default_rng(0).permutation(12)[:8])
    back = tengine._put_lanes(c0, idx, tengine._take_lanes(c0, idx))
    _assert_same(c0, back, "carry round trip")


# ---------------------------------------------------------------------------
# Refused values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, -2, 1.5, "never", True])
def test_compact_paths_reject_bad_k(k):
    _, tb = _pair(_random_params(8, seed=1))
    with pytest.raises(ValueError, match="k"):
        tengine.simulate_batch_arrays_compact(tb, k=k)
    with pytest.raises(ValueError, match="k"):
        tops.epoch_schedule_compact(tb, k=k)


@pytest.mark.parametrize("floor", [0, -4, 6])
def test_compact_paths_reject_bad_floor(floor):
    _, tb = _pair(_random_params(8, seed=1))
    with pytest.raises(ValueError, match="floor"):
        tengine.simulate_batch_arrays_compact(tb, k=2, floor=floor)
    with pytest.raises(ValueError, match="floor"):
        tops.epoch_schedule_compact(tb, k=2, floor=floor)


@pytest.mark.parametrize("compact", [0, -1, "always", 2.5])
def test_run_rejects_bad_compact(compact):
    plan = tsweep.product(tsweep.axis("n_maps", (1, 2)))
    with pytest.raises(ValueError, match="compact"):
        plan.run(device="cpu", compact=compact)
    with pytest.raises(ValueError, match="compact"):
        jsweep.product(jsweep.axis("n_maps", (1, 2))).run(
            compact=compact, cost_model=JPIN)


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

def test_cost_model_roundtrip_and_file_format(tmp_path):
    path = tmp_path / "pinned.json"
    tcost.save_cost_model(TPIN, path)
    m1 = tcost.load_cost_model(path, device="pinned")
    m2 = tcost.load_cost_model(path)
    assert m1 == m2 == TPIN and m1.source == "cache"
    data = json.loads(path.read_text())
    assert data == {"schema": tcost.SCHEMA_VERSION,
                    "models": {"pinned": COEFFS}}
    # the reference writes the same format, and each reads the other's
    jpath = tmp_path / "jax.json"
    jcost.save_cost_model(JPIN, jpath)
    assert json.loads(jpath.read_text()) == data
    assert tcost.load_cost_model(jpath) == TPIN
    assert jcost.load_cost_model(path) == JPIN


def test_cost_model_stale_schema_invalidated(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(
        {"old-dev": {"dispatch_us": 1.0, "epoch_lane_us": 9.9}}))
    with pytest.raises(ValueError, match="schema"):
        tcost.load_cost_model(path, device="old-dev")
    path.write_text(json.dumps(
        {"schema": tcost.SCHEMA_VERSION + 1,
         "models": {"d": {"dispatch_us": 1.0, "epoch_lane_us": 1.0}}}))
    with pytest.raises(ValueError, match="schema"):
        tcost.load_cost_model(path)
    tcost.save_cost_model(TPIN, path)
    data = json.loads(path.read_text())
    assert data["schema"] == tcost.SCHEMA_VERSION
    assert list(data["models"]) == ["pinned"]
    with pytest.raises(KeyError, match="no calibration"):
        tcost.load_cost_model(path, device="other")


def test_cost_model_constants_and_scores_match_reference():
    assert (tcost.SCHEMA_VERSION, tcost.COMPACT_INTERVAL_MIN,
            tcost.COMPACT_INTERVAL_MAX) == (jcost.SCHEMA_VERSION, 1, 64)
    assert jcost.COMPACT_INTERVAL_MIN == 1
    assert jcost.COMPACT_INTERVAL_MAX == 64
    fb_t, fb_j = tcost.fallback_cost_model(), jcost.fallback_cost_model()
    assert fb_t.to_json() == fb_j.to_json() and fb_t.source == "fallback"
    rng = np.random.default_rng(3)
    models = [COEFFS, dict(dispatch_us=1e12, epoch_lane_us=0.05,
                           sync_us=1e12),
              dict(dispatch_us=1e-9, epoch_lane_us=1e9, sync_us=1e-9),
              fb_j.to_json()]
    models += [dict(dispatch_us=float(d), epoch_lane_us=float(e),
                    sync_us=float(s))
               for d, e, s in zip(10 ** rng.uniform(0, 5, 8),
                                  10 ** rng.uniform(-5, 1, 8),
                                  10 ** rng.uniform(0, 4, 8))]
    for c in models:
        t, j = tcost.CostModel(**c), jcost.CostModel(**c)
        for n, pad in ((1, 1), (8, 8), (64, 21), (2048, 23), (16384, 64),
                       (65536, 64), (100, 4)):
            assert t.compact_interval(n, pad) == j.compact_interval(n, pad)
            assert t.bucket_cost_us(n, pad) == j.bucket_cost_us(n, pad)
            assert t.split_gain_us(n, pad, 64) == j.split_gain_us(n, pad, 64)
    huge = tcost.CostModel(dispatch_us=1e12, epoch_lane_us=0.05,
                           sync_us=1e12)
    tiny = tcost.CostModel(dispatch_us=1e-9, epoch_lane_us=1e9,
                           sync_us=1e-9)
    assert huge.compact_interval(2048, 21) == tcost.COMPACT_INTERVAL_MAX
    assert tiny.compact_interval(2048, 21) == tcost.COMPACT_INTERVAL_MIN


def test_bucket_partition_matches_reference_and_is_deterministic():
    params = _random_params(300, seed=11)
    g1 = tsweep._bucket_groups(params, 23, 9, "auto", cost=TPIN)
    g2 = tsweep._bucket_groups(params, 23, 9, "auto", cost=TPIN)
    gj = jsweep._bucket_groups(params, 23, 9, "auto", cost=JPIN)
    assert len(g1) == len(g2) == len(gj) > 1
    for a, b, c in zip(g1, g2, gj):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[0], c[0])
        assert a[2:] == b[2:] == c[2:]


def test_bucket_split_follows_dispatch_cost():
    params = _random_params(300, seed=11, mixed_policies=False)
    cheap = tcost.CostModel(dispatch_us=10.0, epoch_lane_us=0.05)
    pricey = tcost.CostModel(dispatch_us=1e9, epoch_lane_us=0.05)
    n_cheap = len(tsweep._bucket_groups(params, 23, 9, "auto", cost=cheap))
    n_pricey = len(tsweep._bucket_groups(params, 23, 9, "auto",
                                         cost=pricey))
    assert n_pricey == 1 < n_cheap
    assert n_cheap == len(jsweep._bucket_groups(
        params, 23, 9, "auto",
        cost=jcost.CostModel(dispatch_us=10.0, epoch_lane_us=0.05)))


def test_default_cost_model_reads_the_pinned_file(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    tcost.save_cost_model(tcost.CostModel(dispatch_us=123.0,
                                          epoch_lane_us=0.01, sync_us=7.0,
                                          device="cpu"), path)
    monkeypatch.setenv(tcost.ENV_PATH, str(path))
    monkeypatch.setattr(tcost, "_CACHE", {})
    got = tcost.default_cost_model(device="cpu")
    assert (got.dispatch_us, got.epoch_lane_us, got.sync_us,
            got.source) == (123.0, 0.01, 7.0, "cache")
    assert tcost.default_cost_model(device="cpu") is got   # in memory


def test_measure_on_the_cpu_and_cache_it(tmp_path, monkeypatch):
    """With no cache file the default model is measured on the run's
    device, saved under the port's environment path, and read back."""
    path = tmp_path / "fresh" / "costmodel.json"
    monkeypatch.setenv(tcost.ENV_PATH, str(path))
    monkeypatch.setattr(tcost, "_CACHE", {})
    got = tcost.default_cost_model(device="cpu")
    assert got.source == "measured" and got.device == "cpu"
    assert got.dispatch_us > 0 and got.epoch_lane_us > 0 \
        and got.sync_us > 0
    assert tcost.load_cost_model(path, device="cpu") == got
    # the probe lanes outlast the largest chunk the slope times
    lanes, maps, _, k_hi = tcost.PROBE_CPU
    assert tcost.PROBE_CUDA[1:] == tcost.PROBE_CPU[1:]   # same lanes
    for n, m, k in ((8, 7, 9), (lanes, maps, k_hi)):
        out = tops.epoch_schedule(tcost._probe_batch(n, m, "cpu"))
        assert int(out.n_epochs.min()) > k
    monkeypatch.setattr(tcost, "_CACHE", {})
    assert tcost.default_cost_model(allow_measure=False,
                                    path=tmp_path / "none.json",
                                    device="cpu").source == "fallback"


# ---------------------------------------------------------------------------
# run(compact=...), run(report=True) and run(stream_to=)
# ---------------------------------------------------------------------------

def _mixed_plan(sw, n=96, seed=5):
    params = _random_params(n, seed)
    plan = sw.product(sw.zip_(*(sw.axis(k, list(v))
                                for k, v in params.items())))
    return plan.replace(pad_tasks=23, pad_vms=9)


@pytest.mark.parametrize("kw", [
    dict(compact="auto"), dict(compact=True), dict(compact=1),
    dict(bucket=False, compact=4), dict(chunk=17, compact=4)],
    ids=["auto", "true", "k1", "nobucket-k4", "chunk-k4"])
def test_run_compact_matches_reference(kw):
    want = _mixed_plan(jsweep).run(cost_model=JPIN, **kw)
    got = _mixed_plan(tsweep).run(device="cpu", cost_model=TPIN, **kw)
    assert_results_match(want, got, str(kw))
    dense = _mixed_plan(tsweep).run(device="cpu", cost_model=TPIN,
                                    **{k: v for k, v in kw.items()
                                       if k != "compact"})
    for name in dense.metric_names:
        np.testing.assert_array_equal(_bits(got[name]), _bits(dense[name]),
                                      err_msg=f"{kw}: {name}")


def test_run_compact_report_census():
    plan = _mixed_plan(tsweep, n=64, seed=3)
    base = plan.run(device="cpu", cost_model=TPIN)
    for kw in (dict(compact=1), dict(compact=2, chunk=20)):
        res, rep = plan.run(device="cpu", report=True, cost_model=TPIN,
                            **kw)
        for f in base.metric_names:
            if f == "realized_epochs" and "chunk" in kw:
                continue                    # follows the chunks
            np.testing.assert_array_equal(_bits(res[f]), _bits(base[f]),
                                          err_msg=f)
        assert rep.compact == kw["compact"]
        runs = sum(-(-b.cells // kw.get("chunk", b.cells))
                   for b in rep.buckets)
        assert rep.compaction_syncs == sum(b.compactions
                                           for b in rep.buckets) > 0
        assert rep.scalar_syncs == sum(b.compact_rounds
                                       for b in rep.buckets) + runs
        assert rep.cost_model == dict(COEFFS, device="pinned",
                                      source="static")
        assert rep.dispatches == 0          # the plain version on the CPU
    _, dense = plan.run(device="cpu", report=True)
    assert dense.compact is None and dense.compaction_syncs == 0
    assert dense.scalar_syncs == 0
    assert dense.cost_model["source"] == "cache"


def test_run_stream_to_reads_back_as_to_table(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    for compact in (None, 2):
        path = tmp_path / f"grid-{compact}.parquet"
        tplan = _mixed_plan(tsweep, n=40, seed=9)
        info = tplan.run(device="cpu", chunk=16, stream_to=path,
                         compact=compact, cost_model=TPIN)
        assert isinstance(info, tsweep.StreamedSweep)
        assert (info.n_cells, info.n_rows, info.n_chunks) == (40, 40, 3)
        disk = pq.read_table(path)
        mem = tplan.run(device="cpu", cost_model=TPIN).to_table()
        assert disk.column_names == list(mem)
        for name, col in mem.items():
            if name == "realized_epochs":    # follows the chunks
                continue
            np.testing.assert_array_equal(np.asarray(disk[name]),
                                          np.asarray(col), err_msg=name)
        # the reference's streamed file, chunk for chunk
        jpath = tmp_path / f"jax-{compact}.parquet"
        _mixed_plan(jsweep, n=40, seed=9).run(
            chunk=16, stream_to=jpath, compact=compact, cost_model=JPIN)
        jdisk = pq.read_table(jpath)
        assert jdisk.column_names == disk.column_names
        for name in disk.column_names:
            a, b = np.asarray(jdisk[name]), np.asarray(disk[name])
            if name in ORDER_SENSITIVE:
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
        meta = json.loads(pq.read_schema(path).metadata[b"repro_provenance"])
        assert "torch_version" in meta
    streamed, rep = tplan.run(device="cpu", chunk=16, report=True,
                              stream_to=tmp_path / "r.parquet",
                              cost_model=TPIN)
    assert streamed.n_rows == 40 and rep.n_cells == 40
    assert sum(b.cells for b in rep.buckets) == 40
    with pytest.raises(ValueError, match="chunk"):
        tplan.run(device="cpu", stream_to=tmp_path / "x.parquet")
