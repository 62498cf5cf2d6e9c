"""The port's closed-loop control path against the JAX package.

Seeded closed-loop lanes (made by the JAX encoder, so both sides read the
same bits) of four kinds — seeded failures with AUTOSCALE over the elastic
grid, deadlines with SHED/BOOST and preemption, AUTOSCALE reserve fleets,
failover onto replica holders — go through:

* JAX ``mr_epoch(..., control=True, interpret=True)`` at ``tile=1`` and the
  port's ``mr_epoch_plain(control=True)``: 14 of the 15 carry leaves
  bitwise, ``work_lost`` at rtol 1e-6; also, untraced and traced, on lanes
  built to stress admission (``mr_stress``), which the port decides by
  per-task rank where the Pallas kernel scans;
* a per-lane JAX reference (``jax.vmap`` of ``engine.simulate_arrays(
  control=True)`` and its metrics) and the port's ``SweepPlan.run``:
  schedules and integer metrics exact, float metrics bitwise except the
  sums over tasks, at rtol 1e-6.

``work_lost`` is a float sum over tasks inside the kernel; XLA:CPU
vectorises that fused reduction in an order that depends on the row length
and the host's vector width, while the port sums in one fixed order on
every device (ROADMAP C5).  The CUDA kernel is held against the plain
version on the card in ``test_torch_cuda.py``.

A lane's result must not depend on its batch mates (ROADMAP C6): the port
stops each lane at its own end, the meaning of the reference's per-lane
``engine.simulate_arrays``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mr_stress
from repro.core import config as jconfig
from repro.core import control as jcontrol
from repro.core import costmodel as jcost
from repro.core import elasticity as jel
from repro.core import engine as jengine
from repro.core import sweep as jsweep
from repro.kernels.mr_sched import megakernel as jmk
from repro.kernels.mr_sched import ops as jops
from repro_torch.core import control as tcontrol
from repro_torch.core import engine as tengine
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.mr_sched import megakernel as tmk
from repro_torch.kernels.mr_sched import ops as tops
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)

V = 9
KINDS = ("control", "deadline", "reserves", "failover_locality")
ORDER_SENSITIVE = frozenset({
    "avg_exec", "map_avg_exec", "reduce_avg_exec", "vm_cost",
    "utilization", "transfer_bytes", "billed_cost", "vm_busy_fraction",
    "queue_wait", "wasted_work_frac"})


def _params(kind, n, T, seed):
    """Seeded closed-loop columns of one kind (failure rate 0.002/s so that
    failures land inside short jobs)."""
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
        binding_policy=rng.integers(0, 3, n).astype(np.int32),
    )
    if kind in ("control", "deadline"):
        p["job_submit"] = jel.arrival_times(n, rate=0.02, seed=seed)
        start = rng.choice([0.0, 500.0, 2000.0], (n, V)).astype(np.float32)
        p["vm_start"] = start
        p["vm_stop"] = np.where(rng.random((n, V)) < 0.5, 1e30,
                                start + p["job_submit"][:, None] + 40000.0
                                ).astype(np.float32)
        p["spinup_delay"] = rng.choice([0.0, 60.0], n).astype(np.float32)
        p["task_prio"] = rng.integers(0, 3, (n, T)).astype(np.float32)
        p["control_policy"] = np.ones(n, np.int32)
        p["ctl_queue"] = rng.choice([2.0, 8.0], n).astype(np.float32)
        p["ctl_busy"] = np.full(n, 0.5, np.float32)
    if kind in ("control", "deadline", "failover_locality"):
        f, r = jcontrol.failure_times(V * n, rate=0.002, seed=seed,
                                      repair_delay=600.0)
        p["vm_fail"] = np.asarray(f, np.float32).reshape(n, V)
        p["vm_restore"] = np.asarray(r, np.float32).reshape(n, V)
        p["redispatch_delay"] = rng.choice([0.0, 30.0], n
                                           ).astype(np.float32)
    if kind == "deadline":
        dl = (p["job_submit"][:, None]
              + rng.choice([300.0, 1200.0, 4800.0], (n, T))
              ).astype(np.float32)
        p["task_deadline"] = np.where(rng.random((n, T)) < 0.5, 1e30,
                                      dl).astype(np.float32)
        p["deadline_policy"] = rng.integers(1, 3, n).astype(np.int32)
        p["deadline_slack"] = rng.choice([0.0, 120.0], n).astype(np.float32)
        p["preempt"] = np.ones(n, np.int32)
        p["preempt_resume"] = rng.integers(0, 2, n).astype(np.int32)
        p["sched_policy"] = (rng.random(n) < 0.75).astype(np.int32)
    if kind == "reserves":
        nv = rng.integers(3, V + 1, n)
        p["n_vms"] = nv.astype(np.int32)
        k = rng.integers(1, 3, n)
        p["vm_auto"] = (np.arange(V)[None, :] >= (nv - k)[:, None]
                        ).astype(np.float32)
        p["control_policy"] = np.ones(n, np.int32)
        p["ctl_queue"] = np.full(n, 2.0, np.float32)
        p["ctl_busy"] = np.full(n, 0.5, np.float32)
        p["sched_policy"] = np.ones(n, np.int32)
        p["n_maps"] = rng.integers(min(8, T - 3), T - 2, n).astype(np.int32)
    if kind == "failover_locality":
        # the last VM is an AUTOSCALE reserve: a block held only there
        # fails over to a non-holder and pays the re-replication fetch
        nv = np.maximum(p["n_vms"], 2)
        p["n_vms"] = nv.astype(np.int32)
        p["vm_auto"] = (np.arange(V)[None, :] == (nv - 1)[:, None]
                        ).astype(np.float32)
        p["control_policy"] = np.ones(n, np.int32)
        p["ctl_queue"] = np.full(n, 2.0, np.float32)
        p["ctl_busy"] = np.full(n, 0.5, np.float32)
        p["storage_enabled"] = np.ones(n, np.float32)
        p["binding_policy"] = np.full(n, 3, np.int32)
        p["replication"] = rng.integers(1, 4, n).astype(np.int32)
        p["placement"] = np.ones(n, np.int32)
        p["block_size_mb"] = rng.choice([8192.0, 32768.0], n
                                        ).astype(np.float32)
        p["storage_seed"] = rng.integers(0, 1000, n).astype(np.int32)
    return p


def _lanes(kind, n=64, T=16, seed=0):
    """The 28 control ``mr_epoch`` lane-data arrays (numpy) of a seeded
    grid, derived by the JAX package's own wrapper code, plus
    ``max_pes``."""
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
    ctl = jops._control_lane_data(b, lambda x: x, *jops._control_derived(b))
    lanes += tuple(np.ascontiguousarray(np.asarray(x)) for x in ctl)
    return lanes, max(int(np.ceil(lanes[7].max())), 1)


def _jax(lanes, max_pes, **kw):
    return tuple(np.asarray(x) for x in jmk.mr_epoch(
        *lanes, max_pes=max_pes, interpret=True, tile=1, control=True, **kw))


def _torch(lanes, max_pes, state=None, **kw):
    st = None if state is None else tuple(torch.tensor(x) for x in state)
    out = tmk.mr_epoch_plain(*(None if x is None else torch.tensor(x)
                               for x in lanes),
                             state=st, max_pes=max_pes, control=True, **kw)
    return tuple(x.numpy() for x in out)


def _assert_carry(want, got, what, *, exact_work_lost=False):
    assert len(want) == len(got) == 15
    for name, a, b in zip(tmk.STATE_LEAVES_CONTROL, want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if name == "work_lost" and not exact_work_lost:
            # ROADMAP C5: a fused float sum over tasks in XLA:CPU's order
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: leaf {name}")
        else:
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32),
                                          err_msg=f"{what}: leaf {name}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [8, 16])
def test_plain_control_matches_pallas(kind, T):
    lanes, max_pes = _lanes(kind, T=T, seed=T + len(kind))
    want = _jax(lanes, max_pes)
    got = _torch(lanes, max_pes)
    _assert_carry(want, got, f"{kind} T={T}")
    assert want[7].max() > 2                  # lanes took real event epochs
    fired = {"control": want[8].any(), "deadline": want[12].any(),
             "reserves": want[11].any(),
             "failover_locality": (want[14] > 0).any()}
    assert fired[kind], f"{kind}: its mechanism never fired"


def test_plain_control_preempts_like_pallas():
    lanes, max_pes = _lanes("deadline", n=128, T=16, seed=5)
    want = _jax(lanes, max_pes)
    assert want[13].sum() > 0                 # evictions happened
    _assert_carry(want, _torch(lanes, max_pes), "preemption")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("T,pes_delta", [(12, 0), (12, 3), (12, -3),
                                         (40, 0)])
def test_plain_control_matches_pallas_on_admission_stress(T, pes_delta,
                                                          trace):
    """The open loop's admission stress under control, plus BOOST-urgent
    tasks (some that the scan never picks, holding back the rest of their
    VM) and preemption victims on full VMs, failures whose tasks run on
    their second binding, in range or not, SHED deadlines and reserves;
    ``max_pes`` at, above and below the largest PE count."""
    lanes, max_pes = mr_stress.stress_lanes(20, T, seed=50 + T + pes_delta,
                                            control=True)
    max_pes = max(1, max_pes + pes_delta)
    want = _jax(lanes, max_pes, trace=trace)
    got = _torch(lanes, max_pes, trace=trace)
    _assert_carry(want[:15], got[:15], f"stress T={T}")
    if trace:
        np.testing.assert_array_equal(got[15].view(np.int32),
                                      want[15].view(np.int32), err_msg="ts")
    assert (want[3] < 5e29).sum() > 4 * 20          # tasks were admitted
    assert want[8].any() and want[13].any()         # fail-overs, evictions


def test_control_resume_split_matches_pallas_and_one_call():
    lanes, max_pes = _lanes("deadline", T=16, seed=3)
    full = _torch(lanes, max_pes)
    split = int(full[7].max()) // 2
    j1 = _jax(lanes, max_pes, epoch_limit=split)
    t1 = _torch(lanes, max_pes, epoch_limit=split)
    _assert_carry(j1, t1, "first chunk")
    rest = tmk.default_epoch_limit(16, V, True) - split
    resumed = _torch((lanes[0], lanes[1], None) + lanes[3:], max_pes,
                     state=t1, epoch_limit=rest)
    _assert_carry(full, resumed, "resumed", exact_work_lost=True)
    assert (t1[7] <= split).all() and (full[7] > split).any()


def test_control_inputs_match_reference():
    p = _params("failover_locality", 48, 12, 2)
    jb = jsweep.grid_arrays(p, pad_tasks=12, pad_vms=V)
    tb = tsweep.grid_arrays(p, pad_tasks=12, pad_vms=V, device="cpu")
    j_vm2, j_refetch = jops._control_derived(jb)
    t_vm2, t_refetch = tops.control_derived(tb)
    np.testing.assert_array_equal(t_vm2.numpy(), np.asarray(j_vm2))
    np.testing.assert_array_equal(t_refetch.numpy().view(np.int32),
                                  np.asarray(j_refetch).view(np.int32))
    assert (np.asarray(j_refetch) > 0).any()   # re-replication is charged
    want = jops._control_lane_data(jb, lambda x: x, j_vm2, j_refetch)
    got = tops.control_lane_data(tb)
    assert len(got) == len(want) == 15
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.view(np.int32))
    # the t=0 carry: reserves start unopened
    lanes = tuple(torch.tensor(np.asarray(x)) for x in (
        jops._derived_inputs(jb)[0], jops._derived_inputs(jb)[1],
        jb.task_is_reduce.astype(np.int32), jb.task_valid.astype(np.int32),
        jb.vm_start, jb.vm_stop, jb.vm_auto.astype(np.int32)))
    want = jmk.initial_state(*(np.asarray(x) for x in lanes[:4]),
                             vm_start=np.asarray(lanes[4]),
                             vm_stop=np.asarray(lanes[5]),
                             vm_auto=np.asarray(lanes[6]))
    got = tmk.initial_state(*lanes[:4], lanes[4], lanes[5], lanes[6])
    for name, a, b in zip(tmk.STATE_LEAVES_CONTROL, want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.view(np.int32), err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_lane_bound_and_earliest_finish_match_reference(kind):
    p = _params(kind, 64, 12, 7)
    jb = jsweep.grid_arrays(p, pad_tasks=12, pad_vms=V)
    tb = tsweep.grid_arrays(p, pad_tasks=12, pad_vms=V, device="cpu")
    want = np.asarray(jax.vmap(jengine._lane_bound)(jb))
    got = tengine._lane_bound(tb).numpy()
    np.testing.assert_array_equal(got, want)
    # earliest_finish and the BOOST predicate built on it, under jit: a
    # division feeding an add cannot fuse, so one rounding per op
    rng = np.random.default_rng(1)
    now, rem, slack = ((rng.random(500) * s).astype(np.float32)
                       for s in (1e5, 1e6, 240.0))
    mips = rng.choice([0.0, 250.0, 333.0, 1000.0], 500).astype(np.float32)
    dl = now + (rng.random(500) * 3e3).astype(np.float32)

    @jax.jit
    def ref(now, rem, mips, slack, dl):
        efin = jcontrol.earliest_finish(now, rem, mips, xp=jnp)
        return efin, efin + slack >= dl

    want_f, want_u = (np.asarray(x) for x in ref(now, rem, mips, slack, dl))
    got_f = tcontrol.earliest_finish(*(torch.tensor(x)
                                       for x in (now, rem, mips)))
    got_u = (got_f + torch.tensor(slack) >= torch.tensor(dl)).numpy()
    np.testing.assert_array_equal(got_f.numpy().view(np.int32),
                                  want_f.view(np.int32))
    np.testing.assert_array_equal(got_u, want_u)


def _plan(sw, kind, n, T, seed):
    cols = _params(kind, n, T, seed)
    return sw.product(sw.Axis(("cell",), tuple((i,) for i in range(n)),
                              cols))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_metric(want, got, k, what):
    """Bitwise, except the sums over tasks (ROADMAP C5): rtol 1e-6."""
    a, b = np.asarray(want), np.asarray(got)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
    if k in ORDER_SENSITIVE or k == "work_lost":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                   err_msg=f"{what}: {k}")
    else:
        np.testing.assert_array_equal(_bits(b), _bits(a),
                                      err_msg=f"{what}: {k}")


def _per_lane_reference(batch):
    """The JAX package's per-lane closed loop: ``simulate_arrays`` under
    ``vmap``, then its metrics."""
    out = jax.vmap(lambda sc: jengine.simulate_arrays(sc, control=True)
                   )(batch)
    jm = jax.vmap(jengine.job_metrics)(batch, out)
    sm = jax.vmap(jengine.scenario_metrics)(batch, out)
    return out, jm, sm


@pytest.mark.parametrize("kind", KINDS)
def test_control_sweep_matches_per_lane_reference(kind):
    n, T = 96, 16
    jplan, tplan = _plan(jsweep, kind, n, T, 11), _plan(tsweep, kind, n, T,
                                                         11)
    jb = jplan.arrays()
    out_j, jm_j, sm_j = _per_lane_reference(jb)
    # the schedule: exact
    tb = tplan.arrays(device="cpu")
    out_t = tops.epoch_schedule(tb, control=True)
    for f in tengine.SimOutput._fields:
        _assert_metric(getattr(out_j, f), getattr(out_t, f).numpy(), f,
                       f"{kind} SimOutput")
    # the labelled sweep, bucketed and in one batch
    for bucket in ("auto", False):
        got = tplan.run(backend="torch", device="cpu", bucket=bucket)
        for k, v in jm_j._asdict().items():
            _assert_metric(np.asarray(v)[:, 0], got[k], k,
                           f"{kind} bucket={bucket}")
        for k, v in sm_j._asdict().items():
            _assert_metric(v, got[k], k, f"{kind} bucket={bucket}")
        assert (got["realized_epochs"] >= got["n_epochs"]).all()
    fired = {"control": sm_j.tasks_redispatched,
             "deadline": sm_j.shed_tasks,
             "reserves": sm_j.scale_events,
             "failover_locality": sm_j.wasted_work_frac}
    assert (np.asarray(fired[kind]) > 0).any()


def test_control_sweep_chunked_matches_one_batch():
    plan = _plan(tsweep, "deadline", 80, 16, 4)
    whole = plan.run(device="cpu", bucket=False)
    chunked = plan.run(device="cpu", bucket=False, chunk=24)
    for k in whole.metric_names:
        if k == "realized_epochs":
            continue
        np.testing.assert_array_equal(chunked[k].view(np.int32),
                                      whole[k].view(np.int32), err_msg=k)


def _degenerate(sw):
    """The elastic/locality mixed grid with every control column present
    but set to the no-op values."""
    rng = np.random.default_rng(21)
    n, T = 72, 12
    cols = _params("failover_locality", n, T, 21)
    cols.update(sched_policy=rng.integers(0, 2, n).astype(np.int32),
                task_prio=rng.integers(0, 3, (n, T)).astype(np.float32))
    plain = {k: v for k, v in cols.items()
             if k not in tsweep._CONTROL_PARAMS}
    ctl = dict(plain,
               vm_fail=np.full((n, V), 1e30, np.float32),
               vm_restore=np.full((n, V), 1e30, np.float32),
               vm_auto=np.zeros((n, V), np.float32),
               control_policy=np.zeros(n, np.int32),
               ctl_queue=np.full(n, 2.0, np.float32),
               ctl_busy=np.full(n, 0.5, np.float32),
               redispatch_delay=np.full(n, 30.0, np.float32),
               task_deadline=np.full((n, T), 1e30, np.float32),
               deadline_policy=np.zeros(n, np.int32),
               deadline_slack=np.full(n, 120.0, np.float32),
               preempt=np.zeros(n, np.int32),
               preempt_resume=np.zeros(n, np.int32))
    ax = lambda c: sw.Axis(("cell",), tuple((i,) for i in range(n)), c)  # noqa
    return sw.product(ax(plain)), sw.product(ax(ctl))


def test_degenerate_control_columns_equal_open_loop():
    open_plan, ctl_plan = _degenerate(tsweep)
    for bucket in ("auto", False):
        want = open_plan.run(device="cpu", bucket=bucket)
        got = ctl_plan.run(device="cpu", bucket=bucket)
        assert set(want.metric_names) == set(got.metric_names)
        for k in want.metric_names:
            np.testing.assert_array_equal(got[k].view(np.int32),
                                          want[k].view(np.int32),
                                          err_msg=f"bucket={bucket}: {k}")
    # and both equal the reference's open-loop run
    jwant = _degenerate(jsweep)[0].run(
        cost_model=jcost.fallback_cost_model())
    for k in jwant.metric_names:
        _assert_metric(jwant[k], got[k], k, "degenerate vs reference")


def _c6_scenarios():
    """Two base VMs at 1000 MIPS and two AUTOSCALE reserves at 100 MIPS;
    13 maps and 2 reduces, space-shared, failures at 1e-5/s; the second
    scenario is the same with a job 40 times as long."""
    cfg = jconfig
    vms = (cfg.VMSpec("base", mips=1000.0), cfg.VMSpec("base", mips=1000.0),
           cfg.VMSpec("res", mips=100.0, autoscale=True),
           cfg.VMSpec("res", mips=100.0, autoscale=True))
    job = cfg.JobSpec("j", length_mi=362_880.0, data_mb=200_000.0,
                      n_maps=13, n_reduces=2)
    ctl = cfg.ControlSpec(policy=cfg.ControlPolicy.AUTOSCALE,
                          queue_threshold=2.0, busy_threshold=0.5,
                          failure_rate=1e-5, failure_seed=3,
                          repair_delay=300.0)
    short = cfg.Scenario(vms=vms, jobs=(job,), control=ctl,
                         sched_policy=cfg.SchedPolicy.SPACE_SHARED)
    long_ = dataclasses.replace(short, jobs=(dataclasses.replace(
        job, length_mi=40 * 362_880.0),))
    return short, long_


def test_lane_result_does_not_depend_on_batch_mates():
    """ROADMAP C6: under control a finished lane is not a fixed point of
    the reference's epoch body, so its batched engine gives the short lane
    another ``vm_close``/``n_scale`` when a long lane shares its batch.
    The port stops each lane at its own end, in the kernel and in the
    engine body: alone or paired, the short lane is the reference's
    per-lane ``simulate_arrays``."""
    short_j, long_j = _c6_scenarios()
    enc = [jengine.from_scenario(s, pad_tasks=16) for s in (short_j, long_j)]
    want = jengine.simulate_arrays(enc[0], control=True)
    assert np.asarray(want.vm_close)[2] == np.float32(1e30)
    assert int(want.n_scale) == 3

    def port(encs, backend):
        d = {k: np.stack([np.asarray(getattr(e, k)) for e in encs])
             for k in jengine.ScenarioArrays._fields}
        batch = tengine.scenario_arrays_from_numpy(d, device="cpu")
        out, _ = tengine.simulate_batch_arrays(batch, backend=backend)
        return {k: v[0].numpy() for k, v in out._asdict().items()}

    # the mr_epoch kernel's plain version, then the engine body
    for backend in (None, "engine"):
        alone, paired = port(enc[:1], backend), port(enc, backend)
        for k in alone:
            np.testing.assert_array_equal(_bits(paired[k]), _bits(alone[k]),
                                          err_msg=f"{backend}: {k}")
            _assert_metric(getattr(want, k), alone[k], k, f"C6 {backend}")
    # the reference's batched engine is the fault the port does not copy
    both = jax.tree.map(lambda *x: np.stack(x), *enc)
    batched, _ = jengine.simulate_batch_arrays(both, control=True)
    assert np.asarray(batched.vm_close)[0, 2] != np.float32(1e30)
    assert int(np.asarray(batched.n_scale)[0]) == 4


def test_wrapper_takes_plain_control_version_on_cpu():
    lanes, max_pes = _lanes("reserves", n=16, T=8, seed=9)
    before = (tmk.mr_epoch.launches, tmk.mr_epoch.control_launches)
    got = tmk.mr_epoch(*(torch.tensor(x) for x in lanes), max_pes=max_pes,
                       control=True)
    assert (tmk.mr_epoch.launches, tmk.mr_epoch.control_launches) == before
    _assert_carry(_torch(lanes, max_pes), tuple(x.numpy() for x in got),
                  "wrapper", exact_work_lost=True)
    with pytest.raises(ValueError, match="fifteen"):
        tmk.mr_epoch(*(torch.tensor(x) for x in lanes[:14]),
                     max_pes=max_pes, control=True)


def test_control_kernel_shared_memory_layout():
    # the C source's lane_smem_bytes and the wrapper's agree, untraced and
    # traced, at one, two and three task-set words per VM, with the VMs'
    # task sets in shared memory and in global scratch
    src = tmk.__file__.rsplit("/", 1)[0] + "/csrc/mr_epoch_control.cu"
    text = open(src).read()
    assert "const int vw = shared_sets ? V * W : 0;" in text
    for trace, (per_t, per_v) in ((False, (80, 55)), (True, (82, 57))):
        assert (f"({per_t} * T + {per_v} * V + 8 * vw + 24 * W + 15) "
                "/ 16 * 16") in text
        for T, Vv in ((8, 1), (64, 16), (70, 9)):
            W = (T + 31) // 32
            for shared in (True, False):
                vw = Vv * W if shared else 0
                assert tmk.lane_smem_bytes(T, Vv, control=True, trace=trace,
                                           shared_sets=shared) \
                    == (per_t * T + per_v * Vv + 8 * vw + 24 * W + 15) \
                    // 16 * 16
    assert tmk.block_layout(64, 16, control=True) == (2, True)
    # T = 1024 on 400 VMs takes a block of its own; on 1024 VMs at T =
    # 1536 the task sets move to global scratch
    assert tmk.block_layout(1024, 400, control=True) == (1, True)
    assert tmk.block_layout(1536, 1024, control=True) == (1, False)
    with pytest.raises(ValueError):
        tmk.block_layout(4096, 16, control=True)


def test_control_path_never_falls_back_to_cpu():
    plan = _plan(tsweep, "reserves", 16, 12, 1)
    batch = plan.arrays(device="cpu")
    before = (tmk.mr_epoch.launches, tmk.mr_epoch.control_launches)
    with pytest.raises(ValueError, match="card"):
        tops.epoch_schedule(batch, backend="cuda", control=True)
    with pytest.raises(ValueError, match="card"):
        plan.run(backend="cuda", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            plan.run()                     # device defaults to "cuda"
    assert (tmk.mr_epoch.launches, tmk.mr_epoch.control_launches) == before
