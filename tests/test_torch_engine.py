"""The port's host layer, encoder and metrics against the JAX package.

Seeded numpy inputs go through the JAX function and its port: the binding
strategies, the block-placement hash, the remote-fetch delay, the failover
targets, the host and batch encoders, ``job_metrics``/``scenario_metrics``
on one ``SimOutput``, and ``simulate``.  Integer outputs must be exact and
float outputs bitwise, except the float metrics that are sums: XLA:CPU
vectorises some fused reductions into another order, so those are held to
``rtol=1e-6`` (ROADMAP C5).
"""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import control as jcontrol
from repro.core import engine as jengine
from repro.core import storage as jstorage
from repro.core import sweep as jsweep
from repro.kernels.mr_sched import ops as jops
from repro_torch.core import config as tconfig
from repro_torch.core import control as tcontrol
from repro_torch.core import engine as tengine
from repro_torch.core import storage as tstorage
from repro_torch.core import sweep as tsweep
from repro_torch.core.util import fma32

# float metrics that are sums over tasks: summation order may differ
ORDER_SENSITIVE = frozenset({
    "avg_exec", "map_avg_exec", "reduce_avg_exec", "vm_cost",
    "utilization", "transfer_bytes", "billed_cost", "vm_busy_fraction",
    "queue_wait", "wasted_work_frac"})


def assert_metrics_match(want: dict, got: dict, what=""):
    for k, a in want.items():
        a, b = np.asarray(a), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if k in ORDER_SENSITIVE:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b.view(np.int32),
                                          a.view(np.int32),
                                          err_msg=f"{what}: {k}")


def _grid(n, seed, storage=True, elastic=True, T=20, V=7):
    rng = np.random.default_rng(seed)
    p = dict(
        n_maps=rng.integers(1, T - 1, n).astype(np.int32),
        n_reduces=rng.integers(1, 3, n).astype(np.int32),
        n_vms=rng.integers(1, V + 1, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], (n, V)).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], (n, V)).astype(np.float32),
        vm_cost=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        job_data=(rng.random(n) * 8e5 + 1e4).astype(np.float32),
        sched_policy=rng.integers(0, 2, n).astype(np.int32),
        binding_policy=rng.integers(0, 4, n).astype(np.int32),
        task_mult=rng.choice([1.0, 1.5, 3.0], (n, T)).astype(np.float32),
    )
    if storage:
        p.update(
            storage_enabled=(rng.random(n) < 0.8).astype(np.float32),
            replication=rng.integers(1, 5, n).astype(np.int32),
            placement=rng.integers(0, 2, n).astype(np.int32),
            block_size_mb=(rng.random(n) * 3e4 + 500).astype(np.float32),
            storage_seed=rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    if elastic:
        p.update(
            job_submit=(rng.random(n) * 500).astype(np.float32),
            vm_start=rng.choice([0.0, 300.0], (n, V)).astype(np.float32),
            vm_stop=np.where(rng.random((n, V)) < 0.6, 1e30,
                             rng.random((n, V)) * 4e4 + 1e3
                             ).astype(np.float32),
            spinup_delay=rng.choice([0.0, 45.0], n).astype(np.float32),
            billing_granularity=rng.choice([1.0, 60.0, 3600.0], n
                                           ).astype(np.float32),
            task_prio=rng.integers(0, 3, (n, T)).astype(np.float32))
    return p, T, V


def _jax_batch_np(params, T, V):
    b = jsweep.grid_arrays(params, pad_tasks=T, pad_vms=V)
    return {k: np.asarray(v) for k, v in b._asdict().items()}


@pytest.mark.parametrize("storage,elastic", [(False, False), (True, False),
                                             (True, True)])
def test_grid_arrays_encode_bitwise(storage, elastic):
    params, T, V = _grid(96, seed=7 + storage + 2 * elastic,
                         storage=storage, elastic=elastic)
    want = _jax_batch_np(params, T, V)
    got = tengine.to_numpy(tsweep.grid_arrays(params, pad_tasks=T,
                                              pad_vms=V, device="cpu"))
    for k in want:
        np.testing.assert_array_equal(
            got[k].view(np.int32) if got[k].dtype == np.float32 else got[k],
            want[k].view(np.int32) if want[k].dtype == np.float32
            else want[k], err_msg=k)


def test_static_binding_policy_encodes_like_a_column():
    params, T, V = _grid(64, seed=3)
    for bp in range(4):
        col = dict(params, binding_policy=np.full(64, bp, np.int32))
        st = dict(params)
        del st["binding_policy"]
        a = tsweep.grid_arrays(col, pad_tasks=T, pad_vms=V, device="cpu")
        b = tsweep.grid_arrays(st, pad_tasks=T, pad_vms=V, device="cpu",
                               static_params={"binding_policy": bp})
        assert torch.equal(a.task_vm, b.task_vm), bp


def test_bind_tasks_matches_reference():
    rng = np.random.default_rng(11)
    N, T, V = 48, 20, 6
    valid = rng.random((N, T)) < 0.85
    task_len = (rng.random((N, T)) * 1e5).astype(np.float32)
    mips = rng.choice([250.0, 500.0, 1000.0], (N, V)).astype(np.float32)
    pes = rng.choice([1.0, 2.0, 4.0], (N, V)).astype(np.float32)
    vm_valid = np.arange(V)[None, :] < rng.integers(1, V + 1, (N, 1))
    bp = rng.integers(0, 4, N).astype(np.int32)
    block_vm = np.where(rng.random((N, T, V)) < 0.3,
                        rng.integers(0, V, (N, T, V)), -1).astype(np.int32)
    cand = np.asarray(jax.vmap(lambda b, v: jstorage.locality_candidates(
        jnp, b, v))(block_vm, vm_valid))
    want = np.asarray(jax.vmap(jengine.bind_tasks)(
        bp, valid, task_len, mips, pes, vm_valid, cand))
    tt = torch.as_tensor
    tcand = tstorage.locality_candidates(tt(block_vm), tt(vm_valid))
    np.testing.assert_array_equal(tcand.numpy(), cand)
    got = tengine.bind_tasks(tt(bp), tt(valid), tt(task_len), tt(mips),
                             tt(pes), tt(vm_valid), locality_cand=tcand)
    np.testing.assert_array_equal(got.numpy(), want)
    # no candidate mask: LOCALITY binds as LEAST_LOADED
    want_ll = np.asarray(jax.vmap(jengine.bind_tasks)(
        bp, valid, task_len, mips, pes, vm_valid))
    got_ll = tengine.bind_tasks(tt(bp), tt(valid), tt(task_len), tt(mips),
                                tt(pes), tt(vm_valid))
    np.testing.assert_array_equal(got_ll.numpy(), want_ll)


def test_placement_hash_matches_reference():
    rng = np.random.default_rng(5)
    for seed in (0, 7, -5, 2**31 - 1, 2**32 + 3):
        for placement in (0, 1):
            kw = dict(seed=seed, placement=placement, replication=3,
                      block_size_mb=np.float32(777.5),
                      job_data=np.float32(123456.7), n_vms=7, pad_vms=9)
            m = np.arange(40, dtype=np.int32)
            j = np.full(40, 2, np.int32)
            want = jstorage.map_block_placement(np, m, j, **kw)
            got = tstorage.map_block_placement(m, j, **kw)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(a, b)
    # the batched torch form against the reference's device (jnp) form
    n = 64
    seeds = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    cols = dict(seed=seeds, placement=rng.integers(0, 2, n).astype(np.int32),
                replication=rng.integers(1, 6, n).astype(np.int32),
                block_size_mb=(rng.random(n) * 3e4 + 1).astype(np.float32),
                job_data=(rng.random(n) * 1e6).astype(np.float32),
                n_vms=rng.integers(1, 10, n).astype(np.int32))
    t = np.arange(24, dtype=np.int32)
    z = np.zeros(24, np.int32)
    want = jax.jit(jax.vmap(lambda s, p, r, b, d, v:
                            jstorage.map_block_placement(
                                jnp, t, z, seed=s, placement=p,
                                replication=r, block_size_mb=b,
                                job_data=d, n_vms=v, pad_vms=9)))(
        *cols.values())
    tt = {k: torch.as_tensor(v) for k, v in cols.items()}
    tt["seed"] = tt["seed"].long()
    got = tstorage.map_block_placement_torch(
        torch.as_tensor(t), torch.as_tensor(z), pad_vms=9, **tt)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(want[1]).view(np.int32))


def test_remote_fetch_delay_and_failover_match_reference():
    params, T, V = _grid(64, seed=21)
    d = _jax_batch_np(params, T, V)
    b = tengine.scenario_arrays_from_numpy(d, device="cpu")
    want = np.asarray(jstorage.remote_fetch_delay(
        d["block_vm"], d["block_size"], d["task_vm"], d["kappa_in"][:, None],
        d["net_bw"][:, None], d["net_enabled"][:, None], xp=jnp))
    got = tstorage.remote_fetch_delay(
        b.block_vm, b.block_size, b.task_vm, b.kappa_in[:, None],
        b.net_bw[:, None], b.net_enabled[:, None])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert (want > 0).any()
    rng = np.random.default_rng(2)
    auto = rng.random(d["vm_auto"].shape) < 0.3
    valid = d["vm_valid"] & (rng.random(d["vm_valid"].shape) < 0.9)
    want_fo = np.asarray(jax.vmap(
        lambda tv, vv, va, bv: jcontrol.failover_targets(tv, vv, va, bv,
                                                         xp=jnp))(
        d["task_vm"], valid, auto, d["block_vm"]))
    got_fo = tcontrol.failover_targets(b.task_vm, torch.as_tensor(valid),
                                       torch.as_tensor(auto), b.block_vm)
    np.testing.assert_array_equal(got_fo.numpy(), want_fo)


def test_metrics_on_the_same_sim_output():
    params, T, V = _grid(96, seed=4)
    jb = jsweep.grid_arrays(params, pad_tasks=T, pad_vms=V)
    jout = jops.epoch_schedule(jb, tile=32, interpret=True)
    want_jm = jax.jit(jax.vmap(jengine.job_metrics))(jb, jout)
    want_sm = jax.jit(jax.vmap(jengine.scenario_metrics))(jb, jout)
    tb = tengine.scenario_arrays_from_numpy(
        {k: np.asarray(v) for k, v in jb._asdict().items()}, device="cpu")
    dt = {"hit": torch.bool, "shed": torch.bool, "task_vm2": torch.int32,
          "n_epochs": torch.int32, "n_scale": torch.int32,
          "n_evict": torch.int32}
    tout = tengine.SimOutput(**{
        k: torch.tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
        for k, v in jout._asdict().items()})
    got_jm = tengine.to_numpy(tengine.job_metrics(tb, tout))
    got_sm = tengine.to_numpy(tengine.scenario_metrics(tb, tout))
    assert_metrics_match({k: np.asarray(v) for k, v in
                          want_jm._asdict().items()}, got_jm, "job")
    assert_metrics_match({k: np.asarray(v) for k, v in
                          want_sm._asdict().items()}, got_sm, "scenario")
    # and the port's own stepping gives the same SimOutput
    pout = tengine.to_numpy(jops_port_epoch_schedule(tb))
    for k, v in jout._asdict().items():
        np.testing.assert_array_equal(
            np.asarray(v).view(np.int32) if np.asarray(v).dtype
            == np.float32 else np.asarray(v),
            pout[k].view(np.int32) if pout[k].dtype == np.float32
            else pout[k], err_msg=k)


def jops_port_epoch_schedule(batch):
    from repro_torch.kernels.mr_sched import epoch_schedule
    return epoch_schedule(batch, backend="torch")


def test_scenario_arrays_from_numpy_round_trips():
    params, T, V = _grid(16, seed=8)
    d = _jax_batch_np(params, T, V)
    b = tengine.scenario_arrays_from_numpy(d, device="cpu")
    assert b._fields == tuple(jengine.ScenarioArrays._fields)
    back = tengine.to_numpy(b)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


SCENARIOS = [
    jconfig.paper_scenario(n_maps=4, n_reduces=2),
    jconfig.paper_scenario(vm="medium", n_vms=4, n_maps=8, n_reduces=3,
                           sched_policy=1, binding_policy=1),
    jconfig.paper_scenario(job="big", n_vms=5, n_maps=16, n_reduces=2,
                           sched_policy=1, binding_policy=2),
]


def _scenario_pair(sc_j):
    """The same Scenario built from each package's own config module."""
    conv = {"vms": lambda vs: tuple(tconfig.VMSpec(**dataclasses.asdict(v))
                                    for v in vs),
            "jobs": lambda js: tuple(tconfig.JobSpec(**dataclasses.asdict(j))
                                     for j in js)}
    kw = {f.name: getattr(sc_j, f.name) for f in dataclasses.fields(sc_j)}
    out = {}
    for k, v in kw.items():
        if k in conv:
            out[k] = conv[k](v)
        elif dataclasses.is_dataclass(v):
            cls = getattr(tconfig, type(v).__name__)
            out[k] = cls(**dataclasses.asdict(v))
        else:
            out[k] = v
    return tconfig.Scenario(**out)


def _locality_scenario():
    st = jstorage.StorageSpec(enabled=True, replication=2, placement=1,
                              seed=9, block_size_mb=4096.0)
    vms = (jconfig.VM_SMALL, jconfig.VM_MEDIUM,
           dataclasses.replace(jconfig.VM_LARGE, lease_start=100.0,
                               lease_stop=9e4),
           jconfig.VM_SMALL)
    job = dataclasses.replace(jconfig.JOB_MEDIUM, n_maps=10, n_reduces=2,
                              priority=1.0)
    return jconfig.Scenario(vms=vms, jobs=(job,), storage=st,
                            sched_policy=jconfig.SchedPolicy.SPACE_SHARED,
                            binding_policy=jconfig.BindingPolicy.LOCALITY)


@pytest.mark.parametrize("i", range(len(SCENARIOS) + 1))
def test_from_scenario_and_simulate_match_reference(i):
    sc_j = SCENARIOS[i] if i < len(SCENARIOS) else _locality_scenario()
    sc_t = _scenario_pair(sc_j)
    want = jengine.from_scenario(sc_j)
    got = tengine.from_scenario(sc_t)
    for k in jengine.ScenarioArrays._fields:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    jm_want = jengine.simulate(sc_j)
    jm_got = tengine.simulate(sc_t, device="cpu")
    assert_metrics_match({k: np.asarray(v)[None] for k, v in
                          jm_want._asdict().items()},
                         tengine.to_numpy(jm_got), f"scenario {i}")


def test_simulate_rejects_what_later_slices_bring():
    # a two-job scenario is no longer refused: it steps through the engine
    # body and matches the reference's engine
    multi = jconfig.Scenario(jobs=(jconfig.JOB_SMALL, dataclasses.replace(
        jconfig.JOB_SMALL, n_maps=3, submit_time=600.0)))
    jm_want = jengine.simulate(multi)
    jm_got = tengine.simulate(_scenario_pair(multi), device="cpu")
    assert jm_got.makespan.shape == (1, 2)
    assert_metrics_match({k: np.asarray(v)[None] for k, v in
                          jm_want._asdict().items()},
                         tengine.to_numpy(jm_got), "two jobs")
    # a closed-loop scenario (seeded failures, an AUTOSCALE reserve) is no
    # longer refused: it runs the control lowering, as the reference does
    vms = (jconfig.VM_SMALL, jconfig.VM_SMALL,
           dataclasses.replace(jconfig.VM_SMALL, autoscale=True))
    job = dataclasses.replace(jconfig.JOB_SMALL, n_maps=9, n_reduces=2)
    sc_j = jconfig.Scenario(
        vms=vms, jobs=(job,), sched_policy=jconfig.SchedPolicy.SPACE_SHARED,
        control=jcontrol.ControlSpec(
            policy=jcontrol.ControlPolicy.AUTOSCALE, failure_rate=1e-3,
            failure_seed=3, repair_delay=300.0, queue_threshold=2.0,
            busy_threshold=0.5))
    jm_want = jengine.simulate(sc_j)
    jm_got = tengine.simulate(_scenario_pair(sc_j), device="cpu")
    assert_metrics_match({k: np.asarray(v)[None] for k, v in
                          jm_want._asdict().items()},
                         tengine.to_numpy(jm_got), "closed loop")


def _round_f32(exact: Fraction) -> np.float32:
    """The float32 nearest to ``exact``, ties to even."""
    lo = np.float32(float(exact))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(3000) * 1e3).astype(np.float32)
    b = (rng.standard_normal(3000) * 1e-2).astype(np.float32)
    c = (rng.standard_normal(3000) * 1e2).astype(np.float32)
    # a float64 sum that lands exactly on a float32 rounding midpoint,
    # where rounding it again would go the wrong way (2^24+2 is odd):
    # (2^24 + 2) +- (1 - 2^-40) must round to 2^24 + 2 both times
    a[:2] = np.float32(1 + 2.0 ** -20) * np.array([1, -1], np.float32)
    b[:2] = np.float32(1 - 2.0 ** -20)
    c[:2] = np.float32(2.0 ** 24 + 2)
    got = fma32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    assert (got[:2] == 2.0 ** 24 + 2).all()
    for x, y, z, r in zip(a.tolist(), b.tolist(), c.tolist(),
                          got.numpy().tolist()):
        want = _round_f32(Fraction(x) * Fraction(y) + Fraction(z))
        assert np.float32(r) == want, (x, y, z)


@pytest.mark.parametrize("n", [8, 23, 32, 33, 41, 64, 100])
def test_sum_order_is_xla_reduce_order(n):
    x = (np.random.default_rng(n).random((64, n)) * 1000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    got = tengine._sum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
