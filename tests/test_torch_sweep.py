"""``SweepPlan.run`` of the port against the JAX package's, end to end.

Each grid is built through both packages' declarative API and run by JAX
``plan.run()`` and by the port's ``plan.run(backend="torch",
device="cpu")`` (the ``mr_epoch`` plain version), with ``bucket="auto"``
and ``bucket=False``.  Both runs price bucket splits with the JAX package's
fallback coefficients, passed to each, so the buckets and
``realized_epochs`` agree.  Integer metrics
and ``realized_epochs`` are exact; float metrics bitwise, except the sums
over tasks, held to ``rtol=1e-6`` (ROADMAP C5: XLA:CPU vectorises some
fused reductions into another summation order).
"""
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro.core import sweep as jsweep
from repro_torch.core import costmodel as tcost
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.mr_sched import megakernel as tmk
from repro_torch.kernels.mr_sched import ops as tops
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)

ORDER_SENSITIVE = frozenset({
    "avg_exec", "map_avg_exec", "reduce_avg_exec", "vm_cost",
    "utilization", "transfer_bytes", "billed_cost", "vm_busy_fraction",
    "queue_wait", "wasted_work_frac"})


def assert_results_match(want, got, what=""):
    assert want.axis_names == got.axis_names
    assert want.axis_labels == got.axis_labels
    assert want.n_jobs == got.n_jobs
    assert set(want.metric_names) == set(got.metric_names)
    for k in want.metric_names:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if k in ORDER_SENSITIVE:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b.view(np.int32),
                                          a.view(np.int32),
                                          err_msg=f"{what}: {k}")


def _table4(sw):
    return sw.product(sw.axis("n_maps", range(1, 11)),
                      sw.axis("network_delay", [True, False]),
                      vm_type="small", job="small")


def _mixed(sw, n=160, seed=1):
    rng = np.random.default_rng(seed)
    cols = dict(
        n_maps=rng.integers(1, 21, n).astype(np.int32),
        n_reduces=rng.integers(1, 3, n).astype(np.int32),
        n_vms=rng.integers(1, 10, n).astype(np.int32),
        vm_mips=rng.choice([250.0, 500.0, 1000.0], n).astype(np.float32),
        vm_pes=rng.choice([1.0, 2.0, 4.0], n).astype(np.float32),
        job_length=rng.choice([362880.0, 725760.0], n).astype(np.float32),
        sched_policy=rng.integers(0, 2, n).astype(np.int32),
        binding_policy=rng.integers(0, 4, n).astype(np.int32))
    return sw.product(sw.zip_(*(sw.axis(k, list(v))
                                for k, v in cols.items())),
                      job_data=4e5)


def _locality(sw):
    return sw.product(sw.axis("replication", [1, 2, 3]),
                      sw.axis("placement", ["uniform", "skewed"]),
                      sw.axis("binding_policy", [0, 1, 3]),
                      sw.axis("storage_seed", [0, 11]),
                      storage=True, n_vms=6, n_maps=12, n_reduces=2,
                      vm_type="medium", block_size_mb=16384.0,
                      sched_policy=1)


def _elastic(sw, n=64, seed=4):
    rng = np.random.default_rng(seed)
    start = rng.choice([0.0, 500.0, 2000.0], (n, 6)).astype(np.float32)
    cols = dict(
        n_maps=rng.integers(2, 30, n).astype(np.int32),
        vm_start=start,
        vm_stop=np.where(rng.random((n, 6)) < 0.5, 1e30,
                         start + 20000.0).astype(np.float32),
        task_prio=rng.integers(0, 3, (n, 30)).astype(np.float32),
        sched_policy=rng.integers(0, 2, n).astype(np.int32))
    return sw.product(sw.zip_(*(sw.axis(k, list(v))
                                for k, v in cols.items())),
                      n_vms=6, n_reduces=1, spinup_delay=60.0,
                      billing_granularity=60.0).arrivals(
        2, rate=0.002, seed=seed)


GRIDS = {"table4": _table4, "mixed": _mixed, "locality": _locality,
         "elastic": _elastic}


@pytest.mark.parametrize("bucket", ["auto", False])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_run_matches_reference(grid, bucket):
    want = GRIDS[grid](jsweep).run(bucket=bucket,
                                   cost_model=jcost.fallback_cost_model())
    got = GRIDS[grid](tsweep).run(bucket=bucket, backend="torch",
                                  device="cpu",
                                  cost_model=tcost.fallback_cost_model())
    assert_results_match(want, got, f"{grid}/{bucket}")
    assert got["realized_epochs"].max() >= 2


def test_chunked_run_matches_unchunked():
    plan = _mixed(tsweep, n=96, seed=3)
    fallback = tcost.fallback_cost_model()
    whole = plan.run(backend="torch", device="cpu", cost_model=fallback)
    parts = plan.run(chunk=40, backend="torch", device="cpu",
                     cost_model=fallback)
    for k in whole.metric_names:
        if k != "realized_epochs":      # a per-chunk count by design
            np.testing.assert_array_equal(whole[k], parts[k], err_msg=k)


def test_select_coord_and_table_match_reference():
    want = _table4(jsweep).run(cost_model=jcost.fallback_cost_model())
    got = _table4(tsweep).run(backend="torch", device="cpu",
                              cost_model=tcost.fallback_cost_model())
    for sel in ({"n_maps": 4}, {"network_delay": False},
                {"n_maps": 8, "network_delay": True}):
        a, b = want.select(**sel), got.select(**sel)
        assert a.axis_names == b.axis_names and a.shape == b.shape
        np.testing.assert_array_equal(a["makespan"], b["makespan"])
    assert want.coord((3, 1)) == got.coord((3, 1))
    ta, tb = want.to_table(), got.to_table()
    assert list(ta) == list(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    # the paper's Table IV network cost, 4250 / (M + 1)
    np.testing.assert_allclose(
        got.select(network_delay=True)["network_cost"],
        4250.0 / (np.arange(1, 11) + 1), rtol=1e-4)


@pytest.mark.parametrize("kw,slice_", [({"mesh": object()}, "A8")])
def test_unported_run_options_raise(kw, slice_):
    # every run option is ported now: compact= and stream_to=
    # (test_torch_compaction.py), mesh= (slice A8,
    # test_torch_mesh_sweep.py); what raises is the combination the
    # reference refuses too, before any collective
    with pytest.raises(ValueError, match="mesh or chunk"):
        _table4(tsweep).run(device="cpu", chunk=4, **kw)


def test_control_columns_raise():
    # control columns run the closed-loop lowering now; what raises is a
    # control column the plan validation refuses, as in the reference
    plan = tsweep.product(tsweep.axis("n_maps", [2, 4]),
                          control_policy="autoscale")
    got = plan.run(device="cpu")
    assert got["scale_events"].shape == (2,)
    plan = tsweep.product(tsweep.axis("n_maps", [2, 4])).failures(
        2, rate=1e-3, n_vms=3)
    got = plan.run(device="cpu")
    assert (got["failures_injected"] >= 0).all()
    for sw in (jsweep, tsweep):
        with pytest.raises(ValueError, match="task_prio"):
            sw.product(sw.axis("n_maps", [2, 4]), preempt=1).params()
        with pytest.raises(ValueError, match="control_policy"):
            sw.grid_arrays({"n_maps": np.array([2], np.int32),
                            "control_policy": np.array([7], np.int32)},
                           pad_tasks=4, pad_vms=3)


def test_no_silent_cpu_run_for_the_kernel():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel path runs there")
    batch = _table4(tsweep).arrays(device="cpu")
    before = tmk.mr_epoch.launches
    with pytest.raises((RuntimeError, AssertionError)):
        tops.epoch_schedule(batch, device="cuda")
    with pytest.raises(ValueError, match="card"):
        tops.epoch_schedule(batch, backend="cuda")
    with pytest.raises(ValueError, match="card"):
        _table4(tsweep).run(backend="cuda", device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        _table4(tsweep).run()               # device defaults to "cuda"
    assert tmk.mr_epoch.launches == before
