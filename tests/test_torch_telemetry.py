"""The port's telemetry layer against the JAX package.

* ``TraceResult`` exports: the port's ``to_table``, ``events``,
  ``counts_by_kind``, ``dropped_events`` and ``to_chrome_trace`` equal the
  JAX ``TraceResult``'s on the same numpy buffers (``otherData``, the
  provenance stamp, aside); the Chrome trace holds one ``"X"`` span per
  START.
* Provenance names the port and torch, not JAX, in parquet metadata
  (``pyarrow`` is optional: those tests skip without it).
* ``SweepPlan.run(report=True)`` changes no metric and its counts add up;
  ``stack_scenarios`` encodes as the reference; ``trace_scenario`` of a
  multi-job scenario (the engine body) equals the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import sweep as jsweep
from repro.core import telemetry as jtel
from repro_torch.core import config as tconfig
from repro_torch.core import control as tcontrol
from repro_torch.core import costmodel as tcost
from repro_torch.core import engine as tengine
from repro_torch.core import sweep as tsweep
from repro_torch.core import telemetry as ttel
from repro_torch.kernels.mr_sched import megakernel as tmk

from test_torch_engine import _scenario_pair
from test_torch_trace import _bits, _scenarios
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)


def _failure_trace():
    sc = tconfig.paper_scenario(
        n_maps=6, n_reduces=2, n_vms=4,
        sched_policy=tconfig.SchedPolicy.SPACE_SHARED).replace(
            control=tcontrol.ControlSpec(failure_rate=0.002, failure_seed=7,
                                         repair_delay=300.0,
                                         redispatch_delay=5.0))
    return ttel.trace_scenario(sc, label="failures", device="cpu")


def _batch_buffers(trace_events=None):
    _, tsc = _scenarios()
    tb = tsweep.stack_scenarios(tsc, device="cpu")
    _, _, buf = tengine.simulate_batch_arrays(tb, control=True, trace=True,
                                              trace_events=trace_events)
    return ttel.to_numpy(buf)


@pytest.mark.parametrize("trace_events", [None, 6])
def test_trace_result_exports_equal_the_reference(trace_events):
    buf = _batch_buffers(trace_events)
    mine = ttel.TraceResult(buf, label="grid")
    ref = jtel.TraceResult(jtel.TraceBuffers(*buf), label="grid")
    assert mine.n_lanes == ref.n_lanes == 4
    assert mine.event_capacity == ref.event_capacity
    np.testing.assert_array_equal(mine.dropped_events, ref.dropped_events)
    np.testing.assert_array_equal(
        ttel.TraceBuffers(*buf).dropped_events, ref.dropped_events)
    for a, b in ((mine.to_table(), ref.to_table()),
                 (mine.events(), ref.events())):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for lane in (None, 0, 3):
        assert mine.counts_by_kind(lane) == ref.counts_by_kind(lane)
    d_mine, d_ref = mine.to_chrome_trace(), ref.to_chrome_trace()
    assert d_mine["traceEvents"] == d_ref["traceEvents"]
    assert d_mine["displayTimeUnit"] == d_ref["displayTimeUnit"]
    assert d_mine["otherData"]["dropped_events"] \
        == d_ref["otherData"]["dropped_events"]
    # a single lane's buffers read as a batch of one, as in the reference
    one = ttel.TraceBuffers(*(x[0] for x in buf))
    assert ttel.TraceResult(one).counts_by_kind(0) \
        == jtel.TraceResult(jtel.TraceBuffers(*one)).counts_by_kind(0)


def test_chrome_trace_one_span_per_start(tmp_path):
    _, tr = _failure_trace()
    path = tmp_path / "trace.json"
    tr.to_chrome_trace(path)
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    counts = tr.counts_by_kind(0)
    assert counts["kill"] > 0, "no failure ever fired"
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == counts["start"]
    kills = [e for e in doc["traceEvents"]
             if e["ph"] == "i" and e["name"] == "kill"]
    assert len(kills) == counts["kill"]
    for e in spans:
        assert e["dur"] >= 0.0
        assert e["args"]["outcome"] in ("ok", "kill", "preempt",
                                        "unterminated")
    other = doc["otherData"]
    assert other["torch_version"] == torch.__version__
    assert other["backend"] in ("cuda", "cpu")
    assert "jax_version" not in other and other["dropped_events"] == 0


def test_provenance_names_the_port():
    prov = ttel.provenance()
    assert set(prov) == {"repro_torch_version", "torch_version",
                         "cuda_version", "backend", "device_kind",
                         "git_sha"}
    assert prov["torch_version"] == torch.__version__
    assert prov["cuda_version"] == torch.version.cuda
    meta = ttel.parquet_metadata()
    assert json.loads(meta[b"repro_provenance"]) == prov
    assert tcost.device_key("cpu") == "cpu"


def test_parquet_provenance_names_torch(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    _, tr = _failure_trace()
    p = tmp_path / "ts.parquet"
    tr.to_parquet(p)
    prov = json.loads(pq.read_schema(p).metadata[b"repro_provenance"])
    assert prov["torch_version"] == torch.__version__
    assert "jax_version" not in prov
    table = pq.read_table(p).to_pydict()
    assert len(table["epoch"]) == int((tr.ts[:, :, 4] > 0).sum())
    plan = tsweep.product(tsweep.axis("n_maps", [2, 3, 4]), n_vms=2)
    res = plan.run(device="cpu")
    p2 = tmp_path / "res.parquet"
    res.to_parquet(p2)
    prov2 = json.loads(pq.read_schema(p2).metadata[b"repro_provenance"])
    assert prov2 == prov
    np.testing.assert_array_equal(pq.read_table(p2).to_pydict()["makespan"],
                                  res.to_table()["makespan"])


@pytest.mark.parametrize("control", [False, True])
def test_run_report_is_observational(control):
    dims = [tsweep.axis("n_maps", [2, 3, 8, 12]),
            tsweep.axis("n_vms", [2, 4])]
    if control:
        dims.append(tsweep.axis("deadline_policy", ["NONE", "SHED"]))
    plan = tsweep.product(*dims)
    base = plan.run(device="cpu")
    res, rep = plan.run(device="cpu", report=True, chunk=5)
    for f in base.metric_names:
        if f == "realized_epochs":
            continue                       # follows the chunks
        np.testing.assert_array_equal(base[f], res[f], err_msg=f)
    assert rep.n_cells == plan.size == sum(b.cells for b in rep.buckets)
    assert rep.n_buckets == len(rep.buckets) >= 1
    assert all(b.control == control for b in rep.buckets)
    # on the CPU the plain version runs: no kernel launch is counted
    assert rep.dispatches == sum(b.dispatches for b in rep.buckets) == 0
    assert rep.backend == "torch" and rep.device == "cpu"
    assert rep.compaction_syncs == rep.scalar_syncs == 0
    assert rep.encoder_cache_hits == rep.encoder_cache_misses == 0
    # report=True resolves the default (here the pinned cache file) up front
    assert rep.cost_model["source"] == "cache"
    assert rep.cost_model["dispatch_us"] == \
        tcost.fallback_cost_model().dispatch_us
    assert rep.provenance == ttel.provenance()
    assert rep.wall_s > 0 and all(b.wall_s > 0 for b in rep.buckets)
    json.loads(rep.to_json())


def test_run_report_counts_launches(monkeypatch):
    """``dispatches`` is the delta of the mr_epoch launch counters over
    each bucket: a stand-in kernel that counts like the CUDA wrapper."""
    from repro_torch.kernels.mr_sched import ops as tops

    def counting(*args, **kw):
        tmk.mr_epoch.launches += 1
        return tmk.mr_epoch_plain(*args, **kw)

    monkeypatch.setattr(tops, "mr_epoch", counting)
    monkeypatch.setattr(tops, "resolve_backend", lambda b, d: "cuda")
    plan = tsweep.product(tsweep.axis("n_maps", [2, 3, 9, 17, 33]),
                          tsweep.axis("n_vms", [2, 4]))
    before = tmk.total_launches()
    res, rep = plan.run(device="cpu", report=True,
                        cost_model=tcost.CostModel(dispatch_us=1.0,
                                                   epoch_lane_us=1.0))
    assert rep.n_buckets > 1
    assert rep.dispatches == tmk.total_launches() - before == rep.n_buckets
    assert all(b.dispatches == 1 for b in rep.buckets)
    assert rep.cost_model["source"] == "static"     # built by the caller
    base = plan.run(device="cpu")
    for f in base.metric_names:
        np.testing.assert_array_equal(base[f], res[f], err_msg=f)


def test_stack_scenarios_matches_reference():
    jsc, tsc = _scenarios()
    jb = jsweep.stack_scenarios(jsc)
    tb = tsweep.stack_scenarios(tsc, device="cpu")
    for f in tengine.ScenarioArrays._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b.view(np.int32) if b.dtype ==
                                      np.float32 else b,
                                      a.view(np.int32) if a.dtype ==
                                      np.float32 else a, err_msg=f)


def test_trace_scenario_multi_job_matches_reference():
    """A two-job trace steps through the engine body and equals the
    reference's, buffers and schedule; the single-job path still runs."""
    jobs = (jconfig.JOB_SMALL, dataclasses.replace(
        jconfig.JOB_SMALL, n_maps=2, submit_time=300.0))
    sc = jconfig.Scenario(vms=(jconfig.VM_SMALL,) * 2, jobs=jobs)
    want_out, want = jtel.trace_scenario(sc)
    got_out, got = ttel.trace_scenario(_scenario_pair(sc), device="cpu")
    for f in want_out._fields:
        np.testing.assert_array_equal(
            _bits(getattr(got_out, f).numpy()[0]),
            _bits(np.asarray(getattr(want_out, f))), err_msg=f)
    for f in ttel.TraceBuffers._fields:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)), err_msg=f)
    assert got.counts_by_kind(0) == want.counts_by_kind(0)
    assert got.counts_by_kind(0)["start"] == sc.total_tasks()
    out, tr = _failure_trace()
    assert tr.n_lanes == 1 and int(tr.dropped_events[0]) == 0
    assert out.finish.shape[0] == 1


def test_core_exports_the_reference_names():
    """``repro_torch.core`` re-exports every public name of ``repro.core``
    (the sequential oracle and the workload bridge among them) and, as
    it does, the beyond-paper layers ``speculative`` and ``streaming``."""
    import repro.core as jcore
    import repro_torch.core as tcore
    missing = set(jcore.__all__) - set(tcore.__all__)
    assert not missing
    for name in ("speculative", "streaming"):
        assert hasattr(jcore, name) and hasattr(tcore, name)
    from repro_torch.core import ChipSpec, StepCost, refsim, workload
    assert ChipSpec is workload.ChipSpec and StepCost is workload.StepCost
    assert refsim.simulate is tcore.refsim.simulate
    from repro_torch.core import (RunReport, TraceResult, TraceSpec,
                                  trace_scenario)
    assert TraceSpec is tcore.telemetry.TraceSpec
    assert TraceResult is tcore.telemetry.TraceResult
    assert RunReport is tcore.telemetry.RunReport
    assert trace_scenario is tcore.telemetry.trace_scenario
    from repro_torch.core import StreamedSweep, costmodel
    assert StreamedSweep is tcore.sweep.StreamedSweep
    assert costmodel is tcore.costmodel
    for name in ("CostModel", "default_cost_model", "fallback_cost_model",
                 "load_cost_model", "save_cost_model", "measure",
                 "device_key", "SCHEMA_VERSION", "ENV_PATH",
                 "COMPACT_INTERVAL_MIN", "COMPACT_INTERVAL_MAX"):
        assert hasattr(jcore.costmodel, name) and hasattr(costmodel, name)
    assert all(hasattr(tcore, name) for name in tcore.__all__)
