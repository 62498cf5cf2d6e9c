"""The port's beyond-paper layers against the JAX package's.

* ``speculative``: host numpy op for op, so every output equals the
  reference's on the cases of ``tests/test_extensions.py`` and
  ``tests/test_speculative.py`` and on a derandomized grid; ROADMAP C2's
  example ``(5, 4, 'small', 'small', False)`` is pinned as the reference has
  it (two backups fire without stragglers).
* ``streaming``: ``analyze_batch`` against ``jax.jit(jax.vmap(analyze))``
  bitwise on the smart-city grid (every column sums at most two products,
  whose order does not matter), and on seeded 32-operator DAGs at a stated
  tolerance (ROADMAP C11: XLA:CPU's dot order is not reproduced):
  throughput and utilization at rtol 1e-6, latency at rtol 5e-4 (the
  queueing wait ``u / (s (1 - u))`` multiplies a few ulps by up to 1 /
  (1 - 0.999)); ``stable`` and ``bottleneck`` exact.  ``analyze`` against
  the reference's eager ``analyze`` at the same tolerances.
* ``workload``: ``ChipSpec``, ``StepCost``, ``step_scenario`` and
  ``simulate_training`` equal the reference's (``tests/test_extensions.py``,
  ``tests/test_system.py``).
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                     # seeded fallback, same test surface
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

import repro.core as jc
import repro_torch.core as tc
from repro.core import speculative as jspec
from repro.core import streaming as jstream
from repro.core import workload as jwork
from repro_torch.core import speculative as tspec
from repro_torch.core import streaming as tstream
from repro_torch.core import workload as twork

from test_torch_refsim import _same, to_port

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

STREAM_RTOL = {"throughput": 1e-6, "utilization": 1e-6, "latency_s": 5e-4}


def _assert_same_dict(want, got, what=""):
    assert set(want) == set(got), what
    for k in want:
        assert _same(want[k], got[k]), f"{what}: {k}: {want[k]} != {got[k]}"


# ---------------------------------------------------------------------------
# speculative execution
# ---------------------------------------------------------------------------

def _spec_both(sc, mult, **kw):
    want = jspec.simulate_speculative(sc, mult, **kw)
    got = tspec.simulate_speculative(to_port(sc), mult, **kw)
    _assert_same_dict(want, got, str(kw))
    return got


def test_speculative_noop_without_stragglers():
    sc = jc.paper_scenario(n_maps=12, n_vms=4)
    r = _spec_both(sc, [1.0] * sc.total_tasks())
    assert r["n_backups"] == 0
    assert r["makespan_plain"] == pytest.approx(r["makespan_spec"])


def test_speculative_beats_stragglers():
    sc = jc.paper_scenario(n_maps=12, n_vms=12)
    mult = [1.0] * sc.total_tasks()
    mult[3] = 5.0
    r = _spec_both(sc, mult, threshold=1.5)
    assert r["n_backups"] == 1 and r["speedup"] > 1.15


@pytest.mark.parametrize("sigma,seed", [(0.6, 1), (0.6, 0), (0.3, 4)])
def test_straggler_multipliers_and_lognormal_study(sigma, seed):
    sc = jc.paper_scenario(n_maps=16, n_vms=16)
    want = jspec.straggler_multipliers(sc, sigma=sigma, seed=seed)
    got = tspec.straggler_multipliers(to_port(sc), sigma=sigma, seed=seed)
    assert [_same(a, b) for a, b in zip(want, got)] == [True] * len(want)
    r = _spec_both(sc, got)
    assert r["makespan_spec"] <= r["makespan_plain"] + 1e-9
    _spec_both(sc, got, threshold=1.2, max_backups=2)


def test_c2_example_is_reproduced():
    """ROADMAP C2: with every multiplier at 1.0 the reference still fires
    two backups on ``(5, 4, 'small', 'small', False)`` (round-robin
    imbalance looks like straggling); the port gives the same outputs."""
    sc = jc.paper_scenario(job="small", vm="small", n_vms=4, n_maps=5,
                           n_reduces=1, network_delay=False)
    r = _spec_both(sc, [1.0] * sc.total_tasks())
    assert r["n_backups"] == 2
    assert r["cost_plain"] == pytest.approx(2177.28, rel=1e-12)
    assert r["cost_spec"] == pytest.approx(2757.888, rel=1e-12)
    assert r["extra_work_frac"] == pytest.approx(0.2666666, rel=1e-5)
    assert r["makespan_plain"] == pytest.approx(1306.368, rel=1e-12)


spec_params = st.tuples(st.integers(1, 12), st.integers(1, 8),
                        st.sampled_from(["small", "medium", "large"]),
                        st.sampled_from(["small", "medium", "big"]),
                        st.booleans(), st.integers(0, 3))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(spec_params)
def test_property_speculative_matches_reference(p):
    """On the reference property's grid (and with stragglers), the port's
    outputs are the reference's."""
    m, v, vm, job, nd, seed = p
    sc = jc.paper_scenario(job=job, vm=vm, n_vms=v, n_maps=m, n_reduces=1,
                           network_delay=nd)
    _spec_both(sc, [1.0] * sc.total_tasks())
    _spec_both(sc, jspec.straggler_multipliers(sc, 0.5, seed))


def test_speculative_rejects_what_it_does_not_model():
    sc = tc.paper_scenario(n_maps=4, n_vms=2)
    with pytest.raises(ValueError, match="4 multipliers for 5 tasks"):
        tspec.simulate_speculative(sc, [1.0] * 4)
    two = sc.replace(jobs=list(sc.jobs) * 2)
    with pytest.raises(ValueError, match="2 jobs"):
        tspec.simulate_speculative(two, [1.0] * two.total_tasks())
    mult = [1.0] * sc.total_tasks()
    with pytest.raises(ValueError, match="TIME_SHARED"):
        tspec.simulate_speculative(
            sc.replace(sched_policy=tc.SchedPolicy.SPACE_SHARED), mult)
    with pytest.raises(ValueError, match="ROUND_ROBIN"):
        tspec.simulate_speculative(
            sc.replace(binding_policy=tc.BindingPolicy.LEAST_LOADED), mult)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def _jax_topo(arrs):
    return jstream.Topology(*(jnp.asarray(x) for x in arrs))


def _port_topo(arrs):
    return tstream.Topology(*(torch.from_numpy(np.asarray(x)) for x in arrs))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_stream(want, got, bitwise, what=""):
    assert set(want) == set(got)
    for k in ("stable", "bottleneck"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")
    for k, rtol in STREAM_RTOL.items():
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        if bitwise:
            np.testing.assert_array_equal(_bits(b), _bits(a),
                                          err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0.0,
                                       err_msg=f"{what}: {k}")


def test_smart_city_topology_matches_reference():
    for par in ((1, 2, 2, 1, 1), (1, 2, 4, 1, 1), (3, 1, 7, 2, 5)):
        want = jstream.smart_city_topology(cam_rate=1500.0, parallelism=par)
        got = tstream.smart_city_topology(cam_rate=1500.0, parallelism=par,
                                          device="cpu")
        for a, b in zip(want, got):
            np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


@pytest.mark.parametrize("par,stable,bottleneck", [
    ((1, 2, 4, 1, 1), True, None), ((1, 2, 1, 1, 1), False, 2),
    ((1, 2, 2, 1, 1), True, None)])
def test_analyze_matches_reference(par, stable, bottleneck):
    """``test_streaming_stable_topology`` / ``_bottleneck_detection``:
    the reference's eager ``analyze`` against the port's."""
    want = jstream.analyze(jstream.smart_city_topology(parallelism=par))
    got = tstream.analyze(tstream.smart_city_topology(parallelism=par,
                                                      device="cpu"))
    _assert_stream({k: np.asarray(v) for k, v in want.items()},
                   {k: v.numpy() for k, v in got.items()}, False, str(par))
    assert bool(got["stable"]) is stable
    if bottleneck is not None:
        assert int(got["bottleneck"]) == bottleneck
    if stable:        # detect sees every camera tuple
        np.testing.assert_allclose(float(got["throughput"][2]), 2000.0,
                                   rtol=1e-5)
    assert bool(np.isfinite(float(got["latency_s"]))) == stable


def test_analyze_batch_bitwise_on_the_smart_city_grid():
    """65,536 smart-city topologies (parallelism 1-16 on detect, aggregate
    and alert, 16 camera rates) through ``jax.jit(jax.vmap(analyze))``
    and the port: bitwise."""
    arrs = tuple(x.numpy() for x in chip_smoke.smart_city_grid("cpu"))
    assert arrs[0].shape == (65536, 5, 5)
    want = jstream.analyze_batch(_jax_topo(arrs))
    got = tstream.analyze_batch(_port_topo(arrs))
    _assert_stream({k: np.asarray(v) for k, v in want.items()},
                   {k: v.numpy() for k, v in got.items()}, True, "city")
    assert 0.0 < float(got["stable"].float().mean()) < 1.0


def test_analyze_batch_matches_the_reference_sweep():
    """``test_streaming_batch_sweep``: stacked topologies, stability by
    the detect operator's parallelism."""
    topos = [tstream.smart_city_topology(parallelism=(1, 2, p, 1, 1),
                                         device="cpu") for p in (1, 2, 4, 8)]
    got = tstream.analyze_batch(tstream.Topology(
        *(torch.stack(x) for x in zip(*topos))))
    assert got["stable"].tolist() == [False, True, True, True]


@pytest.mark.parametrize("seed", [16, 17])
def test_analyze_batch_on_random_dags_within_c11(seed):
    """Seeded 32-operator DAGs (1-3 weighted predecessors each): XLA sums
    each column's products in an order the port does not reproduce
    (ROADMAP C11), so floats agree at ``STREAM_RTOL``; ``stable`` and
    ``bottleneck`` exactly."""
    arrs = chip_smoke.streaming_dags(2048, seed)
    want = jstream.analyze_batch(_jax_topo(arrs))
    got = tstream.analyze_batch(_port_topo(arrs))
    _assert_stream({k: np.asarray(v) for k, v in want.items()},
                   {k: v.numpy() for k, v in got.items()}, False,
                   f"dags {seed}")
    for i in range(0, 2048, 256):
        one = jstream.analyze(jstream.Topology(
            *(jnp.asarray(x[i]) for x in arrs)))
        mine = tstream.analyze(tstream.Topology(
            *(torch.from_numpy(x[i]) for x in arrs)))
        _assert_stream({k: np.asarray(v) for k, v in one.items()},
                       {k: v.numpy() for k, v in mine.items()}, False,
                       f"dag {i}")


def test_streaming_dags_are_well_formed():
    adj, src, svc, par, mips = chip_smoke.streaming_dags(512, 3)
    n_pred = (adj > 0).sum(axis=1)
    assert (n_pred[:, :4] == 0).all() and (src[:, :4] > 0).all()
    assert ((n_pred[:, 4:] >= 1) & (n_pred[:, 4:] <= 3)).all()
    assert (np.tril(adj) == 0).all()          # feed-forward, in order
    assert (adj.sum(axis=2) <= 1.0 + 1e-6).all()
    assert set(np.unique(mips)) == {250.0, 500.0, 1000.0}
    assert par.min() >= 1 and par.max() <= 8
    assert svc.min() >= 1e-3 and svc.max() <= 1.0


# ---------------------------------------------------------------------------
# workload bridge
# ---------------------------------------------------------------------------

def test_chip_spec_and_roofline_terms_match_reference():
    assert dataclasses.asdict(twork.ChipSpec()) == \
        dataclasses.asdict(jwork.ChipSpec())
    assert tc.ChipSpec is twork.ChipSpec and tc.StepCost is twork.StepCost
    for kw in (dict(flops=1e14, hbm_bytes=1e12, collective_bytes=1e10),
               dict(flops=5e13, hbm_bytes=5e11, collective_bytes=5e9),
               dict(flops=1e12, hbm_bytes=1e13, collective_bytes=1e8)):
        want, got = jwork.StepCost(**kw), twork.StepCost(**kw)
        _assert_same_dict(want.roofline_terms(jwork.ChipSpec()),
                          got.roofline_terms(twork.ChipSpec()))
        assert _same(want.step_seconds(jwork.ChipSpec()),
                     got.step_seconds(twork.ChipSpec()))


@pytest.mark.parametrize("n,sigma,sp,bp", [
    (64, 0.0, 0, 0), (64, 0.2, 0, 0), (256, 0.0, 0, 0), (16, 0.3, 1, 3)])
def test_step_scenario_matches_reference(n, sigma, sp, bp):
    cost = dict(flops=1e14, hbm_bytes=1e11, collective_bytes=1e9)
    storage = jc.StorageSpec(enabled=True) if bp == 3 else None
    want, wm = jwork.step_scenario(
        jwork.StepCost(**cost), jwork.ChipSpec(), n, straggler_sigma=sigma,
        seed=3, sched_policy=jc.SchedPolicy(sp),
        binding_policy=jc.BindingPolicy(bp), storage=storage)
    got, gm = twork.step_scenario(
        twork.StepCost(**cost), twork.ChipSpec(), n, straggler_sigma=sigma,
        seed=3, sched_policy=tc.SchedPolicy(sp),
        binding_policy=tc.BindingPolicy(bp), storage=to_port(storage))
    assert got == to_port(want)
    assert (gm is None) == (wm is None)
    if gm is not None:
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("kw", [
    dict(cost=(1e14, 1e11, 1e9), n_devices=64, n_steps=100),
    dict(cost=(1e14, 1e11, 1e9), n_devices=64, n_steps=100,
         straggler_sigma=0.2, seed=3),
    dict(cost=(1e14, 1e11, 1e9), n_devices=64, n_steps=100,
         mtbf_hours=1.0),
    dict(cost=(5e13, 5e11, 5e9), n_devices=128, n_steps=500,
         straggler_sigma=0.05, mtbf_hours=500.0),
    dict(cost=(5e13, 5e11, 5e9), n_devices=128, n_steps=500,
         straggler_sigma=0.05, mtbf_hours=50.0),
], ids=["clean", "stragglers", "failures", "system", "system-worse"])
def test_simulate_training_matches_reference(kw):
    """``test_workload_straggler_and_failures`` and
    ``test_simulator_to_training_bridge``: every output bitwise (both run
    their package's ``refsim``)."""
    kw = dict(kw)
    cost = dict(zip(("flops", "hbm_bytes", "collective_bytes"),
                    kw.pop("cost")))
    want = jwork.simulate_training(jwork.StepCost(**cost), jwork.ChipSpec(),
                                   **kw)
    got = twork.simulate_training(twork.StepCost(**cost), twork.ChipSpec(),
                                  **kw)
    _assert_same_dict(want, got)
    assert 0.0 < got["goodput"] <= 1.0


def test_training_bridge_orders_as_the_reference():
    cost, chip = twork.StepCost(1e14, 1e11, 1e9), twork.ChipSpec()
    clean = twork.simulate_training(cost, chip, n_devices=64, n_steps=100)
    assert clean["straggler_slowdown"] == pytest.approx(1.0, rel=1e-3)
    slow = twork.simulate_training(cost, chip, n_devices=64, n_steps=100,
                                   straggler_sigma=0.2, seed=3)
    assert slow["step_seconds"] > clean["step_seconds"]
    failing = twork.simulate_training(cost, chip, n_devices=64,
                                      n_steps=100, mtbf_hours=1.0)
    assert failing["expected_failures"] > 0
    assert failing["goodput"] < clean["goodput"]
