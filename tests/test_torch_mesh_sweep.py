"""Multi-rank sweeps: ``SweepPlan.run(mesh=...)`` and
``sweep.simulate_batch_sharded`` of the port on four ``gloo`` ranks (a
1-D mesh of 4 and a ``("data", "model")`` mesh of 2 x 2), against the
port's own ``mesh=None`` run (bitwise) and the JAX package's
``run(mesh=...)`` on 4 forced host devices (integers and
``realized_epochs`` exact, the sums over tasks at rtol 1e-6, ROADMAP C5,
every other metric bitwise).  Both packages price buckets with the JAX
package's fallback coefficients.

The plans: 7 open-loop cells (padded to 8 over the ranks), 48 closed-loop
cells of the smoke's mixed control family, and a ``bucket="auto"`` grid
that splits into more than one bucket.  Further cases: ranks handed
different cost models, a rank whose plan differs (every rank raises), and
the ``ValueError``s of the options a mesh does not take.

Each multi-rank run is a subprocess with its own time limit: a rank that
raises would otherwise leave the others waiting in a collective."""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import costmodel as tcost
from repro_torch.core import sweep as tsweep
from torch_costpin import pinned_cost_cache  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]

C5 = frozenset({
    "avg_exec", "map_avg_exec", "reduce_avg_exec", "vm_cost",
    "utilization", "transfer_bytes", "billed_cost", "vm_busy_fraction",
    "queue_wait", "wasted_work_frac", "work_lost"})
MESHES = ("4", "2x2")
PLANS = ("open7", "closed48", "auto")

# plans built from either package's sweep module (``sw``); the closed-loop
# columns are numpy draws, the same for both
_PLANS = """
import sys
sys.path.insert(0, ROOT)
import chip_smoke

MJ = dict(max_maps=5, vms=(2, 6))
MJ_PAD = dict(pad_tasks=32, pad_jobs=4, pad_vms=6)


def plans(sw):
    cols = chip_smoke.mixed_control_columns(48, 5)
    return {
        "open7": sw.product(sw.axis("n_maps", range(1, 8))),
        "closed48": sw.product(sw.Axis(("cell",), tuple(
            (i,) for i in range(48)), cols)),
        "auto": sw.product(sw.axis("n_maps", (1, 2, 3, 90, 120)),
                           sw.axis("n_vms", range(2, 9))),
    }
"""

_PORT = """
import os, pickle, socket, sys
ROOT, OUT = sys.argv[1], sys.argv[2]
import numpy as np
import torch, torch.distributed as dist
import torch.multiprocessing as mp
""" + _PLANS + """

def run(rank, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.core as core
    from repro_torch.core import costmodel, sweep
    pin = costmodel.fallback_cost_model("cpu")
    meshes = {"4": init_device_mesh("cpu", (4,), mesh_dim_names=("data",)),
              "2x2": init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("data", "model"))}
    out = {}
    for mname, mesh in meshes.items():
        for pname, plan in plans(sweep).items():
            res = plan.run(mesh=mesh, device="cpu", cost_model=pin)
            out[mname, pname] = dict(res.metrics)
        for n in (10, 12):
            scs = chip_smoke.multijob_scenarios(core, n, 3, **MJ)
            batch = sweep.stack_scenarios(scs, device="cpu", **MJ_PAD)
            out[mname, "sharded", n] = {
                k: v.numpy() for k, v in
                sweep.simulate_batch_sharded(batch, mesh)._asdict().items()}
    mesh = meshes["2x2"]
    # ranks handed different cost models: the first rank's prices all
    own = costmodel.CostModel(dispatch_us=[1500.0, 1e12, 1e-3, 7.0][rank],
                              epoch_lane_us=[0.03, 1e-9, 5.0, 0.5][rank],
                              device="cpu")
    res, rep = plans(sweep)["auto"].run(mesh=mesh, device="cpu",
                                        cost_model=own, report=True)
    out["own_cost"] = dict(res.metrics)
    out["own_cost_buckets"] = [(b.cells, b.pad_tasks, b.dispatches)
                               for b in rep.buckets]
    # a rank whose plan differs: every rank raises, none hangs
    plan = plans(sweep)["open7" if rank != 2 else "auto"]
    try:
        plan.run(mesh=mesh, device="cpu", cost_model=pin)
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    with open(os.path.join(OUT, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(run, args=(port,), nprocs=4, start_method="spawn")
    print("PORT_OK")
"""

_REF = """
import os, pickle, sys
ROOT, OUT = sys.argv[1], sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
""" + _PLANS + """
import repro.core as core
from repro.core import costmodel, engine, sweep
pin = costmodel.fallback_cost_model()
meshes = {"4": jax.make_mesh((4,), ("data",)),
          "2x2": jax.make_mesh((2, 2), ("data", "model"))}
out = {}
for mname, mesh in meshes.items():
    for pname, plan in plans(sweep).items():
        res = plan.run(mesh=mesh, cost_model=pin)
        out[mname, pname] = {k: np.asarray(v) for k, v in res.metrics.items()}
    # the reference splits a batch it does not pad: 12 lanes on 4
    scs = chip_smoke.multijob_scenarios(core, 12, 3, **MJ)
    batch = jax.tree.map(lambda *x: np.stack(x), *[
        engine.from_scenario(s, **MJ_PAD) for s in scs])
    out[mname, "sharded", 12] = {
        k: np.asarray(v) for k, v in
        sweep.simulate_batch_sharded(batch, mesh)._asdict().items()}
with open(os.path.join(OUT, "ref.pkl"), "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


def _spawn(code: str, out: pathlib.Path, marker: str, timeout: int,
           jax_env: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    script = out / "script.py"              # spawned ranks import it
    script.write_text(code)
    run = subprocess.run([sys.executable, str(script), str(ROOT), str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=str(ROOT))
    assert marker in run.stdout, run.stderr[-4000:]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the four-rank port run."""
    out = tmp_path_factory.mktemp("mesh_port")
    _spawn(_PORT, out, "PORT_OK", timeout=600)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(4)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's mesh runs on 4 forced host devices."""
    out = tmp_path_factory.mktemp("mesh_ref")
    _spawn(_REF, out, "REF_OK", timeout=600, jax_env=True)
    return pickle.loads((out / "ref.pkl").read_bytes())


def _plans():
    ns = {"ROOT": str(ROOT)}
    exec(_PLANS, ns)
    return ns


def _local(pname):
    """The port's own single-process run (``mesh=None``)."""
    plan = _plans()["plans"](tsweep)[pname]
    res = plan.run(device="cpu",
                   cost_model=tcost.fallback_cost_model("cpu"))
    return {k: np.asarray(v) for k, v in res.metrics.items()}


def _bitwise(want, got, what):
    assert set(want) == set(got), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=f"{what}: {k}")


def _like_reference(want, got, what):
    assert set(want) == set(got), what
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if k in C5:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b.view(np.uint8),
                                          a.view(np.uint8),
                                          err_msg=f"{what}: {k}")


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("mname", MESHES)
def test_mesh_run_is_bitwise_the_single_process_run(ranks, mname, pname):
    """Every rank returns the whole result, bit for bit the port's
    ``mesh=None`` run, ``realized_epochs`` included."""
    want = _local(pname)
    for r, got in enumerate(ranks):
        _bitwise(want, got[mname, pname], f"rank {r} {mname} {pname}")


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("mname", MESHES)
def test_mesh_run_matches_reference(ranks, reference, mname, pname):
    """The port's four-rank run against the reference's ``run(mesh=)`` on
    a mesh of the same shape."""
    _like_reference(reference[mname, pname], ranks[0][mname, pname],
                    f"{mname} {pname}")


def test_auto_plan_has_several_buckets():
    """The ``bucket="auto"`` grid splits (so the mesh path pads, steps and
    trims more than one bucket)."""
    plan = _plans()["plans"](tsweep)["auto"]
    _, rep = plan.run(device="cpu", report=True,
                      cost_model=tcost.fallback_cost_model("cpu"))
    assert rep.n_buckets >= 2
    assert any(b.cells % 4 for b in rep.buckets)      # a padded bucket


@pytest.mark.parametrize("n", [10, 12], ids=["padded", "even"])
@pytest.mark.parametrize("mname", MESHES)
def test_simulate_batch_sharded_matches(ranks, reference, mname, n):
    """A multi-job batch split over the mesh: bitwise the port's
    ``simulate_batch`` on every rank, 10 lanes padded to 12 among them,
    and the reference's ``simulate_batch_sharded`` at the stated
    tolerances on 12 (the reference raises on a batch that does not
    divide the mesh; the port pads it, as ``run(mesh=)`` pads a bucket)."""
    import repro_torch.core as core
    ns = _plans()
    scs = ns["chip_smoke"].multijob_scenarios(core, n, 3, **ns["MJ"])
    batch = tsweep.stack_scenarios(scs, device="cpu", **ns["MJ_PAD"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = {k: v.numpy() for k, v in
                tsweep.simulate_batch(batch)._asdict().items()}
    finally:
        torch.set_num_threads(threads)
    for r, got in enumerate(ranks):
        _bitwise(want, got[mname, "sharded", n], f"rank {r} {mname}")
    if n in {k[2] for k in reference if k[1] == "sharded"}:
        _like_reference(reference[mname, "sharded", n],
                        ranks[0][mname, "sharded", n], f"reference {mname}")


def test_ranks_with_different_cost_models_bucket_alike(ranks):
    """Each rank passes its own cost model (one of them never splits):
    every rank prices with the first rank's, so all hold its buckets and
    its result, one dispatch per bucket."""
    first = tcost.CostModel(dispatch_us=1500.0, epoch_lane_us=0.03,
                            device="cpu")
    plan = _plans()["plans"](tsweep)["auto"]
    res, rep = plan.run(device="cpu", cost_model=first, report=True)
    want = {k: np.asarray(v) for k, v in res.metrics.items()}
    buckets = [(b.cells, b.pad_tasks, 1) for b in rep.buckets]
    assert len(buckets) >= 2
    for r, got in enumerate(ranks):
        assert got["own_cost_buckets"] == buckets, r
        _bitwise(want, got["own_cost"], f"rank {r}")


def test_rank_with_another_plan_raises_on_every_rank(ranks):
    """A rank whose bucket list differs makes every rank raise (the
    digest check runs before any lane is stepped), so no rank waits."""
    for r, got in enumerate(ranks):
        assert got["mismatch"] and "bucketed the plan differently" in \
            got["mismatch"], r


@pytest.mark.parametrize("kw", [
    {"chunk": 4},
    {"chunk": 4, "stream_to": "x.parquet"},
    {"stream_to": "x.parquet"},
], ids=["chunk", "chunk+stream_to", "stream_to"])
def test_mesh_refuses_chunk_and_stream_to(kw):
    """``mesh`` takes no ``chunk``; ``stream_to`` needs ``chunk``: both
    raise before any collective (a placeholder mesh is never touched)."""
    plan = tsweep.product(tsweep.axis("n_maps", range(1, 8)))
    with pytest.raises(ValueError, match="chunk"):
        plan.run(mesh=object(), device="cpu", **kw)
