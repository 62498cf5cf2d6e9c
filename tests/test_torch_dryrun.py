"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's on reduced cells: per-device ``argument_bytes`` and
``output_bytes`` of a dense and a MoE train cell on a 2×2 mesh against the
reference's ``memory_analysis()`` on 4 host devices; the counted FLOPs
against ``FlopCounterMode`` over the same step on real CPU tensors; the
sampled loops against running every step; and the CLI's records.

Each cell runs in a subprocess of its own (the dry run opens a ``fake``
default process group; the reference needs 4 host devices), each with its
own time limit."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# reduced cells: 2 layers, seq 64, global batch 8 (the microbatch count
# is the reference's rule on these shapes)
CELLS = [("yi-6b", "train_4k"), ("mixtral-8x7b", "train_4k")]

_SHRINK = """
import dataclasses

def shrink(configs, shape, n_layers=2, seq=64, batch=8):
    s = configs.SHAPES[shape]
    configs.SHAPES[shape] = dataclasses.replace(
        s, seq_len=seq, global_batch=batch if s.global_batch > 1 else 1)
"""

_PORT = _SHRINK + """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch import configs
from repro_torch.launch import dryrun
arch, shape, dims = sys.argv[1], sys.argv[2], sys.argv[3]
dims = tuple(int(d) for d in dims.split("x"))
n = 1
for d in dims:
    n *= d
mesh = DeviceMesh("cpu", torch.arange(n).reshape(dims),
                  mesh_dim_names=("data", "model"))
shrink(configs, shape)
cfg = configs.get(arch).reduced(n_layers=2)
rec = dryrun.run_cell(arch, shape, multi_pod=False, cfg_override=cfg,
                      mesh=mesh)
out = {"rec": rec}
if n == 1:
    # the same step on real CPU tensors under FlopCounterMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    fn, args, pl, _ = dryrun.build_cell(cfg, shape, mesh)
    g = torch.Generator().manual_seed(0)

    def real(t, p):
        if isinstance(t, torch.Tensor):
            x = (torch.randn(t.shape, generator=g, dtype=t.dtype) * 0.02
                 if t.dtype.is_floating_point
                 else torch.zeros(t.shape, dtype=t.dtype))
            return DTensor.from_local(x, mesh, p, run_check=False)
        if isinstance(t, dict):
            return {k: real(v, p[k]) for k, v in t.items()}
        parts = [real(v, q) for v, q in zip(t, p)]
        return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
    rargs = real(tuple(args), tuple(pl))
    with FlopCounterMode(display=False) as fc, implicit_replication():
        fn(*rargs)
    out["real_flops"] = fc.get_total_flops()
print("RESULT " + json.dumps(out))
"""

_REF = _SHRINK + """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro import configs
from repro.launch import dryrun
arch, shape = sys.argv[1], sys.argv[2]
shrink(configs, shape)
cfg = configs.get(arch).reduced(n_layers=2)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
fn, args, in_sh, donate = dryrun.build_cell(cfg, shape, mesh)
jitted = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate)
ma = jitted.lower(*args).compile().memory_analysis()
n_out = len(jax.tree.leaves(jax.eval_shape(fn, *args)))
print("RESULT " + json.dumps({"argument_bytes": ma.argument_size_in_bytes,
                              "output_bytes": ma.output_size_in_bytes,
                              "n_out": n_out}))
"""


def _run(code: str, *args, timeout: int = 300, jax_env: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_memory_per_device_matches_reference(arch, shape):
    """argument_bytes equal; output_bytes equal once XLA's output tuple
    table (8 bytes a leaf, which ``output_size_in_bytes`` adds) is taken
    out."""
    got = _run(_PORT, arch, shape, "2x2")["rec"]["memory"]
    ref = _run(_REF, arch, shape, jax_env=True)
    assert got["argument_bytes"] == ref["argument_bytes"]
    assert got["output_bytes"] == ref["output_bytes"] - 8 * ref["n_out"]
    assert got["code_bytes"] is None
    assert got["temp_bytes"] > 0


# one layer of a GQA arch, S <= 512: every scan of the reference runs one
# trip, so XLA's count of a loop body is the whole loop's
_GQA_CFG = """
import dataclasses, sys
arch, shape, dims = sys.argv[1], sys.argv[2], sys.argv[3]
heads, kv, seq, batch = (int(a) for a in sys.argv[4:8])

def gqa_cfg(configs):
    s = configs.SHAPES[shape]
    configs.SHAPES[shape] = dataclasses.replace(s, seq_len=seq,
                                                global_batch=batch)
    return configs.get(arch).reduced(n_layers=1, n_heads=heads,
                                     n_kv_heads=kv, d_model=32 * heads)
"""

_GQA_PORT = _GQA_CFG + """
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch import configs
from repro_torch.launch import dryrun
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(arch, shape, multi_pod=False,
                      cfg_override=gqa_cfg(configs), mesh=mesh)
print("RESULT " + json.dumps({"flops": rec["flops"]}))
"""

_GQA_REF = _GQA_CFG + """
import json, os, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro import configs
from repro.launch import dryrun
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
fn, args, in_sh, donate = dryrun.build_cell(gqa_cfg(configs), shape, mesh)
compiled = jax.jit(fn, in_shardings=in_sh,
                   donate_argnums=donate).lower(*args).compile()
ca = compiled.cost_analysis()
ca = ca[0] if isinstance(ca, list) else ca
hlo = compiled.as_text()
shapes = {m.group(1): [int(d) for d in m.group(2).split(",") if d]
          for m in re.finditer(r"(%[\\w.\\-]+) = \\w+\\[([\\d,]*)\\]", hlo)}
dots = 0
for m in re.finditer(r"= \\w+\\[([\\d,]*)\\]\\S* dot\\((%[\\w.\\-]+), "
                     r"%[\\w.\\-]+\\),.*?lhs_contracting_dims=\\{([\\d,]*)\\}", hlo):
    n = 2
    for d in m.group(1).split(","):
        n *= int(d) if d else 1
    for c in m.group(3).split(","):
        n *= shapes[m.group(2)][int(c)]
    dots += n
print("RESULT " + json.dumps({"flops": ca["flops"], "dot_flops": dots}))
"""

# (arch, shape, query heads, kv heads, seq, global batch)
GQA_CELLS = [
    ("yi-6b", "prefill_32k", 4, 1, 256, 8),   # query heads split, K/V whole
    ("yi-6b", "prefill_32k", 5, 1, 256, 8),   # 5 heads on 2: rows split
    ("yi-6b", "decode_32k", 4, 1, 256, 8),
    ("yi-6b", "train_4k", 4, 1, 256, 2),
]


@pytest.mark.parametrize("arch,shape,heads,kv,seq,batch", GQA_CELLS)
def test_gqa_flops_per_device_match_reference(arch, shape, heads, kv, seq,
                                              batch):
    """Per-device FLOPs of a one-layer GQA cell on a 2x2 mesh against the
    reference's ``cost_analysis()`` on 4 host devices: equal to the FLOPs
    of its compiled module's products (its dots, counted from their shapes
    as ``cost_analysis()`` counts them), and below its ``flops``, which
    add the elementwise ops the port's count leaves out.  The train cell
    adds the reference's second score product per block: its kv-block
    body is rematerialised again inside the backward
    (``jax.checkpoint(kv_block)``), which the port's block loop is not:
    2 B Hq S T Dh per device, B and Hq split over data and model."""
    args = (arch, shape, "2x2", str(heads), str(kv), str(seq), str(batch))
    got = _run(_GQA_PORT, *args)["flops"]
    ref = _run(_GQA_REF, *args, jax_env=True)
    remat = 0
    if shape.startswith("train"):
        remat = 2 * (batch // 2) * (heads // 2) * seq * seq * 32
    assert got + remat == ref["dot_flops"]
    assert got < ref["flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_match_flop_counter_on_real_tensors(arch, shape):
    """On a one-device mesh the fake run's per-device FLOPs (time and
    block loops sampled) equal FlopCounterMode's over the same step run
    on real CPU tensors, every step."""
    out = _run(_PORT, arch, shape, "1x1")
    assert out["rec"]["flops"] == out["real_flops"] > 0


_SAMPLED = _SHRINK + """
import contextlib, json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch import configs, loops
from repro_torch.launch import dryrun
arch, shape, n_layers, seq = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
shrink(configs, shape, seq=seq)
cfg = configs.get(arch).reduced(n_layers=n_layers)
run = lambda: dryrun.run_cell(arch, shape, multi_pod=False,
                              cfg_override=cfg, mesh=mesh)
run()                     # warm DTensor's propagation caches
sampled = run()
loops.sampling = lambda sampler: contextlib.nullcontext()
every = run()
print("RESULT " + json.dumps({"sampled": sampled, "every": every}))
"""


@pytest.mark.parametrize("arch,shape,n_layers,seq", [
    ("yi-6b", "prefill_32k", 2, 2048),      # 4 x 2 attention blocks
    ("rwkv6-3b", "train_4k", 2, 64),        # WKV6 plain fwd and bwd loops
    ("jamba-v0.1-52b", "prefill_32k", 8, 64),   # the Mamba time loop
    ("mixtral-8x7b", "train_4k", 1, 64),        # 4 microbatches
])
def test_sampled_loops_count_as_every_step(arch, shape, n_layers, seq):
    """Two steps of each loop stand for all: FLOPs, collectives and the
    argument and output bytes equal running every step; bytes accessed
    within 1e-3 and temp within 1e-2 where no loop is differentiated
    through autograd (here: the first step's carry changes layout once,
    and nested block loops free one block's accumulator at another
    moment)."""
    out = _run(_SAMPLED, arch, shape, str(n_layers), str(seq), timeout=600)
    s, e = out["sampled"], out["every"]
    assert s["flops"] == e["flops"]
    assert s["collectives"] == e["collectives"]
    for key in ("argument_bytes", "output_bytes"):
        assert s["memory"][key] == e["memory"][key]
    assert s["memory"]["temp_bytes"] == pytest.approx(
        e["memory"]["temp_bytes"], rel=1e-2)
    assert s["bytes_accessed"] == pytest.approx(e["bytes_accessed"],
                                                rel=1e-3)


_CLI = _SHRINK + """
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
full = configs.get
configs.get = lambda name: full(name).reduced(n_layers=2)
shrink(configs, "decode_32k")
dryrun.main(sys.argv[1:])
"""

# the reference's record keys
_KEYS = {"arch", "shape", "mesh", "tag", "n_layers", "period_len",
         "n_periods", "flops", "bytes_accessed", "memory", "collectives",
         "collective_count", "collective_operand_bytes",
         "collective_wire_bytes", "lower_s", "compile_s"}


def test_cli_writes_the_references_records(tmp_path):
    """``--variants`` adds the L1/L0 records; the JSON is incremental; a
    failed cell is listed and the run exits 1.  The production mesh
    (16x16, a fake 512-rank group), reduced widths."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(*args):
        return subprocess.run([sys.executable, "-c", _CLI, *args], env=env,
                              capture_output=True, text=True, timeout=300,
                              cwd=str(ROOT))

    run = cli("--arch", "yi-6b", "--shape", "decode_32k", "--variants",
              "--out", str(out))
    assert run.returncode == 0, run.stderr[-4000:]
    recs = json.loads(out.read_text())
    assert sorted(recs) == [f"yi-6b|decode_32k|16x16|{t}"
                            for t in ("L0", "L1", "full")]
    for key, rec in recs.items():
        assert set(rec) == _KEYS, key
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "code_bytes"}
        assert rec["mesh"] == "16x16"
    assert recs["yi-6b|decode_32k|16x16|L0"]["n_layers"] == 0
    assert recs["yi-6b|decode_32k|16x16|L1"]["n_periods"] == 1
    again = cli("--arch", "yi-6b", "--shape", "decode_32k", "--variants",
                "--out", str(out))
    assert again.returncode == 0 and "...\n" not in again.stdout
    bad = cli("--arch", "no-such-arch", "--shape", "decode_32k", "--out",
              str(out))
    assert bad.returncode == 1
    assert "FAILURES" in bad.stdout and "no-such-arch" in bad.stdout


_CLI_ALL_SHAPES = _SHRINK + """
import sys
from repro_torch import configs
from repro_torch.launch import dryrun
full = configs.get
configs.get = lambda name: full(name).reduced(n_layers=2)
for name in list(configs.SHAPES):       # a batch the data axis splits,
    shrink(configs, name, batch=16)     # as every train and prefill cell
dryrun.main(sys.argv[1:])
"""


def test_cli_depth_runs_one_variant_of_every_shape(tmp_path):
    """``--arch`` without ``--shape`` runs every cell of that arch;
    ``--depth L1`` writes only each cell's 1-period record; an arch with
    no cell is an error.  The production mesh, reduced widths."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(*args):
        return subprocess.run([sys.executable, "-c", _CLI_ALL_SHAPES, *args],
                              env=env, capture_output=True, text=True,
                              timeout=300, cwd=str(ROOT))

    run = cli("--arch", "rwkv6-3b", "--depth", "L1", "--out", str(out))
    assert run.returncode == 0, run.stderr[-4000:]
    recs = json.loads(out.read_text())
    assert sorted(recs) == sorted(
        f"rwkv6-3b|{s}|16x16|L1"
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"))
    assert all(r["n_periods"] == 1 and r["flops"] > 0
               for r in recs.values())
    bad = cli("--arch", "no-such-arch", "--out", str(out))
    assert bad.returncode == 2 and "no cell" in bad.stderr


_REFUSED = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.launch import dryrun
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(4, 4), mesh, (Shard(0), Shard(1)),
                           run_check=False)
    census = dryrun.Census()
    try:
        with census:
            x.unbind(1)          # DTensor has no strategy on a split dim
    except RuntimeError as e:
        print("RESULT " + json.dumps({"raised": "unbind" in str(e),
                                      "records": len(census.records)}))
"""


def test_a_refused_op_fails_the_cell():
    """An op ``DTensor`` has no sharding strategy for raises through the
    census: it is not retried on re-laid operands."""
    out = _run("import json\n" + _REFUSED)
    assert out == {"raised": True, "records": 0}


def test_smoke_dry_commands_record_every_cell_once():
    """``chip_smoke.py``'s phase 19 (a) runs: every ``all_cells()`` cell at
    full depth on 16 x 16 and every multi-pod cell at one period, each
    recorded by exactly one run; the longest archs' cells each a run of
    their own."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch import configs
    cmds = chip_smoke.dry_commands()
    keys = [k for _, _, ks in cmds for k in ks]
    assert len(keys) == len(set(keys))
    assert sorted(keys) == sorted(
        [f"{a}|{s}|16x16|full" for a, s in configs.all_cells()]
        + [f"{a}|{s}|2x16x16|L1" for a, s in chip_smoke.DRY_MULTI_POD])
    for a in chip_smoke.DRY_FIRST:
        assert ([len(ks) for _, args, ks in cmds if args[1] == a]
                == [1] * len(configs.supported_shapes(configs.get(a))) + [1]
                * sum(b == a for b, _ in chip_smoke.DRY_MULTI_POD))


def test_smoke_dry_runs_stop_when_an_earlier_phase_fails(tmp_path,
                                                          monkeypatch):
    """Phase 19 (a)'s runs go on beside phase 3 in a thread; when phase 3
    fails, setting ``stop`` kills the runs still going and the thread's
    join raises, so the smoke leaves no process behind."""
    import threading
    import time

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    started, popen = [], subprocess.Popen

    def sleeper(cmd, **kw):
        proc = popen(["sleep", "60"], stdout=kw["stdout"],
                     stderr=kw["stderr"])
        started.append(proc)
        return proc
    monkeypatch.setattr(chip_smoke, "DRY_OUT", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "dry_commands", lambda: [
        (f"run {i}", [], [f"cell {i}"]) for i in range(3)])
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", sleeper)
    stop = threading.Event()
    join = chip_smoke.in_background(lambda: chip_smoke.phase_dryrun(stop))
    deadline = time.time() + 30
    while len(started) < 3 and time.time() < deadline:
        time.sleep(0.1)
    stop.set()
    with pytest.raises(AssertionError, match="stopped"):
        join()
    assert len(started) == 3
    assert all(p.poll() is not None for p in started)
