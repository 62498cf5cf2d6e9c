"""The port's dry run on cells whose global batch does not divide the
(pod × data) extent: the reference's ``spec_for`` leaves such a batch
unsplit, and so does the port (``rules.mesh_ctx(batch=...)``: products
contract over the weights' FSDP shards and their partial sums are reduced
at once, never reduce-scattered into an uneven batch split).

Each cell runs in a subprocess of its own (the port's dry run opens a
``fake`` default process group; the reference needs forced host devices),
each with its own time limit."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SHAPE = """
import dataclasses, sys
arch, shape, dims = sys.argv[1], sys.argv[2], sys.argv[3]
seq, batch, n_layers = (int(a) for a in sys.argv[4:7])
dims = tuple(int(d) for d in dims.split("x"))
n_dev = dims[0] * dims[1]

def cell_cfg(configs):
    s = configs.SHAPES[shape]
    configs.SHAPES[shape] = dataclasses.replace(s, seq_len=seq,
                                                global_batch=batch)
    if len(sys.argv) > 7:          # a one-layer GQA cell: heads, kv heads
        heads, kv = int(sys.argv[7]), int(sys.argv[8])
        return configs.get(arch).reduced(n_layers=1, n_heads=heads,
                                         n_kv_heads=kv, d_model=32 * heads)
    return configs.get(arch).reduced(n_layers=n_layers)
"""

_PORT = _SHAPE + """
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
from repro_torch import configs
from repro_torch.launch import dryrun
mesh = DeviceMesh("cpu", torch.arange(n_dev).reshape(dims),
                  mesh_dim_names=("data", "model"))
rec = dryrun.run_cell(arch, shape, multi_pod=False,
                      cfg_override=cell_cfg(configs), mesh=mesh)
print("RESULT " + json.dumps({"flops": rec["flops"],
                              "memory": rec["memory"]}))
"""

_REF = _SHAPE + """
import json, os, re
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
import jax
from repro import configs
from repro.launch import dryrun
mesh = jax.make_mesh(dims, ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
fn, args, in_sh, donate = dryrun.build_cell(cell_cfg(configs), shape, mesh)
compiled = jax.jit(fn, in_shardings=in_sh,
                   donate_argnums=donate).lower(*args).compile()
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
print("RESULT " + json.dumps({"dot_flops": dots}))
"""


def _run(code: str, *args, timeout: int = 300, jax_env: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


# (arch, shape, mesh, seq, global batch): every batch here leaves a
# remainder on the (pod x data) extent (4 on 4x1 and 4x2, 2 on 2x2)
UNSPLIT = [
    ("rwkv6-3b", "train_4k", "4x2", 64, 2),
    ("rwkv6-3b", "train_4k", "2x2", 64, 3),
    ("yi-6b", "train_4k", "2x2", 64, 3),
    ("mixtral-8x7b", "train_4k", "4x1", 64, 2),
]


@pytest.mark.parametrize("arch,shape,mesh,seq,batch", UNSPLIT)
def test_unsplit_batch_cell_completes(arch, shape, mesh, seq, batch):
    """A reduced two-layer train cell whose batch does not divide the
    data axis runs to its end on the port's dry run (it raised in
    ``DTensor``'s sharding propagation before: an uneven batch split, or
    the sequence split over ``data``, that a later view cannot take), with
    per-device FLOPs and argument bytes counted."""
    got = _run(_PORT, arch, shape, mesh, seq, batch, 2)
    assert got["flops"] > 0
    assert got["memory"]["argument_bytes"] > 0


def test_reference_completes_the_rwkv6_cell():
    """The reference's dry run compiles the same reduced rwkv6 cell on 8
    forced host devices (so the port's failure there was the port's)."""
    ref = _run(_REF, "rwkv6-3b", "train_4k", "4x2", 64, 2, 2, jax_env=True)
    assert ref["dot_flops"] > 0


# one-layer GQA prefill cells, S <= 512 (every scan of the reference runs
# one trip): (arch, shape, mesh, seq, global batch, query heads, kv heads)
GQA_UNSPLIT = [
    ("yi-6b", "prefill_32k", "4x2", 256, 2, 4, 1),
    ("yi-6b", "prefill_32k", "2x2", 256, 3, 4, 1),
]


@pytest.mark.parametrize("arch,shape,mesh,seq,batch,heads,kv", GQA_UNSPLIT)
def test_unsplit_batch_flops_match_reference(arch, shape, mesh, seq, batch,
                                             heads, kv):
    """Per-device FLOPs of a prefill cell with an unsplit batch equal the
    FLOPs of the reference's compiled products on the same mesh: the
    batch whole on every device, each product split over ``data`` by its
    FSDP-sharded weight and over ``model`` by its tensor-parallel one."""
    args = (arch, shape, mesh, seq, batch, 1, heads, kv)
    got = _run(_PORT, *args)["flops"]
    ref = _run(_REF, *args, jax_env=True)
    assert got == ref["dot_flops"]
