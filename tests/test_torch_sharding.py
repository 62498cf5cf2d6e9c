"""The port's sharding rules, abstract trees and collective accounting
against the JAX package's: ``repro_torch.sharding`` vs ``repro.sharding``
(resolver on the reference's ``jax.sharding.AbstractMesh``: no devices),
``abstract_model`` / ``model_axes`` / ``input_specs`` / ``state_axes`` /
``tree_shardings`` for every arch and cell, ``launch.comm_stats`` vs
``launch.hlo_stats``, MoE's dispatch groups under a data extent of 4
against the reference on 4 host devices, and the elastic restore onto a
2×2 mesh of 4 ``gloo`` processes.  The subprocess tests carry their own
time limits."""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import hlo_stats
from repro.models import abstract_model as j_abstract_model
from repro.models import model_axes as j_model_axes
from repro.models.model import init_decode_state as j_init_decode_state
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import comm_stats
from repro_torch.launch.mesh import production_axes
from repro_torch.models import abstract_model, model_axes
from repro_torch.models.layers import tree_items
from repro_torch.models.model import init_decode_state
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parents[1]

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
TABLES = ("WEIGHT_RULES", "STATE_RULES", "WEIGHT_RULES_FSDP2",
          "ACT_RULES_FSDP2", "ACT_RULES")


def both(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), rules.MeshAxes(axes, shape)


def pad(spec: tuple, n: int) -> tuple:
    return tuple(spec) + (None,) * (n - len(spec))


# ---------------------------------------------------------------------------
# spec_for: the reference's ten pinned cases and a seeded sweep
# ---------------------------------------------------------------------------

_PINNED = [
    # TP + FSDP basics
    ((4096, 11008), ("embed", "mlp"), ("data", "model"), "16x16",
     "WEIGHT_RULES"),
    # llama4: 40 heads don't divide 16 -> head_dim fallback
    ((5120, 40, 128), ("embed", "heads", "head_dim"),
     ("data", None, "model"), "16x16", "WEIGHT_RULES"),
    # divisible heads take the model axis, head_dim skipped (axis used)
    ((4096, 32, 128), ("embed", "heads", "head_dim"),
     ("data", "model", None), "16x16", "WEIGHT_RULES"),
    # hubert vocab 504 -> padded 512 divides; raw 504 would be replicated
    ((512, 1280), ("vocab", "embed"), ("model", "data"), "16x16",
     "WEIGHT_RULES"),
    ((504, 1280), ("vocab", "embed"), (None, "data"), "16x16",
     "WEIGHT_RULES"),
    # kv cache: seq beats head_dim under STATE_RULES, not under ACT_RULES
    ((128, 32768, 8, 128), ("batch", "seq", "kv_heads", "head_dim"),
     ("data", "model", None, None), "16x16", "STATE_RULES"),
    ((128, 32768, 8, 128), ("batch", "seq", "kv_heads", "head_dim"),
     ("data", None, None, "model"), "16x16", "ACT_RULES"),
    # batch super-axis covers pod+data on the multi-pod mesh
    ((256, 4096), ("batch", "seq"), (("pod", "data"), "model"), "2x16x16",
     "ACT_RULES"),
    # indivisible batch degrades to replicated (never fails)
    ((3, 7), ("batch", "seq"), (None, None), "16x16", "ACT_RULES"),
    # FSDP2: one dim takes both axes
    ((5120, 13824), ("embed", "mlp"), (("data", "model"), None), "16x16",
     "WEIGHT_RULES_FSDP2"),
]


@pytest.mark.parametrize("shape,axes,want,mesh,table", _PINNED)
def test_spec_for_resolution(shape, axes, want, mesh, table):
    jm, tm = both(mesh)
    ref = jrules.spec_for(jm, shape, axes, getattr(jrules, table))
    got = rules.spec_for(tm, shape, axes, getattr(rules, table))
    assert pad(tuple(ref), len(shape)) == want
    assert got == want


def test_rule_tables_are_the_references():
    for table in TABLES:
        ref = {k: [(tuple(a) if isinstance(a, tuple) else a, p)
                   for a, p in v] for k, v in getattr(jrules, table).items()}
        assert getattr(rules, table) == ref, table


_NAMES = ("batch", "seq", "embed", "embed2", "mlp", "inner", "heads",
          "kv_heads", "head_dim", "vocab", "experts", "state", "layers",
          "capacity", None)
_SIZES = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 256,
          504, 512, 1024, 4096, 32768)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_matches_reference_on_a_seeded_sweep(mesh):
    """700 random (shape, axes, table) draws per mesh (2,100 in all): the
    spec equal entry by entry."""
    jm, tm = both(mesh)
    rng = np.random.default_rng([2026, len(MESHES[mesh][0])])
    for _ in range(700):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(_SIZES)) for _ in range(rank))
        axes = tuple(_NAMES[int(i)] for i in rng.integers(0, len(_NAMES),
                                                          rank))
        table = TABLES[int(rng.integers(0, len(TABLES)))]
        ref = jrules.spec_for(jm, shape, axes, getattr(jrules, table))
        got = rules.spec_for(tm, shape, axes, getattr(rules, table))
        assert got == pad(tuple(ref), rank), (shape, axes, table)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mp = production_axes(multi_pod=True)
    assert rules.placements(mp, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert rules.placements(mp, (None, None)) == (Replicate(),) * 3
    sp = production_axes()
    assert rules.placements(sp, (("data", "model"), None)) == (
        Shard(0), Shard(0))


# ---------------------------------------------------------------------------
# abstract trees, input specs, state axes, tree shardings
# ---------------------------------------------------------------------------

def _jleaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


def _tleaves(tree):
    return dict(tree_items(tree))


@pytest.mark.parametrize("arch", jconfigs.arch_names())
def test_abstract_model_and_axes_match_reference(arch):
    """Full size, nothing allocated: every leaf's shape, dtype and axes."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    ref = _jleaves(j_abstract_model(jcfg))
    got = _tleaves(abstract_model(cfg))
    assert sorted(ref) == sorted(got)
    for path, sds in ref.items():
        t = got[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(sds.shape), path
        assert str(t.dtype).split(".")[-1] == str(sds.dtype), path
    rax = _jleaves(j_model_axes(jcfg), lambda x: isinstance(x, tuple))
    gax = _tleaves(model_axes(cfg))
    assert rax == gax


@pytest.mark.parametrize("arch,shape", jconfigs.all_cells())
def test_input_specs_match_reference(arch, shape):
    ref = _jleaves(jconfigs.input_specs(jconfigs.get(arch), shape))
    got = configs.input_specs(configs.get(arch), shape)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v
    walk(got, ())
    assert sorted(ref) == sorted(flat)
    for path, sds in ref.items():
        assert flat[path].device.type == "meta"
        assert tuple(flat[path].shape) == tuple(sds.shape), path
        assert str(flat[path].dtype).split(".")[-1] == str(sds.dtype), path


@pytest.mark.parametrize("arch", [a for a in jconfigs.arch_names()
                                  if jconfigs.get(a).has_decode])
def test_state_axes_match_reference(arch):
    """Each decoding family's reduced decode state."""
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    ref_state = jax.eval_shape(lambda: j_init_decode_state(jcfg, 2, 16))
    ref = _jleaves(jrules.state_axes(ref_state),
                   lambda x: isinstance(x, tuple))
    got = _tleaves(rules.state_axes(init_decode_state(cfg, 2, 16,
                                                      device="meta")))
    assert ref == got


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", jconfigs.arch_names())
def test_tree_shardings_match_reference(arch, mesh):
    jm, tm = both(mesh)
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    ref = _jleaves(jrules.tree_shardings(jm, j_model_axes(jcfg),
                                         j_abstract_model(jcfg)))
    got = _tleaves(rules.tree_shardings(tm, model_axes(cfg),
                                        abstract_model(cfg)))
    assert sorted(ref) == sorted(got)
    for path, ns in ref.items():
        spec = pad(tuple(ns.spec), len(got[path]))
        assert got[path] == rules.placements(tm, spec), path


# ---------------------------------------------------------------------------
# comm_stats against hlo_stats
# ---------------------------------------------------------------------------

# the synthetic HLO of tests/test_sharding_rules.py
_HLO = """
HloModule test
fused {
  %x = bf16[16,4096]{1,0} parameter(0)
}
ENTRY main {
  %p0 = bf16[16,4096]{1,0} parameter(0)
  %ag = bf16[256,4096]{1,0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[8,1024]{1,0} parameter(1)
  %ar2 = f32[8,1024]{1,0} all-reduce(%ar), replica_groups={{0,1,2,3}}, to_apply=add
  %rs = bf16[2,4096]{1,0} reduce-scatter(%p0), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = bf16[16,4096]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  ROOT %t = (bf16[256,4096]{1,0}) tuple(%ag)
}
"""

# the same collectives as the port records them
_RECORDS = [
    comm_stats.Record("all-gather", 16 * 4096 * 2, 256 * 4096 * 2, 16),
    comm_stats.Record("all-reduce", 8 * 1024 * 4, 8 * 1024 * 4, 4),
    comm_stats.Record("reduce-scatter", 16 * 4096 * 2, 2 * 4096 * 2, 8),
    comm_stats.Record("collective-permute", 16 * 4096 * 2, 16 * 4096 * 2,
                      1),
]


def test_collective_stats_match_hlo_stats():
    ref = hlo_stats.collective_stats(_HLO)
    got = comm_stats.collective_stats(_RECORDS)
    assert got == ref
    assert comm_stats.totals(got) == hlo_stats.totals(ref)
    # a record standing for n collectives sums as n of them
    many = comm_stats.collective_stats([_RECORDS[0]._replace(count=3)])
    assert many == comm_stats.collective_stats([_RECORDS[0]] * 3)
    assert comm_stats.collective_stats([]) == hlo_stats.collective_stats(
        "ENTRY main { ROOT %c = s32[] constant(0) }")


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "other"])
def test_wire_bytes_match_hlo_stats(kind):
    for k in (0, 1, 2, 4, 16, 512):
        for op, res in ((0, 0), (4096, 65536), (12345, 777)):
            assert comm_stats._wire_bytes(kind, op, res, k) == \
                hlo_stats._wire_bytes(kind, op, res, k)


# ---------------------------------------------------------------------------
# MoE's dispatch groups: a data extent of 4 against the reference on 4 host
# devices
# ---------------------------------------------------------------------------

_MOE_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import moe
from repro.sharding import rules
d = np.load(sys.argv[1])
cfg = configs.get("mixtral-8x7b").reduced(dtype="float32")
cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                           "capacity_factor": 1.0}))
p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("p_")}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
with rules.mesh_ctx(mesh):
    out = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg))(p, x)
    G = moe._dispatch_groups(x.shape[0])
B, S, D = x.shape
gates, idx = moe._route(p, x.reshape(B * S, D), cfg)
np.savez(sys.argv[2], out=np.asarray(out), G=G, idx=np.asarray(idx),
         gates=np.asarray(gates))
"""


def test_moe_groups_match_reference_under_a_data_extent_of_4(tmp_path):
    from repro_torch.models import moe
    cfg = configs.get("mixtral-8x7b").reduced(dtype="float32")
    # capacity 1.0: tokens drop, and where they drop depends on the groups
    cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                               "capacity_factor": 1.0}))
    rng = np.random.default_rng(7)
    decls = moe.moe_decls(cfg)
    p = {k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
         for k, v in decls.items()}
    x = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, **{f"p_{k}": v for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _MOE_REF,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    ref = np.load(tmp_path / "out.npz")
    assert int(ref["G"]) == 4
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    with rules.mesh_ctx(rules.MeshAxes(("data",), (4,))):
        assert moe._dispatch_groups(8) == 4
        out = moe.apply_moe(tp, tx, cfg)
    gates, idx = moe._route(tp, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    # keep: the kept assignments per group are the reference's
    G, N = 4, 8 * 16 // 4
    _, _, keep, _ = moe._dispatch(idx.reshape(G, N, -1), cfg.moe.n_experts,
                                  moe.capacity(cfg, N))
    assert not keep.all()                       # capacity drops tokens
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=1e-5,
                               atol=1e-5)
    # one group drops other tokens: the groups are what matched
    assert not np.allclose(moe.apply_moe(tp, tx, cfg).numpy(), ref["out"],
                           rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# elastic restore onto a 2x2 mesh of 4 gloo processes
# ---------------------------------------------------------------------------

_ELASTIC = """
import os, sys, socket
import torch, torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, root, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.train import checkpoint
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    if rank == 0:
        checkpoint.save(root, 1, tree)          # unsharded
    dist.barrier()
    step, got, _ = checkpoint.restore(
        root, tree, shardings={"w": (mesh, (Shard(0), Shard(1)))})
    assert step == 1
    assert got["w"].placements == (Shard(0), Shard(1))
    i, j = mesh.get_coordinate()
    block = torch.arange(64.0).reshape(8, 8)[4 * i:4 * i + 4, 4 * j:4 * j + 4]
    assert torch.equal(got["w"].to_local(), block), (rank, got["w"])
    assert torch.equal(got["w"].full_tensor(), tree["w"])
    dist.destroy_process_group()

if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(run, args=(sys.argv[1], port), nprocs=4,
                       start_method="spawn")
    print("ELASTIC_OK")
"""


def test_elastic_resharding(tmp_path):
    """Save unsharded, restore onto a 2x2 mesh with (Shard(0), Shard(1)):
    each rank's local shard is its block of arange(64).reshape(8, 8)."""
    script = tmp_path / "elastic.py"
    script.write_text(_ELASTIC)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(script), str(tmp_path / "e")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert "ELASTIC_OK" in run.stdout, run.stderr
