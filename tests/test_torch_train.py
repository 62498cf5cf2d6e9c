"""The port's training path (``repro_torch.models.loss_fn`` and
``repro_torch.train``) against the JAX package on the CPU, with the JAX
parameters carried over by ``convert.params_from_numpy`` and the JAX
package's batches fed to both (the port's token stream is its own, ROADMAP
C13), and the port's own versions of ``tests/test_trainer.py``'s and
``tests/test_extensions.py``'s training cases.

Tolerances, each measured on these inputs:

* ``loss_fn`` (every arch, reduced, float32): the loss at rtol 1e-6
  (measured <= 1.8e-7 relative) and every gradient leaf at atol 1e-6,
  rtol 1e-5 (measured <= 4.9e-7 absolute, rwkv6's): the same op sequence
  summed in other orders.  MoE routing is compared exactly.
* ``optimizer.update`` / ``schedule`` / ``global_norm``: rtol 1e-6, atol
  1e-8 (the per-leaf sums of the global norm round apart, and with
  clipping the scale carries that ulp into every update, lr·step ~ 1e-2:
  measured 4.7e-10 absolute on a weight of 2.4e-4 that the update nearly
  cancelled).
* ``compress_grads``: bitwise (the same elementwise ops; ``torch.round``
  and ``jnp.round`` both round half to even).
* three train steps from the same parameters and batches (lr 1e-3):
  losses and grad norms at rtol 1e-5 (measured <= 3.4e-7); parameters at
  atol 2e-5, rtol 1e-5, and at most 1 in 1000 of them beyond 1e-7.  AdamW
  divides each gradient element by its own running RMS, so an element
  near zero, known only to the gradients' absolute tolerance, can move
  its weight by a visible share of lr: measured 5.7e-6 (mixtral) at 38 of
  254,784 weights, the rest within 1e-7.
* checkpoints: bitwise, both ways.
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import models as jax_models
from repro.models import moe as jax_moe
from repro.train import checkpoint as jax_ckpt
from repro.train import compress as jax_compress
from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro.train import trainer as jax_trainer
from repro_torch import configs
from repro_torch import train as port_train
from repro_torch.launch import train as launch_train
from repro_torch.models import ArchConfig, convert, loss_fn, moe
from repro_torch.models.layers import tree_from_items, tree_items
from repro_torch.train import (NodeFailure, OptConfig, TrainConfig,
                               checkpoint, compress, data,
                               make_train_step, optimizer, train)

LOSS_RTOL = 1e-6
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
OPT_TOL = dict(atol=1e-8, rtol=1e-6)
STEP_TOL = dict(atol=2e-5, rtol=1e-5)

TINY = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, vocab_pad_to=8,
                  dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops (a Python loop over time, tiny layers): one thread
    each keeps them from contending with the other test workers'
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """The JAX and port reduced configs as ``tests/test_arch_smoke.py``
    reduces them, float32 activations."""
    kw = dict(n_layers=4, attn_every=4) if name == "jamba-v0.1-52b" else {}
    return tuple(reg.get(name).reduced(dtype="float32", **kw)
                 for reg in (jax_configs, configs))


def _params(jcfg, seed=0):
    jp = jax_models.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _flat(tree):
    """A JAX tree -> {path: numpy leaf} (dict keys, the port's paths)."""
    return {tuple(getattr(k, "key", getattr(k, "name", None))
                  for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, ::5] = -1                                 # unlabelled
    return {"inputs": inputs, "labels": labels}


def _port_value_and_grad(params, cfg, batch, **kw):
    paths, leaves = zip(*((p, x.detach().clone().requires_grad_())
                          for p, x in tree_items(params)))
    loss = loss_fn(tree_from_items(zip(paths, leaves)), cfg,
                   {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(paths, (g.numpy()
                                                  for g in grads)))


def _record_routes(monkeypatch):
    got = {"jax": [], "port": []}
    jax_route, port_route = jax_moe._route, moe._route

    def jax_recording(p, xf, cfg):
        gates, idx = jax_route(p, xf, cfg)
        jax.debug.callback(lambda i: got["jax"].append(np.array(i)), idx)
        return gates, idx

    def port_recording(p, xf, cfg):
        gates, idx = port_route(p, xf, cfg)
        got["port"].append(idx.numpy().copy())
        return gates, idx

    monkeypatch.setattr(jax_moe, "_route", jax_recording)
    monkeypatch.setattr(moe, "_route", port_recording)
    return got


# ---------------------------------------------------------------------------
# loss_fn against jax.value_and_grad(loss_fn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", configs.arch_names())
def test_loss_and_grads_match_jax(name, monkeypatch):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=3)
    batch = _batch(cfg, 2, 16, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: jax_models.loss_fn(p, jcfg, jbatch))(jp)
    got_loss, got = _port_value_and_grad(tp, cfg, batch)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    want = _flat(want)
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], err_msg=str(path),
                                   **GRAD_TOL)
    if cfg.moe is not None:
        # the routing of the loss's forward, every token's experts exact
        routes = _record_routes(monkeypatch)
        jax_models.loss_fn(jp, jcfg, jbatch, remat=False)
        with torch.no_grad():
            loss_fn(tp, cfg, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        n = sum(e["mlp"] == "moe" for e in cfg.block_pattern())
        assert len(routes["jax"]) == len(routes["port"]) == n
        for a, b in zip(routes["port"], routes["jax"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["rwkv6-3b", "yi-6b"])
def test_chunked_xent_matches_jax(name):
    # S > xent_chunk and divisible: the rematerialised chunk loop
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=4)
    batch = _batch(cfg, 2, 24, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: jax_models.loss_fn(p, jcfg, jbatch, xent_chunk=8))(jp)
    got_loss, got = _port_value_and_grad(tp, cfg, batch, xent_chunk=8)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    want = _flat(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], err_msg=str(path),
                                   **GRAD_TOL)


@pytest.mark.parametrize("name", ["yi-6b", "mixtral-8x7b"])
def test_chunked_attention_grads_match_jax(name, monkeypatch):
    # chunked_sdpa writes each q block into its output in place; under
    # autograd that slice write must carry the gradient (8 x 8 blocks here
    # against the reference's one block: the same online softmax)
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "BLOCK_Q", 8)
    monkeypatch.setattr(attention, "BLOCK_K", 8)
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=8)
    batch = _batch(cfg, 2, 16, seed=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: jax_models.loss_fn(p, jcfg, jbatch,
                                     attn_impl="chunked"))(jp)
    got_loss, got = _port_value_and_grad(tp, cfg, batch,
                                         attn_impl="chunked")
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    want = _flat(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], err_msg=str(path),
                                   **GRAD_TOL)


def test_remat_gives_the_same_gradients():
    # checkpointed periods recompute the same ops: bitwise on the CPU
    _, cfg = _cfgs("jamba-v0.1-52b")
    _, tp = _params(_cfgs("jamba-v0.1-52b")[0], seed=5)
    batch = _batch(cfg, 2, 8, seed=5)
    a = _port_value_and_grad(tp, cfg, batch, remat=True)
    b = _port_value_and_grad(tp, cfg, batch, remat=False)
    assert a[0] == b[0]
    for path in a[1]:
        np.testing.assert_array_equal(a[1][path], b[1][path])


# ---------------------------------------------------------------------------
# optimizer, compression, checkpoints against the reference
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(300)).astype(np.float32),
                  "d": np.zeros(3, np.float32)}}


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_optimizer_update_matches_jax(clip):
    rng = np.random.default_rng(int(clip))
    params = _tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    jcfg, tcfg = jax_opt.OptConfig(**cfg), OptConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, device="cpu")
    js, ts = jax_opt.init(jp), optimizer.init(tp)
    for _ in range(5):
        g = _tree(rng, scale=0.3)
        jp, js, jm = jax_opt.update(jcfg, jax.tree.map(jnp.asarray, g), js,
                                    jp)
        tp, ts, tm = optimizer.update(
            tcfg, convert.params_from_numpy(g, device="cpu"), ts, tp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **OPT_TOL)
        assert int(ts.step) == int(js.step)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            want = _flat(want)
            for path, leaf in tree_items(got):
                np.testing.assert_allclose(leaf.numpy(), want[path],
                                           err_msg=str(path), **OPT_TOL)


def test_schedule_and_global_norm_match_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(optimizer.schedule(OptConfig(**cfg), torch.tensor(s))),
            float(jax_opt.schedule(jax_opt.OptConfig(**cfg), jnp.asarray(s))),
            **OPT_TOL)
    tree = _tree(np.random.default_rng(9))
    np.testing.assert_allclose(
        float(optimizer.global_norm(convert.params_from_numpy(
            tree, device="cpu"))),
        float(jax_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
        **OPT_TOL)


def test_compress_grads_matches_jax_bitwise():
    rng = np.random.default_rng(11)
    g = _tree(rng, scale=1e-3)
    g["b"]["e"] = np.array([0.5, -0.5, 1.5, 2.5, 127.0, -254.0, 0.0],
                           np.float32)        # halves and exact ties
    jef = jax_compress.init_state(jax.tree.map(jnp.asarray, g))
    tef = compress.init_state(convert.params_from_numpy(g, device="cpu"))
    for step in range(3):
        gs = jax.tree.map(lambda a: a * (step + 1), g)
        jg, jef = jax_compress.compress_grads(jax.tree.map(jnp.asarray, gs),
                                              jef)
        tg, tef = compress.compress_grads(
            convert.params_from_numpy(gs, device="cpu"), tef)
        for got, want in ((tg, jg), (tef.residual, jef.residual)):
            want = _flat(want)
            for path, leaf in tree_items(got):
                np.testing.assert_array_equal(leaf.numpy(), want[path],
                                              err_msg=str(path))
    assert compress.wire_bytes(convert.params_from_numpy(g, device="cpu")) \
        == jax_compress.wire_bytes(jax.tree.map(jnp.asarray, g))


def _state(rng):
    p = _tree(rng)
    return p, (p, {"step": np.int32(4), "m": _tree(rng), "v": _tree(rng)})


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(12)
    p, (_, st) = _state(rng)
    jtree = (jax.tree.map(jnp.asarray, p),
             jax_opt.OptState(jnp.asarray(st["step"]),
                              jax.tree.map(jnp.asarray, st["m"]),
                              jax.tree.map(jnp.asarray, st["v"])))
    jax_ckpt.save(str(tmp_path), 7, jtree, meta={"loss": 1.5})
    tp = convert.params_from_numpy(p, device="cpu")
    like = (tp, optimizer.init(tp))
    step, got, meta = checkpoint.restore(str(tmp_path), like, device="cpu")
    assert step == 7 and meta == {"loss": 1.5}
    assert isinstance(got[1], optimizer.OptState)
    assert got[1].step.dtype == torch.int32 and int(got[1].step) == 4
    for mine, want in ((got[0], p), (got[1].m, st["m"]),
                       (got[1].v, st["v"])):
        for path, leaf in tree_items(mine):
            node = want
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(leaf.numpy(), node)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    rng = np.random.default_rng(13)
    p, (_, st) = _state(rng)
    tp = convert.params_from_numpy(p, device="cpu")
    tstate = optimizer.OptState(torch.tensor(4, dtype=torch.int32),
                                convert.params_from_numpy(st["m"], "cpu"),
                                convert.params_from_numpy(st["v"], "cpu"))
    d = checkpoint.save(str(tmp_path / "t"), 3, (tp, tstate))
    jlike = (jax.tree.map(jnp.asarray, p), jax_opt.init(
        jax.tree.map(jnp.asarray, p)))
    jax_ckpt.save(str(tmp_path / "j"), 3, jlike)
    step, got, _ = jax_ckpt.restore(str(tmp_path / "t"), jlike)
    assert step == 3 and int(got[1].step) == 4
    for want, mine in ((p, got[0]), (st["m"], got[1].m),
                       (st["v"], got[1].v)):
        flat = _flat(mine)
        for path, leaf in tree_items(want):
            np.testing.assert_array_equal(flat[path], leaf)
    # the manifest's structure is the reference's, string for string
    with open(os.path.join(d, "manifest.json")) as f:
        mine = json.load(f)
    with open(tmp_path / "j" / "step_00000003" / "manifest.json") as f:
        ref = json.load(f)
    for key in ("step", "treedef", "paths", "leaves"):
        assert mine[key] == ref[key], key


_RESTORE_ONTO_MESH = """
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.train import checkpoint
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
like = {"x": torch.zeros(3)}
step, got, _ = checkpoint.restore(sys.argv[1], like,
                                  shardings={"x": (mesh, (Replicate(),))})
assert step == 1 and isinstance(got["x"], DTensor), got
assert got["x"].placements == (Replicate(),)
assert torch.equal(got["x"].to_local(), torch.arange(3.0))
dist.destroy_process_group()
print("RESTORED")
"""


def test_restore_onto_a_mesh_waits_for_sharding(tmp_path):
    """Restoring with ``shardings`` lays each leaf out on the mesh (a
    process of its own: it opens a default process group)."""
    import subprocess
    import sys
    checkpoint.save(str(tmp_path), 1, {"x": torch.arange(3.0)})
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, "-c", _RESTORE_ONTO_MESH,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert "RESTORED" in out.stdout, out.stderr


# ---------------------------------------------------------------------------
# train steps against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-3b", "yi-6b", "mixtral-8x7b"])
def test_make_train_step_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=6)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jstep = jax_trainer.make_train_step(jcfg, jax_opt.OptConfig(**ocfg),
                                        donate=False)
    tstep = make_train_step(cfg, OptConfig(**ocfg), device="cpu")
    js, ts = jax_opt.init(jp), optimizer.init(tp)
    dcfg = jax_data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                               seed=6)
    for s in range(3):
        jb = jax_data.batch_at(dcfg, s)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(np.array(v))
                                    for k, v in jb.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
    want = _flat(jp)
    beyond = total = 0
    for path, leaf in tree_items(tp):
        np.testing.assert_allclose(leaf.numpy(), want[path],
                                   err_msg=str(path), **STEP_TOL)
        beyond += int((np.abs(leaf.numpy() - want[path]) > 1e-7).sum())
        total += leaf.numel()
    assert beyond <= total // 1000, (beyond, total)


# ---------------------------------------------------------------------------
# the port's own versions of tests/test_trainer.py
# ---------------------------------------------------------------------------

def _tc(tmp_path=None, **kw):
    base = dict(steps=30, seq_len=32, global_batch=4,
                opt=OptConfig(lr=3e-3, warmup_steps=5, clip_norm=1.0),
                ckpt_every=10, log_every=100)
    if tmp_path is not None:
        base["ckpt_dir"] = os.path.join(str(tmp_path), "ckpt")
    base.update(kw)
    return TrainConfig(**base)


def test_loss_decreases():
    h = train(TINY, _tc(), device="cpu")
    assert np.mean(h["loss"][-5:]) < np.mean(h["loss"][:5]) - 0.1


def test_checkpoint_resume_bit_exact(tmp_path):
    """Interrupt at 30, resume to 60 == one uninterrupted 60-step run."""
    h_full = train(TINY, _tc(steps=60), device="cpu")

    class Abort(Exception):
        pass

    def hook(s):
        if s == 30:
            raise Abort

    with pytest.raises(Abort):
        train(TINY, _tc(tmp_path, steps=60), fault_hook=hook, device="cpu")
    h_res = train(TINY, _tc(tmp_path, steps=60), device="cpu")
    assert h_res["resumed_at"] == 30
    np.testing.assert_allclose(h_res["loss"], h_full["loss"][30:],
                               rtol=1e-5)
    assert h_res["loss"] == h_full["loss"][30:]      # bitwise on the CPU


def test_kill_and_restore(tmp_path):
    """Injected node failure at step 25 -> restore from 20 and replay."""
    fails = {"armed": True}

    def hook(s):
        if s == 25 and fails["armed"]:
            fails["armed"] = False
            raise NodeFailure("injected")

    h = train(TINY, _tc(tmp_path, steps=40), fault_hook=hook, device="cpu")
    assert h["restarts"] == 1
    assert len(h["loss"]) >= 40 - 20
    h_clean = train(TINY, _tc(steps=40), device="cpu")
    np.testing.assert_allclose(h["loss"][-5:], h_clean["loss"][-5:],
                               rtol=1e-6)


def test_node_failure_without_checkpoints_raises():
    def hook(s):
        raise NodeFailure("injected")
    with pytest.raises(NodeFailure):
        train(TINY, _tc(steps=2), fault_hook=hook, device="cpu")


def test_straggler_watchdog():
    # the induced straggler sleeps 1 s, or 5x the median step the hook has
    # seen (the hook runs at the start of each step) if that is longer, so
    # it stands out however slowly a loaded CPU runs the eager steps
    starts = []

    def hook(s):
        starts.append(time.perf_counter())
        if s == 20:
            time.sleep(max(1.0, 5 * float(np.median(np.diff(starts)))))

    h = train(TINY, _tc(steps=25), fault_hook=hook, device="cpu")
    assert 20 in h["straggler_steps"]


def test_checkpoint_atomic_commit(tmp_path):
    root = str(tmp_path / "c")
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}}
    checkpoint.save(root, 7, tree)
    os.makedirs(os.path.join(root, "step_00000009.tmp"))
    assert checkpoint.latest_step(root) == 7
    step, got, _ = checkpoint.restore(root, tree, device="cpu")
    assert step == 7
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(4.0))


def test_checkpoint_retention(tmp_path):
    root = str(tmp_path / "c")
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(root, s, tree, keep=2)
    assert checkpoint.all_steps(root) == [4, 5]


def test_data_determinism_and_sharding():
    dcfg = data.DataConfig(vocab=97, seq_len=16, global_batch=8)
    b1 = data.batch_at(dcfg, 5, device="cpu")
    b2 = data.batch_at(dcfg, 5, device="cpu")
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert b1["inputs"].dtype == torch.int32
    b3 = data.batch_at(dcfg, 6, device="cpu")
    assert not torch.equal(b1["inputs"], b3["inputs"])
    s0 = data.batch_at(dcfg, 5, shard=0, n_shards=4, device="cpu")
    s1 = data.batch_at(dcfg, 5, shard=1, n_shards=4, device="cpu")
    assert s0["inputs"].shape == (2, 16)
    assert not torch.equal(s0["inputs"], s1["inputs"])
    assert (b1["inputs"] < 97).all() and (b1["inputs"] >= 0).all()
    # labels are the inputs shifted by one.  The Markov repeat (p = 0.5)
    # shifts the previous *base* draw, which the input keeps with p = 0.5,
    # so ~1/4 of labels are their input + 1 (plus Zipf coincidences)
    assert torch.equal(b1["labels"][:, :-1], b1["inputs"][:, 1:])
    big = data.batch_at(data.DataConfig(vocab=97, seq_len=512,
                                        global_batch=8), 0, device="cpu")
    rep = (big["labels"] == (big["inputs"] + 1) % 97).float().mean()
    assert 0.22 < float(rep) < 0.4
    with pytest.raises(ValueError):
        data.batch_at(dcfg, 0, n_shards=3, device="cpu")
    e = data.embedding_batch_at(dcfg, 12, 5, device="cpu")
    assert e["inputs"].shape == (8, 16, 12)
    assert e["inputs"].dtype == torch.bfloat16
    assert torch.equal(e["labels"], data.embedding_batch_at(
        dcfg, 12, 5, device="cpu")["labels"])


def test_optimizer_semantics():
    params = {"w": torch.ones((4,)), "b": torch.zeros((2,))}
    grads = {"w": torch.full((4,), 2.0), "b": torch.ones((2,))}
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=100_000,
                    clip_norm=1e9, weight_decay=0.0)
    st = optimizer.init(params)
    p1, _, m = optimizer.update(
        cfg, grads, st, {k: v.clone() for k, v in params.items()})
    np.testing.assert_allclose(p1["w"].numpy(), 1.0 - 0.1 * np.ones(4),
                               rtol=1e-3)
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(4 * 4 + 2),
                                                  rel=1e-5)
    cfg2 = cfg.replace(clip_norm=0.1)
    p2, _, _ = optimizer.update(
        cfg2, grads, optimizer.init(params),
        {k: v.clone() for k, v in params.items()})
    assert np.all(np.abs(p2["w"].numpy() - 1.0)
                  <= np.abs(p1["w"].numpy() - 1.0) + 1e-7)


def test_update_writes_in_place_in_pieces(monkeypatch):
    # pieces of a leaf give the bits of one pass (elementwise ops)
    rng = np.random.default_rng(14)
    p = {"w": rng.standard_normal(1000).astype(np.float32)}
    g = {"w": rng.standard_normal(1000).astype(np.float32)}
    cfg = OptConfig(lr=1e-2, warmup_steps=0)
    outs = []
    for piece in (1 << 24, 7):
        monkeypatch.setattr(optimizer, "PIECE", piece)
        tp = convert.params_from_numpy(p, device="cpu")
        ptr = tp["w"].data_ptr()
        new, st, _ = optimizer.update(
            cfg, convert.params_from_numpy(g, device="cpu"),
            optimizer.init(tp), tp)
        assert new["w"].data_ptr() == ptr
        outs.append((new["w"], st.m["w"], st.v["w"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    lrs = [float(optimizer.schedule(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


# ---------------------------------------------------------------------------
# the port's own versions of tests/test_extensions.py's compression cases
# ---------------------------------------------------------------------------

def test_compression_roundtrip_small_error():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)) * 1e-3}
    ef = compress.init_state(g)
    deq, ef2 = compress.compress_grads(g, ef)
    assert float((deq["w"] - g["w"]).abs().max()) < 2e-5
    np.testing.assert_allclose((deq["w"] + ef2.residual["w"]).numpy(),
                               g["w"].numpy(), atol=1e-8)


def test_compression_wire_savings():
    wb = compress.wire_bytes({"w": torch.zeros((10000,))})
    assert wb["fp32"] / wb["int8"] > 3.5


def test_compression_convergence_parity():
    cfg = dataclasses.replace(TINY, name="tiny-c")
    tc = TrainConfig(steps=25, seq_len=32, global_batch=4,
                     opt=OptConfig(lr=3e-3, warmup_steps=5))
    base = train(cfg, tc, device="cpu")
    from repro_torch.models import init_model
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_state = optimizer.init(params)
    ef = compress.init_state(params)
    ocfg = tc.opt.replace(total_steps=25)
    losses = []
    for s in range(25):
        batch = data.batch_at(dcfg, s, device="cpu")
        paths, leaves = zip(*((p, x.detach().requires_grad_())
                              for p, x in tree_items(params)))
        loss = loss_fn(tree_from_items(zip(paths, leaves)), cfg, batch)
        grads = tree_from_items(zip(paths, torch.autograd.grad(loss,
                                                               leaves)))
        grads, ef = compress.compress_grads(grads, ef)
        params, opt_state, _ = optimizer.update(ocfg, grads, opt_state,
                                                params)
        losses.append(float(loss.detach()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert abs(np.mean(losses[-5:]) - np.mean(base["loss"][-5:])) < 0.25


# ---------------------------------------------------------------------------
# the package surface and the launcher
# ---------------------------------------------------------------------------

def test_train_exports_the_references_names():
    import repro.train as jax_train
    assert port_train.__all__ == jax_train.__all__
    for name in port_train.__all__:
        assert hasattr(port_train, name), name


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    h = launch_train.main(["--arch", "rwkv6-3b", "--reduced", "--device",
                           "cpu", "--steps", "3", "--seq-len", "16",
                           "--global-batch", "2", "--ckpt-dir",
                           str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b-reduced" in out and "device=cpu" in out
    assert len(h["loss"]) == 3 and all(np.isfinite(h["loss"]))
    assert checkpoint.all_steps(str(tmp_path)) == [2, 3]
    h2 = launch_train.main(["--arch", "rwkv6-3b", "--reduced", "--device",
                            "cpu", "--steps", "4", "--seq-len", "16",
                            "--global-batch", "2", "--ckpt-dir",
                            str(tmp_path)])
    assert h2["resumed_at"] == 3 and len(h2["loss"]) == 1
