"""The port's LM substrate against the JAX package on reduced configs in
float32, with the JAX parameters carried over by
``convert.params_from_numpy``: ``forward`` for every attention impl,
``prefill`` (logits and every leaf of the decode state) and two
``decode_step``s, for yi-6b (dense GQA; ``attn_impl="flash"`` runs the
flash kernel's plain version here), rwkv6-3b (RWKV6; the WKV6 kernel's
plain version), mixtral-8x7b and llama4-scout-17b-a16e (MoE, top-2 with a
sliding window and top-1) and jamba-v0.1-52b (Mamba, attention and MoE;
one 4-layer period, as ``tests/test_arch_smoke.py`` reduces it), plus the
other dense-attention configs and the config registry itself.  Every MoE
layer's routing decisions (the experts of every token) are recorded in
both packages and must be equal; serving runs the MoE configs drop-free
(``capacity_factor = n_experts / top_k``), since capacity drops
legitimately differ between a prefill and the forward over more tokens.

Tolerance: 1e-5 absolute and relative on logits and states.  The two
packages run the same op sequence in f32 and differ only in the summation
order of their matrix products (the reduced models' logits are of order 1
and agree to ~1e-6 measured)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import models as jax_models
from repro.models import moe as jax_moe
from repro_torch import configs
from repro_torch.models import (LM, convert, decode_step, forward,
                                init_model, model_decls, moe, prefill)
from repro_torch.models.layers import P, tree_items

TOL = dict(atol=1e-5, rtol=1e-5)
SERVED = ("yi-6b", "rwkv6-3b")
DENSE = ("stablelm-1.6b", "minitron-8b", "stablelm-12b")
EMBEDDING_INPUTS = ("hubert-xlarge", "pixtral-12b")
ROUTED = ("mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")


def _cfgs(name, drop_free=False, **kw):
    """The JAX and port reduced configs, float32 activations (jamba: one
    4-layer period; ``drop_free``: MoE capacity C = N)."""
    if name == "jamba-v0.1-52b":
        kw = dict(dict(n_layers=4, attn_every=4), **kw)
    out = []
    for reg in (jax_configs, configs):
        cfg = reg.get(name).reduced(dtype="float32", **kw)
        if drop_free:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        out.append(cfg)
    return tuple(out)


@pytest.fixture
def routes(monkeypatch):
    """Every MoE routing decision of both packages, in call order: the
    experts chosen for each token (``{"jax": [...], "port": [...]}``)."""
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


def _assert_same_routes(routes, n_calls):
    assert len(routes["port"]) == len(routes["jax"]) == n_calls
    for i, (got, want) in enumerate(zip(routes["port"], routes["jax"])):
        np.testing.assert_array_equal(got, want, err_msg=f"MoE call {i}")


def _params(jcfg, seed=0):
    jp = jax_models.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _assert_tree_close(got: dict, want, **tol):
    want = jax.tree.map(np.asarray, want)
    flat = dict(tree_items(convert.state_to_numpy(got)))
    wflat = {tuple(k.key for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == wflat.keys()
    for path, leaf in wflat.items():
        assert flat[path].shape == leaf.shape, path
        np.testing.assert_allclose(flat[path], leaf, err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("name", configs.arch_names())
def test_configs_match_jax(name):
    jcfg, cfg = jax_configs.get(name), configs.get(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.block_pattern() == jcfg.block_pattern()
    assert (cfg.padded_vocab, cfg.head_dim, cfg.has_decode,
            cfg.subquadratic) == (jcfg.padded_vocab, jcfg.head_dim,
                                  jcfg.has_decode, jcfg.subquadratic)
    assert configs.supported_shapes(cfg) == \
        jax_configs.supported_shapes(jcfg)
    for seq in (4096, 32_768, 524_288):
        assert configs.decode_cache_len(cfg, seq) == \
            jax_configs.decode_cache_len(jcfg, seq)


def test_shapes_and_cells_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert configs.all_cells() == jax_configs.all_cells()


@pytest.mark.parametrize("name", SERVED + DENSE + EMBEDDING_INPUTS + ROUTED)
def test_parameter_tree_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    want = jax_models.abstract_model(jcfg)
    got = dict(tree_items(model_decls(cfg)))
    wflat = {tuple(k.key for k in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {k: p.shape for k, p in got.items()} == wflat
    assert all(isinstance(p, P) for p in got.values())


def _n_moe(cfg):
    return sum(e["mlp"] == "moe" for e in cfg.block_pattern())


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash", "auto"])
@pytest.mark.parametrize("name", ROUTED)
def test_forward_moe_and_mamba_match_jax(name, impl, routes):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=5)
    toks = _tokens(cfg, 2, 16, seed=5)
    want = jax_models.forward(jp, jcfg, jnp.asarray(toks), attn_impl=impl)
    got = forward(tp, cfg, torch.from_numpy(toks), attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_same_routes(routes, _n_moe(cfg))


@pytest.mark.parametrize("name", ROUTED)
def test_params_carry_over_from_jax(name):
    # MoE experts and router, Mamba projections, conv, a_log, d_skip: the
    # JAX package's init_model leaf for leaf, bit for bit
    jcfg, _ = _cfgs(name)
    jp, tp = _params(jcfg, seed=6)
    want = {tuple(k.key for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(tree_items(tp))
    assert got.keys() == want.keys()
    leaves = {path[-1] for path in got}
    assert "router" in leaves
    assert ("a_log" in leaves) == (name == "jamba-v0.1-52b")
    for path, leaf in want.items():
        assert got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), leaf,
                                      err_msg=str(path))


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash", "auto"])
def test_forward_dense_matches_jax(impl):
    jcfg, cfg = _cfgs("yi-6b")
    jp, tp = _params(jcfg)
    toks = _tokens(cfg, 2, 16)
    want = jax_models.forward(jp, jcfg, jnp.asarray(toks), attn_impl=impl)
    got = forward(tp, cfg, torch.from_numpy(toks), attn_impl=impl)
    assert got.shape == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", DENSE + ("rwkv6-3b",))
def test_forward_matches_jax(name):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=1)
    toks = _tokens(cfg, 2, 16, seed=1)
    want = jax_models.forward(jp, jcfg, jnp.asarray(toks))
    got = forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", EMBEDDING_INPUTS)
def test_forward_embedding_inputs_match_jax(name):
    # frontend stubs: (B, S, d_model) embeddings in, hubert non-causal
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=2)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)) \
        .astype(np.float32)
    want = jax_models.forward(jp, jcfg, jnp.asarray(x))
    got = forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _serve(name, attn_impl, B=2, S=12, DEC=2, drop_free=False, **kw):
    """Prefill S tokens, then DEC decode steps, in both packages: logits
    and every leaf of the decode state compared after each."""
    jcfg, cfg = _cfgs(name, drop_free=drop_free, **kw)
    jp, tp = _params(jcfg, seed=3)
    toks = _tokens(cfg, B, S + DEC, seed=3)
    cache_len = configs.decode_cache_len(cfg, S + DEC)
    jlg, jst = jax_models.prefill(jp, jcfg, jnp.asarray(toks[:, :S]),
                                  cache_len, attn_impl=attn_impl)
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :S]), cache_len,
                     attn_impl=attn_impl)
    assert lg.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_tree_close(st, jst, **TOL)
    for t in range(S, S + DEC):
        jlg, jst = jax_models.decode_step(jp, jcfg, jnp.asarray(toks[:, t]),
                                          jst, t)
        lg, st = decode_step(tp, cfg, torch.from_numpy(toks[:, t]), st, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _assert_tree_close(st, jst, **TOL)
    # and the decode logits are the full forward's at each position
    full = forward(tp, cfg, torch.from_numpy(toks), attn_impl="dense")
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_serve_dense_matches_jax(impl):
    _serve("yi-6b", impl)


def test_serve_rwkv_matches_jax():
    _serve("rwkv6-3b", "auto")


@pytest.mark.parametrize("name", ROUTED)
def test_serve_moe_and_mamba_match_jax(name, routes):
    # drop-free, so the decode logits are the full forward's; the decode
    # state's Mamba leaves (h, conv) and KV caches leaf for leaf
    _serve(name, "flash", drop_free=True)
    jcfg, cfg = _cfgs(name, drop_free=True)
    # prefill and two steps in each package, then the port's forward
    n = _n_moe(cfg)
    assert len(routes["port"]) == 4 * n and len(routes["jax"]) == 3 * n
    routes["port"] = routes["port"][:3 * n]
    _assert_same_routes(routes, 3 * n)


def test_serve_sliding_window_ring_buffer_matches_jax():
    # a cache shorter than the prompt: prefill keeps the last `window`
    # positions ring-addressed and decode continues over them
    _serve("yi-6b", "flash", S=12, DEC=3, window=8)


def test_lm_module_matches_the_functions():
    jcfg, cfg = _cfgs("rwkv6-3b")
    _, tp = _params(jcfg, seed=4)
    lm = LM(cfg, tp)
    assert all(not p.requires_grad for p in lm.parameters())
    assert sum(p.numel() for p in lm.parameters()) == \
        sum(x.numel() for _, x in tree_items(tp))
    toks = torch.from_numpy(_tokens(cfg, 2, 9, seed=4))
    torch.testing.assert_close(lm(toks), forward(tp, cfg, toks), rtol=0,
                               atol=0)
    lg, st = lm.prefill(toks[:, :8], 9)
    lg2, st2 = prefill(tp, cfg, toks[:, :8], 9)
    torch.testing.assert_close(lg, lg2, rtol=0, atol=0)
    lg, _ = lm.decode_step(toks[:, 8], st, 8)
    lg2, _ = decode_step(tp, cfg, toks[:, 8], st2, 8)
    torch.testing.assert_close(lg, lg2, rtol=0, atol=0)


@pytest.mark.parametrize("name", SERVED + ROUTED)
def test_init_model_draws_the_declared_distributions(name):
    # the port draws its own numbers (torch.Generator, not jax.random), from
    # the JAX package's distributions: zeros, ones, 0.02 N(0,1) and
    # 0.02/sqrt(2) N(0,1) for the output projections
    _, cfg = _cfgs(name, d_model=128, d_ff=256)
    tp = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    decls = dict(tree_items(model_decls(cfg)))
    for path, x in tree_items(tp):
        p = decls[path]
        assert tuple(x.shape) == p.shape and x.dtype == torch.float32
        if p.init == "zeros":
            assert not x.any()
        elif p.init == "ones":
            assert bool((x == 1).all())
        elif p.init == "arange_log":
            row = torch.log(torch.arange(1, p.shape[-1] + 1,
                                         dtype=torch.float32))
            assert torch.equal(x, row.expand(p.shape))
        elif x.numel() >= 4096:
            want = 0.02 if p.init == "normal" else 0.02 / np.sqrt(2.0)
            assert abs(float(x.std()) / want - 1) < 0.1, path
    again = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, again_leaf) for (_, a), (_, again_leaf)
               in zip(tree_items(tp), tree_items(again)))


def test_state_allocators_default_to_the_card():
    # every function that allocates a model, its parameters or a decode
    # state puts it on the card unless the caller names another device
    import inspect
    from repro_torch.models import attention, model, ssm, stacks
    for fn in (model.init_model, model.init_decode_state, convert
               .params_from_numpy, stacks.init_stack_state,
               attention.init_kv_cache, ssm.init_mamba_state,
               ssm.init_rwkv_state, LM.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
