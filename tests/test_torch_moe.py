"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU, float32, with the JAX parameters
carried over by ``convert.params_from_numpy``: the router (gates at 1e-5,
experts exact, ties broken toward the lower index as ``jax.lax.top_k``
does), the capacity (the reference's integer arithmetic, also read off the
reference's output), the sort-based dispatch with dropped assignments (the
``keep`` sets exact, the output at 1e-5) and the dense oracle, top-1
(llama4-scout) and top-2 (mixtral, jamba).

Tolerance: 1e-5 absolute and relative, as the model tests: the packages
differ only in the summation order of their products."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import moe as jax_moe
from repro_torch import configs
from repro_torch.models import convert, moe

TOL = dict(atol=1e-5, rtol=1e-5)
# (config, top_k): mixtral and jamba route to 2 experts, llama4-scout to 1
ROUTED = [("mixtral-8x7b", 2), ("jamba-v0.1-52b", 2),
          ("llama4-scout-17b-a16e", 1)]


def _cfgs(name, **moe_kw):
    """The JAX and port reduced configs (f32), MoE spec fields replaced."""
    out = []
    for reg in (jax_configs, configs):
        cfg = reg.get(name).reduced(dtype="float32", d_model=32, d_ff=48)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _params(jcfg, seed):
    jp = jax_moe.moe_decls(jcfg)
    rng = np.random.default_rng(seed)
    jp = {k: (0.3 * rng.standard_normal(p.shape)).astype(np.float32)
          for k, p in jp.items()}
    return ({k: jnp.asarray(v) for k, v in jp.items()},
            convert.params_from_numpy(jp, device="cpu"))


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)


def _jax_keep(jp, x, jcfg):
    """The reference's ``keep`` flags over its sorted assignments
    (``repro/models/moe.py:97-118``, one dispatch group), with its order."""
    B, S, D = x.shape
    E, k = jcfg.moe.n_experts, jcfg.moe.top_k
    N = B * S
    _, idx = jax_moe._route(jp, jnp.asarray(x).reshape(N, D), jcfg)
    C = int(jcfg.moe.capacity_factor * N * k / E + 0.999)
    C = max(8, -(-C // 8) * 8)
    C = min(C, N)
    flat_e = idx.reshape(1, N * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    counts = jnp.sum(jax.nn.one_hot(sorted_e, E, dtype=jnp.int32), axis=1)
    start = jnp.cumsum(counts, axis=1) - counts
    rank = (jnp.arange(N * k)[None, :]
            - jnp.take_along_axis(start, sorted_e, axis=1))
    return np.asarray(order), np.asarray(rank < C), C


@pytest.mark.parametrize("name,top_k", ROUTED)
def test_route_matches_jax(name, top_k):
    jcfg, cfg = _cfgs(name)
    assert cfg.moe.top_k == top_k
    jp, tp = _params(jcfg, seed=1)
    x = _x(1, 64, cfg.d_model, seed=1)[0]
    jg, ji = jax_moe._route(jp, jnp.asarray(x), jcfg)
    g, i = moe._route(tp, torch.from_numpy(x), cfg)
    assert g.dtype == torch.float32 and i.shape == (64, top_k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("name,top_k", ROUTED)
def test_route_breaks_ties_toward_the_lower_index(name, top_k):
    # experts 1 and 3 (and 0 and 2) share router columns, so their
    # probabilities tie exactly: jax.lax.top_k keeps the lower index first
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=2)
    r = np.asarray(jp["router"]).copy()
    r[:, 3] = r[:, 1]
    r[:, 2] = r[:, 0]
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r))
    x = _x(1, 32, cfg.d_model, seed=2)[0]
    jg, ji = jax_moe._route(jp, jnp.asarray(x), jcfg)
    g, i = moe._route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    if top_k == 2:
        # tokens whose top two are a tied pair: the pair in index order
        tied = np.isin(i.numpy()[:, 0], (0, 1)) & \
            (i.numpy()[:, 1] == i.numpy()[:, 0] + 2)
        assert tied.any()
    assert not np.isin(i.numpy()[:, 0], (2, 3)).any()


def test_capacity_is_the_references_arithmetic():
    # repro/models/moe.py:105-107, float arithmetic in the same order, over
    # a sweep of (N, E, k, cf)
    for N in (1, 7, 8, 16, 37, 64, 100, 2048, 4096, 8192, 8224, 16384):
        for E, k in ((4, 1), (4, 2), (8, 2), (16, 1), (16, 2)):
            for cf in (0.5, 1.0, 1.25, 2.0, E / k, 8.0):
                want = int(cf * N * k / E + 0.999)
                want = min(max(8, -(-want // 8) * 8), N)
                _, cfg = _cfgs("mixtral-8x7b", n_experts=E, top_k=k,
                               capacity_factor=cf)
                assert moe.capacity(cfg, N) == want, (N, E, k, cf)
                if cf == E / k:
                    assert want == N          # drop-free


@pytest.mark.parametrize("N,E,k,cf", [(20, 4, 1, 1.25), (40, 4, 2, 1.25),
                                      (64, 8, 2, 1.0), (33, 4, 2, 0.5)])
def test_capacity_matches_the_references_output(N, E, k, cf):
    # every token's top expert is expert 0 (and its second expert 1): the
    # reference keeps exactly the first C tokens, the rest get zeros
    jcfg, cfg = _cfgs("mixtral-8x7b", n_experts=E, top_k=k,
                      capacity_factor=cf)
    jp, _ = _params(jcfg, seed=3)
    r = np.zeros((cfg.d_model, E), np.float32)
    r[0, 0], r[0, 1] = 4.0, 2.0
    x = np.abs(_x(1, N, cfg.d_model, seed=3)) + 1.0
    out = np.asarray(jax_moe.apply_moe(dict(jp, router=jnp.asarray(r)),
                                       jnp.asarray(x), jcfg))[0]
    kept = np.abs(out).sum(axis=-1) > 0
    C = moe.capacity(cfg, N)
    assert kept.tolist() == [True] * C + [False] * (N - C)


@pytest.mark.parametrize("name,top_k", ROUTED)
def test_apply_moe_with_drops_matches_jax(name, top_k):
    jcfg, cfg = _cfgs(name, capacity_factor=1.25)
    jp, tp = _params(jcfg, seed=4)
    x = _x(2, 48, cfg.d_model, seed=4)
    # skew the router so that expert 0 overflows its capacity
    x[..., 0] = 3.0
    r = np.asarray(jp["router"]).copy()
    r[0, 0] += 1.0
    jp, tp = dict(jp, router=jnp.asarray(r)), dict(tp,
                                                  router=torch.from_numpy(r))
    want = np.asarray(jax_moe.apply_moe(jp, jnp.asarray(x), jcfg))
    got = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the keep sets, exactly, over the same sorted order
    jorder, jkeep, jC = _jax_keep(jp, x, jcfg)
    N = x.shape[0] * x.shape[1]
    _, idx = moe._route(tp, torch.from_numpy(x).reshape(N, -1), cfg)
    C = moe.capacity(cfg, N)
    order, tok, keep, slot = moe._dispatch(idx.reshape(1, N, top_k),
                                           cfg.moe.n_experts, C)
    assert C == jC
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert not keep.all(), "the case must drop assignments"
    assert bool((slot[~keep] == cfg.moe.n_experts * C).all())
    # a dropped assignment contributes nothing: with no expert kept, zeros
    dropped_tokens = set(tok[~keep].tolist()) - set(tok[keep].tolist())
    for t in dropped_tokens:
        assert not got.reshape(N, -1)[t].any()


@pytest.mark.parametrize("name,top_k", ROUTED)
def test_apply_moe_dense_matches_jax(name, top_k):
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=5)
    x = _x(2, 24, cfg.d_model, seed=5)
    want = np.asarray(jax_moe.apply_moe_dense(jp, jnp.asarray(x), jcfg))
    got = moe.apply_moe_dense(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name,top_k", ROUTED)
def test_apply_moe_drop_free_is_the_dense_oracle(name, top_k):
    # capacity_factor = n_experts / top_k makes C = N: nothing is dropped
    # and the dispatch computes the dense oracle's function
    E = configs.get(name).reduced().moe.n_experts
    jcfg, cfg = _cfgs(name, capacity_factor=E / top_k)
    _, tp = _params(jcfg, seed=6)
    x = torch.from_numpy(_x(2, 40, cfg.d_model, seed=6))
    assert moe.capacity(cfg, 80) == 80
    torch.testing.assert_close(moe.apply_moe(tp, x, cfg),
                               moe.apply_moe_dense(tp, x, cfg), **TOL)


def test_expert_ffn_matches_jax():
    jcfg, cfg = _cfgs("mixtral-8x7b")
    jp, tp = _params(jcfg, seed=7)
    xg = np.random.default_rng(7).standard_normal(
        (cfg.moe.n_experts, 8, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax_moe._expert_ffn(jp, jnp.asarray(xg), jcfg))
    got = moe._expert_ffn(tp, torch.from_numpy(xg), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    grouped = moe._expert_ffn_grouped(tp, torch.from_numpy(xg)[None], cfg)
    torch.testing.assert_close(grouped[0], got, rtol=0, atol=0)


def test_moe_decls_match_jax():
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    want = jax_moe.moe_decls(jcfg)
    got = moe.moe_decls(cfg)
    assert {k: tuple(p) for k, p in got.items()} == \
        {k: tuple(p) for k, p in want.items()}


def test_c12_routing_rule():
    """``chip_smoke.compare_routes``, the routing rule of phases 16 and 17
    (ROADMAP C12), on constructed decisions: 2 prompts of 4 tokens, top-2
    over 4 experts, two MoE layers."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    tie = chip_smoke.ROUTE_NEAR_TIE
    idx = np.array([[0, 1], [1, 2], [2, 3], [3, 0]] * 2)
    keep = np.ones((8, 2), bool)
    margin = np.full(8, 0.5, np.float32)

    def layer(i=idx, k=keep, m=margin):
        return (i.copy(), k.copy(), m.copy())

    same = chip_smoke.compare_routes([layer(), layer()], [layer(), layer()],
                                     4)
    assert (same["flips"], same["moved"], same["left_out"]) == (0, 0, set())
    assert same["margin"] == 0.5
    # a near-tie flip in prompt 1 (token 5) leaves prompt 1 out; its later
    # differences are counted, not judged; a keep it moved in prompt 0
    # leaves prompt 0 out too
    m_tie = margin.copy()
    m_tie[5] = tie / 2
    flipped = idx.copy()
    flipped[5] = [2, 1]
    moved = keep.copy()
    moved[2, 1] = False
    later = idx.copy()
    later[6] = [1, 0]
    r = chip_smoke.compare_routes(
        [layer(flipped, moved), layer(later)],
        [layer(m=m_tie), layer()], 4)
    assert (r["flips"], r["moved"], r["downstream"]) == (1, 1, 1)
    assert r["left_out"] == {0, 1}
    assert r["margin"] == float(np.float32(tie / 2))
    # a flip whose plain-path margin is not a near-tie fails
    with pytest.raises(AssertionError, match="near-tie"):
        chip_smoke.compare_routes([layer(flipped)], [layer()], 4)
    # keep cannot move while every token's experts agree
    with pytest.raises(AssertionError, match="keep differs"):
        chip_smoke.compare_routes([layer(k=moved)], [layer()], 4)
    # at most ROUTE_MAX_FLIPS near-tie flips in the compared prompts
    n = chip_smoke.ROUTE_MAX_FLIPS + 1
    many = np.tile(idx, (n, 1))
    m_many = np.full(len(many), tie / 2, np.float32)
    many_flipped = many.copy()
    many_flipped[:n] = many[:n, ::-1]
    assert (many_flipped != many).any(axis=1).sum() == n
    with pytest.raises(AssertionError, match="near-tie flips"):
        chip_smoke.compare_routes(
            [layer(many_flipped, np.ones_like(many, bool))],
            [layer(many, np.ones_like(many, bool), m_many)], 4)
    # the logits comparison needs a prompt left in
    assert chip_smoke.kept_prompts(r, 3) == [2]
    with pytest.raises(AssertionError, match="left all 2 prompts out"):
        chip_smoke.kept_prompts(r, 2)
