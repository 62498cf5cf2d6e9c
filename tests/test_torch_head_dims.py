"""The families whose head dims the other CPU tests never reach, at their
published head dims, against the JAX package: reduced configs keep the
head dim of the full config (``reduced(d_model=320, n_heads=2)`` gives
stablelm-12b's and pixtral-12b's 160, ``reduced(d_model=160, n_heads=2)``
hubert-xlarge's 80, and so on), where ``reduced()`` alone gives 16.

* flash attention at head dims 160 (causal GQA, with and without a
  window, and a ragged S < T case) and 80 (non-causal): the port's plain
  version, which the CUDA kernel is held against on the card, against the
  Pallas kernel in interpret mode, at the tolerances of
  ``tests/test_torch_flash_attention.py`` (float32 2e-6; bfloat16 within
  2 bf16 ulps of the Pallas result plus 1e-5);
* the wrapper's head-dim limit: 160 is the kernel's largest instantiation
  and passes its check, a larger head dim raises a message naming 160;
* serving (a prefill, then two decode steps, logits and every leaf of the
  decode state at 1e-5, as ``tests/test_torch_models.py``) under
  ``attn_impl="flash"`` and ``"dense"`` for stablelm-1.6b, minitron-8b,
  stablelm-12b, pixtral-12b (prefill from embeddings, decode from tokens)
  and llama4-scout-17b-a16e (routes recorded in both packages and equal);
* hubert-xlarge's ``forward`` (non-causal, from frame embeddings) under
  both impls.

Under ``"flash"`` the JAX package runs its Pallas kernel in interpret mode
and the port the kernel's plain version."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch import configs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import decode_step, forward, init_model, prefill
from repro_torch.models.layers import embed_tokens, tree_map
from test_torch_flash_attention import DTYPES, _inputs, _np
from test_torch_models import (TOL, _assert_same_routes, _assert_tree_close,
                               _cfgs, _n_moe, _tokens, routes)

FA_SHAPES = [
    # (B, S, T, Hq, Hkv, Dh, causal, window)
    (1, 64, 64, 2, 1, 160, True, None),       # stablelm-12b / pixtral: GQA
    (1, 64, 64, 4, 2, 160, True, 24),         # the same with a window
    (1, 40, 72, 2, 1, 160, False, None),      # ragged, S < T
    (1, 64, 64, 2, 2, 80, False, None),       # hubert: non-causal MHA
    (1, 64, 64, 5, 1, 128, True, None),       # llama4-scout's odd group 5
]
# reduced widths that keep each family's published head dim; n_kv_heads
# keeps stablelm-1.6b's and hubert's MHA (reduced() would give 2/1)
WIDTHS = {
    "stablelm-1.6b": dict(d_model=128, n_heads=2, n_kv_heads=2),   # 64
    "minitron-8b": dict(d_model=256, n_heads=2),                   # 128
    "stablelm-12b": dict(d_model=320, n_heads=2),                  # 160
    "pixtral-12b": dict(d_model=320, n_heads=2),                   # 160
    "hubert-xlarge": dict(d_model=160, n_heads=2, n_kv_heads=2),   # 80
    "llama4-scout-17b-a16e": dict(d_model=256, n_heads=2),         # 128
}


def test_widths_keep_the_published_head_dims():
    for name, kw in WIDTHS.items():
        jcfg, cfg = _cfgs(name, **kw)
        assert cfg.head_dim == jcfg.head_dim == configs.get(name).head_dim
        full = configs.get(name)
        assert (cfg.n_kv_heads == cfg.n_heads) == \
            (full.n_kv_heads == full.n_heads), name


def test_smoke_checks_flash_at_every_served_shape():
    """``chip_smoke.py`` holds flash to its plain version on the card, in
    float32 and bfloat16, at every prefill shape a serve phase launches it
    at, and times it in one serve phase per (head dim, mask, GQA group)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    checked = {c[:8]: set(c[8]) for c in chip_smoke.FA_CHECK_SHAPES}
    served = chip_smoke.served_flash_shapes()
    assert len(served) == len(chip_smoke.SERVE) - 1      # all but rwkv6-3b
    for name, shape in served.items():
        assert checked.get(shape) == {"float32", "bfloat16"}, (name, shape)
    key = lambda n: chip_smoke.flash_key(chip_smoke.serve_config(n)[0])  # noqa
    timed = chip_smoke.flash_timed()
    assert sorted(map(key, timed), key=str) == \
        sorted({key(n) for n in served}, key=str)
    assert "llama4-scout-17b-a16e" in timed      # the one odd group (5)


@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas_interpret(shape, dtype):
    *_, causal, window = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    want = _np(jax_flash(jq, jk, jv, causal=causal, window=window,
                         block_q=64, block_k=32, interpret=True))
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                block_q=64, block_k=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=2e-6, rtol=2e-6)
    else:
        want = torch.from_numpy(want)
        diff = (got.float() - want).abs()
        tol = 2 * fa_kernel.bf16_ulp(want) + 1e-5
        assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.parametrize("Dh", [8, 80, 128, 160])
def test_wrapper_check_takes_head_dims_up_to_160(Dh):
    # the check that runs before a launch: the parent refused 160
    q = torch.zeros((1, 8, 4, Dh), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, Dh), dtype=torch.bfloat16)
    fa_kernel._check(q, k, k, None)


@pytest.mark.parametrize("Dh", [168, 256])
def test_wrapper_check_refuses_head_dims_above_160(Dh):
    assert fa_kernel.MAX_HEAD_DIM == 160
    q = torch.zeros((1, 8, 4, Dh))
    k = torch.zeros((1, 8, 2, Dh))
    with pytest.raises(ValueError, match=r"head_dim \d+ outside the "
                                         r"kernel's 1 \.\. 160"):
        fa_kernel._check(q, k, k, None)


def _params(cfg, seed):
    """Seeded parameters drawn by the port, and the same numbers as the
    JAX package's tree (its ``init_model`` compiles anew for every config,
    which costs seconds a family here)."""
    tp = init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


def _serve(name, impl, *, embeddings=False, B=2, S=12, DEC=2):
    """A prefill of S positions (seeded tokens, or with ``embeddings``
    seeded (B, S, d_model) embeddings), then DEC decode steps from tokens,
    in both packages: logits and every leaf of the decode state after
    each; then the decode logits against the port's forward over the
    prompt followed by the decoded tokens (drop-free MoE, so capacity
    drops cannot differ between the two)."""
    moe = configs.get(name).moe is not None
    jcfg, cfg = _cfgs(name, drop_free=moe, **WIDTHS[name])
    jp, tp = _params(cfg, seed=3)
    toks = _tokens(cfg, B, S + DEC, seed=3)
    if embeddings:
        prompt = np.random.default_rng(3).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        prompt = toks[:, :S]
    cache_len = configs.decode_cache_len(cfg, S + DEC)
    # the JAX package's functions compiled once a test (eagerly, every call
    # traces and compiles the layer scan anew, ~0.5 s here); new functions
    # each test, so that no trace outlives the routes fixture's recorder
    _jax_prefill = jax.jit(lambda *a: jax_models.prefill(*a, attn_impl=impl),
                           static_argnums=(1, 3))
    _jax_decode = jax.jit(lambda *a: jax_models.decode_step(*a),
                          static_argnums=(1,))
    jlg, jst = _jax_prefill(jp, jcfg, jnp.asarray(prompt), cache_len)
    lg, st = prefill(tp, cfg, torch.from_numpy(prompt), cache_len,
                     attn_impl=impl)
    assert lg.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _assert_tree_close(st, jst, **TOL)
    logits = []
    for t in range(S, S + DEC):
        jlg, jst = _jax_decode(jp, jcfg, jnp.asarray(toks[:, t]), jst, t)
        lg, st = decode_step(tp, cfg, torch.from_numpy(toks[:, t]), st, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _assert_tree_close(st, jst, **TOL)
        logits.append(lg)
    seq = torch.from_numpy(toks)
    if embeddings:
        seq = torch.cat([torch.from_numpy(prompt),
                         embed_tokens(tp["embed"], seq[:, S:], cfg)], dim=1)
    full = forward(tp, cfg, seq, attn_impl="dense")
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(lg.numpy(), full[:, S + i].numpy(), **TOL)
    return cfg


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "minitron-8b",
                                  "stablelm-12b"])
def test_serve_dense_families_match_jax(name, impl):
    _serve(name, impl)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_serve_pixtral_from_embeddings_matches_jax(impl):
    # the prefill takes (B, S, d_model) patch embeddings, the decode steps
    # take tokens
    _serve("pixtral-12b", impl, embeddings=True)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_serve_llama4_scout_matches_jax(impl, routes):
    # top-1 of 16 experts: every routing decision of the prefill and the
    # two steps equal in both packages (the port's forward routes too)
    cfg = _serve("llama4-scout-17b-a16e", impl)
    n = _n_moe(cfg)
    assert len(routes["port"]) == 4 * n and len(routes["jax"]) == 3 * n
    routes["port"] = routes["port"][:3 * n]
    _assert_same_routes(routes, 3 * n)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_hubert_forward_at_head_dim_80_matches_jax(impl):
    # an encoder: non-causal attention over frame embeddings, no decode
    jcfg, cfg = _cfgs("hubert-xlarge", **WIDTHS["hubert-xlarge"])
    assert not cfg.causal and not cfg.has_decode
    jp, tp = _params(cfg, seed=2)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)) \
        .astype(np.float32)
    want = jax_models.forward(jp, jcfg, jnp.asarray(x), attn_impl=impl)
    got = forward(tp, cfg, torch.from_numpy(x), attn_impl=impl)
    assert got.shape == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
