"""The port's flash attention (its plain PyTorch version, which the CUDA
kernel is held against on the card) against the JAX package: the Pallas
kernel in interpret mode and its oracle ``attention_ref``, on the kernel
tests' shapes, seeded with numpy.

Tolerances are those of ``tests/test_kernels.py`` for the Pallas kernel
against its oracle: 2e-6 in float32 (summation order of the two products
and the row sums) and 2e-2 in bfloat16 (the output's rounding to bf16, a
few units in the last place of values of order 1).  The bf16 result is
also held in ulps: within 2 bf16 ulps of the Pallas kernel's plus 1e-5,
the unit the CUDA kernel is held to on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import ArchConfig as JaxArchConfig
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import flash_attention_plain, ops
from repro_torch.kernels.flash_attention.kernel import bf16_ulp
from repro_torch.models import ArchConfig, attention

FA_SHAPES = [
    # (B, S, T, Hq, Hkv, Dh, causal, window) — tests/test_kernels.py
    (2, 128, 128, 4, 2, 32, True, None),       # GQA causal
    (1, 256, 256, 8, 8, 16, True, 64),         # MHA sliding window
    (2, 64, 64, 4, 1, 32, False, None),        # encoder (MQA)
    (1, 128, 128, 2, 2, 64, True, None),       # head_dim 64
    (1, 96, 96, 2, 1, 8, True, 32),            # non-pow2 seq
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, dtype, seed=0):
    B, S, T, Hq, Hkv, Dh, _, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, Hq, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh)))
    jdt, tdt, _ = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_pallas_interpret(shape, dtype):
    *_, causal, window = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64,
                     block_k=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              block_q=64, block_k=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_bf16_within_ulps_of_pallas(shape):
    # both round the same f32 recurrence to bf16 once, at the output: the
    # summation order of the products and row sums moves a value across a
    # rounding boundary by at most an ulp, and near zero by a few 1e-8
    *_, causal, window = shape
    for seed in (0, 1, 2):
        (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "bfloat16", seed=seed)
        want = torch.from_numpy(_np(jax_flash(
            jq, jk, jv, causal=causal, window=window, block_q=64,
            block_k=32, interpret=True)))
        got = flash_attention_plain(tq, tk, tv, causal=causal,
                                    window=window, block_q=64, block_k=32)
        assert got.dtype == torch.bfloat16
        diff = (got.float() - want).abs()
        assert bool((diff <= 2 * bf16_ulp(want) + 1e-5).all()), \
            float((diff / (2 * bf16_ulp(want) + 1e-5)).max())


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, -0.75, 2.0 ** -20, 0.0, 3.0e4])
    want = [2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -27, 0.0, 2.0 ** 7]
    assert bf16_ulp(x).tolist() == want
    # a bf16 value plus one ulp is the next bf16 value up
    b = torch.tensor([1.0, 0.3, 7.0], dtype=torch.bfloat16)
    up = (b.float() + bf16_ulp(b)).to(torch.bfloat16)
    assert torch.equal(up, torch.nextafter(b, torch.full_like(b, 1e9)))


@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_attention_ref(shape, dtype):
    *_, causal, window = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=1)
    tr = lambda x: x.transpose(0, 2, 1, 3)                    # noqa: E731
    want = attention_ref(tr(jq), tr(jk), tr(jv), causal=causal,
                         window=window).transpose(0, 2, 1, 3)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", [(8, 8), (16, 32), (32, 16), (96, 96)])
def test_flash_result_does_not_depend_on_blocks(blocks):
    # the kernel tiles by 64 whatever the wrapper's blocks: a row that a
    # live block masks entirely adds exp(0) terms (scores -1e30, m from
    # -inf) which its first real score wipes out through corr, so the
    # result depends on the blocks only through summation order (f32:
    # 2e-6, as above)
    shape = (1, 96, 96, 4, 2, 16, True, 24)
    _, (tq, tk, tv) = _inputs(shape, "float32", seed=2)
    ref = flash_attention_plain(tq, tk, tv, causal=True, window=24,
                                block_q=32, block_k=32)
    got = flash_attention_plain(tq, tk, tv, causal=True, window=24,
                                block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-6, rtol=2e-6)


def test_flash_plain_skips_dead_blocks_and_keeps_masked_rows():
    # the live-block rule: with a window of 8 and 8-wide blocks, q-block 3
    # sees only kv-blocks 2 and 3; kv-block 2 is live for row 24 (keys 17
    # .. 23) but masks every entry of row 31 (its window starts at 24), so
    # row 31 takes exp(0) terms there until kv-block 3 wipes them out
    from repro_torch.kernels.flash_attention.kernel import live_block
    live = [ki for ki in range(4) if live_block(24, 8 * ki, 8, 8, True, 8)]
    assert live == [2, 3]
    assert not live_block(0, 8, 8, 8, True, None)      # above the diagonal
    assert live_block(0, 8, 8, 8, False, None)         # encoder: all live


def test_model_attention_impls_match_jax():
    """dense, chunked and flash inside the model agree with each other and
    with the JAX package's sdpa and chunked_sdpa (f32)."""
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=16, window=48)
    cfg, jcfg = ArchConfig(**kw), JaxArchConfig(**kw)
    B, S, Dh = 2, 128, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, 4, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, Dh)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pos, jpos = torch.arange(S), jnp.arange(S)
    dense = attention.sdpa(cfg, tq, tk, tv,
                           attention._gqa_scores_mask(cfg, pos, pos))
    chunked = attention.chunked_sdpa(cfg, tq, tk, tv, block_q=32,
                                     block_k=32)
    flash = ops.flash_attention(tq, tk, tv, causal=True, window=48,
                                block_q=32, block_k=32)
    jdense = jax_attention.sdpa(jcfg, jq, jk, jv,
                                jax_attention._gqa_scores_mask(jcfg, jpos,
                                                               jpos))
    jchunked = jax_attention.chunked_sdpa(jcfg, jq, jk, jv, block_q=32,
                                          block_k=32)
    # 1e-5: the tolerance of tests/test_kernels.py for the three JAX impls
    for got in (dense, chunked, flash):
        np.testing.assert_allclose(_np(got), _np(jdense), atol=1e-5)
    np.testing.assert_allclose(_np(chunked), _np(jchunked), atol=1e-5)
