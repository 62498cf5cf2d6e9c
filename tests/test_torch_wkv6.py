"""The port's WKV6 recurrence (its plain PyTorch version, which the CUDA
kernel is held against on the card) against the JAX package, seeded with
numpy: ``ops.wkv6`` against the oracle ``wkv6_ref`` on the kernel tests'
shapes, and the model's ``ssm._wkv_scan`` with a non-zero initial state
against the JAX ``ssm._wkv_scan``, output and final state.  Not against the
Pallas kernel, which no longer traces under jax 0.9 (ROADMAP C1).

Tolerances: ``tests/test_kernels.py``'s for WKV6 (1e-4 in float32 for the
summation order of the hs-term dot products over T steps, 5e-2 in bfloat16
for the output's rounding), and 1e-5 for ``_wkv_scan``, whose f32 output
keeps no bf16 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import wkv6_ref
from repro.models import ssm as jax_ssm
from repro_torch.kernels.rwkv6 import ops, wkv6_scan_plain
from repro_torch.models import ssm

WKV_SHAPES = [
    # (B, H, T, hs) — tests/test_kernels.py (its block_t dropped)
    (2, 3, 96, 16),
    (1, 2, 64, 8),
    (2, 1, 40, 4),
    (1, 4, 128, 32),
]


def _inputs(B, H, T, hs, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, hs)))) * 0.5
         + 0.45).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hs))).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_ref(shape, dtype):
    B, H, T, hs = shape
    r, k, v, w, u, _ = _inputs(B, H, T, hs, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tr = lambda x: jnp.asarray(x, jdt).transpose(0, 2, 1, 3)  # noqa: E731
    want = wkv6_ref(tr(r), tr(k), tr(v), tr(w), jnp.asarray(u, jdt)) \
        .transpose(0, 2, 1, 3)
    got = ops.wkv6(*(torch.from_numpy(a).to(tdt) for a in (r, k, v, w, u)))
    assert got.dtype == tdt and got.shape == (B, T, H, hs)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("T", [1, 40, 512])
def test_wkv_scan_with_state_matches_jax(T):
    # T = 1 is a decode step; T = 512 takes the JAX scan's chunked path
    B, H, hs = 2, 3, 16
    r, k, v, w, u, s0 = _inputs(B, H, T, hs, seed=T)
    s_want, y_want = jax_ssm._wkv_scan(
        {"u": jnp.asarray(u)}, *(jnp.asarray(a) for a in (r, k, v, w, s0)))
    s_got, y_got = ssm._wkv_scan(
        {"u": torch.from_numpy(u)}, *(torch.from_numpy(a)
                                      for a in (r, k, v, w, s0)))
    assert y_got.dtype == torch.float32 and s_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want),
                               atol=1e-5, rtol=1e-5)


def test_wkv6_scan_resumes_from_its_state():
    # prefill then decode: two calls carrying the state equal one call,
    # bit for bit (the same op sequence, step by step)
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _inputs(1, 2, 24, 8, seed=4))
    y, s = wkv6_scan_plain(r, k, v, w, u, s0)
    y1, s1 = wkv6_scan_plain(r[:, :20], k[:, :20], v[:, :20], w[:, :20], u,
                             s0)
    y2, s2 = wkv6_scan_plain(r[:, 20:], k[:, 20:], v[:, 20:], w[:, 20:], u,
                             s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s)


def test_wkv6_zero_state_is_the_default():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _inputs(2, 1, 16, 4, seed=5))
    y, s = wkv6_scan_plain(r, k, v, w, u)
    y0, s0_ = wkv6_scan_plain(r, k, v, w, u, torch.zeros_like(s0))
    assert torch.equal(y, y0) and torch.equal(s, s0_)
    np.testing.assert_array_equal(ops.wkv6(r, k, v, w, u).numpy(),
                                  y.numpy())

