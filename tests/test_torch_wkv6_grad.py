"""The gradient of the port's WKV6 recurrence on the CPU, where
``kernels.rwkv6.WKV6`` runs its plain forward (``wkv6_scan_plain``) and its
plain backward (``wkv6_bwd_plain``, the reverse recurrence the ``wkv6_bwd``
kernel computes on the card), against the JAX package seeded with numpy:
``jax.grad`` of the model's ``ssm._wkv_scan`` (output and final state, a
non-zero initial state and a non-zero final-state gradient; at T = 512 the
reference runs its time-chunked remat path), and of the oracle
``wkv6_ref`` through ``ops.wkv6`` in float32 and bfloat16; against
``torch.autograd`` through ``wkv6_scan_plain``; ``wkv6_bwd_plain`` against
float64 autograd, and against ``jax.value_and_grad`` through ``_wkv_scan``
at the T around the kernels' kept-state interval; and that interval
given to both CUDA sources by the build from ``kernel.py``'s ``CHUNK``.

Tolerances (atol = rtol): 1e-5 against the JAX package and autograd in
float32 (the same gradient summed in other orders: hs-term dot products
per step, the state's gradient carried over T steps; measured at most
3.1e-6 of 1 + |g|, on gradients up to 31); 5e-2 in bfloat16,
``tests/test_kernels.py``'s WKV6 tolerance (both sides round the output
and the gradients to bf16); 1e-12 in float64."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import wkv6_ref
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.kernels.rwkv6 import kernel, ops
from repro_torch.models import init_model, loss_fn

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [
    # (B, H, T, hs): T = 1, T a multiple of neither the kernels' 4-step
    # kept-state interval nor 64, the kernel tests' shapes, and T = 512
    # (the reference's chunked scan)
    (2, 3, 1, 16),
    (2, 3, 77, 16),
    (1, 2, 64, 8),
    (2, 1, 40, 4),
    (1, 4, 128, 32),
    (1, 2, 512, 16),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small eager ops (a Python loop over time, tiny layers): one thread
    each keeps them from contending with the other test workers'
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, T, hs, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.45, 0.95, (B, T, H, hs)).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hs))).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    gy = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    gs = (0.5 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    return r, k, v, w, u, s0, gy, gs


def _port_grads(r, k, v, w, u, s0, gy, gs, dtype=torch.float32):
    xs = [torch.from_numpy(a).to(dtype if i < 3 else torch.float32)
          .requires_grad_() for i, a in enumerate((r, k, v, w, u, s0))]
    y, s = kernel.wkv6_scan(*xs)
    grads = torch.autograd.grad(
        (y, s), xs, (torch.from_numpy(gy), torch.from_numpy(gs)))
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv6_grads_match_jax_wkv_scan(shape):
    r, k, v, w, u, s0, gy, gs = _inputs(*shape, seed=shape[2])

    def f(r, k, v, w, u, s0):
        s, y = jax_ssm._wkv_scan({"u": u}, r, k, v, w, s0)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    got = _port_grads(r, k, v, w, u, s0, gy, gs)
    for name, g, ref in zip("r k v w u s0".split(), got, want):
        np.testing.assert_allclose(g, np.asarray(ref), err_msg=name, **TOL)


K = kernel.CHUNK          # the forward keeps the state every K steps


@pytest.mark.parametrize("hs", [16, 64])
@pytest.mark.parametrize("T", [K - 1, K + 1, 64 + K + 1])
def test_bwd_plain_matches_jax_value_and_grad_around_the_interval(T, hs):
    # the T just under and over the kept-state interval K, and 64 + K + 1:
    # the plain backward the card is held to, against the reference's own
    # gradient and loss
    r, k, v, w, u, s0, gy, gs = _inputs(2, 2, T, hs, seed=T * hs)

    def f(r, k, v, w, u, s0):
        s, y = jax_ssm._wkv_scan({"u": u}, r, k, v, w, s0)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    val, want = jax.value_and_grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0, gy, gs)]
    got = kernel.wkv6_bwd_plain(*t)
    for name, g, ref in zip("r k v w u s0".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), err_msg=name,
                                   **TOL)
    # the loss: a float32 sum of ~10^4 terms of both signs, held at 1e-6 of
    # the sum of their magnitudes (two summation orders)
    y, s = kernel.wkv6_scan_plain(*t[:6])
    terms = torch.cat([(y * t[6]).flatten(), (s * t[7]).flatten()])
    assert abs(float(terms.sum()) - float(val)) <= 1e-6 * float(
        terms.abs().sum())


def test_kept_state_interval_is_one_constant():
    # kernel.py's CHUNK sizes s_chk; the build passes it to wkv6.cu (which
    # keeps the state at that interval) and wkv6_bwd.cu (which replays
    # sub-chunks of it), and neither source defines a value of its own
    # (read as text)
    from repro_torch.kernels import _build
    for name in ("wkv6", "wkv6_bwd"):
        src, macros = _build.LIBRARIES[name]
        assert f"-DWKV6_CHUNK={kernel.CHUNK}" in macros, name
        text = _build.SOURCES[src].read_text()
        assert not re.search(r"^\s*#\s*define\s+WKV6_CHUNK\b", text,
                             re.M), name
        assert re.search(r"^#ifndef WKV6_CHUNK\n#error", text, re.M), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[1:5])
def test_ops_wkv6_grads_match_jax_ref(shape, dtype):
    B, H, T, hs = shape
    r, k, v, w, u, _, gy, _ = _inputs(*shape, seed=T + 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tr = lambda x: jnp.transpose(x, (0, 2, 1, 3))  # noqa: E731

    def f(r, k, v, w, u):
        y = wkv6_ref(tr(r), tr(k), tr(v), tr(w), u)
        return jnp.sum(tr(y).astype(jnp.float32) * gy)

    want = jax.grad(f, argnums=tuple(range(5)))(
        *(jnp.asarray(a, jdt) for a in (r, k, v, w, u)))
    xs = [torch.from_numpy(a).to(tdt).requires_grad_()
          for a in (r, k, v, w, u)]
    y = ops.wkv6(*xs)
    assert y.dtype == tdt
    got = torch.autograd.grad((y.float() * torch.from_numpy(gy)).sum(), xs)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for name, g, x, ref in zip("r k v w u".split(), got, xs, want):
        assert g.dtype == x.dtype, name        # each input's own dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv6_function_matches_autograd_through_plain_scan(shape):
    r, k, v, w, u, s0, gy, gs = _inputs(*shape, seed=7)
    got = _port_grads(r, k, v, w, u, s0, gy, gs)
    xs = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, w, u, s0)]
    y, s = kernel.wkv6_scan_plain(*xs)
    want = torch.autograd.grad(
        (y, s), xs, (torch.from_numpy(gy), torch.from_numpy(gs)))
    for name, g, ref in zip("r k v w u s0".split(), got, want):
        np.testing.assert_allclose(g, ref.numpy(), err_msg=name, **TOL)


def test_bwd_plain_is_the_gradient_in_float64(monkeypatch):
    monkeypatch.setattr(kernel, "F32", torch.float64)
    r, k, v, w, u, s0, gy, gs = (torch.from_numpy(a.astype(np.float64))
                                 for a in _inputs(2, 3, 37, 8, seed=3))
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = kernel.wkv6_scan_plain(*xs)
    want = torch.autograd.grad((y, s), xs, (gy, gs))
    got = kernel.wkv6_bwd_plain(r, k, v, w, u, s0, gy, gs)
    for name, g, ref in zip("r k v w u s0".split(), got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-12,
                                   rtol=1e-12, err_msg=name)


def test_wkv6_without_s0_and_unused_state():
    # s0 None (zeros) and the final state unused: gs is None in backward,
    # no gradient for s0
    r, k, v, w, u, s0, gy, _ = _inputs(1, 2, 70, 8, seed=4)
    xs = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, w, u)]
    y, _ = kernel.wkv6_scan(*xs)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), xs)
    ys, _ = kernel.wkv6_scan_plain(*xs)
    want = torch.autograd.grad((ys * torch.from_numpy(gy)).sum(), xs)
    for g, ref in zip(got, want):
        torch.testing.assert_close(g, ref, **TOL)
    wzero = kernel.wkv6_bwd_plain(*(x.detach() for x in xs), None,
                                  torch.from_numpy(gy))
    for g, ref in zip(wzero[:5], got):
        torch.testing.assert_close(g, ref, **TOL)


def test_no_grad_call_takes_the_plain_forward(monkeypatch):
    # serving: no input requires grad -> no autograd.Function
    def refuse(*_a, **_k):
        raise AssertionError("the serving call went through WKV6")
    monkeypatch.setattr(kernel.WKV6, "apply", refuse)
    r, k, v, w, u, s0, _, _ = _inputs(1, 2, 9, 4, seed=5)
    y, s = kernel.wkv6_scan(*(torch.from_numpy(a)
                              for a in (r, k, v, w, u, s0)))
    y2, s2 = kernel.wkv6_scan_plain(*(torch.from_numpy(a)
                                      for a in (r, k, v, w, u, s0)))
    assert torch.equal(y, y2) and torch.equal(s, s2)
    with torch.no_grad():
        kernel.wkv6_scan(*(torch.from_numpy(a).requires_grad_()
                           for a in (r, k, v, w, u, s0)))


def test_flash_under_grad_raises_naming_the_roadmap():
    cfg = configs.get("yi-6b").reduced(dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["embed"]["embedding"].requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    batch = {"inputs": toks, "labels": toks}
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        loss_fn(params, cfg, batch, attn_impl="flash")
    with torch.no_grad():            # serving through flash is unchanged
        assert torch.isfinite(loss_fn(params, cfg, batch,
                                      attn_impl="flash"))
