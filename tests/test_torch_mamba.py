"""The port's Mamba mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, float32, with the JAX parameters
carried over by ``convert.params_from_numpy``: ``apply_mamba`` with its
decode state (``h``, ``conv``) at S = 16 and at S = 512, where the
reference takes its time-chunked branch (chunks of 256) and the port its
flat recurrence; ``mamba_step`` token by token against ``apply_mamba``; and
the softplus form.

Tolerance: 1e-5 absolute and relative, as the model tests (the packages
differ in the summation order of their products and in the last ulp of
``exp``, below)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jax_configs
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.models import convert, ssm

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs():
    """jamba's reduced config (d_model 64, d_inner 128, d_state 8, d_conv 4,
    dt_rank 8), f32 activations, in both packages."""
    return (jax_configs.get("jamba-v0.1-52b").reduced(dtype="float32"),
            configs.get("jamba-v0.1-52b").reduced(dtype="float32"))


def _params(jcfg, seed):
    # the declared distributions, with a_log's arange_log and d_skip's
    # ones kept, widened so dt spans both sides of softplus's kink
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in jax_ssm.mamba_decls(jcfg).items():
        if p.init == "arange_log":
            a = np.log(np.arange(1, p.shape[-1] + 1, dtype=np.float32))
            out[k] = np.broadcast_to(a, p.shape).copy()
        elif p.init == "ones":
            out[k] = np.ones(p.shape, np.float32)
        else:
            out[k] = (0.2 * rng.standard_normal(p.shape)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            convert.params_from_numpy(out, device="cpu"))


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)) \
        .astype(np.float32)


@pytest.mark.parametrize("S", [16, 512])
def test_apply_mamba_matches_jax(S):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=S)
    x = _x(2, S, cfg.d_model, seed=S)
    want, wst = jax_ssm.apply_mamba(jp, jnp.asarray(x), jcfg,
                                    return_state=True)
    got, st = ssm.apply_mamba(tp, torch.from_numpy(x), cfg,
                              return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(st) == set(wst) == {"h", "conv"}
    di, _, ds, dc = ssm._mamba_dims(cfg)
    assert st["h"].shape == (2, di, ds) and st["h"].dtype == torch.float32
    assert st["conv"].shape == (2, dc - 1, di)
    for k in ("h", "conv"):
        np.testing.assert_allclose(convert.state_to_numpy(st)[k],
                                   np.asarray(wst[k]), err_msg=k, **TOL)
    # the conv state is the last d_conv - 1 inputs of the conv: exact
    xin = (torch.from_numpy(x) @ tp["in_proj"]).chunk(2, dim=-1)[0]
    torch.testing.assert_close(st["conv"], xin[:, -(dc - 1):], rtol=0,
                               atol=0)


def test_mamba_step_follows_apply_mamba():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    x = torch.from_numpy(_x(2, 12, cfg.d_model, seed=3))
    full, fst = ssm.apply_mamba(tp, x, cfg, return_state=True)
    state = ssm.init_mamba_state(cfg, 2, device="cpu")
    assert state["conv"].dtype == torch.float32
    outs = []
    jstate = jax_ssm.init_mamba_state(jcfg, 2)
    for t in range(12):
        out, state = ssm.mamba_step(tp, x[:, t:t + 1], state, cfg)
        outs.append(out)
        jout, jstate = jax_ssm.mamba_step(
            jp, jnp.asarray(x[:, t:t + 1].numpy()), jstate, jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **TOL)
    torch.testing.assert_close(state["h"], fst["h"], **TOL)
    # the conv state is the in-projection of the last inputs: one token's
    # product here, the sequence's there (summation order)
    torch.testing.assert_close(state["conv"], fst["conv"], **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   **TOL)


def test_prefill_then_steps_continue_the_sequence():
    # the state apply_mamba returns carries on through mamba_step exactly
    # as one apply_mamba over the whole sequence
    _, cfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=4)
    x = torch.from_numpy(_x(1, 20, cfg.d_model, seed=4))
    full = ssm.apply_mamba(tp, x, cfg)
    out, state = ssm.apply_mamba(tp, x[:, :16], cfg, return_state=True)
    outs = [out]
    for t in range(16, 20):
        out, state = ssm.mamba_step(tp, x[:, t:t + 1], state, cfg)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **TOL)


def _softplus_grid():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.linspace(-60.0, -20.0, 40001, dtype=np.float32),   # x < -20
        np.linspace(-20.0, 20.0, 80001, dtype=np.float32),    # |x| < 20
        np.linspace(20.0, 60.0, 40001, dtype=np.float32),     # x > 20
        rng.uniform(-30, 30, 40000).astype(np.float32),
        np.array([0.0, -0.0, 1e-8, -1e-8, 88.0, -88.0, -104.0, 1e30, -1e30,
                  np.inf, -np.inf, np.nan], np.float32)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_softplus_is_the_references_form():
    """The reference's ``logaddexp(x, 0)`` form, pinned bitwise.

    XLA:CPU's float32 ``exp`` and ``log1p`` are its own approximations (on
    this grid its ``exp`` of -|x| is 1 ulp from the correctly rounded value
    at 9.4% of the points, torch's at 1.1%), so no torch op reproduces
    ``jax.nn.softplus``'s bits everywhere.  What the port owns is the form
    around those two functions: on every point where the packages' ``exp``
    and ``log1p`` give the same bits, the port's softplus gives
    ``jax.nn.softplus``'s bits, over all three ranges; ``F.softplus``, the
    other form, does not.  Everywhere else the two differ by at most the
    ulps the two functions pass on (4 ulps, a stated bound), except below
    float32's smallest normal (x < -87.3), which XLA:CPU flushes to zero and
    the port keeps as a denormal."""
    x = _softplus_grid()
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    a = -np.abs(x)
    e_j = np.asarray(jnp.exp(jnp.asarray(a)))
    e_t = torch.exp(torch.from_numpy(a)).numpy()
    same_exp = _bits(e_j) == _bits(e_t)
    l_j = np.asarray(jnp.log1p(jnp.asarray(e_j)))
    l_t = torch.log1p(torch.from_numpy(e_j.copy())).numpy()
    same = same_exp & (_bits(l_j) == _bits(l_t))
    for lo, hi in ((-np.inf, -20.0), (-20.0, 20.0), (20.0, np.inf)):
        part = (x > lo) & (x < hi)
        assert (same & part).sum() > 0.8 * part.sum(), (lo, hi)
    np.testing.assert_array_equal(_bits(got)[same], _bits(want)[same])
    nan = np.isnan(x)
    assert np.isnan(got[nan]).all()
    tiny = np.finfo(np.float32).tiny
    flushed = (want == 0) & (got < tiny) & (x < -87.0)
    ulps = np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64))
    assert ulps[~nan & ~flushed].max() <= 4
    # the other form disagrees on points where the primitives agree
    other = F.softplus(torch.from_numpy(x)).numpy()
    assert (_bits(other)[same] != _bits(want)[same]).sum() > 1000


def test_mamba_decls_match_jax():
    jcfg, cfg = _cfgs()
    want = jax_ssm.mamba_decls(jcfg)
    got = ssm.mamba_decls(cfg)
    assert {k: tuple(p) for k, p in got.items()} == \
        {k: tuple(p) for k, p in want.items()}
