"""State-space / linear-recurrence mixers: Mamba (jamba) and RWKV6 (finch).

Mamba is the JAX package's selective scan in plain tensor ops, a Python
loop over time (the reference runs a ``lax.scan`` and has no Pallas kernel
for it), with its projections around it.  Serving runs the flat
recurrence; the reference's time-chunked ``jax.checkpoint`` form exists
for the backward pass only and computes the same steps.

The WKV recurrence of RWKV6 runs in the hand-written CUDA kernel
``kernels.rwkv6`` (its plain PyTorch version on the CPU), with the decode
state as its initial state, so prefill (T = S) and each decode step
(T = 1) take the same path.  Under grad it goes through
``kernels.rwkv6.WKV6``, whose backward is the ``wkv6_bwd`` kernel on the
card (the reference differentiates its ``lax.scan``).  The projections
around it are plain tensor ops, in the JAX package's op sequence, and
differentiate through autograd; nothing on the training path writes in
place into a tensor the graph keeps (the Mamba loop rebinds ``h``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6.kernel import wkv6_scan
from .config import ArchConfig
from .layers import P, torch_dtype

F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ArchConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, dt_rank, m.d_state, m.d_conv


def mamba_decls(cfg: ArchConfig) -> dict:
    di, dtr, ds, dc = _mamba_dims(cfg)
    return {
        "in_proj": P((cfg.d_model, 2 * di), ("embed", "inner")),
        "conv_w": P((dc, di), ("conv", "inner")),
        "conv_b": P((di,), ("inner",), "zeros"),
        "x_proj": P((di, dtr + 2 * ds), ("inner", "proj")),
        "dt_w": P((dtr, di), ("proj", "inner")),
        "dt_b": P((di,), ("inner",), "zeros"),
        "a_log": P((di, ds), ("inner", "state"), "arange_log"),
        "d_skip": P((di,), ("inner",), "ones"),
        "out_proj": P((di, cfg.d_model), ("inner", "embed"), "scaled"),
    }


def softplus(x):
    """``jax.nn.softplus``'s form, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``, and ``x + 0`` where ``x`` is NaN.  (``F.softplus``
    is ``log1p(exp(x))`` below its threshold and ``x`` above it, another
    rounding.)"""
    out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x + 0.0, out)


def _mamba_pre(p, x, cfg: ArchConfig, conv_state=None):
    """Shared projections. x: (B,S,D). Returns (xin, z, dt, Bc, Cc,
    conv_tail)."""
    di, dtr, ds, dc = _mamba_dims(cfg)
    dt_ = x.dtype
    xz = x @ p["in_proj"].to(dt_)
    xin, z = torch.chunk(xz, 2, dim=-1)
    # causal depthwise conv over time
    if conv_state is None:
        pad = torch.zeros((x.shape[0], dc - 1, di), dtype=dt_,
                          device=x.device)
    else:
        pad = conv_state.to(dt_)
    xin_p = torch.cat([pad, xin], dim=1)
    conv_tail = xin_p[:, -(dc - 1):, :].clone()
    w = p["conv_w"].to(dt_)
    S = xin.shape[1]
    # the reference's Python sum: 0 + term 0 + term 1 + ..., in that order
    xin = sum(xin_p[:, i:i + S, :] * w[i] for i in range(dc))
    xin = F.silu(xin + p["conv_b"].to(dt_))

    xp = xin @ p["x_proj"].to(dt_)
    dt_low, Bc, Cc = torch.split(xp, [dtr, ds, ds], dim=-1)
    dt = softplus(dt_low @ p["dt_w"].to(dt_) + p["dt_b"].to(dt_)).to(F32)
    return xin, z, dt, Bc.to(F32), Cc.to(F32), conv_tail


def _mamba_scan(p, xin, dt, Bc, Cc, h0):
    """h_t = exp(dt A) h + dt x B ; y_t = h C. Carries h (B,di,ds) f32.

    A Python loop over the S steps.  Returns (h, y (B,S,di) f32)."""
    A = -torch.exp(p["a_log"].to(F32))                    # (di, ds)
    x = xin.to(F32)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]                                   # (B, di)
        dA = torch.exp(dt_t[..., None] * A)               # (B, di, ds)
        h = h * dA + (dt_t * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    return h, torch.stack(ys, dim=1)


def _mamba_out(p, x, y, xin, z):
    dt_ = x.dtype
    y = (y.to(dt_) + p["d_skip"].to(dt_) * xin) * F.silu(z)
    return y @ p["out_proj"].to(dt_)


def apply_mamba(p, x, cfg: ArchConfig, *, return_state: bool = False):
    """Prefill / full-sequence path. x: (B,S,D)."""
    di, _, ds, _ = _mamba_dims(cfg)
    xin, z, dt, Bc, Cc, conv_tail = _mamba_pre(p, x, cfg)
    h0 = torch.zeros((x.shape[0], di, ds), dtype=F32, device=x.device)
    h, y = _mamba_scan(p, xin, dt, Bc, Cc, h0)
    out = _mamba_out(p, x, y, xin, z)
    if return_state:
        return out, {"h": h, "conv": conv_tail}
    return out


def init_mamba_state(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    di, _, ds, dc = _mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, ds), dtype=F32, device=device),
            "conv": torch.zeros((batch, dc - 1, di),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def mamba_step(p, x, state, cfg: ArchConfig):
    """One-token decode. x: (B,1,D)."""
    xin, z, dt, Bc, Cc, conv_tail = _mamba_pre(p, x, cfg,
                                               conv_state=state["conv"])
    h, y = _mamba_scan(p, xin, dt, Bc, Cc, state["h"])
    return _mamba_out(p, x, y, xin, z), {"h": h, "conv": conv_tail}


# ---------------------------------------------------------------------------
# RWKV6 (finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------

def _rwkv_dims(cfg: ArchConfig):
    hs = cfg.rwkv.head_size
    return cfg.d_model // hs, hs


def rwkv_tmix_decls(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    H, hs = _rwkv_dims(cfg)
    r = cfg.rwkv
    return {
        "mu": P((5, D), ("five", "embed")),               # r,k,v,w,g shifts
        "mix_down": P((D, 5 * r.mix_lora), ("embed", "lora")),
        "mix_up": P((5, r.mix_lora, D), ("five", "lora", "embed")),
        "wr": P((D, H * hs), ("embed", "inner")),
        "wk": P((D, H * hs), ("embed", "inner")),
        "wv": P((D, H * hs), ("embed", "inner")),
        "wg": P((D, H * hs), ("embed", "inner")),
        "w0": P((H * hs,), ("inner",), "zeros"),
        "decay_down": P((D, r.decay_lora), ("embed", "lora")),
        "decay_up": P((r.decay_lora, H * hs), ("lora", "inner")),
        "u": P((H, hs), ("heads", "head_dim")),
        "ln_scale": P((H * hs,), ("inner",), "ones"),
        "ln_bias": P((H * hs,), ("inner",), "zeros"),
        "wo": P((H * hs, D), ("inner", "embed"), "scaled"),
    }


def _shift(x):
    """x shifted one step along time, zeros first: ``x_prev``."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _tmix_proj(p, x, x_prev, cfg: ArchConfig):
    """Token-shift mixing + projections. x: (B,S,D); x_prev: shifted x.
    Returns r, k, v (B,S,H,hs) in x's dtype, the gate g (B,S,H·hs) and the
    decay w (B,S,H,hs) in f32 (its LoRA product in f32: no TF32)."""
    dt = x.dtype
    dx = x_prev - x
    lo = torch.tanh((x + dx * p["mu"][4].to(dt)) @ p["mix_down"].to(dt))
    B, S = x.shape[:2]
    lo = lo.reshape(B, S, 5, cfg.rwkv.mix_lora)
    dyn = torch.einsum("bsfl,fld->bsfd", lo, p["mix_up"].to(dt))
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (p["mu"].to(dt) + dyn)
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)
    H, hs = _rwkv_dims(cfg)
    shp = (B, S, H, hs)
    r = (xr @ p["wr"].to(dt)).reshape(shp)
    k = (xk @ p["wk"].to(dt)).reshape(shp)
    v = (xv @ p["wv"].to(dt)).reshape(shp)
    g = F.silu(xg @ p["wg"].to(dt))
    # data-dependent decay in (0,1): w = exp(-exp(w0 + lora(xw)))
    wlog = p["w0"].to(F32) + (
        torch.tanh(xw @ p["decay_down"].to(dt)).to(F32)
        @ p["decay_up"].to(F32))
    w = torch.exp(-torch.exp(wlog)).reshape(shp)
    return r, k, v, g, w


def _wkv_scan(p, r, k, v, w, s0):
    """S_t = diag(w_t) S + kᵀv ; y_t = r·(S + diag(u) kᵀv). s0: (B,H,hs,hs).

    Returns ``(final state, y (B,S,H,hs) f32)`` through the ``wkv6``
    kernel (the JAX package's scan reference and its Pallas production
    path in one call); differentiable through ``WKV6`` (the reference's
    time-chunked remat of the scan is the kernel's kept states here).
    """
    y, s = wkv6_scan(r, k, v, w, p["u"].to(F32), s0)
    return s, y


def _tmix_out(p, y, g, cfg: ArchConfig):
    """Per-head group-norm, gate, output projection."""
    B, S, H, hs = y.shape
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, H * hs)
    y = y * p["ln_scale"].to(F32) + p["ln_bias"].to(F32)
    y = y.to(g.dtype) * g
    return y @ p["wo"].to(g.dtype)


def apply_rwkv_tmix(p, x, cfg: ArchConfig, *, return_state: bool = False):
    B, S, D = x.shape
    r, k, v, g, w = _tmix_proj(p, x, _shift(x), cfg)
    H, hs = _rwkv_dims(cfg)
    s0 = torch.zeros((B, H, hs, hs), dtype=F32, device=x.device)
    s, y = _wkv_scan(p, r, k, v, w, s0)
    out = _tmix_out(p, y, g, cfg)
    if return_state:
        return out, {"s": s, "x_tmix": x[:, -1]}
    return out


def rwkv_cmix_decls(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "mu_k": P((D,), ("embed",)),
        "mu_r": P((D,), ("embed",)),
        "wk": P((D, cfg.d_ff), ("embed", "mlp")),
        "wv": P((cfg.d_ff, D), ("mlp", "embed"), "scaled"),
        "wr": P((D, D), ("embed", "embed2")),
    }


def apply_rwkv_cmix(p, x, cfg: ArchConfig, x_prev=None):
    dt = x.dtype
    if x_prev is None:
        x_prev = _shift(x)
    dx = x_prev - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    return torch.sigmoid(xr @ p["wr"].to(dt)) * (k @ p["wv"].to(dt))


def init_rwkv_state(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    H, hs = _rwkv_dims(cfg)
    D = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    return {"s": torch.zeros((batch, H, hs, hs), dtype=F32, device=device),
            "x_tmix": torch.zeros((batch, D), dtype=dt, device=device),
            "x_cmix": torch.zeros((batch, D), dtype=dt, device=device)}


def rwkv_tmix_step(p, x, state, cfg: ArchConfig):
    """One-token decode. x: (B,1,D)."""
    x_prev = state["x_tmix"][:, None, :]
    r, k, v, g, w = _tmix_proj(p, x, x_prev, cfg)
    S, y = _wkv_scan(p, r, k, v, w, state["s"])
    out = _tmix_out(p, y, g, cfg)
    return out, {"s": S, "x_tmix": x[:, 0]}


def rwkv_cmix_step(p, x, state_x, cfg: ArchConfig):
    out = apply_rwkv_cmix(p, x, cfg, x_prev=state_x[:, None, :])
    return out, x[:, 0]
