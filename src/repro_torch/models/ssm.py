"""Linear-recurrence mixers: RWKV6 (finch).

The WKV recurrence runs in the hand-written CUDA kernel
``kernels.rwkv6`` (its plain PyTorch version on the CPU), with the decode
state as its initial state, so prefill (T = S) and each decode step
(T = 1) take the same path.  The projections around it are plain tensor
ops, in the JAX package's op sequence.  Mamba (jamba) is not ported yet:
its entry points raise ``NotImplementedError`` (ROADMAP A9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6.kernel import wkv6_scan
from .config import ArchConfig
from .layers import P, torch_dtype

F32 = torch.float32


def _mamba_not_ported(*_args, **_kw):
    raise NotImplementedError("Mamba blocks (jamba) are not ported to "
                              "repro_torch yet (ROADMAP A9)")


mamba_decls = apply_mamba = init_mamba_state = mamba_step = _mamba_not_ported


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
    path in one call).
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


def init_rwkv_state(cfg: ArchConfig, batch: int, device=None) -> dict:
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
