"""Grouped-query attention: training/prefill forward + KV-cache decode.

q/k/v projections are kept 3-D ``(embed, heads, head_dim)`` as in the JAX
package, so the parameter trees match leaf for leaf.  ``impl`` picks the
core softmax(QKᵀ)V of the full-sequence path: ``"dense"`` (:func:`sdpa`,
materialises the S×T scores), ``"chunked"`` (:func:`chunked_sdpa`, an
online softmax over q/kv blocks in plain tensor ops), ``"flash"`` (the
hand-written CUDA kernel ``kernels.flash_attention``; its plain version on
the CPU) and ``"auto"`` (chunked from S = 2048 on, else dense).  Training
takes ``"auto"``: the flash kernel has no backward (nor has the JAX
package's Pallas call), so ``"flash"`` under grad raises.  The decode
path's attention and every projection are plain products
(``torch.einsum``/``matmul``), as the JAX package leaves them to XLA.

The KV cache is updated in place (the JAX package returns a new dict).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as fa_ops
from .config import ArchConfig
from .layers import P, apply_rope, rope_freqs, torch_dtype

F32 = torch.float32
_NEG = -1e30
# chunked-attention tile sizes
BLOCK_Q = 512
BLOCK_K = 1024


def attn_decls(cfg: ArchConfig) -> dict:
    dh = cfg.head_dim
    return {
        "wq": P((cfg.d_model, cfg.n_heads, dh), ("embed", "heads", "head_dim")),
        "wk": P((cfg.d_model, cfg.n_kv_heads, dh),
                ("embed", "kv_heads", "head_dim")),
        "wv": P((cfg.d_model, cfg.n_kv_heads, dh),
                ("embed", "kv_heads", "head_dim")),
        "wo": P((cfg.n_heads, dh, cfg.d_model),
                ("heads", "head_dim", "embed"), "scaled"),
    }


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    D, H, K = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * K)).unflatten(-1, (H, K))


def _out_proj(out, w):
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    H, K, D = w.shape
    return out.flatten(-2) @ w.to(out.dtype).reshape(H * K, D)


def _qkv(p, x, cfg: ArchConfig, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _gqa_scores_mask(cfg: ArchConfig, q_pos, k_pos):
    """mask[S, T] — True where attendable."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if cfg.causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if cfg.window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < cfg.window
    return ok


def sdpa(cfg: ArchConfig, q, k, v, mask):
    """Reference scaled-dot-product attention with GQA grouping.

    q: (B,S,Hq,Dh)  k,v: (B,T,Hkv,Dh)  mask: (S,T) or (B,S,T).  Scores in
    f32 (bf16 operands widen exactly, as ``preferred_element_type=f32``),
    softmax weights cast to v's dtype for the PV product.
    """
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, Dh)
    scores = torch.einsum("bshgk,bthk->bhgst", qg.to(F32), k.to(F32))
    scores = scores * Dh ** -0.5
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthk->bshgk", w, v)
    return out.reshape(B, S, Hq, Dh)


def chunked_sdpa(cfg: ArchConfig, q, k, v, *, block_q: int | None = None,
                 block_k: int | None = None):
    """Flash-style online-softmax attention in plain tensor ops (loops over
    q/kv blocks); never materialises the S×T scores.  Assumes contiguous
    positions 0..S-1 (training/prefill).  Unlike the flash kernel, p is cast
    to v's dtype for the PV product, as in the JAX package."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq = min(block_q or BLOCK_Q, S)
    bk = min(block_k or BLOCK_K, T)
    if S % bq or T % bk:
        raise ValueError(f"chunked_sdpa: blocks ({bq}, {bk}) must divide "
                         f"(S, T) = ({S}, {T})")
    scale = Dh ** -0.5
    dev = q.device
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, S, Dh)
    kh = k.permute(0, 2, 1, 3)[:, :, None]                 # (B,Hkv,1,T,Dh)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, Hkv, G, S, Dh), dtype=q.dtype, device=dev)
    for q0 in range(0, S, bq):
        qb = qg[:, :, :, q0:q0 + bq].to(F32)
        qpos = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((B, Hkv, G, bq), -torch.inf, dtype=F32, device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=F32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, Dh), dtype=F32, device=dev)
        for k0 in range(0, T, bk):
            kb = kh[..., k0:k0 + bk, :]
            vb = vh[..., k0:k0 + bk, :]
            kpos = torch.arange(k0, k0 + bk, device=dev)[None, :]
            s = torch.matmul(qb, kb.to(F32).transpose(-1, -2)) * scale
            ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if cfg.causal:
                ok &= qpos >= kpos
            if cfg.window is not None:
                ok &= qpos - kpos < cfg.window
            s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(vb.dtype), vb).to(F32)
            m = m_new
        out[:, :, :, q0:q0 + bq] = (
            acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out.reshape(B, Hq, S, Dh).permute(0, 2, 1, 3)


def _core_attention(cfg: ArchConfig, q, k, v, positions, impl: str):
    if impl == "auto":
        impl = "chunked" if q.shape[1] >= 2048 else "dense"
    if impl == "flash":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "attn_impl='flash' has no gradient: the flash_attention "
                "kernel has no backward, as the JAX package's Pallas call "
                "has none (ROADMAP A9); train with attn_impl='auto', "
                "'dense' or 'chunked'")
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.window)
    if impl == "chunked":
        return chunked_sdpa(cfg, q, k, v)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    mask = _gqa_scores_mask(cfg, positions[0], positions[0])
    return sdpa(cfg, q, k, v, mask)


def _positions(S: int, device):
    return torch.arange(S, device=device)[None, :]


def apply_attention(p, x, cfg: ArchConfig, positions=None, *,
                    impl: str = "auto"):
    """Full-sequence path (training / prefill). x: (B,S,D)."""
    if positions is None:
        positions = _positions(x.shape[1], x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    out = _core_attention(cfg, q, k, v, positions, impl)
    return _out_proj(out, p["wo"])


def prefill_attention(p, x, cfg: ArchConfig, cache_len: int, *,
                      impl: str = "auto"):
    """Full-sequence forward that also materialises the KV cache.

    With ``cache_len < S`` (sliding-window long-context serving) only the
    last ``cache_len`` positions are kept, ring-buffer addressed so a
    subsequent :func:`decode_attention` continues seamlessly.
    """
    B, S, _ = x.shape
    positions = _positions(S, x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    out = _core_attention(cfg, q, k, v, positions, impl)
    y = _out_proj(out, p["wo"])

    keep = min(cache_len, S)
    kpos = torch.arange(S - keep, S, device=x.device)
    slots = torch.remainder(kpos, cache_len)
    cache = init_kv_cache(cfg, B, cache_len, device=x.device)
    cache["k"][:, slots] = k[:, S - keep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, S - keep:].to(cache["v"].dtype)
    cache["slot_pos"][slots] = kpos.to(torch.int32)
    return y, cache


# ---------------------------------------------------------------------------
# KV cache decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
                  device="cuda") -> dict:
    """Ring-buffer KV cache.  ``slot_pos`` holds each slot's absolute
    position (-1 = empty); with sliding-window archs ``cache_len`` may be
    just the window size."""
    dtype = torch_dtype(dtype or cfg.kv_dtype or cfg.dtype)
    kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def decode_attention(p, x, cache, cfg: ArchConfig, t: int):
    """One-token decode step.  x: (B,1,D); t: absolute position (an int).

    Returns (out (B,1,D), cache), the cache updated in place.  Batch-uniform
    position (the serving shapes decode in lockstep).
    """
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    slot = t % Sc
    kv_dt = cache["k"].dtype
    cache["k"][:, slot] = k[:, 0].to(kv_dt)
    cache["v"][:, slot] = v[:, 0].to(kv_dt)
    cache["slot_pos"][slot] = t

    kpos = cache["slot_pos"]
    ok = (kpos >= 0) & (kpos <= t)
    if cfg.window is not None:
        ok &= (t - kpos) < cfg.window
    mask = ok[None, None, :]                      # (1, S=1, T)
    out = sdpa(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
    return _out_proj(out, p["wo"]), cache
