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

The KV cache is updated in place (the JAX package returns a new dict);
prefill builds it from the keys and values functionally, so under a mesh
it takes their layout.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.flash_attention import ops as fa_ops
from ..loops import scan
from ..sharding.rules import (as_mesh, batch_axes, batch_only, shard_act,
                              sharded_dims, unsplit, write_index)
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
    """``einsum("bsd,dhk->bshk")`` as one matrix product.  A weight sharded
    along ``head_dim`` alone (heads that do not divide the mesh axis) is
    flattened head_dim first, so that each shard's columns stay one block
    (``DTensor`` has no product strategy for interleaved ones)."""
    D, H, K = w.shape
    if 2 in sharded_dims(w) and 1 not in sharded_dims(w):
        y = x @ w.to(x.dtype).transpose(1, 2).reshape(D, K * H)
        return y.unflatten(-1, (K, H)).transpose(-1, -2)
    return (x @ w.to(x.dtype).reshape(D, H * K)).unflatten(-1, (H, K))


def _out_proj(out, w):
    """``einsum("bshk,hkd->bsd")`` as one matrix product (head_dim first
    for a weight sharded along it alone, as in :func:`_proj`)."""
    H, K, D = w.shape
    if 1 in sharded_dims(w) and 0 not in sharded_dims(w):
        return (out.transpose(-1, -2).flatten(-2)
                @ w.to(out.dtype).transpose(0, 1).reshape(K * H, D))
    return out.flatten(-2) @ w.to(out.dtype).reshape(H * K, D)


def _qkv(p, x, cfg: ArchConfig, positions):
    x = batch_only(x)
    q = shard_act(_proj(x, p["wq"]),
                  ("batch", "seq", "heads", "head_dim"))
    k = shard_act(_proj(x, p["wk"]),
                  ("batch", "seq", "kv_heads", "head_dim"))
    v = shard_act(_proj(x, p["wv"]),
                  ("batch", "seq", "kv_heads", "head_dim"))
    cos, sin = rope_freqs(cfg, positions)
    # rope turns head_dim's halves into each other: whole on each device
    return (apply_rope(unsplit(q, 3), cos, sin),
            apply_rope(unsplit(k, 3), cos, sin), v)


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
                 block_k: int | None = None, q_offset: int = 0):
    """Flash-style online-softmax attention in plain tensor ops (loops over
    q/kv blocks); never materialises the S×T scores.  Assumes contiguous
    positions: keys 0..T-1, queries ``q_offset``..``q_offset``+S-1
    (training/prefill: 0 and S = T).  Unlike the flash kernel, p is cast
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

    def q_block(_, qi):
        q0 = qi * bq
        qb = qg[:, :, :, q0:q0 + bq].to(F32)
        qpos = torch.arange(q_offset + q0, q_offset + q0 + bq,
                            device=dev)[:, None]

        def kv_block(carry, ki):
            m, l, acc = carry
            k0 = ki * bk
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
            return (m_new, l, acc), None

        init = (torch.full((B, Hkv, G, bq), -torch.inf, dtype=F32,
                           device=dev),
                torch.zeros((B, Hkv, G, bq), dtype=F32, device=dev),
                torch.zeros((B, Hkv, G, bq, Dh), dtype=F32, device=dev))
        (m, l, acc), _ = scan(kv_block, init, T // bk)
        return None, (acc / torch.clamp_min(l[..., None], 1e-30)).to(
            q.dtype)

    _, blocks = scan(q_block, None, S // bq)
    out = torch.cat(blocks, dim=3)                         # (B,Hkv,G,S,Dh)
    return out.reshape(B, Hq, S, Dh).permute(0, 2, 1, 3)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: the block loops'
    gradients of K and V come out transposed in memory, and ``DTensor``
    views them (its ``view`` of a local shard does not copy)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def sharded_chunked_sdpa(cfg: ArchConfig, q, k, v):
    """:func:`chunked_sdpa`, shard-local on ``DTensor``s under a mesh
    context, as GSPMD tiles the reference's block scans.  The batch is
    split over the (pod, data) axes; over ``model``, the query heads when
    they divide it (each shard takes the kv heads its query heads read:
    its own kv-head shard when the kv heads divide the axis too, else
    picked from K/V gathered whole), otherwise the query rows (K/V
    gathered whole, the causal mask offset by the shard's first row).
    Raises when neither divides it.  The output is laid out as ``q``.
    Plain tensors: :func:`chunked_sdpa`."""
    if not isinstance(q, DTensor):
        return chunked_sdpa(cfg, q, k, v)
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    axes = as_mesh(mesh)
    B, S, Hq, _ = q.shape
    Hkv = k.shape[2]
    bat = batch_axes(axes)
    split_b = B % math.prod(axes.shape[a] for a in bat) == 0
    m = axes.shape.get("model", 1)
    if m == 1 or Hq % m == 0:
        mode = "heads"
    elif S % m == 0:
        mode = "rows"
    else:
        raise ValueError(f"sharded_chunked_sdpa: neither {Hq} heads nor "
                         f"{S} rows divide the model axis ({m})")
    kv_whole = mode == "rows" or Hkv % m != 0

    def pl(dim):
        return tuple(
            Shard(0) if a in bat and split_b and axes.shape[a] > 1
            else Shard(dim) if a == "model" and m > 1 and dim is not None
            else Replicate() for a in axes.axis_names)

    q_pl = pl(2 if mode == "heads" else 1)
    kv_pl = pl(None if kv_whole else 2)
    coord = mesh.get_coordinate()
    j = coord[axes.axis_names.index("model")] if "model" in axes.axis_names \
        else 0

    def local(q, k, v):
        q, k, v = (_ContiguousGrad.apply(t) if t.requires_grad else t
                   for t in (q, k, v))
        if mode == "heads" and kv_whole and m > 1:
            hl = q.shape[2]
            idx = (j * hl + torch.arange(hl, device=q.device)) // (Hq // Hkv)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        off = j * q.shape[1] if mode == "rows" else 0
        return chunked_sdpa(cfg, q, k, v, q_offset=off)

    out = local_map(local, out_placements=(q_pl,),
                    in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                    redistribute_inputs=True)(q, k, v)
    return out.redistribute(mesh, q.placements)


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
        return sharded_chunked_sdpa(cfg, q, k, v)
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
    kv_dt = torch_dtype(cfg.kv_dtype or cfg.dtype)
    kpos = torch.arange(S - keep, S, dtype=torch.int32, device=x.device)
    cache = {"k": _ring(k[:, S - keep:].to(kv_dt), 1, cache_len, S, 0.0),
             "v": _ring(v[:, S - keep:].to(kv_dt), 1, cache_len, S, 0.0),
             "slot_pos": _ring(kpos, 0, cache_len, S, -1)}
    return y, cache


def _ring(tail, dim: int, cache_len: int, S: int, empty):
    """The ring buffer of ``cache_len`` slots that holds ``tail`` (the last
    ``keep`` = min(cache_len, S) positions along ``dim``) at slot
    ``position mod cache_len``, ``empty`` in the unused slots: a rotation of
    the tail when it fills the ring, else the tail then empties (S <
    cache_len: the slots are the positions).  Built functionally, so a
    sharded tail gives a sharded cache."""
    keep = tail.shape[dim]
    if keep < cache_len:
        pad = list(tail.shape)
        pad[dim] = cache_len - keep
        return torch.cat([tail, torch.full(pad, empty, dtype=tail.dtype,
                                           device=tail.device)], dim=dim)
    shift = (S - keep) % cache_len
    return torch.roll(tail, shift, dim) if shift else tail.contiguous()


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
    write_index(cache["k"], 1, slot, k[:, 0].to(kv_dt))
    write_index(cache["v"], 1, slot, v[:, 0].to(kv_dt))
    write_index(cache["slot_pos"], 0, slot, t)

    kpos = cache["slot_pos"]
    ok = (kpos >= 0) & (kpos <= t)
    if cfg.window is not None:
        ok &= (t - kpos) < cfg.window
    mask = ok[None, None, :]                      # (1, S=1, T)
    # the query replicated over the cache's seq shards: scores split by
    # key, as the reference's flash-decoding cache layout
    out = sdpa(cfg, batch_only(q), cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
    return _out_proj(out, p["wo"]), cache
