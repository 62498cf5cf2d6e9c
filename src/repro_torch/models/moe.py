"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The dispatch is gather/scatter (no one-hot dispatch product), so the expert
products cost only the capacity's rows, as in the JAX package's
``models/moe.py``.  The router runs in float32 whatever the activations'
dtype; the gates are cast to it only at the combine.

Tokens are dispatched in groups (a leading axis ``G``): capacity is per
group.  The port has no mesh yet (sharding is ROADMAP A9's last part), so
there is one group; the axis stays in the shapes for the sharding slice.

No kernel: the reference computes the routing, sort and gathers in XLA and
the expert products as einsums, outside any Pallas kernel, so here they
are plain tensor ops (``torch.argsort``, indexing, ``torch.einsum``,
``index_add_``).

:func:`apply_moe_dense` is the oracle: every expert densely, no capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import P

F32 = torch.float32


def moe_decls(cfg: ArchConfig) -> dict:
    E = cfg.moe.n_experts
    return {
        "router": P((cfg.d_model, E), ("embed", "experts")),
        "w_gate": P((E, cfg.d_model, cfg.d_ff), ("experts", "embed", "mlp")),
        "w_up": P((E, cfg.d_model, cfg.d_ff), ("experts", "embed", "mlp")),
        "w_down": P((E, cfg.d_ff, cfg.d_model), ("experts", "mlp", "embed"),
                    "scaled"),
    }


def _route(p, xf, cfg: ArchConfig):
    """Router: top-k gates (renormalized softmax) and their experts.
    xf: (N, D) -> gates (N, k) float32, idx (N, k) int64.

    ``jax.lax.top_k`` orders the k largest descending and breaks ties
    toward the lower index; a stable descending sort gives that order on
    every device (``torch.topk`` promises neither on CUDA)."""
    logits = xf.to(F32) @ p["router"].to(F32)                # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return gates, idx


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens of one group: the
    reference's integer arithmetic, rounded up to a multiple of 8 (at
    least 8), at most ``n_tokens``."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = int(cfg.moe.capacity_factor * n_tokens * k / E + 0.999)
    C = max(8, -(-C // 8) * 8)
    return min(C, n_tokens)


def _dispatch(idx, E: int, C: int):
    """Capacity dispatch of the groups' assignments.  idx: (G, N, k).

    Assignments are ordered by expert (stable, so token order within an
    expert) and ranked within their expert's bucket; those ranked past
    ``C`` are dropped.  Returns ``(order, tok, keep, slot)`` over the
    sorted assignments, each (G, N·k): the flat assignment each sorted one
    is, its token, whether it fits, and its row in the (E·C) buckets
    (``E·C``, the absorbing row, when dropped)."""
    G, N, k = idx.shape
    flat_e = idx.reshape(G, N * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    tok = order // k
    # rank within expert bucket = position - bucket start, where
    # start[e] = #assignments routed to experts < e (exclusive cumsum)
    counts = F.one_hot(sorted_e, E).sum(dim=1)               # (G, E)
    start = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(N * k, device=idx.device)[None, :]
            - torch.gather(start, 1, sorted_e))
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    return order, tok, keep, slot


def _expert_ffn(p, xg, cfg: ArchConfig):
    """Grouped SwiGLU over expert buckets. xg: (E, C, D) -> (E, C, D)."""
    dt = xg.dtype
    h = F.silu(torch.einsum("ecd,edf->ecf", xg, p["w_gate"].to(dt))) \
        * torch.einsum("ecd,edf->ecf", xg, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))


def _expert_ffn_grouped(p, xg, cfg: ArchConfig):
    """Grouped SwiGLU. xg: (G, E, C, D) -> (G, E, C, D)."""
    dt = xg.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", xg, p["w_gate"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", xg, p["w_up"].to(dt))
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))


def apply_moe(p, x, cfg: ArchConfig):
    """Sort-based capacity dispatch. x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    G = 1                                   # dispatch groups (no mesh)
    N = (B * S) // G                                          # per group
    xf = x.reshape(G, N, D)
    gates, idx = _route(p, xf.reshape(G * N, D), cfg)
    C = capacity(cfg, N)
    order, tok, keep, slot = _dispatch(idx.reshape(G, N, k), E, C)

    gi = torch.arange(G, device=x.device)[:, None]
    # gather tokens into (G, E, C, D) buckets (the zero row N absorbs
    # empty slots; dropped assignments all land in the unused row E*C)
    buf_tok = torch.full((G, E * C + 1), N, dtype=torch.int64,
                         device=x.device)
    buf_tok[gi, slot] = tok
    xpad = torch.cat([xf, torch.zeros((G, 1, D), dtype=x.dtype,
                                      device=x.device)], dim=1)
    xg = xpad[gi, buf_tok[:, :E * C]].reshape(G, E, C, D)

    yg = _expert_ffn_grouped(p, xg, cfg).reshape(G, E * C, D)

    # combine: scatter-add gate-weighted expert outputs back to tokens.
    # A token receives at most top_k terms onto zeros, and with top_k <= 2
    # (every config: mixtral and jamba 2, llama4-scout 1) (0 + a) + b ==
    # (0 + b) + a exactly, so index_add_ is deterministic on the card too.
    g_sorted = torch.gather(gates.reshape(G, N * k), 1, order).to(x.dtype)
    got = yg[gi, torch.clamp_max(slot, E * C - 1)] * g_sorted[..., None]
    contrib = torch.where(keep[..., None], got, 0.0)
    out = torch.zeros((G * N, D), dtype=x.dtype, device=x.device)
    out.index_add_(0, (tok + gi * N).reshape(-1), contrib.reshape(-1, D))
    return out.reshape(B, S, D)


def apply_moe_dense(p, x, cfg: ArchConfig):
    """Oracle: dense per-expert compute, no capacity drop. O(E) FLOPs."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx = _route(p, xf, cfg)
    out = torch.zeros_like(xf)
    dt = xf.dtype
    for e in range(cfg.moe.n_experts):
        h = F.silu(xf @ p["w_gate"][e].to(dt)) * (xf @ p["w_up"][e].to(dt))
        ye = h @ p["w_down"][e].to(dt)
        w = torch.sum(torch.where(idx == e, gates, 0.0), dim=-1).to(dt)
        out += w[:, None] * ye
    return out.reshape(B, S, D)
