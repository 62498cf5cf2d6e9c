"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The dispatch is gather/scatter (no one-hot dispatch product), so the expert
products cost only the capacity's rows, as in the JAX package's
``models/moe.py``.  The router runs in float32 whatever the activations'
dtype; the gates are cast to it only at the combine.

Tokens are dispatched in groups (a leading axis ``G``): capacity is per
group.  Under a mesh context ``G`` is the mesh's (pod × data) extent
(halved until it divides the batch), as in the reference, and each group's
sort, gather and scatter run on the device that holds it
(``sharding.shard_local``); without one there is one group.

No kernel: the reference computes the routing, sort and gathers in XLA and
the expert products as einsums, outside any Pallas kernel, so here they
are plain tensor ops (``torch.argsort``, indexing, ``torch.einsum``,
``index_add_``).

:func:`apply_moe_dense` is the oracle: every expert densely, no capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import rules
from ..sharding.rules import batch_only, shard_act, shard_local
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
    h = shard_act(h, ("experts", None, "mlp"))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))


def _dispatch_groups(batch: int) -> int:
    """Dispatch-group count = the mesh's (pod × data) extent when a mesh
    context is active (sort/gather/scatter then stay shard-local), halved
    until it divides ``batch``; else 1."""
    if rules._CTX is None:
        return 1
    mesh = rules.as_mesh(rules._CTX["mesh"])
    g = 1
    for a in rules.batch_axes(mesh):
        g *= mesh.shape[a]
    while batch % g:
        g //= 2
    return max(g, 1)


def _expert_ffn_grouped(p, xg, cfg: ArchConfig):
    """Grouped SwiGLU. xg: (G, E, C, D) -> (G, E, C, D); mlp dim TP.
    Each expert's product takes its rows of every group at once, experts
    leading: the layout einsum's batched product takes, with the rows made
    contiguous first, since a ``DTensor`` whose local shard holds several
    groups (a batch left unsplit) cannot view its transposed rows (for
    one group the copy is none)."""
    G, E, C, _ = xg.shape
    dt = xg.dtype

    def experts_first(a):                     # (G, E, C, X) -> (E, G·C, X)
        return a.transpose(0, 1).contiguous().flatten(1, 2)

    def groups_first(a):                      # (E, G·C, X) -> (G, E, C, X)
        return a.unflatten(1, (G, C)).transpose(0, 1)

    xe = experts_first(xg)
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dt))) \
        * torch.bmm(xe, p["w_up"].to(dt))
    h = shard_act(groups_first(h), ("batch", "experts", "capacity", "mlp"))
    return groups_first(torch.bmm(experts_first(h), p["w_down"].to(dt)))


def _gather_buckets(xf, idx, E: int, C: int):
    """Each group's capacity dispatch and its (E, C, D) token buckets.
    xf: (G, N, D); idx: (G, N, k) -> ``(xg (G, E, C, D), order, tok, keep,
    slot)`` (:func:`_dispatch`)."""
    G, N, D = xf.shape
    order, tok, keep, slot = _dispatch(idx, E, C)
    gi = torch.arange(G, device=xf.device)[:, None]
    # gather tokens into (G, E, C, D) buckets (the zero row N absorbs
    # empty slots; dropped assignments all land in the unused row E*C)
    buf_tok = torch.full((G, E * C + 1), N, dtype=torch.int64,
                         device=xf.device)
    buf_tok[gi, slot] = tok
    xpad = torch.cat([xf, torch.zeros((G, 1, D), dtype=xf.dtype,
                                      device=xf.device)], dim=1)
    xg = xpad[gi, buf_tok[:, :E * C]].reshape(G, E, C, D)
    return xg, order, tok, keep, slot


def _combine(yg, gates, order, tok, keep, slot):
    """Scatter-add each group's gate-weighted expert outputs back to its
    tokens.  yg: (G, E·C, D); gates: (G, N, k) -> (G, N, D).

    A token receives at most top_k terms onto zeros, and with top_k <= 2
    (every config: mixtral and jamba 2, llama4-scout 1) (0 + a) + b ==
    (0 + b) + a exactly, so index_add_ is deterministic on the card too."""
    G, EC, D = yg.shape
    N, k = gates.shape[1:]
    gi = torch.arange(G, device=yg.device)[:, None]
    g_sorted = torch.gather(gates.reshape(G, N * k), 1, order).to(yg.dtype)
    got = yg[gi, torch.clamp_max(slot, EC - 1)] * g_sorted[..., None]
    contrib = torch.where(keep[..., None], got, 0.0)
    out = torch.zeros((G * N, D), dtype=yg.dtype, device=yg.device)
    out.index_add_(0, (tok + gi * N).reshape(-1), contrib.reshape(-1, D))
    return out.reshape(G, N, D)


def apply_moe(p, x, cfg: ArchConfig):
    """Group-local sort-based capacity dispatch. x: (B, S, D).

    Tokens are dispatched independently within contiguous batch groups
    aligned to the data-parallel shards (capacity is per group), with the
    reference's sharding constraint on every dispatch intermediate.  With
    no mesh context this is one global group.
    """
    x = batch_only(x)
    B, S, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    G = _dispatch_groups(B)
    N = (B * S) // G                                          # per group

    def grp(a, ax):                                           # G leads
        return shard_act(a, ("batch",) + ax)

    xf = grp(x.reshape(G, N, D), (None, None))
    gates, idx = shard_local(
        lambda xf, router: _route({"router": router},
                                  xf.reshape(-1, D), cfg),
        G, (0, None), (0, 0))(xf, p["router"])
    gates = grp(gates.reshape(G, N, k), (None, None))
    idx = grp(idx.reshape(G, N, k), (None, None))
    C = capacity(cfg, N)
    xg, order, tok, keep, slot = shard_local(
        lambda xf, idx: _gather_buckets(xf, idx, E, C), G, (0, 0),
        (0, 0, 0, 0, 0))(xf, idx)
    # EP: expert buckets sharded over the model axis (capacity dim when
    # E doesn't divide it)
    xg = grp(xg, ("experts", "capacity", None))
    yg = _expert_ffn_grouped(p, xg, cfg)
    yg = grp(yg, ("experts", "capacity", None)).reshape(G, E * C, D)
    out = shard_local(_combine, G, (0, 0, 0, 0, 0, 0), (0,))(
        yg, gates, order, tok, keep, slot)
    return grp(out, (None, None)).reshape(B, S, D)


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
