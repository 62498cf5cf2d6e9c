"""Shared layers + the parameter-declaration convention.

Every block declares its parameters as a nested dict of :class:`P`
``(shape, logical_axes, init)`` entries, as in the JAX package; from one
declaration tree :func:`init_params` draws the parameters.  The logical
axes are kept for the sharding rules that come with ROADMAP A9/A8; the JAX
package's activation constraints (``shard_act``) are no-ops without a mesh
and are left out here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig

F32 = torch.float32


class P(NamedTuple):
    shape: tuple
    axes: tuple                      # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | scaled


def tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, keys in sorted order (the
    order ``jax.tree.flatten`` gives a dict)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_from_items(items) -> dict:
    """The nested dict of ``(path, leaf)`` pairs (:func:`tree_items`'s
    inverse)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict (``P`` entries are leaves)."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype names) -> torch."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def init_params(decls, generator: torch.Generator, dtype=F32,
                device=None):
    """Draw a parameter tree from its declarations: the JAX package's
    distributions (``normal``: 0.02·N(0,1); ``scaled``: 0.02/√2·N(0,1);
    ``zeros``, ``ones``; ``arange_log``: log(1..n) along the last dim), one
    draw per leaf in the leaves' sorted-key order from ``generator``.  The
    numbers differ from ``jax.random``'s: parity with the JAX package goes
    through ``convert.params_from_numpy``."""
    device = torch.device(device if device is not None
                          else generator.device)
    dtype = torch_dtype(dtype)
    out = []
    for path, p in tree_items(decls):
        if p.init == "zeros":
            x = torch.zeros(p.shape, dtype=dtype, device=device)
        elif p.init == "ones":
            x = torch.ones(p.shape, dtype=dtype, device=device)
        elif p.init == "arange_log":
            row = torch.log(torch.arange(1, p.shape[-1] + 1, dtype=dtype,
                                         device=device))
            x = row.expand(p.shape).clone()
        else:
            scale = 0.02 if p.init == "normal" else 0.02 / math.sqrt(2.0)
            x = torch.randn(p.shape, generator=generator, dtype=dtype,
                            device=device) * scale
        out.append((path, x))
    return tree_from_items(out)


def stack_decls(decls, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the per-layer parameters stacked on a
    leading ``layers`` axis)."""
    return tree_map(lambda p: P((n,) + p.shape, (axis_name,) + p.axes,
                                p.init), decls)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_decls(cfg: ArchConfig) -> dict:
    d = {"scale": P((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = P((cfg.d_model,), ("embed",), "zeros")
    return d


def apply_norm(p, x, cfg: ArchConfig, eps: float = 1e-5):
    """RMSNorm or LayerNorm over the last dim, in f32, cast back."""
    xf = x.to(F32)
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].to(F32)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = ((xf - mu) * torch.rsqrt(var + eps) * p["scale"].to(F32)
             + p["bias"].to(F32))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ArchConfig, positions):
    """positions: int[...]; returns (cos, sin) f32 with trailing
    head_dim/2."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=F32, device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=F32,
                                       device=positions.device), exps)
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., n_heads, head_dim); cos/sin broadcast over heads."""
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def mlp_decls(cfg: ArchConfig) -> dict:
    if cfg.act == "swiglu":
        return {
            "w_gate": P((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "w_up": P((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "w_down": P((cfg.d_ff, cfg.d_model), ("mlp", "embed"), "scaled"),
        }
    return {
        "w_up": P((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
        "b_up": P((cfg.d_ff,), ("mlp",), "zeros"),
        "w_down": P((cfg.d_ff, cfg.d_model), ("mlp", "embed"), "scaled"),
        "b_down": P((cfg.d_model,), ("embed",), "zeros"),
    }


def apply_mlp(p, x, cfg: ArchConfig):
    dt = x.dtype
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_decls(cfg: ArchConfig) -> dict:
    d = {"embedding": P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        d["head"] = P((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return d


def embed_tokens(p, tokens, cfg: ArchConfig):
    # The JAX package casts the whole table, then gathers; gathering the
    # rows first and casting them gives the same bits without a cast copy
    # of the table.
    return p["embedding"][tokens].to(torch_dtype(cfg.dtype))


def lm_head(p, x, cfg: ArchConfig):
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    return x @ w.to(x.dtype)
