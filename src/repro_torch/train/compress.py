"""Gradient compression with error feedback (int8 block quantisation).

As the JAX package's ``repro/train/compress.py``: each gradient leaf plus
its carried residual is quantised to int8 in blocks of 256 with one float32
scale per block (what would cross the wire), dequantised, and the rounding
error carried into the next step.  ``torch.round`` rounds half to even, as
``jnp.round``; the scale divides by a tensor on the leaf's device (not a
host scalar, which torch on CUDA turns into a multiply by its reciprocal).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.layers import tree_from_items, tree_items, tree_map

F32 = torch.float32


class EFState(NamedTuple):
    residual: dict            # tree like grads (float32)


def init_state(params) -> EFState:
    return EFState(tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params))


def _quantize_block(g, block: int = 256):
    """Symmetric int8 with per-block scales.  g: any shape, float32."""
    flat = g.reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / torch.tensor(
        127.0, dtype=F32, device=g.device)
    q = torch.clamp(torch.round(flat / torch.clamp_min(scale, 1e-30)),
                    -127, 127).to(torch.int8)
    return q, scale, n


def _dequantize(q, scale, n, shape):
    return (q.to(F32) * scale).reshape(-1)[:n].reshape(shape)


def compress_grads(grads, ef: EFState, *, block: int = 256):
    """Returns (dequantized grads as seen after the all-reduce, new EF
    state)."""
    residual = dict(tree_items(ef.residual))
    new_g, new_r = [], []
    for path, g in tree_items(grads):
        gf = g.to(F32) + residual[path]
        q, scale, n = _quantize_block(gf, block)
        deq = _dequantize(q, scale, n, gf.shape)
        new_g.append((path, deq))
        new_r.append((path, gf - deq))
    return tree_from_items(new_g), EFState(tree_from_items(new_r))


def wire_bytes(params) -> dict:
    """Uncompressed vs int8 wire bytes for one gradient all-reduce."""
    n = sum(p.numel() for _, p in tree_items(params))
    return {"fp32": 4 * n, "int8": n + 4 * (n // 256 + 1)}
