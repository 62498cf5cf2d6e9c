"""Assigned input shapes (``seq_len × global_batch``) and which
(architecture, shape) cells are runnable: the JAX package's
``configs/shapes.py``, with ``input_specs`` giving meta tensors (no
allocation: the dry-run contract) where the reference gives
``ShapeDtypeStruct``s:

* ``train_4k``     — seq 4096,    batch 256;
* ``prefill_32k``  — seq 32768,   batch 32;
* ``decode_32k``   — seq 32768,   batch 128 (one new token against a
  seq_len KV cache / recurrent state);
* ``long_500k``    — seq 524288,  batch 1; only for sub-quadratic archs
  (SSM / hybrid / sliding-window).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ArchConfig
from ..models.layers import torch_dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """Assignment rules: which (arch × shape) cells are runnable."""
    s = SHAPES[shape]
    if s.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention: 500k decode needs sub-quadratic"
    return True, ""


def supported_shapes(cfg: ArchConfig) -> list[str]:
    return [s for s in SHAPES if cell_supported(cfg, s)[0]]


def decode_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Sliding-window archs cap the decode cache at the window size."""
    if cfg.window is not None:
        return min(cfg.window, seq_len)
    return seq_len


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """Abstract inputs for the step function this shape runs (meta
    tensors).  Frontend-stubbed archs take ``(B, S, d_model)`` embeddings.

    train:   {"batch": {"inputs", "labels"}}
    prefill: {"inputs"}
    decode:  {"tokens", "state", "t"}   (state = KV caches / SSM states)
    """
    from ..models.model import init_decode_state
    s = SHAPES[shape]
    B, S = s.global_batch, s.seq_len
    if cfg.embedding_inputs:
        inputs = _sds((B, S, cfg.d_model), torch_dtype(cfg.dtype))
    else:
        inputs = _sds((B, S), torch.int32)
    if s.kind == "train":
        return {"batch": {"inputs": inputs,
                          "labels": _sds((B, S), torch.int32)}}
    if s.kind == "prefill":
        return {"inputs": inputs}
    cache_len = decode_cache_len(cfg, S)
    state = init_decode_state(cfg, B, cache_len, device="meta")
    return {"tokens": _sds((B,), torch.int32), "state": state,
            "t": _sds((), torch.int32)}
