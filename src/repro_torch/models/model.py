"""Top-level model: embedding → stack → head, prefill/decode.

Plain functions on tensors take the JAX package's nested parameter dict
(:func:`forward`, :func:`prefill`, :func:`decode_step`, ...), so tests
compare like with like; :class:`LM` owns such a tree as an ``nn.Module``.
Frontend-stubbed archs (``cfg.embedding_inputs``) take ``(B, S, d_model)``
embeddings instead of token ids.  Every block family runs: attention
(dense, sliding window), MoE, Mamba and RWKV6 (``stacks``).  Entry points
that allocate take ``device=`` and default to ``"cuda"``.  ``loss_fn``
waits for the training slice (ROADMAP A9).
"""
from __future__ import annotations

import torch
from torch import nn

from . import stacks
from .config import ArchConfig
from .layers import (apply_norm, embed_decls, embed_tokens, init_params,
                     lm_head, norm_decls, torch_dtype, tree_items)


def model_decls(cfg: ArchConfig) -> dict:
    return {
        "embed": embed_decls(cfg),
        "stack": stacks.stack_param_decls(cfg),
        "final_norm": norm_decls(cfg),
    }


def init_model(cfg: ArchConfig, generator: torch.Generator | None = None,
               device="cuda"):
    """A random parameter tree (the JAX package's distributions, drawn from
    ``generator``; default: a generator on ``device`` seeded with 0)."""
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return init_params(model_decls(cfg), generator, cfg.param_dtype,
                       device=device)


def _embed(params, cfg: ArchConfig, inputs):
    if cfg.embedding_inputs:
        return inputs.to(torch_dtype(cfg.dtype))
    return embed_tokens(params["embed"], inputs, cfg)


def forward_hidden(params, cfg: ArchConfig, inputs, *,
                   attn_impl: str = "auto"):
    """Final-normed hidden states (B,S,D)."""
    x = stacks.apply_stack(params["stack"], _embed(params, cfg, inputs), cfg,
                           attn_impl=attn_impl)
    return apply_norm(params["final_norm"], x, cfg)


def forward(params, cfg: ArchConfig, inputs, *, attn_impl: str = "auto"):
    """Logits for a full sequence.  inputs: (B,S) int or (B,S,D) embeds."""
    return lm_head(params["embed"],
                   forward_hidden(params, cfg, inputs, attn_impl=attn_impl),
                   cfg)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    return stacks.init_stack_state(cfg, batch, cache_len, device=device)


def prefill(params, cfg: ArchConfig, inputs, cache_len: int, *,
            attn_impl: str = "auto"):
    """Returns (last-position logits (B, vocab), decode state)."""
    x, state = stacks.prefill_stack(params["stack"],
                                    _embed(params, cfg, inputs), cfg,
                                    cache_len, attn_impl=attn_impl)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_head(params["embed"], x[:, -1:], cfg)[:, 0], state


def decode_step(params, cfg: ArchConfig, tokens, state, t: int):
    """One decode step.  tokens: (B,) int; t: their position (an int).

    Returns (logits (B, vocab), state); the state is updated in place.
    """
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    x, state = stacks.step_stack(params["stack"], x, state, cfg, t)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_head(params["embed"], x, cfg)[:, 0], state


class LM(nn.Module):
    """A model that owns its parameter tree (``requires_grad=False``).

    ``LM(cfg, params)`` adopts a tree (e.g. from
    ``convert.params_from_numpy``); ``LM(cfg, device=..., generator=...)``
    draws one with :func:`init_model`.  ``self.params`` is the nested dict
    the functions above take; its leaves are this module's parameters.
    """

    def __init__(self, cfg: ArchConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_model(cfg, generator, device)
        self.params: dict = {}
        for path, leaf in tree_items(params):
            param = nn.Parameter(leaf, requires_grad=False)
            self.register_parameter("__".join(path), param)
            node = self.params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = param

    @torch.inference_mode()
    def forward(self, inputs, *, attn_impl: str = "auto"):
        return forward(self.params, self.cfg, inputs, attn_impl=attn_impl)

    @torch.inference_mode()
    def prefill(self, inputs, cache_len: int, *, attn_impl: str = "auto"):
        return prefill(self.params, self.cfg, inputs, cache_len,
                       attn_impl=attn_impl)

    @torch.inference_mode()
    def decode_step(self, tokens, state, t: int):
        return decode_step(self.params, self.cfg, tokens, state, t)

    def init_decode_state(self, batch: int, cache_len: int):
        device = next(self.parameters()).device
        return init_decode_state(self.cfg, batch, cache_len, device=device)
