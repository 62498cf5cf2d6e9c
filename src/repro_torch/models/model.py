"""Top-level model: embedding → stack → head, loss, prefill/decode.

Plain functions on tensors take the JAX package's nested parameter dict
(:func:`forward`, :func:`loss_fn`, :func:`prefill`, :func:`decode_step`,
...), so tests compare like with like; :class:`LM` owns such a tree as an
``nn.Module`` for serving (its methods run under ``inference_mode``;
training calls the plain functions on a tree whose leaves require grad).
Frontend-stubbed archs (``cfg.embedding_inputs``) take ``(B, S, d_model)``
embeddings instead of token ids.  Every block family runs: attention
(dense, sliding window), MoE, Mamba and RWKV6 (``stacks``).  Entry points
that allocate take ``device=`` and default to ``"cuda"``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..sharding.rules import (batch_only, remat_contexts, shard_act,
                              sharded_dims, take_last)
from . import stacks
from .config import ArchConfig
from .layers import (abstract_params, apply_norm, embed_decls, embed_tokens,
                     init_params, lm_head, norm_decls, param_axes,
                     torch_dtype, tree_items)


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


def abstract_model(cfg: ArchConfig):
    """Meta-tensor param tree — the no-allocation dry-run input."""
    return abstract_params(model_decls(cfg), cfg.param_dtype)


def model_axes(cfg: ArchConfig):
    """Logical-axis tree mirroring the params (for sharding rules)."""
    return param_axes(model_decls(cfg))


def _embed(params, cfg: ArchConfig, inputs):
    if cfg.embedding_inputs:
        return inputs.to(torch_dtype(cfg.dtype))
    return embed_tokens(params["embed"], inputs, cfg)


def forward_hidden(params, cfg: ArchConfig, inputs, *,
                   attn_impl: str = "auto", remat: bool = True):
    """Final-normed hidden states (B,S,D) — the LM head is applied by the
    caller (``loss_fn`` fuses it into chunked cross-entropy).  ``remat``
    acts under grad only (``stacks.apply_stack``)."""
    x = shard_act(_embed(params, cfg, inputs), ("batch", "seq", "embed"))
    x = stacks.apply_stack(params["stack"], x, cfg, attn_impl=attn_impl,
                           remat=remat)
    return apply_norm(params["final_norm"], x, cfg)


def forward(params, cfg: ArchConfig, inputs, *, attn_impl: str = "auto",
            remat: bool = True):
    """Logits for a full sequence.  inputs: (B,S) int or (B,S,D) embeds."""
    return shard_act(
        lm_head(params["embed"],
                forward_hidden(params, cfg, inputs, attn_impl=attn_impl,
                               remat=remat), cfg),
        ("batch", "seq", "vocab"))


def _xent_chunk(params, cfg: ArchConfig, xc, lc):
    """Σ nll over one sequence chunk and its labelled count.  xc: (B,ck,D);
    lc: (B,ck), -1 = unlabelled."""
    logits = shard_act(lm_head(params["embed"], xc, cfg),
                       ("batch", "seq", "vocab")).to(torch.float32)
    mask = lc >= 0
    idx = torch.clamp_min(lc, 0).to(torch.int64)
    if logits.dim() - 1 in sharded_dims(logits):
        # vocab split over the mesh: the softmax's max and sum reduced
        # across the shards (to batch-split values), each shard picking
        # the labels it holds
        z = logits - batch_only(logits.detach().amax(dim=-1, keepdim=True))
        ll = (batch_only(take_last(z, idx))
              - torch.log(batch_only(torch.exp(z).sum(dim=-1))))
    else:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    return -torch.sum(torch.where(mask, ll, 0.0)), torch.sum(mask)


def loss_fn(params, cfg: ArchConfig, batch, *, attn_impl: str = "auto",
            remat: bool = True, xent_chunk: int = 512):
    """Mean next-token (or masked-label) cross-entropy.  batch:
    {"inputs": ids or embeds, "labels": (B,S) int, -1 = unlabelled}.

    As the reference: the LM head and softmax run in sequence chunks of
    ``xent_chunk`` when it divides S (and S is longer), each chunk
    rematerialised under grad, the chunks' sums added in order; otherwise
    over the whole sequence at once.
    """
    x = forward_hidden(params, cfg, batch["inputs"], attn_impl=attn_impl,
                       remat=remat)
    labels = batch["labels"]
    S = labels.shape[1]
    ck = xent_chunk
    if S > ck and S % ck == 0:
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        n = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, S, ck):
            xc, lc = x[:, c0:c0 + ck], labels[:, c0:c0 + ck]
            if torch.is_grad_enabled():
                nll_c, n_c = checkpoint(_xent_chunk, params, cfg, xc, lc,
                                        use_reentrant=False,
                                        context_fn=remat_contexts)
            else:
                nll_c, n_c = _xent_chunk(params, cfg, xc, lc)
            nll, n = nll + nll_c, n + n_c
    else:
        nll, n = _xent_chunk(params, cfg, x, labels)
    return nll / torch.clamp_min(n, 1)


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
