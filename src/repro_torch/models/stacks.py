"""Layer stacks: a Python loop over the stacked ``layers`` axis.

Parameters are stacked on a leading ``layers`` axis per sub-block of the
block pattern's smallest repeating period, as in the JAX package (whose
``lax.scan`` over that axis becomes a loop here).  Under grad,
:func:`apply_stack` rematerialises as the reference's ``jax.checkpoint``
does: each period is a ``torch.utils.checkpoint`` region (non-reentrant),
and each sub-block of a heterogeneous period (jamba) one inside it, so the
backward keeps the periods' inputs and one period's (sub-block's)
internals; serving (no grad) runs the plain loop.  Decode states are
stacked the same way and updated in place.  Every block kind of the JAX
package is here: mixers ``attn``, ``mamba``, ``rwkv``; mlps ``mlp``,
``moe``, ``rwkv_cmix`` (jamba's period: 8 sub-blocks, one attention among
seven Mamba mixers and MoE every other one).
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..sharding.rules import (batch_only_grad, gather_weights,
                              remat_contexts, shard_act)
from . import attention, moe, ssm
from .config import ArchConfig
from .layers import (apply_mlp, apply_norm, mlp_decls, norm_decls,
                     stack_decls, torch_dtype, tree_from_items, tree_items,
                     tree_map)


def _pattern_period(cfg: ArchConfig) -> list[dict]:
    pat = cfg.block_pattern()
    for p in range(1, len(pat) + 1):
        if len(pat) % p == 0 and pat == pat[:p] * (len(pat) // p):
            return pat[:p]
    return pat


MIXER_DECLS = {"attn": attention.attn_decls, "mamba": ssm.mamba_decls,
               "rwkv": ssm.rwkv_tmix_decls}
MLP_DECLS = {"mlp": mlp_decls, "moe": moe.moe_decls,
             "rwkv_cmix": ssm.rwkv_cmix_decls}


def sub_block_decls(cfg: ArchConfig, entry: dict) -> dict:
    return {
        "norm1": norm_decls(cfg),
        "mixer": MIXER_DECLS[entry["mixer"]](cfg),
        "norm2": norm_decls(cfg),
        "mlp": MLP_DECLS[entry["mlp"]](cfg),
    }


def stack_param_decls(cfg: ArchConfig) -> dict:
    """{"sub{i}": decls} stacked over n_layers/period periods."""
    period = _pattern_period(cfg)
    if not period:                       # 0-layer variant
        return {}
    n_periods = cfg.n_layers // len(period)
    return {
        f"sub{i}": stack_decls(sub_block_decls(cfg, e), n_periods)
        for i, e in enumerate(period)
    }


def _layer(tree, li: int):
    """Layer ``li``'s slice of a stacked tree (views)."""
    return tree_map(lambda a: a[li], tree)


def _n_periods(params: dict) -> int:
    return next(iter(tree_items(params)))[1].shape[0]


def _apply_mixer(p, h, cfg: ArchConfig, entry: dict, positions,
                 attn_impl: str):
    """A sub-block's mixer on its normed input h (full sequence)."""
    if entry["mixer"] == "attn":
        return attention.apply_attention(p, h, cfg, positions,
                                         impl=attn_impl)
    if entry["mixer"] == "mamba":
        return ssm.apply_mamba(p, h, cfg)
    return ssm.apply_rwkv_tmix(p, h, cfg)


def _apply_mlp_block(p, h, cfg: ArchConfig, entry: dict):
    if entry["mlp"] == "mlp":
        return apply_mlp(p, h, cfg)
    if entry["mlp"] == "moe":
        return moe.apply_moe(p, h, cfg)
    return ssm.apply_rwkv_cmix(p, h, cfg)


def _apply_sub_block(p, x, cfg: ArchConfig, entry: dict, positions,
                     attn_impl: str):
    p = gather_weights(p, x.shape[0])
    # constraint on the *bf16* norm output anchors the SP->TP gather on
    # the cast tensor, as in the reference
    h = shard_act(apply_norm(p["norm1"], x, cfg), ("batch", "seq", "embed"))
    x = x + batch_only_grad(
        _apply_mixer(p["mixer"], h, cfg, entry, positions, attn_impl))
    h = apply_norm(p["norm2"], x, cfg)
    return x + batch_only_grad(_apply_mlp_block(p["mlp"], h, cfg, entry))


def _unbind(tree):
    """A stacked tree -> one tree per layer (views).  One ``unbind`` per
    leaf, so its gradient is one stack of the per-layer gradients, not a
    full-size zero tensor per layer as indexing gives."""
    paths, per = zip(*((path, leaf.unbind(0))
                       for path, leaf in tree_items(tree)))
    return [tree_from_items(zip(paths, parts)) for parts in zip(*per)]


def apply_stack(params: dict, x, cfg: ArchConfig, positions=None, *,
                attn_impl: str = "auto", remat: bool = True):
    """Full-sequence forward through all layers.  x: (B,S,D).  ``remat``
    (under grad only): checkpoint each period, and each sub-block of a
    heterogeneous period, as the reference's ``jax.checkpoint``s."""
    period = _pattern_period(cfg)
    if not period:
        return shard_act(x, ("batch", "seq", "embed"))
    remat = remat and torch.is_grad_enabled()
    nested = remat and len(period) > 1
    layers = {f"sub{i}": _unbind(params[f"sub{i}"])
              for i in range(len(period))}

    def one_period(x, pparams):
        x = shard_act(x, ("batch", "seq", "embed"))   # SP residual stream
        for i, entry in enumerate(period):
            fn = functools.partial(_apply_sub_block, cfg=cfg, entry=entry,
                                   positions=positions, attn_impl=attn_impl)
            if nested:
                fn = functools.partial(checkpoint, fn, use_reentrant=False,
                                       context_fn=remat_contexts)
            x = fn(pparams[f"sub{i}"], x)
        return x

    for li in range(_n_periods(params)):
        pparams = {key: per[li] for key, per in layers.items()}
        if remat:
            x = checkpoint(one_period, x, pparams, use_reentrant=False,
                           context_fn=remat_contexts)
        else:
            x = one_period(x, pparams)
    return x


# ---------------------------------------------------------------------------
# Decode: per-layer recurrent state threading
# ---------------------------------------------------------------------------

def init_stack_state(cfg: ArchConfig, batch: int, cache_len: int,
                     device="cuda") -> dict:
    """Stacked per-period decode states (KV caches / SSM states)."""
    period = _pattern_period(cfg)
    if not period:
        return {}
    n_periods = cfg.n_layers // len(period)

    def stacked(leaves):
        def stack(a):
            return a.expand((n_periods,) + a.shape).clone()
        return (tree_map(stack, leaves) if isinstance(leaves, dict)
                else stack(leaves))

    state = {}
    for i, entry in enumerate(period):
        sub = {}
        if entry["mixer"] == "attn":
            sub["mixer"] = stacked(attention.init_kv_cache(
                cfg, batch, cache_len, device=device))
        elif entry["mixer"] == "mamba":
            sub["mixer"] = stacked(ssm.init_mamba_state(cfg, batch,
                                                        device=device))
        else:
            sub["mixer"] = stacked(ssm.init_rwkv_state(cfg, batch,
                                                       device=device))
        if entry["mlp"] == "rwkv_cmix":
            sub["mlp"] = stacked(torch.zeros(
                (batch, cfg.d_model), dtype=torch_dtype(cfg.dtype),
                device=device))
        state[f"sub{i}"] = sub
    return state


def _prefill_sub_block(p, x, cfg: ArchConfig, entry: dict, cache_len: int,
                       attn_impl: str):
    p = gather_weights(p, x.shape[0])
    h = apply_norm(p["norm1"], x, cfg)
    new = {}
    if entry["mixer"] == "attn":
        out, new["mixer"] = attention.prefill_attention(
            p["mixer"], h, cfg, cache_len, impl=attn_impl)
    elif entry["mixer"] == "mamba":
        out, new["mixer"] = ssm.apply_mamba(p["mixer"], h, cfg,
                                            return_state=True)
    else:
        out, new["mixer"] = ssm.apply_rwkv_tmix(p["mixer"], h, cfg,
                                                return_state=True)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg)
    if entry["mlp"] == "rwkv_cmix":
        # cmix token-shift decode state = last token of the cmix input h
        new["mlp"] = h[:, -1]
    return x + _apply_mlp_block(p["mlp"], h, cfg, entry), new


def _stack_states(states: list):
    """A list of per-layer state trees -> one tree stacked on axis 0."""
    first = states[0]
    if isinstance(first, dict):
        return {k: _stack_states([s[k] for s in states]) for k in first}
    return torch.stack(states)


def prefill_stack(params: dict, x, cfg: ArchConfig, cache_len: int, *,
                  attn_impl: str = "auto"):
    """Full-sequence forward that also returns stacked decode states."""
    period = _pattern_period(cfg)
    if not period:
        return x, {}
    per_layer = []
    for li in range(_n_periods(params)):
        new_st = {}
        for i, entry in enumerate(period):
            x, new_st[f"sub{i}"] = _prefill_sub_block(
                _layer(params[f"sub{i}"], li), x, cfg, entry, cache_len,
                attn_impl)
        per_layer.append(new_st)
    return x, _stack_states(per_layer)


def _step_sub_block(p, x, st, cfg: ArchConfig, entry: dict, t: int):
    p = gather_weights(p, x.shape[0])
    h = apply_norm(p["norm1"], x, cfg)
    new = {}
    if entry["mixer"] == "attn":
        out, new["mixer"] = attention.decode_attention(p["mixer"], h,
                                                       st["mixer"], cfg, t)
    elif entry["mixer"] == "mamba":
        out, new["mixer"] = ssm.mamba_step(p["mixer"], h, st["mixer"], cfg)
    else:
        out, new["mixer"] = ssm.rwkv_tmix_step(p["mixer"], h, st["mixer"],
                                               cfg)
    x = x + out
    h = apply_norm(p["norm2"], x, cfg)
    if entry["mlp"] == "rwkv_cmix":
        out, new["mlp"] = ssm.rwkv_cmix_step(p["mlp"], h, st["mlp"], cfg)
        return x + out, new
    return x + _apply_mlp_block(p["mlp"], h, cfg, entry), new


def _write_back(dst, li: int, new) -> None:
    """Store layer ``li``'s new state into the stacked tree ``dst`` (a
    leaf that is already the stacked tensor's view is left alone)."""
    for path, leaf in tree_items(new):
        node = dst
        for key in path[:-1]:
            node = node[key]
        slot = node[path[-1]][li]
        if not _same_memory(leaf, slot):
            slot.copy_(leaf)


def _same_memory(a, b) -> bool:
    """Whether two tensors (or ``DTensor``s' local shards) view the same
    memory at the same offset."""
    a, b = (x.to_local() if isinstance(x, DTensor) else x for x in (a, b))
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def step_stack(params: dict, x, state: dict, cfg: ArchConfig, t: int):
    """One-token decode through all layers.  x: (B,1,D); t: position.
    ``state`` is updated in place and returned."""
    period = _pattern_period(cfg)
    if not period:
        return x, state
    for li in range(_n_periods(params)):
        for i, entry in enumerate(period):
            key = f"sub{i}"
            x, new = _step_sub_block(_layer(params[key], li), x,
                                     _layer(state[key], li), cfg, entry, t)
            _write_back(state[key], li, new)
    return x, state
