"""AdamW with warmup-cosine schedule and global-norm clipping.

The JAX package's optimizer (``repro/train/optimizer.py``) op for op, in
float32: the state mirrors the parameter tree.  :func:`update` writes the
parameters and the moments in place (the reference donates them to its
jitted step, ``donate_argnums``), a piece of at most ``PIECE`` elements at
a time, so its temporaries stay small beside a multi-GB leaf; every op is
elementwise, so the pieces give the bits of one pass.  Scalars that divide
are tensors on the parameters' device (torch on CUDA divides by a host
scalar as a multiply by its reciprocal).  ``DTensor`` parameters (the dry
run's) are updated shard by shard, each gradient first laid out as its
parameter.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..models.layers import tree_items, tree_map

F32 = torch.float32
PIECE = 1 << 24          # elements per in-place update piece (64 MB f32)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict
    v: dict


def init(params) -> OptState:
    dev = next(tree_items(params))[1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params))


def _const(x, like):
    return torch.tensor(x, dtype=F32, device=like.device)


def schedule(cfg: OptConfig, step):
    """Linear warmup → cosine decay to min_lr_frac·lr (a float32 tensor on
    ``step``'s device)."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.minimum(step / _const(max(cfg.warmup_steps, 1), step),
                         _const(1.0, step))
    prog = torch.clamp((step - cfg.warmup_steps) / _const(
        max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    """√(Σ over the leaves, in sorted-key order, of Σ x²), float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for _, x in tree_items(tree)))


def _local(x):
    """A ``DTensor``'s local shard (its storage: writes go through)."""
    return x.to_local() if isinstance(x, DTensor) else x


def _pieces(x):
    """Flat pieces of a contiguous tensor (views: writes go through)."""
    return x.view(-1).split(PIECE)


def update(cfg: OptConfig, grads, state: OptState, params):
    """One AdamW step.  Returns (params, new state, metrics); ``params``
    and the state's moments are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = torch.minimum(_const(1.0, gnorm), _const(cfg.clip_norm, gnorm)
                          / torch.clamp_min(gnorm, 1e-12))
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1 - torch.pow(_const(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_const(cfg.b2, stepf), stepf)
    gflat = dict(tree_items(grads))
    mflat, vflat = dict(tree_items(state.m)), dict(tree_items(state.v))
    scale, lr, b1c, b2c = map(_local, (scale, lr, b1c, b2c))
    for path, p in tree_items(params):
        grad = gflat[path]
        if isinstance(p, DTensor):     # each device updates its shard
            grad = grad.redistribute(p.device_mesh, p.placements)
        p, grad, m, v = map(_local, (p, grad, mflat[path], vflat[path]))
        for pp, gp, mp, vp in zip(_pieces(p), grad.reshape(-1).split(PIECE),
                                  _pieces(m), _pieces(v)):
            g = gp.to(F32) * scale
            mp.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            vp.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            mh = mp / b1c
            vh = vp / b2c
            p32 = pp.to(F32)
            step_p = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
            pp.copy_((p32 - lr * step_p).to(pp.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v), metrics
