"""Training loop: the train step, checkpoint/restart, straggler watchdog,
failure recovery (the JAX package's ``repro/train/trainer.py``).

Fault-tolerance contract:

* every ``ckpt_every`` steps the full (params, opt, data-step) state is
  committed atomically (``checkpoint.py``);
* a step that raises :class:`NodeFailure` restores the last committed
  state and replays: the data pipeline is a pure function of the step
  counter, so the replay repeats the lost steps;
* a step-walltime watchdog flags steps slower than ``straggler_factor``
  times the median of the last 50.

The step is eager PyTorch: ``loss_fn`` under autograd (per-period remat;
RWKV6 through the ``wkv6`` and ``wkv6_bwd`` kernels on the card), then
AdamW in place (the reference's jitted step donates its inputs).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..models import ArchConfig, init_model, loss_fn
from ..models.layers import torch_dtype, tree_from_items, tree_items
from . import checkpoint, data, optimizer


class NodeFailure(RuntimeError):
    """Raised (by the runtime or an injected fault hook) when a step loses
    a node; the loop restores the last committed checkpoint and replays."""


@dataclass
class TrainConfig:
    steps: int = 100
    seed: int = 0
    seq_len: int = 128
    global_batch: int = 8
    opt: optimizer.OptConfig = field(default_factory=optimizer.OptConfig)
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0     # step > factor x median -> flagged
    max_restarts: int = 3


def make_train_step(cfg: ArchConfig, opt_cfg: optimizer.OptConfig, *,
                    attn_impl: str = "auto", device="cuda"):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the batch is moved to ``device``, ``params`` and the
    moments are updated in place.  Metrics: ``loss``, ``grad_norm``, ``lr``
    (0-d tensors)."""
    dev = torch.device(device)

    def step(params, opt_state, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        paths, leaves = zip(*((path, leaf.detach().requires_grad_(True))
                              for path, leaf in tree_items(params)))
        with torch.enable_grad():
            loss = loss_fn(tree_from_items(zip(paths, leaves)), cfg, batch,
                           attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        del leaves
        params, opt_state, m = optimizer.update(
            opt_cfg, tree_from_items(zip(paths, grads)), opt_state, params)
        m["loss"] = loss.detach()
        return params, opt_state, m

    return step


def train(cfg: ArchConfig, tc: TrainConfig, *,
          fault_hook: Callable[[int], None] | None = None,
          resume: bool = True, device="cuda", params=None) -> dict:
    """Run the loop on ``device``.  ``fault_hook(step)`` may raise to
    simulate node loss (the loop restores the last checkpoint and
    replays).  ``params``, a parameter tree on ``device`` that the loop
    updates in place, is the starting point; by default ``init_model``
    draws one from a generator on ``device`` seeded with ``tc.seed``."""
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len,
                           global_batch=tc.global_batch, seed=tc.seed)
    opt_cfg = tc.opt.replace(total_steps=tc.steps)
    step_fn = make_train_step(cfg, opt_cfg, device=device)

    def batch_fn(s):
        if cfg.embedding_inputs:
            return data.embedding_batch_at(dcfg, cfg.d_model, s,
                                           dtype=torch_dtype(cfg.dtype),
                                           device=device)
        return data.batch_at(dcfg, s, device=device)

    if params is None:
        params = init_model(cfg,
                            torch.Generator(device).manual_seed(tc.seed),
                            device=device)
    opt_state = optimizer.init(params)
    start = 0
    if (resume and tc.ckpt_dir
            and checkpoint.latest_step(tc.ckpt_dir) is not None):
        start, (params, opt_state), _ = checkpoint.restore(
            tc.ckpt_dir, (params, opt_state), device=device)

    history = {"loss": [], "grad_norm": [], "straggler_steps": [],
               "restarts": 0, "resumed_at": start}
    times: list[float] = []
    s = start
    restarts = 0
    while s < tc.steps:
        t0 = time.perf_counter()
        try:
            if fault_hook is not None:
                fault_hook(s)
            batch = batch_fn(s)
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
        except NodeFailure:
            restarts += 1
            if restarts > tc.max_restarts or not tc.ckpt_dir:
                raise
            s, (params, opt_state), _ = checkpoint.restore(
                tc.ckpt_dir, (params, opt_state), device=device)
            history["restarts"] = restarts
            continue
        dt = time.perf_counter() - t0
        times.append(dt)
        med = float(np.median(times[-50:]))
        if len(times) > 5 and dt > tc.straggler_factor * med:
            history["straggler_steps"].append(s)
        history["loss"].append(loss)
        history["grad_norm"].append(float(m["grad_norm"]))
        s += 1
        if tc.ckpt_dir and (s % tc.ckpt_every == 0 or s == tc.steps):
            checkpoint.save(tc.ckpt_dir, s, (params, opt_state),
                            meta={"loss": loss})
    history["final_loss"] = history["loss"][-1] if history["loss"] else None
    return history
