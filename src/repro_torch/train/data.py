"""Deterministic synthetic data pipeline.

As the JAX package's ``repro/train/data.py``: the batch for global step
``s`` is a pure function of ``(seed, s, shard)`` (resume and replay are
exact, each data-parallel shard draws its own slice), Zipfian tokens with
a Markov "document" structure (with p = 0.5 a token repeats the previous
one shifted by one).  The port cannot draw ``jax.random``'s threefry bits:
each batch comes from a CPU ``torch.Generator`` seeded by
``numpy.random.SeedSequence([seed, step, shard])``, so the stream is the
same on the CPU and the card but not the JAX package's (ROADMAP C13); the
parity tests feed the JAX package's batches to both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_logits(cfg: DataConfig):
    ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float32)
    return -cfg.zipf_a * torch.log(ranks)


def _generator(seed: int, step: int, shard: int) -> torch.Generator:
    hi, lo = np.random.SeedSequence([int(seed), int(step), int(shard)]) \
        .generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(hi) << 32) | int(lo))


def _per_shard(cfg: DataConfig, n_shards: int) -> int:
    if cfg.global_batch % n_shards:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    return cfg.global_batch // n_shards


def batch_at(cfg: DataConfig, step, *, shard: int = 0, n_shards: int = 1,
             device="cuda"):
    """Batch for a global step (this shard's slice): int32 ``inputs`` and
    ``labels`` (the inputs shifted by one), (global_batch / n_shards,
    seq_len), on ``device``."""
    b = _per_shard(cfg, n_shards)
    g = _generator(cfg.seed, step, shard)
    probs = torch.softmax(_zipf_logits(cfg), dim=0)
    base = torch.multinomial(probs, b * (cfg.seq_len + 1), replacement=True,
                             generator=g).reshape(b, cfg.seq_len + 1)
    rep = torch.rand((b, cfg.seq_len + 1), generator=g) < 0.5
    prev = torch.roll(base, 1, dims=1)
    toks = torch.where(rep, (prev + 1) % cfg.vocab, base).to(torch.int32)
    return {"inputs": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def embedding_batch_at(cfg: DataConfig, d_model: int, step, *,
                       shard: int = 0, n_shards: int = 1,
                       dtype=torch.bfloat16, device="cuda"):
    """Frontend-stub variant: (B,S,D) embeddings + class labels."""
    b = _per_shard(cfg, n_shards)
    g = _generator(cfg.seed, step, shard + 977)
    emb = torch.randn((b, cfg.seq_len, d_model), generator=g)
    labels = torch.randint(0, cfg.vocab, (b, cfg.seq_len), generator=g)
    return {"inputs": emb.to(device=device, dtype=dtype),
            "labels": labels.to(device=device, dtype=torch.int32)}
