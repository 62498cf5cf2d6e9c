"""Architecture configuration for the LM workload substrate (a copy of the
JAX package's ``models/config.py``: pure data).

One :class:`ArchConfig` describes every assigned architecture family:
dense decoder (llama-style GQA), encoder-only (hubert), VLM backbone
(pixtral), MoE (mixtral / llama4-scout), hybrid Mamba+attention+MoE (jamba)
and attention-free SSM (rwkv6).  Family-specific blocks are selected by
``block_pattern()``.

Modality frontends ([audio]/[vlm]) are STUBS by assignment: such configs
(``embedding_inputs``) take precomputed frame/patch embeddings, the
backbone here is the transformer itself.  The port serves every family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "encoder", "vlm", "moe", "hybrid", "ssm"]


@dataclass(frozen=True)
class MoESpec:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    every: int = 1            # MoE replaces the MLP every `every` layers
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> d_model // 16


@dataclass(frozen=True)
class RWKVSpec:
    head_size: int = 64
    decay_lora: int = 64      # rank of the data-dependent decay LoRA
    mix_lora: int = 32        # rank of the token-shift mix LoRA


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    rope_theta: float = 10_000.0
    window: int | None = None          # sliding-window attention (mixtral)
    attn_every: int = 1                # hybrid: attention layer period (jamba: 8)
    causal: bool = True                # False for encoder-only
    # family specs
    moe: MoESpec | None = None
    mamba: MambaSpec | None = None
    rwkv: RWKVSpec | None = None
    # numerics / structure
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    vocab_pad_to: int = 128            # pad vocab for sharding (Megatron-style)
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    kv_dtype: str | None = None        # decode KV cache dtype (serving
                                       # memory knob; None -> dtype)
    # frontend stub ([audio]/[vlm]): inputs are embeddings, not token ids
    embedding_inputs: bool = False

    @property
    def head_dim(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        """Can run the 500k-token long-context decode shape."""
        return (self.family in ("ssm", "hybrid")
                or self.window is not None)

    def block_pattern(self) -> list[dict]:
        """Per-layer block description: mixer kind + mlp kind."""
        out = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "rwkv"
            elif self.family == "hybrid":
                # jamba: 1 attention layer per attn_every (at the middle
                # slot of each period, per the paper's 1:7 interleave)
                mixer = ("attn" if i % self.attn_every
                         == self.attn_every // 2 else "mamba")
            else:
                mixer = "attn"
            if self.moe is not None and i % self.moe.every == (
                    self.moe.every - 1):
                mlp = "moe"
            elif self.family == "ssm":
                mlp = "rwkv_cmix"
            else:
                mlp = "mlp"
            out.append({"mixer": mixer, "mlp": mlp})
        return out

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, *, n_layers: int = 2, d_model: int = 64,
                n_heads: int | None = None, d_ff: int = 128,
                vocab: int = 256, **kw) -> "ArchConfig":
        """Smoke-test-sized config of the same family (CPU-runnable)."""
        if n_heads is None:
            n_heads = 0 if self.n_heads == 0 else 4
        kv = 0 if self.n_kv_heads == 0 else min(self.n_kv_heads, max(n_heads // 2, 1))
        changes: dict = dict(
            name=self.name + "-reduced", n_layers=n_layers, d_model=d_model,
            n_heads=n_heads, n_kv_heads=kv, d_ff=d_ff, vocab=vocab,
            vocab_pad_to=8)
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4))
        if self.mamba is not None:
            changes["mamba"] = dataclasses.replace(
                self.mamba, d_state=8, d_conv=4, expand=2, dt_rank=8)
        if self.rwkv is not None:
            changes["rwkv"] = dataclasses.replace(
                self.rwkv, head_size=16, decay_lora=8, mix_lora=8)
        if self.attn_every > 1:
            changes["attn_every"] = min(self.attn_every, max(n_layers, 2))
        if self.window is not None:
            changes["window"] = kw.pop("window", 32)
        changes.update(kw)
        return self.replace(**changes)
