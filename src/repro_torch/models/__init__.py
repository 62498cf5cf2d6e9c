"""LM workload substrate: the JAX package's model definitions in PyTorch.

Ported so far: the serving path (``forward``, ``prefill``,
``decode_step``) of every family of the JAX package's block pattern: the
dense GQA families (dense, encoder, VLM backbone) and attention layers
through the ``flash_attention`` kernel (sliding window included), RWKV6
through the ``wkv6`` kernel, MoE (``moe``: sort-based capacity dispatch)
and Mamba (``ssm``: the selective scan) in plain tensor ops, as the
reference computes them outside Pallas.  Training, sharding and the launch
report wait for later slices (ROADMAP A9).
"""
from . import attention, convert, layers, moe, ssm, stacks
from .config import ArchConfig, Family, MambaSpec, MoESpec, RWKVSpec
from .model import (LM, decode_step, forward, forward_hidden,
                    init_decode_state, init_model, model_decls, prefill)

__all__ = [
    "attention", "convert", "layers", "moe", "ssm", "stacks",
    "ArchConfig", "Family", "MoESpec", "MambaSpec", "RWKVSpec", "LM",
    "decode_step", "forward", "forward_hidden", "init_decode_state",
    "init_model", "model_decls", "prefill",
]
