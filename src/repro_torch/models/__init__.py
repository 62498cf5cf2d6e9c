"""LM workload substrate: the JAX package's model definitions in PyTorch.

Ported so far: the serving path (``forward``, ``prefill``,
``decode_step``) of the dense GQA families (dense, encoder, VLM backbone)
through the ``flash_attention`` kernel and of RWKV6 through the ``wkv6``
kernel.  MoE, Mamba and training wait for later slices (ROADMAP A9).
"""
from . import attention, convert, layers, ssm, stacks
from .config import ArchConfig, Family, MambaSpec, MoESpec, RWKVSpec
from .model import (LM, decode_step, forward, forward_hidden,
                    init_decode_state, init_model, model_decls, prefill)

__all__ = [
    "attention", "convert", "layers", "ssm", "stacks",
    "ArchConfig", "Family", "MoESpec", "MambaSpec", "RWKVSpec", "LM",
    "decode_step", "forward", "forward_hidden", "init_decode_state",
    "init_model", "model_decls", "prefill",
]
