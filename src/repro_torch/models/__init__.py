"""LM workload substrate: the JAX package's model definitions in PyTorch.

Ported so far: the serving path (``forward``, ``prefill``,
``decode_step``) of every family of the JAX package's block pattern: the
dense GQA families (dense, encoder, VLM backbone) and attention layers
through the ``flash_attention`` kernel (sliding window included), RWKV6
through the ``wkv6`` kernel, MoE (``moe``: sort-based capacity dispatch)
and Mamba (``ssm``: the selective scan) in plain tensor ops, as the
reference computes them outside Pallas; and the training loss
(``loss_fn``, per-period remat, chunked cross-entropy), which RWKV6
differentiates through the ``wkv6`` forward and ``wkv6_bwd`` kernels
(``repro_torch.train`` runs it).  ``abstract_model``/``model_axes`` give
the meta-tensor parameter tree and its logical axes, which the sharding
rules (``repro_torch.sharding``) lay out on a mesh; under a mesh context
the blocks constrain their activations as the reference does
(``shard_act``), and ``repro_torch.launch.dryrun`` reports every cell.
"""
from . import attention, convert, layers, moe, ssm, stacks
from .config import ArchConfig, Family, MambaSpec, MoESpec, RWKVSpec
from .model import (LM, abstract_model, decode_step, forward, forward_hidden,
                    init_decode_state, init_model, loss_fn, model_axes,
                    model_decls, prefill)

__all__ = [
    "attention", "convert", "layers", "moe", "ssm", "stacks",
    "ArchConfig", "Family", "MoESpec", "MambaSpec", "RWKVSpec", "LM",
    "abstract_model", "decode_step", "forward", "forward_hidden",
    "init_decode_state", "init_model", "loss_fn", "model_axes",
    "model_decls", "prefill",
]
