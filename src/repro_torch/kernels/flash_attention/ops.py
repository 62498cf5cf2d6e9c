"""Public wrapper with the JAX ``ops.flash_attention`` signature: model
layout ``(B, S, H, Dh)`` in and out (the kernel reads it through strides,
so no transposes).  The block sizes shape the plain version's schedule on
CPU tensors, which shrinks them to divisors of S and T; the CUDA kernel
tiles by 64 whatever they are."""
from __future__ import annotations

from .kernel import flash_attention as _flash_attention
from .kernel import flash_attention_plain


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, block_q: int = 512,
                    block_k: int = 512, interpret: bool | None = None):
    """q: (B, S, Hq, Dh); k/v: (B, T, Hkv, Dh) — model layout.

    ``interpret`` is the JAX signature's switch between the TPU kernel and
    its interpreter; here the tensors' device decides (CUDA: the kernel,
    CPU: its plain version), so it is accepted and not read.
    """
    del interpret
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    return _flash_attention(q, k, v, causal=causal, window=window)
