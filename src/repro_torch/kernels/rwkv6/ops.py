"""Public wrapper with the JAX ``ops.wkv6`` signature (model layout
``(B, T, H, hs)``, zero initial state, ``y`` in r's dtype)."""
from __future__ import annotations

from .kernel import wkv6_scan


def wkv6(r, k, v, w, u):
    """r/k/v/w: (B, T, H, hs) (model layout); u: (H, hs) -> y (B, T, H, hs).

    The exact counterpart of the TPU kernel ``wkv6_bhts``: zero initial
    state, the final state dropped (the JAX signature's TPU tiling
    ``block_t`` and ``interpret`` switch have no counterpart: the kernel
    streams the whole sequence in one block per (batch, head), and the
    tensors' device picks kernel or plain version).
    """
    y, _ = wkv6_scan(r, k, v, w, u)
    return y.to(r.dtype)
