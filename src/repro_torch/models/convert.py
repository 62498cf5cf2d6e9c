"""Parameter and state trees between numpy and the port.

:func:`params_from_numpy` takes a parameter tree as nested dicts of numpy
arrays (for instance the JAX package's ``init_model`` output passed through
``np.asarray`` leaf by leaf), so both packages compute with the same
weights; :func:`state_to_numpy` turns a decode state back into numpy, so
decode states can be compared leaf by leaf.  Neither imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import tree_map


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: reinterpret
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device=device, dtype=dtype if dtype is not None
                else t.dtype)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (in their own dtype, or ``dtype``)."""
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


def state_to_numpy(tree):
    """A tree of tensors (a decode state) -> numpy arrays on the host;
    bfloat16 leaves widen to float32 (numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(leaf, tree)
