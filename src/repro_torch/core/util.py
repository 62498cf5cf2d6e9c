"""Small shared numeric utilities.

``pow2_pad``/``pow2_pads`` are the shape-rounding rule of the adaptive
schedule (the sweep's bucket task/VM paddings); ``fma32`` is the
single-rounding multiply-add the reference's XLA:CPU lowering performs.
"""
from __future__ import annotations

import numpy as np
import torch

# floor * 2**j ladder, precomputed far past any realistic padding; the
# table form makes the vectorized rounding exact (no float log2 edge
# cases at exact powers of two)
_MAX_DOUBLINGS = 50


def validate_pow2_floor(floor: int) -> int:
    """Reject nonsensical padding floors with ``ValueError``.

    The ``floor * 2**j`` ladder only makes sense for a positive
    power-of-two floor: zero/negative floors collapse the table to
    garbage (every pad rounds to 0) and a non-pow2 floor silently
    produces pads like 24 that defeat the compile-cache-friendly shape
    set the rounding exists to guarantee.  Every entry point that
    accepts a ``floor=`` kwarg funnels through here so the failure is
    loud at the call site, not downstream in a shape mismatch."""
    f = int(floor)
    if f < 1 or (f & (f - 1)) != 0:
        raise ValueError(
            f"pow2 padding floor must be a positive power of two, got "
            f"{floor!r}")
    return f


def pow2_pads(need, cap: int, floor: int = 4) -> np.ndarray:
    """Vectorized :func:`pow2_pad`: smallest ``floor * 2**j >= need``
    elementwise, clamped to ``cap``.  ``need`` may be any integer array;
    entries ``<= floor`` round to ``floor``, entries past ``cap`` clamp
    to ``cap`` (the grid-wide max or an explicit pad override)."""
    floor = validate_pow2_floor(floor)
    need = np.asarray(need, np.int64)
    table = floor * (np.int64(1) << np.arange(_MAX_DOUBLINGS, dtype=np.int64))
    idx = np.searchsorted(table, np.maximum(need, 1), side="left")
    return np.minimum(table[np.minimum(idx, _MAX_DOUBLINGS - 1)],
                      np.int64(cap))


def pow2_pad(need: int, cap: int, floor: int = 4) -> int:
    """Smallest of ``{floor, 2*floor, 4*floor, ...}`` that fits ``need``,
    clamped to ``cap``.  Power-of-two rounding keeps the set of compiled
    shapes small and stable across differently-composed grids/batches
    (compile-cache friendly)."""
    return int(pow2_pads(np.asarray([need]), cap, floor)[0])


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors with ONE rounding, as a fused
    multiply-add gives it (C's ``fmaf``).

    XLA:CPU contracts a multiply that feeds an add into an FMA, so the
    reference rounds once wherever its op sequence reads ``c + a * b``.
    The product of two float32 values is exact in float64; the float64 sum
    is corrected with its exact TwoSum error where it lands on a float32
    rounding midpoint, so the result is the correctly rounded float32 on
    any device.
    """
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r64 = r.double()
    r = torch.where((s == (r64 + up.double()) * 0.5) & (err > 0), up, r)
    return torch.where((s == (r64 + dn.double()) * 0.5) & (err < 0), dn, r)
