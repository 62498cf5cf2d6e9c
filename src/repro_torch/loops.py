"""Python loops over identical steps: the port's ``lax.scan``.

:func:`scan` runs ``carry, y = step(carry, i)`` for ``i`` in ``range(n)``
and returns the last carry and the list of ``y``s.  The time loops (Mamba,
the WKV6 plain versions) and chunked attention's block loops go through
it, because their steps do the same work on tensors of the same shapes,
which lets a caller that only counts work (the dry run,
``launch.dryrun``) run two steps and count the rest as copies of the
second: it installs a sampler with :func:`sampling`.  Without one, every
step runs.
"""
from __future__ import annotations

from contextlib import contextmanager

_SAMPLER = None


def scan(step, carry, n: int):
    """``(carry, [y_0, ..., y_{n-1}])`` of ``n`` steps ``carry, y =
    step(carry, i)``."""
    if _SAMPLER is not None and n > 2:
        return _SAMPLER(step, carry, n)
    ys = []
    for i in range(n):
        carry, y = step(carry, i)
        ys.append(y)
    return carry, ys


@contextmanager
def sampling(sampler):
    """Within: :func:`scan` of more than two steps returns ``sampler(step,
    carry, n)``."""
    global _SAMPLER
    prev, _SAMPLER = _SAMPLER, sampler
    try:
        yield
    finally:
        _SAMPLER = prev
