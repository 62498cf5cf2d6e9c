"""Architecture registry: the 10 assigned architectures (copies of the JAX
package's config files; pure data).

``get(name)`` accepts the hyphenated public ids; every config builds a
model of the port.
"""
from __future__ import annotations

from ..models.config import ArchConfig
from . import (hubert_xlarge, jamba_v0_1_52b, llama4_scout_17b_a16e,
               minitron_8b, mixtral_8x7b, pixtral_12b, rwkv6_3b,
               stablelm_1_6b, stablelm_12b, yi_6b)
from .shapes import (SHAPES, ShapeSpec, cell_supported, decode_cache_len,
                     input_specs, supported_shapes)

_MODULES = (yi_6b, stablelm_1_6b, minitron_8b, stablelm_12b, hubert_xlarge,
            pixtral_12b, jamba_v0_1_52b, mixtral_8x7b,
            llama4_scout_17b_a16e, rwkv6_3b)

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def arch_names() -> list[str]:
    return list(REGISTRY)


def all_cells() -> list[tuple[str, str]]:
    """Every supported (arch, shape) cell per the assignment rules."""
    return [(a, s) for a in REGISTRY for s in SHAPES
            if cell_supported(REGISTRY[a], s)[0]]


__all__ = ["REGISTRY", "get", "arch_names", "all_cells", "SHAPES",
           "ShapeSpec", "cell_supported", "decode_cache_len", "input_specs",
           "supported_shapes"]
