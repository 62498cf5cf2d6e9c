from . import kernel, ops
from .kernel import flash_attention_plain
from .ops import flash_attention

__all__ = ["kernel", "ops", "flash_attention", "flash_attention_plain"]
