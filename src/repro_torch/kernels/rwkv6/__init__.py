from . import kernel, ops
from .kernel import wkv6_scan, wkv6_scan_plain
from .ops import wkv6

__all__ = ["kernel", "ops", "wkv6", "wkv6_scan", "wkv6_scan_plain"]
