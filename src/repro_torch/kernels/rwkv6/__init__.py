from . import kernel, ops
from .kernel import (WKV6, wkv6_bwd, wkv6_bwd_plain, wkv6_fwd, wkv6_scan,
                     wkv6_scan_plain)
from .ops import wkv6

__all__ = ["kernel", "ops", "WKV6", "wkv6", "wkv6_bwd", "wkv6_bwd_plain",
           "wkv6_fwd", "wkv6_scan", "wkv6_scan_plain"]
