#!/usr/bin/env python3
"""A/B device time of the ``wkv6`` forward launches against another copy of
its source, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/rwkv6/csrc/wkv6.cu \\
        > chip_check/other_wkv6.cu
    python3 tools/ab_wkv6.py chip_check/other_wkv6.cu [ROUNDS]

Builds the other source with the package's flags (``kernels/_build``; a
source without a ``#define WKV6_CHUNK`` of its own is given this
checkout's), binds it under its own C signature (a source that names
``s_chk`` takes the kept-states pointer; an older one does not), and times
both on the same preallocated inputs and outputs at rwkv6-3b's prefill
shape (B 4, T 2048, 40 heads of 64, bf16 r/k/v, a non-zero initial state)
and its training shape (T 512), in turns other, this, this, other in every
round, each reading by ``chip_smoke.launch_ms``.  Prints the medians over
the rounds, their ratio, and whether the two agree bit for bit: the
serving launch (no kept states: y and the final state), and, where the
other source keeps states, the launch that keeps them, each at its own
interval (the states at the multiples of both intervals).
"""
from __future__ import annotations

import ctypes
import math
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(4, 2048, 40, 64), (4, 512, 40, 64)]     # (B, T, H, hs)


def build_other(path: pathlib.Path, name: str):
    """Another copy of a WKV6 source built with the package's flags as
    library ``name``: ``(the library, its kept-state interval)``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as wk
    m = re.search(r"^#define\s+WKV6_CHUNK\s+(\d+)", path.read_text(), re.M)
    _build.SOURCES[name] = path
    _build.LIBRARIES[name] = (name, () if m else _build.LIBRARIES["wkv6"][1])
    return _build.load(name), int(m.group(1)) if m else wk.CHUNK


def bind_other(path: pathlib.Path):
    """The other source's ``wkv6_launch``, its pointer count and its
    kept-state interval."""
    lib, chunk = build_other(path, "wkv6_ab_other")
    fn = lib.wkv6_launch
    n_ptr = 9 if "s_chk" in path.read_text() else 8
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, n_ptr, chunk


def closure(fn, n_ptr, ins, dtype, keep=None):
    """A launch of ``fn`` on ``ins`` into fresh outputs, keeping the state
    every ``keep`` steps if given; returns (launch, y, s, s_chk or None)."""
    import torch
    r = ins[0]
    B, T, H, hs = r.shape
    y = torch.empty((B, T, H, hs), dtype=torch.float32, device=r.device)
    s = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    s_chk = (None if keep is None else torch.empty(
        (B, H, -(-T // keep), hs, hs), dtype=torch.float32, device=r.device))
    ptrs = [x.data_ptr() for x in (*ins, y, s)] + (
        [None] * (n_ptr - 8) if keep is None else [s_chk.data_ptr()])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = fn(*ptrs, dtype, B, T, H, hs, stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
    return go, y, s, s_chk


def turns(a, b, rounds):
    """Device times of ``a`` and ``b`` in ``rounds`` rounds of
    ``chip_smoke.launch_ms([a, b, b, a])``, each round's two averaged."""
    import chip_smoke
    ta, tb = [], []
    for _ in range(rounds):
        x = chip_smoke.launch_ms([a, b, b, a])
        ta.append((x[0] + x[3]) / 2)
        tb.append((x[1] + x[2]) / 2)
    return ta, tb


def main(argv=None) -> int:
    import torch
    import chip_smoke
    from repro_torch.kernels.rwkv6 import kernel as wk
    argv = sys.argv[1:] if argv is None else argv
    other_src = pathlib.Path(argv[0]).resolve()
    rounds = int(argv[1]) if len(argv) > 1 else 11
    if not torch.cuda.is_available():
        print("ab_wkv6: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi(), flush=True)
    other, n_ptr, o_chunk = bind_other(other_src)
    this = wk._lib()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for B, T, H, hs in SHAPES:
        r, k, v = (torch.from_numpy(0.5 * rng.standard_normal(
            (B, T, H, hs)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(3))
        w = torch.from_numpy(rng.uniform(0.45, 0.95, (B, T, H, hs)).astype(
            np.float32)).to(dev)
        u = torch.from_numpy((0.3 * rng.standard_normal((H, hs))).astype(
            np.float32)).to(dev)
        s0 = torch.from_numpy((0.2 * rng.standard_normal(
            (B, H, hs, hs))).astype(np.float32)).to(dev)
        ins = (r, k, v, w, u, s0)
        a, ya, sa, _ = closure(other, n_ptr, ins, 1)
        b, yb, sb, _ = closure(this, 9, ins, 1)
        a(), b()
        torch.cuda.synchronize()
        same = torch.equal(ya, yb) and torch.equal(sa, sb)
        ta, tb = turns(a, b, rounds)
        ma, mb = float(np.median(ta)), float(np.median(tb))
        print(f"wkv6 serving launch at (B, T, H, hs) = {(B, T, H, hs)} bf16: "
              f"other ({other_src.name}) {chip_smoke.spread(ta)} ms, this "
              f"checkout {chip_smoke.spread(tb)} ms over {rounds} rounds "
              f"(other, this, this, other); this / other {mb / ma!r}; "
              f"y and final state bitwise equal: {same}", flush=True)
        if n_ptr == 9:
            a, _, _, ka = closure(other, 9, ins, 1, keep=o_chunk)
            b, _, _, kb = closure(this, 9, ins, 1, keep=wk.CHUNK)
            a(), b()
            torch.cuda.synchronize()
            both = math.lcm(o_chunk, wk.CHUNK)
            same = torch.equal(ka[:, :, ::both // o_chunk],
                               kb[:, :, ::both // wk.CHUNK])
            ta, tb = turns(a, b, rounds)
            ma, mb = float(np.median(ta)), float(np.median(tb))
            print(f"wkv6 launch keeping the states at {(B, T, H, hs)} bf16:"
                  f" other (every {o_chunk} steps, {ka.numel() * 4} bytes) "
                  f"{chip_smoke.spread(ta)} ms, this (every {wk.CHUNK}, "
                  f"{kb.numel() * 4} bytes) {chip_smoke.spread(tb)} ms; "
                  f"this / other {mb / ma!r}; the states every {both} steps"
                  f" bitwise equal: {same}", flush=True)
            del ka, kb
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
