#!/usr/bin/env python3
"""A/B device time of the ``wkv6`` serving launch against another copy of
its source, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/rwkv6/csrc/wkv6.cu \\
        > chip_check/other_wkv6.cu
    python3 tools/ab_wkv6.py chip_check/other_wkv6.cu [ROUNDS]

Builds the other source with the package's flags (``kernels/_build``),
binds it under its own C signature (a source that names ``s_chk`` takes
the kept-states pointer, which the serving launch passes as null; an older
one does not), and times both launches on the same preallocated inputs and
outputs at rwkv6-3b's prefill shape (B 4, T 2048, 40 heads of 64, bf16
r/k/v, a non-zero initial state) and its training shape (T 512), in turns
other, this, this, other in every round, each reading by
``chip_smoke.launch_ms``.  Prints the medians over the rounds, their ratio,
and whether the two give the same y and final state bit for bit.
"""
from __future__ import annotations

import ctypes
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(4, 2048, 40, 64), (4, 512, 40, 64)]     # (B, T, H, hs)


def bind_other(path: pathlib.Path):
    """The other source's ``wkv6_launch`` and its pointer count."""
    from repro_torch.kernels import _build
    name = "wkv6_ab_other"
    _build.SOURCES[name] = path
    _build.LIBRARIES[name] = (name, ())
    fn = _build.load(name).wkv6_launch
    n_ptr = 9 if "s_chk" in path.read_text() else 8
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, n_ptr


def closure(fn, n_ptr, ins, dtype):
    """A launch of ``fn`` on ``ins`` into fresh outputs; returns (launch,
    y, s)."""
    import torch
    r = ins[0]
    B, T, H, hs = r.shape
    y = torch.empty((B, T, H, hs), dtype=torch.float32, device=r.device)
    s = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    ptrs = [x.data_ptr() for x in (*ins, y, s)] + [None] * (n_ptr - 8)
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = fn(*ptrs, dtype, B, T, H, hs, stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
    return go, y, s


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
    other, n_ptr = bind_other(other_src)
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
        a, ya, sa = closure(other, n_ptr, ins, 1)
        b, yb, sb = closure(this, 9, ins, 1)
        a(), b()
        torch.cuda.synchronize()
        same = torch.equal(ya, yb) and torch.equal(sa, sb)
        ta, tb = [], []
        for _ in range(rounds):
            x = chip_smoke.launch_ms([a, b, b, a])
            ta.append((x[0] + x[3]) / 2)
            tb.append((x[1] + x[2]) / 2)
        ma, mb = float(np.median(ta)), float(np.median(tb))
        print(f"wkv6 serving launch at (B, T, H, hs) = {(B, T, H, hs)} bf16: "
              f"other ({other_src.name}) {chip_smoke.spread(ta)} ms, this "
              f"checkout {chip_smoke.spread(tb)} ms over {rounds} rounds "
              f"(other, this, this, other); this / other {mb / ma!r}; "
              f"y and final state bitwise equal: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
