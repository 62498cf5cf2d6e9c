#!/usr/bin/env python3
"""A/B device time of the ``wkv6_bwd`` kernel against another copy of its
source, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu \\
        > chip_check/other_wkv6_bwd.cu
    python3 tools/ab_wkv6_bwd.py chip_check/other_wkv6_bwd.cu [ROUNDS]

Builds the other source as ``tools/ab_wkv6.py`` does and binds it under its
own C signature (a source whose launch takes a ``scratch`` pointer gets a
buffer of one chunk's states a (batch, head)).  Each kernel reads this
checkout's forward's kept states (``wkv6_fwd``) at the multiples of its own
interval, which must be a multiple of ``CHUNK`` (the forward's states are
the same bits at any interval).

At rwkv6-3b's training shape (B 4, T 512, 40 heads of 64, bf16 r/k/v, as
the model calls it: zero initial state, no final-state gradient) and at T
2048, both launches run on the same inputs into preallocated outputs, in
turns other, this, this, other in every round (``ab_wkv6.turns``).  Prints
the medians over the rounds, their ratio, and whether the outputs agree:
gs0 bit for bit, gr, gk, gv, gw and gu at ``chip_smoke.WKV_BWD_TOL``, this
kernel's second run bit for bit; then both kernels' ptxas reports at head
size 64 (``chip_smoke.ptxas_report``) and this kernel's resident blocks
per SM.
"""
from __future__ import annotations

import ctypes
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

SHAPES = [(4, 512, 40, 64), (4, 2048, 40, 64)]     # (B, T, H, hs)
OTHER = "wkv6_bwd_ab_other"


def bind_other(path: pathlib.Path):
    """The other source's ``wkv6_bwd_launch``, whether it takes a scratch
    buffer, and its kept-state interval."""
    import ab_wkv6
    lib, chunk = ab_wkv6.build_other(path, OTHER)
    text = path.read_text()
    decl = text[text.index('extern "C" int wkv6_bwd_launch'):]
    scratch = "scratch" in decl[:decl.index("{")]
    fn = lib.wkv6_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * (15 if scratch else 14)
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, scratch, chunk


def closure(fn, scratch, chunk, ins, s_chk_this):
    """A launch of a bound ``wkv6_bwd`` on ``ins`` into preallocated
    outputs; returns (launch, [gr, gk, gv, gw, gu_part, gs0])."""
    import torch
    from repro_torch.kernels.rwkv6 import kernel as wk
    r, k, v, w, u, gy = ins
    B, T, H, hs = r.shape
    if chunk % wk.CHUNK:
        raise ValueError(f"an interval of {chunk} steps is not a multiple "
                         f"of this forward's {wk.CHUNK}")
    s_chk = s_chk_this[:, :, ::chunk // wk.CHUNK].contiguous()
    dev = r.device
    outs = [torch.empty((B, T, H, hs), device=dev) for _ in range(4)]
    outs += [torch.empty((B, H, hs), device=dev),
             torch.empty((B, H, hs, hs), device=dev)]
    extra = ([torch.empty((B, H, chunk, hs, hs), device=dev)]
             if scratch else [])
    ptrs = ([x.data_ptr() for x in (r, k, v, w, u, s_chk, gy)] + [None]
            + [x.data_ptr() for x in extra + outs])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = fn(*ptrs, 1, B, T, H, hs, stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
    go.keep = (s_chk, extra)             # alive as long as the launch
    return go, outs


def agree(a_outs, b_outs):
    """``(gs0 bitwise, worst |diff| of gr..gu, worst share of the
    tolerance)`` between two launches' outputs."""
    import torch
    import chip_smoke
    from repro_torch.kernels.rwkv6 import kernel as wk
    pairs = list(zip(a_outs[:4], b_outs[:4]))
    pairs.append((wk._sum_batch(a_outs[4]), wk._sum_batch(b_outs[4])))
    worst = share = 0.0
    for x, y in pairs:
        e, s = chip_smoke._close(x, y, chip_smoke.WKV_BWD_TOL)
        worst, share = max(worst, e), max(share, s)
    return torch.equal(a_outs[5], b_outs[5]), worst, share


def main(argv=None) -> int:
    import torch
    import ab_wkv6
    import chip_smoke
    from repro_torch.kernels.rwkv6 import kernel as wk
    argv = sys.argv[1:] if argv is None else argv
    other_src = pathlib.Path(argv[0]).resolve()
    rounds = int(argv[1]) if len(argv) > 1 else 11
    if not torch.cuda.is_available():
        print("ab_wkv6_bwd: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi(), flush=True)
    fn, scratch, o_chunk = bind_other(other_src)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, T, H, hs in SHAPES:
        r, k, v = (torch.from_numpy(0.5 * rng.standard_normal(
            (B, T, H, hs)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(3))
        w = torch.from_numpy(rng.uniform(0.45, 0.95, (B, T, H, hs)).astype(
            np.float32)).to(dev)
        u = torch.from_numpy((0.3 * rng.standard_normal((H, hs))).astype(
            np.float32)).to(dev)
        gy = torch.from_numpy(rng.standard_normal((B, T, H, hs)).astype(
            np.float32)).to(dev)
        s0 = torch.zeros((B, H, hs, hs), device=dev)
        _, _, s_chk = wk.wkv6_fwd(r, k, v, w, u, s0)
        ins = (r, k, v, w, u, gy)
        a, a_outs = closure(fn, scratch, o_chunk, ins, s_chk)
        b, b_outs = closure(wk._bwd_lib(), False, wk.CHUNK, ins, s_chk)
        a(), b()
        torch.cuda.synchronize()
        same, worst, share = agree(a_outs, b_outs)
        first = [t.clone() for t in b_outs]
        b()
        torch.cuda.synchronize()
        again = all(torch.equal(x, y) for x, y in zip(first, b_outs))
        ta, tb = ab_wkv6.turns(a, b, rounds)
        ma, mb = float(np.median(ta)), float(np.median(tb))
        print(f"wkv6_bwd at (B, T, H, hs) = {(B, T, H, hs)} bf16: other "
              f"({other_src.name}, states every {o_chunk} steps) "
              f"{chip_smoke.spread(ta)} ms, this checkout (every "
              f"{wk.CHUNK}) {chip_smoke.spread(tb)} ms over {rounds} rounds"
              f" (other, this, this, other); this / other {mb / ma!r}; gs0 "
              f"bitwise equal: {same}; gr, gk, gv, gw, gu max |diff| "
              f"{worst!r} (share of tol {chip_smoke.WKV_BWD_TOL}: "
              f"{share:.3f}); this run twice bitwise: {again}", flush=True)
        del a, b, a_outs, b_outs, first, s_chk
        torch.cuda.empty_cache()
    print(f"ptxas at hs 64: other: {chip_smoke.ptxas_report(OTHER, 'Li64E')}"
          f" || this: {chip_smoke.ptxas_report('wkv6_bwd', 'Li64E')} || "
          f"this kernel at hs 64, bf16: "
          f"{wk.bwd_occupancy(torch.bfloat16, 64)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
