"""``wkv6_scan``: the RWKV6 WKV recurrence with an initial and a final state,
in the model layout ``(B, T, H, hs)``::

    y_t = r_t · (S + diag(u) k_tᵀ v_t)        S ← diag(w_t) S + k_tᵀ v_t

It replaces the JAX package's Pallas kernel ``kernels/rwkv6/kernel.py:
_kernel`` (via ``wkv6_bhts``), which ``models/ssm.py`` names as the
production path of ``_wkv_scan``; with ``s0`` and the final state it serves
prefill (T = S) and every decode step (T = 1).  Two forms, one state
update bit for bit (the kernel adds y's sum over i in partial sums):

* :func:`wkv6_scan_plain` — plain PyTorch, any device: ``_wkv_scan``'s step
  in a Python loop over T, f32 state.
* :func:`wkv6_scan` — the wrapper: a CUDA tensor launches the hand-written
  kernel ``csrc/wkv6.cu`` (built for ``sm_90a`` at first use), a CPU tensor
  takes the plain version.  ``wkv6_scan.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (4, 8, 16, 32, 64)


def wkv6_scan_plain(r, k, v, w, u, s0=None):
    """Plain PyTorch ``wkv6_scan``; arguments and result as
    :func:`wkv6_scan`."""
    B, T, H, hs = r.shape
    uf = u.to(F32)
    S = (torch.zeros((B, H, hs, hs), dtype=F32, device=r.device)
         if s0 is None else s0.to(F32))
    ys = []
    for t in range(T):
        r_t, k_t, v_t, w_t = (x[:, t].to(F32) for x in (r, k, v, w))
        kv = k_t[..., None] * v_t[..., None, :]             # (B,H,hs,hs)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, S + uf[..., None] * kv))
        S = w_t[..., None] * S + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, hs), dtype=F32, device=r.device))
    return y, S


_LIB: list = []


def _lib():
    """The built kernel's launch function, its C signature declared."""
    if not _LIB:
        from .. import _build
        fn = _build.load("wkv6").wkv6_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


def _check(r, k, v, w, u, s0):
    B, T, H, hs = r.shape
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"wkv6: r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError("wkv6: r, k, v, w must have one shape (B, T, H, hs)")
    if tuple(u.shape) != (H, hs):
        raise ValueError(f"wkv6: u must be (H, hs) = {(H, hs)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hs, hs):
        raise ValueError(f"wkv6: s0 must be (B, H, hs, hs) = "
                         f"{(B, H, hs, hs)}, got {tuple(s0.shape)}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: no kernel for head size {hs} "
                         f"({HEAD_SIZES})")
    devs = {x.device for x in (r, k, v, w, u) + ((s0,) if s0 is not None
                                                  else ())}
    if len(devs) != 1:
        raise ValueError(f"wkv6: tensors on several devices {devs}")


def wkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w: (B, T, H, hs); u: (H, hs); s0: (B, H, hs, hs) f32 or None
    (zeros) -> ``(y (B, T, H, hs) f32, final state (B, H, hs, hs) f32)``.

    CUDA tensors launch the kernel (or raise): r, k, v in float32 or
    bfloat16, w, u and s0 read as float32 (cast here where they are not).
    CPU tensors take :func:`wkv6_scan_plain`.
    """
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    _check(r, k, v, w, u, s0)
    B, T, H, hs = r.shape
    c = torch.Tensor.contiguous
    r, k, v = c(r), c(k), c(v)
    w, u = c(w.to(F32)), c(u.to(F32))
    s0 = None if s0 is None else c(s0.to(F32))
    y = torch.empty((B, T, H, hs), dtype=F32, device=r.device)
    s = torch.empty((B, H, hs, hs), dtype=F32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), None if s0 is None else s0.data_ptr(),
                     y.data_ptr(), s.data_ptr(), _DTYPES[r.dtype], B, T, H,
                     hs, stream)
    if err != 0:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6_scan.launches += 1
    return y, s


wkv6_scan.launches = 0
