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

Its gradient (training; the JAX package differentiates its ``lax.scan``)
is :class:`WKV6`, which ``wkv6_scan`` goes through whenever an input
requires grad: on the card its forward is the kernel with the state kept
every ``CHUNK`` steps (:func:`wkv6_fwd`) and its backward the hand-written
kernel ``csrc/wkv6_bwd.cu`` (:func:`wkv6_bwd`, counted in
``wkv6_bwd.launches``), which replays each ``CHUNK``-step sub-chunk's states
from the kept one into shared memory and walks it backwards; on the CPU
they are :func:`wkv6_scan_plain` and :func:`wkv6_bwd_plain`.  A CUDA tensor
never takes a plain version.
"""
from __future__ import annotations

import ctypes

import torch

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (4, 8, 16, 32, 64)
CHUNK = 4       # steps between the states kept for the backward; _build
                # passes it to both CUDA sources as WKV6_CHUNK


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


def wkv6_bwd_plain(r, k, v, w, u, s0, gy, gs=None):
    """Plain PyTorch gradient of :func:`wkv6_scan`: given ``gy`` = dL/dy
    (B, T, H, hs) and ``gs`` = dL/d(final state) (None: zeros), returns
    ``(gr, gk, gv, gw, gu, gs0)`` in float32 (gs0 = dL/ds0).  The states
    come from the forward's loop (the kernel's replay gives the same bits);
    then, from t = T - 1 down, with G = dL/dS_{t+1} and S_t the state
    before step t::

        gw_t = Σ_j G S_t          gk_t = Σ_j G v_t + u r_t (gy_t·v_t)
        gr_t = Σ_j gy_t S_t + u k_t (gy_t·v_t)
        gv_t = Σ_i k_t G + (Σ_i r_t u k_t) gy_t
        gu += r_t k_t (gy_t·v_t)  G ← w_t G + r_tᵀ gy_t

    in the kernel's op order; its sums over j and i run in another order,
    so G and gs0 are the kernel's bit for bit and the rest is not (gu adds
    over time per batch row, then over the batch in order, as the
    kernel)."""
    B, T, H, hs = r.shape
    uf = u.to(F32)
    S = (torch.zeros((B, H, hs, hs), dtype=F32, device=r.device)
         if s0 is None else s0.to(F32))
    states = []
    for t in range(T):
        states.append(S)
        k_t, v_t, w_t = (x[:, t].to(F32) for x in (k, v, w))
        kv = k_t[..., None] * v_t[..., None, :]
        S = w_t[..., None] * S + kv
    G = (torch.zeros((B, H, hs, hs), dtype=F32, device=r.device)
         if gs is None else gs.to(F32))
    grads = {n: [None] * T for n in ("r", "k", "v", "w")}
    gu_b = torch.zeros((B, H, hs), dtype=F32, device=r.device)
    for t in reversed(range(T)):
        r_t, k_t, v_t, w_t, gy_t = (x[:, t].to(F32)
                                    for x in (r, k, v, w, gy))
        S_t = states[t]
        dot = (gy_t * v_t).sum(-1)[..., None]
        grads["w"][t] = (G * S_t).sum(-1)
        grads["k"][t] = (G * v_t[..., None, :]).sum(-1) + uf * r_t * dot
        grads["r"][t] = (gy_t[..., None, :] * S_t).sum(-1) + uf * k_t * dot
        ruk = (r_t * uf * k_t).sum(-1)[..., None]
        grads["v"][t] = (k_t[..., None] * G).sum(-2) + ruk * gy_t
        gu_b = gu_b + r_t * k_t * dot
        G = w_t[..., None] * G + r_t[..., None] * gy_t[..., None, :]
    gu = _sum_batch(gu_b)
    out = [torch.stack(grads[n], dim=1) if T
           else torch.zeros((B, 0, H, hs), dtype=F32, device=r.device)
           for n in ("r", "k", "v", "w")]
    return (*out, gu, G)


def _sum_batch(part):
    """(B, ...) -> (...): the rows added in order, ((p_0 + p_1) + ...)."""
    if part.shape[0] == 0:
        return part.sum(0)
    out = part[0].clone()
    for b in range(1, part.shape[0]):
        out = out + part[b]
    return out


_LIB: list = []
_BWD_LIB: list = []


def _lib():
    """The built kernel's launch function, its C signature declared."""
    if not _LIB:
        from .. import _build
        fn = _build.load("wkv6").wkv6_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


def _bwd_lib():
    """The built backward kernel's launch function, its C signature
    declared."""
    if not _BWD_LIB:
        from .. import _build
        fn = _build.load("wkv6_bwd").wkv6_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        _BWD_LIB.append(fn)
    return _BWD_LIB[0]


def bwd_occupancy(dtype=torch.bfloat16, hs: int = 64) -> dict:
    """The backward kernel's residency on the current card for r/k/v of
    ``dtype`` and head size ``hs``: ``blocks_per_sm`` (the card's
    occupancy calculator), ``threads`` a block and dynamic shared
    ``smem_bytes``."""
    from .. import _build
    fn = _build.load("wkv6_bwd").wkv6_bwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(_DTYPES[dtype], hs, out)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd: occupancy query failed with CUDA "
                           f"error {err}")
    return dict(blocks_per_sm=out[0], threads=out[1], smem_bytes=out[2])


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


def _cuda_only(r):
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")


def _launch(r, k, v, w, u, s0, keep: bool):
    """The forward kernel on CUDA tensors: ``(y, s, s_chk or None)``."""
    _check(r, k, v, w, u, s0)
    B, T, H, hs = r.shape
    c = torch.Tensor.contiguous
    r, k, v = c(r), c(k), c(v)
    w, u = c(w.to(F32)), c(u.to(F32))
    s0 = None if s0 is None else c(s0.to(F32))
    y = torch.empty((B, T, H, hs), dtype=F32, device=r.device)
    s = torch.empty((B, H, hs, hs), dtype=F32, device=r.device)
    s_chk = (torch.empty((B, H, -(-T // CHUNK), hs, hs), dtype=F32,
                         device=r.device) if keep else None)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), None if s0 is None else s0.data_ptr(),
                     y.data_ptr(), s.data_ptr(),
                     None if s_chk is None else s_chk.data_ptr(),
                     _DTYPES[r.dtype], B, T, H, hs, stream)
    if err != 0:
        raise RuntimeError(f"wkv6: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6_scan.launches += 1
    return y, s, s_chk


def wkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w: (B, T, H, hs); u: (H, hs); s0: (B, H, hs, hs) f32 or None
    (zeros) -> ``(y (B, T, H, hs) f32, final state (B, H, hs, hs) f32)``.

    CUDA tensors launch the kernel (or raise): r, k, v in float32 or
    bfloat16, w, u and s0 read as float32 (cast here where they are not).
    CPU tensors take :func:`wkv6_scan_plain`.  When grad is enabled and an
    input requires it, the call goes through :class:`WKV6`.
    """
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        return WKV6.apply(r, k, v, w.to(F32), u.to(F32),
                          None if s0 is None else s0.to(F32))
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, w, u, s0)
    _cuda_only(r)
    y, s, _ = _launch(r, k, v, w, u, s0, keep=False)
    return y, s


wkv6_scan.launches = 0


def wkv6_fwd(r, k, v, w, u, s0=None):
    """The forward kernel as the backward needs it (CUDA tensors only):
    ``(y, final state, s_chk)``, where ``s_chk`` (B, H, ceil(T / CHUNK),
    hs, hs) holds the state before every step t that is a multiple of
    ``CHUNK`` (S_0 = s0 first).  Counted in ``wkv6_scan.launches``."""
    _cuda_only(r)
    return _launch(r, k, v, w, u, s0, keep=True)


def wkv6_bwd(r, k, v, w, u, s_chk, gy, gs=None):
    """The backward kernel ``csrc/wkv6_bwd.cu`` (CUDA tensors only): the
    forward's inputs, its kept states ``s_chk`` (:func:`wkv6_fwd`), ``gy``
    (B, T, H, hs) and ``gs`` (B, H, hs, hs) or None -> ``(gr, gk, gv, gw,
    gu, gs0)`` in float32, as :func:`wkv6_bwd_plain` gives them from s0.
    Deterministic: gu is added over the batch here, in order."""
    _cuda_only(r)
    _check(r, k, v, w, u, None)
    B, T, H, hs = r.shape
    if tuple(s_chk.shape) != (B, H, -(-T // CHUNK), hs, hs):
        raise ValueError(f"wkv6_bwd: s_chk must be (B, H, ceil(T / {CHUNK}),"
                         f" hs, hs), got {tuple(s_chk.shape)}")
    if tuple(gy.shape) != (B, T, H, hs):
        raise ValueError(f"wkv6_bwd: gy must be {(B, T, H, hs)}, got "
                         f"{tuple(gy.shape)}")
    if gs is not None and tuple(gs.shape) != (B, H, hs, hs):
        raise ValueError(f"wkv6_bwd: gs must be {(B, H, hs, hs)}, got "
                         f"{tuple(gs.shape)}")
    c = torch.Tensor.contiguous
    r, k, v = c(r), c(k), c(v)
    w, u, s_chk, gy = (c(x.to(F32)) for x in (w, u, s_chk, gy))
    if s_chk.data_ptr() % 16:          # the kernel copies it 16 bytes at once
        s_chk = s_chk.clone()
    gs = None if gs is None else c(gs.to(F32))
    dev = r.device
    gr, gk, gv, gw = (torch.empty((B, T, H, hs), dtype=F32, device=dev)
                      for _ in range(4))
    gu_part = torch.empty((B, H, hs), dtype=F32, device=dev)
    gs0 = torch.empty((B, H, hs, hs), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_lib()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s_chk.data_ptr(), gy.data_ptr(),
            None if gs is None else gs.data_ptr(), gr.data_ptr(),
            gk.data_ptr(), gv.data_ptr(), gw.data_ptr(), gu_part.data_ptr(),
            gs0.data_ptr(), _DTYPES[r.dtype], B, T, H, hs, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    return gr, gk, gv, gw, _sum_batch(gu_part), gs0


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """``wkv6_scan`` with its gradient.  ``apply(r, k, v, w, u, s0)`` (w, u
    and s0 in float32; s0 may be None) -> ``(y, final state)``.  CUDA: the
    forward kernel keeping the state every ``CHUNK`` steps, and the
    backward kernel; CPU: :func:`wkv6_scan_plain` and
    :func:`wkv6_bwd_plain`.  Gradients come back in each input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            y, s = wkv6_scan_plain(r, k, v, w, u, s0)
            ctx.save_for_backward(r, k, v, w, u, s0)
        else:
            y, s, s_chk = wkv6_fwd(r, k, v, w, u, s0)
            ctx.save_for_backward(r, k, v, w, u, s_chk)
        ctx.has_s0 = s0 is not None
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        r, k, v, w, u, saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(r.shape, dtype=F32, device=r.device)
        if r.device.type == "cpu":
            grads = wkv6_bwd_plain(r, k, v, w, u, saved, gy, gs)
        else:
            grads = wkv6_bwd(r, k, v, w, u, saved, gy, gs)
        gr, gk, gv, gw, gu, gs0 = grads
        return (gr.to(r.dtype), gk.to(k.dtype), gv.to(v.dtype),
                gw.to(w.dtype), gu.to(u.dtype),
                gs0 if ctx.has_s0 else None)
