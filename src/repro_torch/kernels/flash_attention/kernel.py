"""``flash_attention``: causal / sliding-window GQA attention with an online
softmax, in the model layout ``(B, S, H, Dh)``.

It replaces the JAX package's Pallas kernel ``kernels/flash_attention/
kernel.py:_kernel`` (via ``flash_attention_bhsd``).  Two forms, one
recurrence:

* :func:`flash_attention_plain` — plain PyTorch, any device: the TPU
  kernel's schedule on ``(block_q, block_k)`` blocks (blocks that the
  causal / window rule leaves without a live entry are skipped), f32
  ``m, l, acc``, masked scores ``-1e30`` with ``m`` starting at ``-inf``, p
  kept f32 in the PV product, output ``acc / max(l, 1e-30)``.
* :func:`flash_attention` — the wrapper: a CUDA tensor launches the
  hand-written kernel ``csrc/flash_attention.cu`` (built for ``sm_90a`` at
  first use; its own tiles of 64 q rows by 64 keys in float32 and 32 keys
  in bfloat16; head dims up to :data:`MAX_HEAD_DIM` = 160, each run in the
  smallest of the instantiations 16, 32, 64, 80, 128 and 160 that holds
  it), a CPU tensor takes the plain version (any head dim).
  float32 runs on the CUDA cores and agrees with the plain version up to
  summation order; bfloat16 runs on the tensor cores (``mma.sync``, p
  split into a bf16 hi/lo pair in PV) and is held to 2 bf16 ulps
  (:func:`bf16_ulp`) plus a small absolute floor.
  ``flash_attention.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

F32 = torch.float32
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 160     # the kernel's largest instantiation (kMaxDh)


def shrink_blocks(S: int, T: int, block_q: int, block_k: int):
    """``(bq, bk)``: the requested block sizes capped at ``S``/``T`` and
    halved until they divide them (the JAX ``ops.flash_attention`` rule)."""
    bq, bk = min(block_q, S), min(block_k, T)
    while S % bq:
        bq //= 2
    while T % bk:
        bk //= 2
    return max(bq, 1), max(bk, 1)


def live_block(q_start: int, k_start: int, bq: int, bk: int, causal: bool,
               window: int | None) -> bool:
    """The TPU kernel's block-live rule: can any (q, k) of the block be
    attended?"""
    live = True
    if causal:
        live = q_start + bq - 1 >= k_start
    if window is not None:
        live = live and k_start + bk - 1 > q_start - window
    return live


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None, block_q: int = 512,
                          block_k: int = 512):
    """Plain PyTorch flash attention; arguments and result as
    :func:`flash_attention`, plus the block sizes of the schedule (shrunk
    to divisors of S and T by :func:`shrink_blocks`, the one place that
    rule runs)."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = shrink_blocks(S, T, block_q, block_k)
    scale = Dh ** -0.5
    dev = q.device
    qf = q.to(F32).permute(0, 2, 1, 3).reshape(B, Hkv, G, S, Dh)
    kf = k.to(F32).permute(0, 2, 1, 3)                  # (B, Hkv, T, Dh)
    vf = v.to(F32).permute(0, 2, 1, 3)
    out = torch.empty((B, Hkv, G, S, Dh), dtype=F32, device=dev)
    for q_start in range(0, S, bq):
        qb = qf[:, :, :, q_start:q_start + bq]
        qpos = torch.arange(q_start, q_start + bq, device=dev)[:, None]
        m = torch.full((B, Hkv, G, bq), -torch.inf, dtype=F32, device=dev)
        l = torch.zeros((B, Hkv, G, bq), dtype=F32, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, Dh), dtype=F32, device=dev)
        for k_start in range(0, T, bk):
            if not live_block(q_start, k_start, bq, bk, causal, window):
                continue
            kb = kf[:, :, None, k_start:k_start + bk]
            vb = vf[:, :, None, k_start:k_start + bk]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            kpos = torch.arange(k_start, k_start + bk, device=dev)[None, :]
            ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                ok &= qpos >= kpos
            if window is not None:
                ok &= qpos - kpos < window
            s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            m = m_new
            acc = acc * corr[..., None] + torch.matmul(p, vb)
        out[:, :, :, q_start:q_start + bq] = \
            acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Hq, S, Dh).permute(0, 2, 1, 3).contiguous() \
        .to(q.dtype)


_LIB: list = []


def _lib():
    """The built kernel's launch function, its C signature declared."""
    if not _LIB:
        from .. import _build
        fn = _build.load("flash_attention").flash_attention_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 9 + [i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


def _check(q, k, v, window):
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {q.dtype} (float32 "
                        f"or bfloat16)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q (B,S,Hq,Dh), k/v (B,T,Hkv,Dh) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {Dh} outside the "
                         f"kernel's 1 .. {MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def bf16_ulp(x):
    """The spacing of bfloat16 values at ``|x|`` (0 where ``x`` is 0): the
    unit in which the bf16 kernel's result is held to its plain version."""
    x = x.float().abs()
    exp = torch.frexp(x).exponent            # |x| in [2^(e-1), 2^e)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), exp - 8),
                       torch.zeros_like(x))


def _rows_aligned(x) -> bool:
    """Can ``cp.async`` move ``x``'s rows 16 bytes at a time: is its pointer,
    and every stride of a leading dim that has more than one index, a
    multiple of 16 bytes?"""
    return x.data_ptr() % 16 == 0 and all(
        x.size(i) == 1 or x.stride(i) * x.element_size() % 16 == 0
        for i in range(3))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q: (B, S, Hq, Dh); k/v: (B, T, Hkv, Dh) -> (B, S, Hq, Dh) in q's
    dtype (float32 or bfloat16).  q-head ``h`` reads kv-head ``h // G``.

    CUDA tensors launch the kernel (or raise; it tiles by 64); CPU tensors
    take :func:`flash_attention_plain` at its default block sizes.  Inputs
    are read in place through their strides, except: a tensor whose head
    dim is strided is copied contiguous; in bfloat16 a head dim that is not
    a multiple of 8 is zero-padded to one (a copy; the zeros leave the dot
    products exact and the padded output columns are dropped), and a tensor
    whose pointer or row strides are not multiples of 16 bytes is copied
    contiguous, since the tensor-core kernel moves rows by 16-byte
    ``cp.async``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, window)
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    scale = float(np.float32(Dh ** -0.5))
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    pad = -Dh % 8 if q.dtype == torch.bfloat16 else 0
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (x if _rows_aligned(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    o = torch.empty((B, S, Hq, Dh + pad), dtype=q.dtype, device=q.device)
    strides = [x.stride(i) for x in (q, k, v) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     _DTYPES[q.dtype], B, S, T, Hq, Hkv, Dh + pad, *strides,
                     int(causal), 0 if window is None else int(window),
                     scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o[..., :Dh].contiguous() if pad else o


flash_attention.launches = 0
