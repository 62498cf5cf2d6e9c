"""``mr_schedule``: the fixed-epoch MapReduce schedule for a batch of lanes.

It replaces the JAX package's first Pallas kernel, ``kernels/mr_sched/
kernel.py:_kernel`` (via ``mr_schedule``): a fixed ``2T + 2``-epoch loop per
lane over single-job scenarios with both sched policies, no lease windows
and no priorities.  Each epoch evaluates processor-sharing rates, takes the
next-event min over completions and arrivals, fires every completion inside
the ``1e-6`` tie window, releases the reduces after the shuffle delay (from
the next epoch on) and admits space-shared tasks by their ``(ready,
index)`` rank among the eligible tasks of their VM.  Returns ``(start,
finish)``.

Where the reference multiplies into an add, XLA:CPU fuses the two into one
FMA (``rem - dt * rate`` and the tie threshold ``t + 1e-6 * max(t, 1)``);
both forms round once there too, every other op rounds on its own.

Two forms, one op sequence:

* :func:`mr_schedule_plain` — plain PyTorch on ``[N, ...]`` tensors, any
  device; the CPU tests hold it bit for bit against the Pallas kernel in
  interpret mode.  It stops once no lane has a live event: an epoch whose
  next event is ``1e30`` changes no state, so every later epoch is a no-op.
* :func:`mr_schedule` — the wrapper: a CUDA tensor launches the
  hand-written kernel ``csrc/mr_schedule.cu`` (built for ``sm_90a`` at
  first use; each lane stops at its own first epoch without a live event),
  a CPU tensor takes the plain version.  ``mr_schedule.launches`` counts
  its launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.util import fma32
from .megakernel import _check, fit_lanes

_BIG = 1e30
_TIME_EPS = 1e-6
F32, I32 = torch.float32, torch.int32

# (name, dtype, width) of the kernel's inputs, in its C order
_INPUTS = (("task_len", F32, "T"), ("task_vm", I32, "T"),
           ("ready0", F32, "T"), ("is_red", I32, "T"), ("valid", I32, "T"),
           ("shuffle", F32, "1"), ("vm_mips", F32, "V"),
           ("vm_pes", F32, "V"), ("sched_policy", I32, "1"))


def _maximum(a, b):
    """``jnp.maximum`` as XLA:CPU computes it: -0.0 orders below 0.0
    (``torch.maximum`` returns its first argument when they compare
    equal), NaN propagates."""
    return torch.where((a == b) & torch.signbit(a), b, torch.maximum(a, b))


def mr_schedule_plain(task_len, task_vm, ready0, is_red, valid, shuffle,
                      vm_mips, vm_pes, sched_policy=None):
    """Plain PyTorch ``mr_schedule``; arguments and result as
    :func:`mr_schedule`.

    The Pallas kernel's op sequence on batched tensors: one-hot
    contractions become gathers and exact 0/1 counts, the ``T×T``
    ``(ready, index)`` rank an exact count over the tasks of one VM.
    """
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if sched_policy is None:
        sched_policy = torch.zeros((N, 1), dtype=I32, device=dev)
    is_red, valid = is_red != 0, valid != 0
    is_space = sched_policy != 0                            # (N, 1)
    in_range = (task_vm >= 0) & (task_vm < V)
    vm_idx = task_vm.clamp(0, V - 1).long()
    onehot = task_vm[:, :, None] == torch.arange(V, dtype=I32, device=dev)
    onehot_f = onehot.to(F32)
    zt = torch.zeros((N, T), dtype=F32, device=dev)

    def to_task(per_vm):
        return torch.where(in_range, torch.gather(per_vm, 1, vm_idx), zt)

    def per_vm_sum(per_task):
        return (onehot_f * per_task[:, :, None]).sum(dim=1)

    task_pes = to_task(vm_pes)
    idx = torch.arange(T, device=dev)
    same_vm = in_range[:, :, None] & in_range[:, None, :] \
        & (task_vm[:, :, None] == task_vm[:, None, :])
    earlier = idx[None, :] < idx[:, None]                   # [i, j]: j < i
    big_t = torch.full_like(zt, _BIG)
    eps = torch.full((N,), _TIME_EPS, dtype=F32, device=dev)
    one_v = torch.ones_like(vm_mips)

    time = torch.zeros(N, dtype=F32, device=dev)
    rem = task_len.clone()
    running = torch.zeros((N, T), dtype=torch.bool, device=dev)
    start = torch.full_like(zt, _BIG)
    finish = torch.full_like(zt, _BIG)
    ready = ready0.clone()
    for _ in range(2 * T + 2):
        runf = running.to(F32)
        n_on_vm = per_vm_sum(runf)
        share = vm_mips * torch.minimum(one_v, vm_pes
                                        / torch.clamp(n_on_vm, min=1.0))
        rate = to_task(share) * runf
        eta = torch.where(running,
                          time[:, None] + rem / torch.clamp(rate, min=1e-30),
                          big_t)
        not_started = valid & ~running & (finish >= _BIG / 2) \
            & (start >= _BIG / 2)
        has_slot = (task_pes - to_task(n_on_vm)) > 0.5
        arr = torch.where(not_started & (~is_space | has_slot),
                          _maximum(ready, time[:, None].expand_as(ready)),
                          big_t)
        t_next = torch.minimum(eta.amin(dim=1), arr.amin(dim=1))
        live = t_next < _BIG / 2
        if not bool(live.any()):
            break                     # no lane has an event: a fixed point
        # XLA:CPU contracts ``t_next + 1e-6 * max(t_next, 1)`` and
        # ``rem - dt * rate`` into one FMA each
        thr = fma32(eps, torch.clamp(t_next, min=1.0), t_next)[:, None]
        dt = torch.where(live, t_next - time, torch.zeros_like(time))
        rem = torch.where(running, fma32(-dt[:, None].expand_as(rem), rate,
                                         rem), rem)
        done_now = live[:, None] & running & (eta <= thr)
        finish = torch.where(done_now, t_next[:, None].expand_as(finish),
                             finish)
        running = running & ~done_now
        rem = torch.where(done_now, zt, rem)
        maps_left = (valid & ~is_red & (finish >= _BIG / 2)).sum(dim=1)
        maps_done = (valid & ~is_red & done_now).sum(dim=1)
        phase_done = (maps_left == 0) & (maps_done > 0)
        ready_next = torch.where(phase_done[:, None] & is_red,
                                 (t_next + shuffle[:, 0])[:, None]
                                 .expand_as(ready), ready)
        eligible = live[:, None] & not_started & (ready <= thr)
        free_after = task_pes - to_task(n_on_vm
                                        - per_vm_sum(done_now.to(F32)))
        higher = same_vm & ((ready[:, None, :] < ready[:, :, None])
                            | ((ready[:, None, :] == ready[:, :, None])
                               & earlier))
        rank = (higher & eligible[:, None, :]).sum(dim=2).to(F32)
        start_now = eligible & (~is_space | (rank < free_after))
        start = torch.where(start_now, t_next[:, None].expand_as(start),
                            start)
        running = running | start_now
        time = torch.where(live, t_next, time)
        ready = ready_next
    return start.contiguous(), finish.contiguous()


_LIB: list = []


def _lib():
    """The built kernel library, its C signature declared."""
    if not _LIB:
        from .. import _build
        fn = _build.load("mr_schedule").mr_schedule_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * (len(_INPUTS) + 3) + [i] * 4 + [f] * 4 + [p]
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


def mr_schedule(task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips,
                vm_pes, sched_policy=None):
    """Schedule every lane (the JAX ``mr_schedule`` signature, less its
    TPU tiling arguments).

    ``task_len``/``ready0`` ``(N,T)`` f32; ``task_vm``/``is_red``/``valid``
    ``(N,T)`` i32; ``shuffle`` ``(N,1)`` f32; ``vm_mips``/``vm_pes``
    ``(N,V)`` f32; ``sched_policy`` ``(N,1)`` i32 (0 time-shared, 1
    space-shared; default all time-shared).  Returns ``(start, finish)``
    ``(N,T)`` f32.  CUDA tensors launch the kernel (or raise; a lane past
    :func:`block_layout`'s ceiling raises ``ValueError`` before launch),
    CPU tensors take :func:`mr_schedule_plain`.
    """
    if task_vm.device.type == "cpu":
        return mr_schedule_plain(task_len, task_vm, ready0, is_red, valid,
                                 shuffle, vm_mips, vm_pes, sched_policy)
    if task_vm.device.type != "cuda":
        raise ValueError(f"mr_schedule: no kernel for device "
                         f"{task_vm.device}")
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if sched_policy is None:
        sched_policy = torch.zeros((N, 1), dtype=I32, device=dev)
    data = (task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips,
            vm_pes, sched_policy)
    width = {"T": T, "1": 1, "V": V}
    for (name, dtype, w), x in zip(_INPUTS, data):
        _check(name, x, dtype, (N, width[w]), dev, "mr_schedule")
    lanes, shared_sets = block_layout(T, V)
    start = torch.empty((N, T), dtype=F32, device=dev)
    finish = torch.empty_like(start)
    if N == 0:
        return start, finish
    # the VMs' task sets, where shared memory cannot hold them; the kernel
    # fills them
    sets = None if shared_sets else torch.empty(
        N * V * ((T + 31) // 32), dtype=I32, device=dev)
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(*(x.data_ptr() for x in data), start.data_ptr(),
                     finish.data_ptr(),
                     None if sets is None else sets.data_ptr(), N, T, V,
                     lanes, float(f32(_BIG)), float(f32(_BIG / 2)),
                     float(f32(_TIME_EPS)), float(f32(1e-30)), stream)
    if err != 0:
        raise RuntimeError(f"mr_schedule: kernel launch failed with CUDA "
                           f"error {err}")
    mr_schedule.launches += 1
    return start, finish


mr_schedule.launches = 0


def lane_smem_bytes(T: int, V: int, shared_sets: bool = True) -> int:
    """Bytes of shared memory one lane of the kernel keeps (16-aligned):
    per task 7 f32, 1 i32 and 4 flag bytes, per VM 5 f32, the VMs' task
    sets (V x W words, W = ceil(T/32); ``shared_sets=False``: in global
    scratch instead) and three per-epoch task sets of W words."""
    W = (T + 31) // 32
    vw = V * W if shared_sets else 0
    return (36 * T + 20 * V + 4 * vw + 12 * W + 15) // 16 * 16


def block_layout(T: int, V: int) -> tuple[int, bool]:
    """``(lanes per block, VM task sets in shared memory)`` of a launch:
    up to 2 lanes (warps) per block (on the H100, 1 and 2 lanes per block
    ran the open-loop grid's static-fleet buckets equally fast, 4 about 5%
    slower; 2 keeps 64 warps resident per SM on batches too large for one
    wave, where 1 would keep 32), the task sets in global scratch when a
    lane does not fit a block with them.  The ceiling: a lane must fit
    the block's 232,448 bytes without its task sets, ``36 T + 20 V + 12 W
    <= 232448`` (T <= 6385 at V = 9, T <= 5827 at V = 1024); beyond it
    ``ValueError``."""
    return fit_lanes(lane_smem_bytes(T, V), lane_smem_bytes(T, V, False), 2,
                     f"mr_schedule: T={T}, V={V}")
