"""``mr_epoch``: the fused epoch loop for a batch of scenario lanes.

It replaces the JAX package's Pallas kernel ``kernels/mr_sched/
megakernel.py:_kernel`` (via ``_mr_epoch_impl``), open-loop lowering
(``control=False, trace=False``).  One launch advances every lane through
its whole event history: processor-sharing rates, the next-event min over
completions and lease-gated arrivals, completions inside the ``1e-6`` tie
window, the shuffle release of reduces, and space-shared admission by
per-VM lexicographic minima of ``(priority desc, eligible time, index)``
taken ``max_pes`` times.  It is resumable: ``state`` carries the 8-leaf
carry in and out and ``epoch_limit`` caps the epochs of one call.

Where the reference multiplies into an add, XLA:CPU fuses the two into one
FMA (``rem - dt * r`` and the tie threshold ``t + 1e-6 * max(t, 1)``);
both forms round once there too, every other op rounds on its own.

Two forms, one op sequence:

* :func:`mr_epoch_plain` — plain PyTorch on ``[N, ...]`` tensors, any
  device.  The CPU tests hold it against the JAX kernel in interpret mode,
  bit for bit on all 8 carry leaves.
* :func:`mr_epoch` — the wrapper: a CUDA tensor launches the hand-written
  kernel ``csrc/mr_epoch.cu`` (built for ``sm_90a`` at first use), a CPU
  tensor takes the plain version.  ``mr_epoch.launches`` counts launches.

Lanes are independent and a finished lane is a fixed point of the epoch
body, so the TPU kernel's per-tile ``while_loop`` becomes a per-lane loop
(each lane stops at its own realized epoch count) with the same per-lane
``n_epochs``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.util import fma32

_BIG = 1e30
_TIME_EPS = 1e-6
F32, I32 = torch.float32, torch.int32

STATE_LEAVES = ("time", "rem", "running", "start", "finish", "ready",
                "maps_left", "n_epochs")


def initial_state(task_len, ready0, is_red, valid):
    """The t=0 carry: ``(time (N,1) f32, rem (N,T) f32, running (N,T) i32,
    start (N,T) f32, finish (N,T) f32, ready (N,T) f32, maps_left (N,1)
    i32, n_epochs (N,1) i32)`` — the JAX package's ``initial_state``."""
    N, T = task_len.shape
    dev = task_len.device
    maps = ((valid != 0) & ~(is_red != 0)).sum(dim=1, keepdim=True,
                                                dtype=I32)
    return (torch.zeros((N, 1), dtype=F32, device=dev),
            task_len.clone(),
            torch.zeros((N, T), dtype=I32, device=dev),
            torch.full((N, T), _BIG, dtype=F32, device=dev),
            torch.full((N, T), _BIG, dtype=F32, device=dev),
            ready0.clone(),
            maps,
            torch.zeros((N, 1), dtype=I32, device=dev))


def mr_epoch_plain(task_len, task_vm, ready0, is_red, valid, shuffle,
                   vm_mips, vm_pes, sched_policy, vm_start, vm_stop, spinup,
                   prio, state=None, *, max_pes: int = 8,
                   epoch_limit: int | None = None):
    """Plain PyTorch ``mr_epoch``; arguments and result as :func:`mr_epoch`.

    A transcription of the TPU kernel's open-loop op sequence on batched
    tensors: one-hot contractions become gathers (``to_task``) and exact
    0/1 counts (``per_vm_sum``), the per-VM minima are masked reductions.
    """
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if state is None:
        state = initial_state(task_len, ready0, is_red, valid)
    if epoch_limit is None:
        epoch_limit = 2 * T + 2
    time = state[0][:, 0]
    rem, running, start, finish, ready = (state[1], state[2] != 0, state[3],
                                          state[4], state[5])
    maps_left, lane_ep = state[6][:, 0], state[7][:, 0]
    is_red = is_red != 0
    valid = valid != 0
    shuffle = shuffle[:, 0]
    is_space = (sched_policy[:, 0] != 0)[:, None]

    in_range = (task_vm >= 0) & (task_vm < V)
    vm_idx = task_vm.clamp(0, V - 1).long()
    onehot = (task_vm[:, :, None]
              == torch.arange(V, dtype=task_vm.dtype, device=dev))
    onehot_f = onehot.to(F32)
    zt = torch.zeros((N, T), dtype=F32, device=dev)
    idx = torch.arange(T, dtype=I32, device=dev)[None, :]

    def to_task(per_vm):
        """Each task's VM's value (0 for a task bound out of range)."""
        return torch.where(in_range, torch.gather(per_vm, 1, vm_idx), zt)

    def per_vm_sum(per_task):
        """Exact 0/1 counts per VM."""
        return (onehot_f * per_task[:, :, None]).sum(dim=1)

    def vm_extreme(x, fill, op):
        return op(torch.where(onehot, x[:, :, None],
                              torch.full_like(x, fill)[:, :, None]), dim=1)

    task_pes = to_task(vm_pes)
    avail_t = to_task(vm_start + spinup)
    close_t = to_task(vm_stop)
    big_t = torch.full_like(zt, _BIG)
    neg_big_t = torch.full_like(zt, -_BIG)
    one_v = torch.ones_like(vm_mips)
    eps = torch.full((N,), _TIME_EPS, dtype=F32, device=dev)

    def active_lanes():
        return (valid & (finish >= _BIG / 2)).any(dim=1)

    active = active_lanes()
    n = 0
    while n < epoch_limit and bool(active.any()):
        runf = running.to(F32)
        n_on_vm = per_vm_sum(runf)
        share = vm_mips * torch.minimum(one_v, vm_pes
                                        / torch.clamp(n_on_vm, min=1.0))
        r = torch.where(running, to_task(share), zt)
        eta = torch.where(running,
                          time[:, None] + rem / torch.clamp(r, min=1e-30),
                          big_t)
        not_started = valid & ~running & (finish >= _BIG / 2) \
            & (start >= _BIG / 2)
        elig = torch.maximum(ready, avail_t)
        cand_t = torch.maximum(elig, time[:, None].expand_as(elig))
        has_slot = (task_pes - to_task(n_on_vm)) > 0.5
        arr = torch.where(not_started & (~is_space | has_slot)
                          & (cand_t < close_t), cand_t, big_t)
        t_next = torch.minimum(eta.amin(dim=1), arr.amin(dim=1))
        live = t_next < _BIG / 2
        # the reference's XLA:CPU lowering fuses each multiply that feeds
        # an add into one FMA: ``t_next + eps * max(t_next, 1)`` and
        # ``rem - dt * r`` round once
        thr = fma32(eps, torch.clamp(t_next, min=1.0), t_next)[:, None]
        dt = (t_next - time)[:, None].expand_as(rem)
        rem = torch.where(running, fma32(-dt, r, rem), rem)
        done_now = live[:, None] & running & (eta <= thr)
        finish = torch.where(done_now, t_next[:, None].expand_as(finish),
                             finish)
        running = running & ~done_now
        rem = torch.where(done_now, zt, rem)
        maps_done_now = (done_now & ~is_red).sum(dim=1, dtype=I32)
        maps_left_new = maps_left - maps_done_now
        phase_done = (maps_left_new == 0) & (maps_left > 0)
        ready = torch.where(is_red & phase_done[:, None],
                            (t_next + shuffle)[:, None].expand_as(ready),
                            ready)

        eligible = live[:, None] & not_started & (elig <= thr) \
            & (t_next[:, None] < close_t)
        free_v = vm_pes - (n_on_vm - per_vm_sum(done_now.to(F32)))
        free_after = to_task(free_v)
        admit = torch.zeros_like(eligible)
        remaining = eligible
        for s in range(max_pes):
            prio_m = torch.where(remaining, prio, neg_big_t)
            top = remaining & (prio_m == to_task(
                vm_extreme(prio_m, -_BIG, torch.amax)))
            elig_m = torch.where(top, elig, big_t)
            cand = top & (elig_m == to_task(
                vm_extreme(elig_m, _BIG, torch.amin)))
            idx_m = torch.where(cand, idx, torch.full_like(idx, T))
            min_idx_v = torch.where(
                onehot, idx_m[:, :, None],
                torch.full_like(idx_m, T)[:, :, None]).amin(dim=1)
            pick = cand & (idx == to_task(min_idx_v.to(F32)).to(I32))
            admit = admit | (pick & (float(s) < free_after))
            remaining = remaining & ~pick
        start_now = eligible & (~is_space | admit)
        start = torch.where(start_now, t_next[:, None].expand_as(start),
                            start)
        running = running | start_now
        time = torch.where(live, t_next, time)
        maps_left = maps_left_new
        lane_ep = lane_ep + active.to(I32)
        n += 1
        active = active_lanes()
    return (time[:, None].contiguous(), rem.contiguous(),
            running.to(I32), start.contiguous(), finish.contiguous(),
            ready.contiguous(), maps_left[:, None].contiguous(),
            lane_ep[:, None].contiguous())


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_SPEC_T, _SPEC_1, _SPEC_V = "T", "1", "V"
# (name, dtype, width) of the lane data the kernel reads, in its C order
_LANE_DATA = (("task_vm", I32, _SPEC_T), ("is_red", I32, _SPEC_T),
              ("valid", I32, _SPEC_T), ("shuffle", F32, _SPEC_1),
              ("vm_mips", F32, _SPEC_V), ("vm_pes", F32, _SPEC_V),
              ("sched_policy", I32, _SPEC_1), ("vm_start", F32, _SPEC_V),
              ("vm_stop", F32, _SPEC_V), ("spinup", F32, _SPEC_1),
              ("prio", F32, _SPEC_T))
_STATE_SPEC = (("time", F32, _SPEC_1), ("rem", F32, _SPEC_T),
               ("running", I32, _SPEC_T), ("start", F32, _SPEC_T),
               ("finish", F32, _SPEC_T), ("ready", F32, _SPEC_T),
               ("maps_left", I32, _SPEC_1), ("n_epochs", I32, _SPEC_1))


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"mr_epoch: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"mr_epoch: {name} is on {x.device}, the batch on "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"mr_epoch: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"mr_epoch: {name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"mr_epoch: {name} must be contiguous")


_LIB = None


def _lib():
    """The built kernel library, with its C signature declared."""
    global _LIB
    if _LIB is None:
        from .. import _build
        lib = _build.load("mr_epoch")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mr_epoch_launch.argtypes = ([p] * (len(_LANE_DATA) + 16)
                                        + [i] * 6 + [f] * 4 + [p])
        lib.mr_epoch_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def mr_epoch(task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips,
             vm_pes, sched_policy, vm_start, vm_stop, spinup, prio,
             state=None, *, max_pes: int = 8,
             epoch_limit: int | None = None):
    """Advance every lane through its event epochs (the JAX ``mr_epoch``
    signature, open loop).

    Lane data, all led by the lane dim N: ``task_len``/``ready0``/``prio``
    ``(N,T)`` f32; ``task_vm``/``is_red``/``valid`` ``(N,T)`` i32;
    ``shuffle``/``spinup`` ``(N,1)`` f32; ``sched_policy`` ``(N,1)`` i32;
    ``vm_mips``/``vm_pes``/``vm_start``/``vm_stop`` ``(N,V)`` f32.
    ``state`` is a carry in :func:`initial_state` layout (default: the t=0
    state, which reads ``task_len``/``ready0``; on resume ``ready0`` may be
    ``None``).  ``max_pes`` must cover the largest per-VM PE count;
    ``epoch_limit`` caps this call's epochs (default ``2T + 2``: to the
    end).  Returns the advanced 8-leaf carry.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`mr_epoch_plain`.
    """
    if task_vm.device.type == "cpu":
        return mr_epoch_plain(task_len, task_vm, ready0, is_red, valid,
                              shuffle, vm_mips, vm_pes, sched_policy,
                              vm_start, vm_stop, spinup, prio, state,
                              max_pes=max_pes, epoch_limit=epoch_limit)
    if task_vm.device.type != "cuda":
        raise ValueError(f"mr_epoch: no kernel for device {task_vm.device}")
    N, T = task_vm.shape
    V = vm_mips.shape[1]
    dev = task_vm.device
    if state is None:
        _check("task_len", task_len, F32, (N, T), dev)
        _check("ready0", ready0, F32, (N, T), dev)
        state = initial_state(task_len, ready0, is_red, valid)
    if epoch_limit is None:
        epoch_limit = 2 * T + 2
    if len(state) != len(_STATE_SPEC):
        raise ValueError(f"mr_epoch: state must have {len(_STATE_SPEC)} "
                         f"leaves, got {len(state)}")
    if max_pes < 0 or epoch_limit < 0:
        raise ValueError("mr_epoch: max_pes and epoch_limit must be >= 0")
    width = {_SPEC_T: T, _SPEC_1: 1, _SPEC_V: V}
    data = (task_vm, is_red, valid, shuffle, vm_mips, vm_pes, sched_policy,
            vm_start, vm_stop, spinup, prio)
    for (name, dtype, w), x in zip(_LANE_DATA, data):
        _check(name, x, dtype, (N, width[w]), dev)
    for (name, dtype, w), x in zip(_STATE_SPEC, state):
        _check(f"state.{name}", x, dtype, (N, width[w]), dev)
    out = tuple(torch.empty_like(x) for x in state)
    if N == 0:
        return out
    lib = _lib()
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mr_epoch_launch(
            *(x.data_ptr() for x in data), *(x.data_ptr() for x in state),
            *(x.data_ptr() for x in out), N, T, V, int(max_pes),
            int(epoch_limit), _lanes_per_block(T, V),
            float(f32(_BIG)), float(f32(_BIG / 2)), float(f32(_TIME_EPS)),
            float(f32(1e-30)), stream)
    if err != 0:
        raise RuntimeError(f"mr_epoch: kernel launch failed with CUDA error "
                           f"{err}")
    mr_epoch.launches += 1
    return out


mr_epoch.launches = 0

# shared memory one lane (one warp) of the kernel holds, per task and per VM
_LANE_BYTES_T = 11 * 4 + 2 * 4 + 8      # f32 arrays, i32 arrays, flag bytes
_LANE_BYTES_V = 4 * 4 + 4               # f32 per-VM arrays, CSR offsets
_SMEM_LIMIT = 200 * 1024


def lane_smem_bytes(T: int, V: int) -> int:
    """Bytes of shared memory the kernel keeps for one lane (16-aligned)."""
    return (_LANE_BYTES_T * T + _LANE_BYTES_V * V + 4 + 15) // 16 * 16


def _lanes_per_block(T: int, V: int) -> int:
    per_lane = lane_smem_bytes(T, V)
    if per_lane > _SMEM_LIMIT:
        raise ValueError(f"mr_epoch: T={T}, V={V} needs {per_lane} bytes of "
                         "shared memory per lane, above the kernel's limit")
    return max(1, min(4, _SMEM_LIMIT // per_lane))
