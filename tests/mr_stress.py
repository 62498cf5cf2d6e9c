"""Seeded ``mr_epoch`` lanes built to stress space-shared admission.

Imported by the CPU tests (plain version against the Pallas kernel), the
card tests and ``chip_smoke.py`` (kernel against the plain version).  The
lane data is written out directly, not encoded from scenarios, so it can
hold what no encoder emits:

* all tasks bound to one VM;
* equal priorities and equal ready times, so that the index decides;
* -0.0 beside 0.0 priorities;
* VMs with 0 PEs, a fractional PE count, and exactly the ``max_pes`` the
  caller passes (callers also pass a ``max_pes`` above the largest PE
  count, and one below it);
* priorities at the scan's sentinels: -1e30 (still picked), below -1e30
  (never picked) and above 1e30;
* tasks bound outside [0, V);
* under control: BOOST-urgent tasks (some with priorities the scan never
  picks) and preemption victims on full VMs, failures whose tasks fail
  over to a second binding (in range or not), SHED deadlines, and AUTOSCALE
  reserves.

Every lane has ``V = 6`` VM columns (or the ``V`` the caller asks for), of
which the first 2 to V-1 are real.  :func:`schedule_lanes` adapts the
open-loop kinds that apply to ``mr_schedule``, which has no priorities and
no ``max_pes``: its ties and signed zeros go into the ready times.
"""
import numpy as np

V = 6
BIG = 1e30
OPEN_KINDS = ("one_vm", "ties", "signed_zero", "pes_edge", "out_of_range",
              "sentinels")
CONTROL_KINDS = OPEN_KINDS + ("urgent_preempt", "urgent_stall", "failover",
                              "failover_out_of_range")


def _lane(kind, T, rng, control, V=V):
    """One lane's data as a dict of numpy rows."""
    nv = int(rng.integers(2, V))
    n_red = int(rng.integers(1, 3))
    n_valid = T - int(rng.integers(0, 3))
    d = dict(
        task_len=rng.choice([1000.0, 2000.0, 3000.0], T),
        task_vm=rng.integers(0, nv, T),
        ready0=rng.choice([0.0, 0.0, 5.0], T),
        is_red=(np.arange(T) >= n_valid - n_red).astype(np.int64),
        valid=(np.arange(T) < n_valid).astype(np.int64),
        shuffle=float(rng.choice([0.0, 7.0])),
        vm_mips=np.where(np.arange(V) < nv, rng.choice([100.0, 250.0], V),
                         1.0),
        vm_pes=np.where(np.arange(V) < nv, rng.choice([1.0, 2.0, 4.0], V),
                        1.0),
        sched=1,
        vm_start=np.where(rng.random(V) < 0.2, 50.0, 0.0),
        vm_stop=np.full(V, BIG),
        spinup=float(rng.choice([0.0, 3.0])),
        prio=rng.integers(0, 3, T).astype(np.float64),
        vm_valid=(np.arange(V) < nv).astype(np.int64),
        vm_fail=np.full(V, BIG), vm_restore=np.full(V, BIG),
        vm_auto=np.zeros(V, np.int64), ctl_policy=0, ctl_queue=2.0,
        ctl_busy=0.5, redispatch=float(rng.choice([0.0, 30.0])),
        task_vm2=(rng.integers(0, nv, T)), refetch=np.zeros(T),
        task_deadline=np.full(T, BIG), dl_policy=0, dl_slack=0.0,
        preempt=0, preempt_resume=0)
    pes = d["vm_pes"]
    if kind == "one_vm":
        d["task_vm"] = np.zeros(T, np.int64)
        pes[0] = rng.choice([1.0, 2.0, 4.0])
    elif kind == "ties":
        d["prio"] = np.where(rng.random(T) < 0.5, -0.0, 0.0)
        d["ready0"] = np.zeros(T)
        d["task_vm"] = rng.integers(0, 2, T)
    elif kind == "signed_zero":
        d["prio"] = rng.choice([-0.0, 0.0, 1.0, -1.0], T)
    elif kind == "pes_edge":
        pes[:nv] = rng.choice([0.0, 1.5, 2.5, 4.0], nv)
        pes[0] = 4.0                        # exactly the usual max_pes
    elif kind == "out_of_range":
        d["task_vm"] = np.where(rng.random(T) < 0.3,
                                rng.choice([-1, V, V + 2], T),
                                d["task_vm"])
        d["sched"] = int(rng.integers(0, 2))
    elif kind == "sentinels":
        d["prio"] = rng.choice([-BIG, -3e30, 2e30, 0.0, -0.0], T)
        d["sched"] = int(rng.random() < 0.8)
    elif kind in ("urgent_preempt", "urgent_stall"):
        # BOOST: a deadline of 1 s makes a pending task urgent at once
        d["dl_policy"] = 2
        d["dl_slack"] = float(rng.choice([0.0, 120.0]))
        d["task_deadline"] = np.where(rng.random(T) < 0.4, 1.0, BIG)
        d["preempt"] = 1
        d["preempt_resume"] = int(rng.integers(0, 2))
        d["task_vm"] = rng.integers(0, 2, T)
        pes[:2] = rng.choice([1.0, 2.0], 2)
        d["ready0"] = rng.choice([0.0, 40.0, 400.0], T)
        d["prio"] = rng.integers(0, 4, T).astype(np.float64)
        if kind == "urgent_stall":
            # urgent tasks the scan never picks hold back the others
            d["task_deadline"] = np.where(rng.random(T) < 0.5, 1.0, BIG)
            d["prio"] = np.where(rng.random(T) < 0.3, -3e30, d["prio"])
            pes[:2] = 4.0
    elif kind in ("failover", "failover_out_of_range"):
        d["vm_fail"][:nv] = np.where(rng.random(nv) < 0.6,
                                     rng.choice([300.0, 900.0], nv), BIG)
        d["vm_restore"][:nv] = d["vm_fail"][:nv] + 600.0
        d["refetch"] = rng.choice([0.0, 20.0], T)
        d["vm_auto"][nv - 1] = int(rng.random() < 0.5)
        d["ctl_policy"] = int(rng.integers(0, 2))
        d["dl_policy"] = int(rng.integers(0, 3))
        d["task_deadline"] = np.where(rng.random(T) < 0.3, 1500.0, BIG)
        d["preempt"] = int(rng.integers(0, 2))
        d["task_vm"] = rng.integers(0, 2, T)
        if kind == "failover_out_of_range":
            d["task_vm2"] = np.where(rng.random(T) < 0.4,
                                     rng.choice([-1, V], T), d["task_vm2"])
            d["task_vm"] = np.where(rng.random(T) < 0.2, -1, d["task_vm"])
    if not control and kind not in ("out_of_range", "sentinels"):
        d["sched"] = int(rng.random() < 0.85)
    # reduces wait for the shuffle release
    d["ready0"] = np.where(d["is_red"] != 0, BIG, d["ready0"])
    return d


_ORDER = ("task_len", "task_vm", "ready0", "is_red", "valid", "shuffle",
          "vm_mips", "vm_pes", "sched", "vm_start", "vm_stop", "spinup",
          "prio", "vm_valid", "vm_fail", "vm_restore", "vm_auto",
          "ctl_policy", "ctl_queue", "ctl_busy", "redispatch", "task_vm2",
          "refetch", "task_deadline", "dl_policy", "dl_slack", "preempt",
          "preempt_resume")
_INT = frozenset({"task_vm", "is_red", "valid", "sched", "vm_valid",
                  "vm_auto", "ctl_policy", "task_vm2", "dl_policy",
                  "preempt", "preempt_resume"})


def _stack(rows, names):
    out = []
    for name in names:
        a = np.stack([np.atleast_1d(np.asarray(r[name])) for r in rows])
        out.append(np.ascontiguousarray(
            a.astype(np.int32 if name in _INT else np.float32)))
    return tuple(out)


def stress_lanes(n, T, seed, control=False, V=V):
    """``n`` lanes of ``T`` task slots and ``V`` VM columns cycling through
    the kinds (the open kinds, plus the control kinds under ``control``).
    Returns the 28 ``mr_epoch`` lane-data arrays in the order of its
    signature (13 open loop, then the 15 control tensors; the open kinds'
    control tensors are the degenerate no-op values), numpy, each ``(n,
    width)``, and the largest PE count rounded up."""
    rng = np.random.default_rng(seed)
    kinds = CONTROL_KINDS if control else OPEN_KINDS
    rows = [_lane(kinds[i % len(kinds)], T, rng, control, V)
            for i in range(n)]
    out = _stack(rows, _ORDER)
    return out, max(int(np.ceil(out[7].max())), 1)


SCHEDULE_KINDS = ("one_vm", "ties", "signed_zero", "pes_edge",
                  "out_of_range")


def schedule_lanes(n, T, seed, V=V):
    """``n`` ``mr_schedule`` lanes of ``T`` task slots and ``V`` VM columns
    cycling through :data:`SCHEDULE_KINDS`, mostly space-shared.  The
    ``ties`` lanes put -0.0 and 0.0 ready times on two VMs, the
    ``signed_zero`` lanes -0.0, 0.0, 1.0 and -1.0.  Returns the 9 arrays
    of ``mr_schedule``'s signature, numpy, each ``(n, width)``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        kind = SCHEDULE_KINDS[i % len(SCHEDULE_KINDS)]
        d = _lane(kind, T, rng, False, V)
        if kind in ("ties", "signed_zero"):
            vals = [-0.0, 0.0] if kind == "ties" else [-0.0, 0.0, 1.0, -1.0]
            d["ready0"] = np.where(d["is_red"] != 0, BIG,
                                   rng.choice(vals, T))
        rows.append(d)
    return _stack(rows, _ORDER[:9])
