// mr_epoch, control lowering: the IOTSim event-epoch loop with the closed
// loop (VM failures with failover re-dispatch and re-replication, the
// AUTOSCALE reserve hook, deadline SHED/BOOST admission and priority
// preemption), written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the control=True lowering of the JAX package's Pallas TPU kernel
// kernels/mr_sched/megakernel.py:_kernel (called through _mr_epoch_impl).
// The open-loop lowering is mr_epoch.cu, which carries no control code.
// The plain PyTorch version, megakernel.py:mr_epoch_plain(control=True),
// runs the same algorithm; the two agree bit for bit on all 15 carry
// leaves.
//
// What bounds it on this card.  As for the open loop: a few KB of HBM
// traffic per lane for a whole history of up to 7T+V+3 epochs, about a
// hundred compare/select operations per task slot and epoch, and a chain
// of dependent steps per epoch, so a launch lasts as long as its slowest
// lane's epochs and the kernel is bound by the latency of one epoch.  One
// warp per lane, the lane's whole carry in shared memory for its entire
// history, several lanes per block.  Each warp stops at its own lane's end
// (unfinished non-shed work and its epoch bound), which is the per-lane
// meaning of the reference (ROADMAP C6): the TPU kernel stepped a whole
// tile to its slowest lane, and under control a finished lane is not a
// fixed point of the epoch body.
//
// What the first design lost.  Every per-VM reduction ran on one thread per
// VM, walking the VM's two task lists (bound there, failing over there)
// through dependent shared-memory loads: the running and unfinished counts
// and the weakest evictable task, the completion count, the preemption
// victim (three passes), and an admission scan of max_pes steps of four
// passes each.  With 1-9 VMs most of the warp idled through all of it.
//
// What this design does.  No thread walks a VM's task list inside the
// epoch loop.  A task runs on its bound VM (task_vm) until its first
// failure kill or eviction sets `hit`, then on its failover VM (task_vm2);
// each VM keeps the bit masks (W = ceil(T/32) words) of the tasks bound to
// it and of those failing over to it, built once per launch, and its
// current set is (bound & ~hit) | (failover & hit) with `hit` taken at the
// epoch's start, as in the reference.  Per-VM counts are popcounts of that
// set against ballots of the running, unfinished and completed tasks.  The
// per-VM extrema (weakest evictable priority, highest eligible priority on
// a full VM, the victim's priority and index) are shared-memory atomics
// from every task at once, on priorities mapped to order-preserving
// integers; they feed only comparisons, so the sign a zero keeps does not
// matter.  Admission is by per-task rank, the rule of the JAX engine
// (core/engine.py:953-955) that the Pallas scan reproduces: the scan picks
// a VM's eligible tasks by (urgency desc, priority desc, eligible time asc,
// index asc) and admits the one picked at step s < max_pes iff s < the VM's
// free PEs, so each eligible task counts the eligible tasks of its VM ahead
// of it and is admitted iff that rank passes both tests.  A priority below
// -1e30 (the scan's starting maximum) or NaN is never picked, and such an
// urgent task holds its VM's urgent tier open, so no non-urgent task of that
// VM is admitted.  Admission only compares and counts: no rounding changes.
// When a lane does not fit a block with its VMs' task sets (a large
// fleet), the sets live in the lane's slice of a global scratch buffer
// (vm_sets); the kernel is a template on where they live, so the
// shared-memory instantiation keeps its code.
//
// Rounding: built with -fmad=false and IEEE division, so every op rounds on
// its own, except where the reference's XLA:CPU lowering fuses a multiply
// into an add (rem - dt * r, and the tie threshold t + 1e-6 * max(t, 1)):
// those use fmaf, one rounding, as the reference.  work_lost sums each
// epoch's lost work in one fixed order (megakernel.py uses the same).
//
// Built with -DMR_TRACE this source gives the control trace instantiation
// (the trace=True lowering, megakernel.py:534-591, plus the event log of the
// JAX engine's recorder, engine.py:974-1074); without it nothing of the
// trace is compiled.  Each active epoch writes one 32-byte time-series row
// (the new clock; the hook's queue depth, busy fraction and open VMs at the
// opening clock; activity; this epoch's kills, new sheds and evictions) at
// the lane's epoch index, and appends its events at the lane's cursor in
// the reference's order: scale opens and closes per VM at the opening
// clock, then per task, in index order, completions, kills (at the failure
// instant), evictions and starts at the epoch's event time, and new sheds at
// its new clock; a task's VM is its slot at the epoch's start.  A warp
// ballot gives each event its slot, a row lands where the slot is below the
// capacity E, and the cursor counts every event.  The flags the log reads
// after the epoch (killed, newly shed, opened, closed) take 2T + 2V more
// bytes of shared memory.
#include <cuda_runtime.h>

#ifdef MR_TRACE
#define MR_LAUNCH mr_epoch_control_trace_launch
#else
#define MR_LAUNCH mr_epoch_control_launch
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  // lane data
  const float* task_len;
  const int* task_vm;
  const int* is_red;
  const int* valid;
  const float* shuffle;
  const float* vm_mips;
  const float* vm_pes;
  const int* sched;
  const float* spinup;
  const float* prio;
  const int* vm_valid;
  const float* vm_fail;
  const float* vm_restore;
  const int* vm_auto;
  const int* ctl_policy;
  const float* ctl_queue;
  const float* ctl_busy;
  const float* redispatch;
  const int* task_vm2;
  const float* refetch;
  const float* task_deadline;
  const int* dl_policy;
  const float* dl_slack;
  const int* preempt;
  const int* preempt_resume;
  // carry in
  const float* time_in;
  const float* rem_in;
  const int* running_in;
  const float* start_in;
  const float* finish_in;
  const float* ready_in;
  const int* maps_left_in;
  const int* n_epochs_in;
  const int* hit_in;
  const float* vm_open_in;
  const float* vm_close_in;
  const int* n_scale_in;
  const int* shed_in;
  const int* n_evict_in;
  const float* work_lost_in;
  // carry out
  float* time_out;
  float* rem_out;
  int* running_out;
  float* start_out;
  float* finish_out;
  float* ready_out;
  int* maps_left_out;
  int* n_epochs_out;
  int* hit_out;
  float* vm_open_out;
  float* vm_close_out;
  int* n_scale_out;
  int* shed_out;
  int* n_evict_out;
  float* work_lost_out;
  unsigned* vm_sets;  // 2 x V x W words per lane, or null: see lane_smem_bytes
  int N, T, V, max_pes, epoch_limit, lanes_per_block, lane_bytes;
  float big, half_big, eps, tiny;
#ifdef MR_TRACE
  const float* ts_in;
  const float* ev_t_in;
  const int* ev_kind_in;
  const int* ev_task_in;
  const int* ev_vm_in;
  const int* ev_n_in;
  float* ts_out;
  float* ev_t_out;
  int* ev_kind_out;
  int* ev_task_out;
  int* ev_vm_out;
  int* ev_n_out;
  int C, E;
#endif
};

// Shared-memory bytes of one lane; megakernel.py:lane_smem_bytes(control=
// True) agrees.  Per task: f32 x 13, i32 x 4, 12 flag bytes; per VM: f32 x
// 9, i32 x 4, 3 flag bytes; the VMs' two task sets, 2 x V x W words,
// unless they live in the lane's slice of the global scratch vm_sets (a
// large fleet: megakernel.py:block_layout); six per-epoch task sets, W
// words each.  The trace instantiation keeps two more flag bytes per task
// and per VM.
__host__ __device__ inline int lane_smem_bytes(int T, int V, bool shared_sets) {
  const int W = (T + 31) / 32;
  const int vw = shared_sets ? V * W : 0;
#ifdef MR_TRACE
  return (82 * T + 57 * V + 8 * vw + 24 * W + 15) / 16 * 16;
#else
  return (80 * T + 55 * V + 8 * vw + 24 * W + 15) / 16 * 16;
#endif
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_min_int(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ bool has(const unsigned* set, int t) {
  return (set[t >> 5] >> (t & 31)) & 1u;
}

// A float as an int of the same order (-0.0 just below 0.0), so that
// integer atomicMin/atomicMax take float extrema; and back.
__device__ __forceinline__ int okey(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float okey_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The current task set of one VM (its bound and failover masks, W words
// each, at the given hit mask), and its overlap with other task sets.
struct VmSet {
  const unsigned* bound;
  const unsigned* over;
  const unsigned* hitm;
  __device__ __forceinline__ unsigned word(int w) const {
    return (bound[w] & ~hitm[w]) | (over[w] & hitm[w]);
  }
  __device__ __forceinline__ int count(const unsigned* m, int W) const {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(word(w) & m[w]);
    return c;
  }
};

// Whether the admission scan admits eligible task t of the VM whose current
// set is s: its rank, the eligible tasks of the VM that the scan picks
// before t (the urgent tier first), must be below max_pes and, as a float,
// below free_v.  Both tests are monotone in the rank, so counting stops at
// the first rank that fails them.  stalled: an eligible urgent task of the
// VM can never be picked, so the scan never leaves the urgent tier.
__device__ bool admitted(int t, const VmSet& s, const unsigned* elm, int W,
                         const float* prio, const float* elig,
                         const unsigned char* urg, bool stalled, float free_v,
                         int max_pes, float big) {
  const float pt = prio[t];
  const bool ut = urg[t];
  if (!(pt >= -big) || (stalled && !ut)) return false;
  const auto ok = [&](int r) { return r < max_pes && (float)r < free_v; };
  if (ok(s.count(elm, W) - 1)) return true;  // every rank passes
  if (!ok(0)) return false;
  const float et = elig[t];
  int rank = 0;
  for (int w = 0; w < W; ++w) {
    unsigned m = s.word(w) & elm[w];
    while (m) {
      const int u = (w << 5) + __ffs(m) - 1;
      m &= m - 1;
      const bool uu = urg[u];
      const float pu = prio[u], eu = elig[u];
      const bool ahead = uu != ut ? uu
                         : pu > pt || (pu == pt && (eu < et || (eu == et && u < t)));
      if (ahead && !ok(++rank)) return false;
    }
  }
  return true;
}

#ifdef MR_TRACE
// telemetry.EV_*
constexpr int kEvStart = 0, kEvFinish = 1, kEvKill = 2, kEvPreempt = 3,
              kEvShed = 4, kEvScaleOpen = 5, kEvScaleClose = 6;

// Append the events of items [0, count) for which on(i) holds, in index
// order, at the warp-uniform cursor; put(slot, i) writes one row, called
// only for slots below E.  Returns the advanced cursor.
template <class On, class Put>
__device__ __forceinline__ int log_events(int cursor, int count, int E,
                                          On on, Put put) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < count; b += 32) {
    const int i = b + lane;
    const bool hit = i < count && on(i);
    const unsigned m = __ballot_sync(kFull, hit);
    if (hit) {
      const int slot = cursor + __popc(m & ((1u << lane) - 1u));
      if (slot < E) put(slot, i);
    }
    cursor += __popc(m);
  }
  return cursor;
}
#endif

// Sum of x[0..n) in the order of megakernel.py's _sum (XLA:CPU's reduce
// order): left to right up to 32 terms; longer rows in 32-wide windows, the
// row centred with its padding split low half first, each window left to
// right, the window sums reduced the same way.  Overwrites x.
__device__ float fixed_sum(float* x, int n) {
  while (n > 32) {
    const int k = (n + 31) / 32;
    const int lo = (32 * k - n) / 2;
    for (int c = 0; c < k; ++c) {
      const int a = max(32 * c - lo, 0), b = min(32 * c + 32 - lo, n);
      float s = 0.f;
      for (int i = a; i < b; ++i) s += x[i];
      x[c] = s;  // a >= c: this window's terms are read before the write
    }
    n = k;
  }
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += x[i];
  return s;
}

template <bool kSharedSets>
__global__ void mr_epoch_control_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long n = (long)blockIdx.x * p.lanes_per_block + warp;
  if (n >= p.N) return;  // the whole warp leaves together
  const int T = p.T, V = p.V, W = (T + 31) / 32;

  // per-lane shared memory, in lane_smem_bytes order
  unsigned char* base = smem + (size_t)warp * p.lane_bytes;
  // per task, f32
  float* rem = reinterpret_cast<float*>(base);
  float* start = rem + T;
  float* finish = start + T;
  float* ready = finish + T;
  float* elig = ready + T;
  float* prio = elig + T;
  float* rate = prio + T;
  float* eta = rate + T;
  float* tlen = eta + T;
  float* refetch = tlen + T;
  float* dl = refetch + T;
  float* lostf = dl + T;
  float* loste = lostf + T;
  // per VM, f32
  float* vmips = loste + T;
  float* vpes = vmips + V;
  float* von = vpes + V;     // running tasks at the epoch's start
  float* vshare = von + V;
  float* vfail = vshare + V;
  float* vrest = vfail + V;
  float* vopen = vrest + V;
  float* vclose = vopen + V;
  float* vfree = vclose + V; // free PEs after completions and evictions
  // per task, i32
  int* tvm = reinterpret_cast<int*>(vfree + V);
  int* tvm2 = tvm + T;
  int* cvm = tvm2 + T;       // current VM at the epoch's start
  int* nev = cvm + T;
  // per VM, i32: okey()s of the weakest evictable priority, the highest
  // eligible priority and the lowest outranked one; the victim's index
  int* vk_ev = nev + T;
  int* vk_el = vk_ev + V;
  int* vk_low = vk_el + V;
  int* vvic = vk_low + V;
  // task sets, W words each: bound to and failing over to each VM (V sets
  // each), then this epoch's
  unsigned* vbound = kSharedSets ? reinterpret_cast<unsigned*>(vvic + V)
                                 : p.vm_sets + n * 2 * V * W;
  unsigned* vover = vbound + V * W;
  unsigned* hitm = kSharedSets ? vover + V * W  // hit at the epoch's start
                               : reinterpret_cast<unsigned*>(vvic + V);
  unsigned* runm = hitm + W;       // running at the epoch's start
  unsigned* unfm = runm + W;       // unfinished at the epoch's start
  unsigned* donem = unfm + W;      // completed this epoch
  unsigned* elm = donem + W;       // eligible this epoch
  unsigned* stallm = elm + W;      // eligible, urgent, never picked
  // flags
  unsigned char* f_valid = reinterpret_cast<unsigned char*>(stallm + W);
  unsigned char* f_red = f_valid + T;
  unsigned char* f_run = f_red + T;
  unsigned char* f_hit = f_run + T;
  unsigned char* f_shed = f_hit + T;
  unsigned char* f_ns = f_shed + T;     // not started (epoch start)
  unsigned char* f_eval = f_ns + T;     // deadline pressure evaluable
  unsigned char* f_shedc = f_eval + T;  // shed at the arrival candidate
  unsigned char* f_shedt = f_shedc + T; // shed at the admission instant
  unsigned char* f_urg = f_shedt + T;   // BOOST urgent
  unsigned char* f_st = f_urg + T;      // started this epoch
  unsigned char* f_ev = f_st + T;       // evicted this epoch
  unsigned char* v_valid = f_ev + T;
  unsigned char* v_auto = v_valid + V;
  unsigned char* v_full = v_auto + V;   // no free PE after completions
#ifdef MR_TRACE
  unsigned char* f_kill = v_full + V;   // killed by a failure this epoch
  unsigned char* f_nshed = f_kill + T;  // newly shed this epoch
  unsigned char* v_opm = f_nshed + T;   // reserve opened this epoch
  unsigned char* v_clm = v_opm + V;     // reserve closed this epoch
#endif

  const long rT = n * T, rV = n * V;
  const float spin = p.spinup[n];
  const float shuffle = p.shuffle[n];
  const bool is_space = p.sched[n] != 0;
  const bool pol_on = p.ctl_policy[n] == 1;
  const float ctl_queue = p.ctl_queue[n];
  const float ctl_busy = p.ctl_busy[n];
  const float redisp = p.redispatch[n];
  const bool dl_shed = p.dl_policy[n] == 1;
  const bool dl_boost = p.dl_policy[n] == 2;
  const float dl_slack = p.dl_slack[n];
  const bool pre_on = p.preempt[n] != 0;
  const bool pre_onl = pre_on && is_space;
  const bool res_onl = p.preempt_resume[n] != 0;

  bool any_dl = false;
  for (int t = lane; t < T; t += 32) {
    tvm[t] = p.task_vm[rT + t];
    tvm2[t] = p.task_vm2[rT + t];
    rem[t] = p.rem_in[rT + t];
    start[t] = p.start_in[rT + t];
    finish[t] = p.finish_in[rT + t];
    ready[t] = p.ready_in[rT + t];
    prio[t] = p.prio[rT + t];
    tlen[t] = p.task_len[rT + t];
    refetch[t] = p.refetch[rT + t];
    dl[t] = p.task_deadline[rT + t];
    nev[t] = p.n_evict_in[rT + t];
    f_valid[t] = p.valid[rT + t] != 0;
    f_red[t] = p.is_red[rT + t] != 0;
    f_run[t] = p.running_in[rT + t] != 0;
    f_hit[t] = p.hit_in[rT + t] != 0;
    f_shed[t] = p.shed_in[rT + t] != 0;
    any_dl |= f_valid[t] && dl[t] < p.half_big;
  }
  bool any_fail = false;
  for (int v = lane; v < V; v += 32) {
    vmips[v] = p.vm_mips[rV + v];
    vpes[v] = p.vm_pes[rV + v];
    vfail[v] = p.vm_fail[rV + v];
    vrest[v] = p.vm_restore[rV + v];
    vopen[v] = p.vm_open_in[rV + v];
    vclose[v] = p.vm_close_in[rV + v];
    v_valid[v] = p.vm_valid[rV + v] != 0;
    v_auto[v] = p.vm_auto[rV + v] != 0;
    any_fail |= v_valid[v] && vfail[v] < p.half_big;
  }
  // the per-lane epoch bound (engine._lane_bound): additive widenings for
  // the mechanisms this lane's data can trigger
  const int bound = 2 * T + 2 + (__any_sync(kFull, any_fail) ? 2 * T + V : 0) +
                    (dl_shed && __any_sync(kFull, any_dl) ? T + 1 : 0) +
                    (pre_on ? 2 * T : 0);
  for (int i = lane; i < 2 * V * W; i += 32) vbound[i] = 0u;
  __syncwarp();
  for (int t = lane; t < T; t += 32) {
    const unsigned bit = 1u << (t & 31);
    const int v = tvm[t], v2 = tvm2[t];
    if (v >= 0 && v < V) atomicOr(&vbound[v * W + (t >> 5)], bit);
    if (v2 >= 0 && v2 < V) atomicOr(&vover[v2 * W + (t >> 5)], bit);
  }
  __syncwarp();
  const auto vm_set = [&](int v) { return VmSet{vbound + v * W, vover + v * W, hitm}; };

  float time = p.time_in[n];
  int maps_left = p.maps_left_in[n];
  int lane_ep = p.n_epochs_in[n];
  int n_scale = p.n_scale_in[n];
  float work_lost = p.work_lost_in[n];
#ifdef MR_TRACE
  const long rC = n * (long)p.C * 8, rE = n * (long)p.E;
  for (int i = lane; i < p.C * 8; i += 32) p.ts_out[rC + i] = p.ts_in[rC + i];
  for (int i = lane; i < p.E; i += 32) {
    p.ev_t_out[rE + i] = p.ev_t_in[rE + i];
    p.ev_kind_out[rE + i] = p.ev_kind_in[rE + i];
    p.ev_task_out[rE + i] = p.ev_task_in[rE + i];
    p.ev_vm_out[rE + i] = p.ev_vm_in[rE + i];
  }
  int ev_n = p.ev_n_in[n];
  __syncwarp();
#endif

  // Loops that ballot a task set run b over [0, T) in steps of 32 on every
  // lane, so the whole warp takes part in each ballot.
  for (int step = 0; step < p.epoch_limit; ++step) {
    bool unfinished = false;
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      const bool in = t < T;
      bool unf = false;
      if (in) {
        unf = f_valid[t] && finish[t] >= p.half_big && !f_shed[t];
        cvm[t] = f_hit[t] ? tvm2[t] : tvm[t];
      }
      unfinished |= unf;
      const unsigned mu = __ballot_sync(kFull, unf);
      const unsigned mr = __ballot_sync(kFull, in && f_run[t]);
      const unsigned mh = __ballot_sync(kFull, in && f_hit[t]);
      if (lane == 0) {
        unfm[b >> 5] = mu;
        runm[b >> 5] = mr;
        hitm[b >> 5] = mh;
      }
    }
    if (!__any_sync(kFull, unfinished) || lane_ep >= bound) break;
    __syncwarp();

    // per VM at the epoch's start: running count and share, and the
    // control hook's observables
    int q = 0, n_open = 0, n_busy = 0, first = V + 1;
    for (int t = lane; t < T; t += 32)
      q += f_valid[t] && finish[t] >= p.half_big && !f_shed[t] &&
           start[t] >= p.half_big && ready[t] <= time;
    for (int v = lane; v < V; v += 32) {
      const float c = (float)vm_set(v).count(runm, W);
      von[v] = c;
      vshare[v] = vmips[v] * fminf(1.f, vpes[v] / fmaxf(c, 1.f));
      vk_ev[v] = okey(p.big);
      const bool open = v_valid[v] && vopen[v] + spin <= time && time < vclose[v];
      n_open += open;
      n_busy += open && c > 0.5f;
      if (v_valid[v] && v_auto[v] && vopen[v] >= p.half_big) first = min(first, v);
    }
    q = __reduce_add_sync(kFull, q);
    n_open = __reduce_add_sync(kFull, n_open);
    n_busy = __reduce_add_sync(kFull, n_busy);
    first = warp_min_int(first);
    const float busy_frac = (float)n_busy / fmaxf((float)n_open, 1.f);
    const bool trigger = pol_on && (float)q > ctl_queue && busy_frac >= ctl_busy;
    int scaled = 0;
    for (int v = lane; v < V; v += 32) {
      const bool reserve = v_valid[v] && v_auto[v];
      const bool open_m = trigger && reserve && vopen[v] >= p.half_big && v == first;
      // close a reserve with no unfinished work bound to it
      const bool close_m = pol_on && reserve && vopen[v] < p.half_big &&
                           time < vclose[v] && (float)vm_set(v).count(unfm, W) < 0.5f;
      if (open_m) vopen[v] = time;
      if (close_m) vclose[v] = time;
#ifdef MR_TRACE
      v_opm[v] = open_m;
      v_clm[v] = close_m;
#endif
      scaled += open_m + close_m;
    }
    n_scale += __reduce_add_sync(kFull, scaled);
    __syncwarp();
    if (pre_onl) {
      // the weakest evictable task's priority on each VM
      for (int t = lane; t < T; t += 32) {
        const int v = cvm[t];
        if (v >= 0 && v < V && f_run[t] && nev[t] < 2 && prio[t] == prio[t])
          atomicMin(&vk_ev[v], okey(prio[t]));
      }
      __syncwarp();
    }

    // next event: completions, gated arrivals (SHED at the arrival
    // candidate, on the carried rem), pending failure instants
    float lmin = p.big;
    for (int t = lane; t < T; t += 32) {
      const int v = cvm[t];
      const bool inr = v >= 0 && v < V;
      const bool run = f_run[t];
      const float r = run && inr ? vshare[v] : 0.f;
      rate[t] = r;
      const float e = run ? time + rem[t] / fmaxf(r, p.tiny) : p.big;
      eta[t] = e;
      const bool ns = f_valid[t] && !run && finish[t] >= p.half_big &&
                      start[t] >= p.half_big;
      f_ns[t] = ns;
      const float ft = inr ? vfail[v] : 0.f, rt = inr ? vrest[v] : 0.f;
      const float close_t = inr ? vclose[v] : 0.f;
      float el = fmaxf(ready[t], inr ? vopen[v] + spin : 0.f);
      if (el >= ft && el < rt) el = rt;
      elig[t] = el;
      float cand = fmaxf(el, time);
      if (cand >= ft && cand < rt) cand = rt;
      const bool evaluable = ns && el < p.half_big;
      f_eval[t] = evaluable;
      const float efin = cand + rem[t] / fmaxf(inr ? vmips[v] : 0.f, p.tiny);
      const bool shedc = f_shed[t] || (dl_shed && evaluable && cand < close_t && efin > dl[t]);
      f_shedc[t] = shedc;
      const bool slot = ((inr ? vpes[v] : 0.f) - (inr ? von[v] : 0.f)) > 0.5f;
      // a pending task beating the weakest evictable running task on its
      // VM defines an arrival even with no free slot
      const bool can_pre = pre_onl && prio[t] > (inr ? okey_float(vk_ev[v]) : 0.f);
      const float a = ns && !shedc && (!is_space || slot || can_pre) && cand < close_t
                          ? cand : p.big;
      lmin = fminf(lmin, fminf(e, a));
    }
    for (int v = lane; v < V; v += 32)
      if (v_valid[v] && vfail[v] > time) lmin = fminf(lmin, vfail[v]);
    const float t_next = warp_min(lmin);
    const bool live = t_next < p.half_big;
    const float thr = fmaf(p.eps, fmaxf(t_next, 1.f), t_next);
    const float neg_dt = -(t_next - time);

    // SHED at the admission instant and BOOST urgency (carried rem), then
    // advance the fluid state and fire every completion in the tie window
    int maps_done = 0;
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      bool done = false;
      if (t < T) {
        const int v = cvm[t];
        const bool inr = v >= 0 && v < V;
        const float close_t = inr ? vclose[v] : 0.f;
        const float efin = t_next + rem[t] / fmaxf(inr ? vmips[v] : 0.f, p.tiny);
        f_shedt[t] = f_shedc[t] ||
                     (dl_shed && f_eval[t] && t_next < close_t && efin > dl[t]);
        f_urg[t] = dl_boost && f_eval[t] && efin + dl_slack >= dl[t];
        bool run = f_run[t];
        float rm = rem[t];
        if (run) rm = fmaf(neg_dt, rate[t], rm);
        done = live && run && eta[t] <= thr;
        if (done) {
          finish[t] = t_next;
          run = false;
          rm = 0.f;
          maps_done += !f_red[t];
        }
        f_run[t] = run;
        rem[t] = rm;
      }
      const unsigned m = __ballot_sync(kFull, done);
      if (lane == 0) donem[b >> 5] = m;
    }
    maps_done = __reduce_add_sync(kFull, maps_done);
    const int maps_left_new = maps_left - maps_done;
    const bool phase_done = maps_left_new == 0 && maps_left > 0;
    const float release = t_next + shuffle;

    // shuffle release, then failure kills (after completions: a task that
    // finishes at the failure instant completes), then eligibility
    bool lost_any = false;
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      bool e = false;
      if (t < T) {
        if (f_red[t] && phase_done) ready[t] = release;
        const int v = cvm[t];
        const bool inr = v >= 0 && v < V;
        const float ft = inr ? vfail[v] : 0.f, rt = inr ? vrest[v] : 0.f;
        const float close_t = inr ? vclose[v] : 0.f;
        const bool aff = f_valid[t] && live && ft > time && ft <= t_next &&
                         finish[t] >= p.half_big && !f_shedc[t];
        float lost = 0.f;
        if (aff) {
          lost = tlen[t] - rem[t];
          rem[t] = tlen[t];
          f_run[t] = 0;
          start[t] = p.big;
          float rd = fmaxf(ready[t], ft + redisp);
          if (!f_hit[t]) rd = rd + refetch[t];
          ready[t] = rd;
          f_hit[t] = 1;
        }
        lostf[t] = lost;
        lost_any |= lost != 0.f;
#ifdef MR_TRACE
        f_kill[t] = aff;
#endif
        e = live && f_ns[t] && elig[t] <= thr && t_next < close_t &&
            !(t_next >= ft && t_next < rt) && !f_shedt[t];
        f_ev[t] = 0;
      }
      const unsigned me = __ballot_sync(kFull, e);
      const unsigned ms = __ballot_sync(kFull, e && f_urg[t] && !(prio[t] >= -p.big));
      if (lane == 0) {
        elm[b >> 5] = me;
        stallm[b >> 5] = ms;
      }
    }
    __syncwarp();

    // preemption: on each full space-shared VM the weakest evictable
    // running task (lowest priority, latest index) loses its PE to an
    // eligible task that strictly outranks it
    if (pre_onl) {
      for (int v = lane; v < V; v += 32) {
        v_full[v] = (vpes[v] - (von[v] - (float)vm_set(v).count(donem, W))) <= 0.5f;
        vk_el[v] = okey(-p.big);
        vk_low[v] = okey(p.big);
        vvic[v] = -1;
      }
      __syncwarp();
      for (int t = lane; t < T; t += 32) {
        const int v = cvm[t];
        if (has(elm, t) && v >= 0 && v < V && v_full[v] && prio[t] == prio[t])
          atomicMax(&vk_el[v], okey(prio[t]));
      }
      __syncwarp();
      const auto victim_cand = [&](int t) {
        const int v = cvm[t];
        return v >= 0 && v < V && v_full[v] && f_run[t] && nev[t] < 2 &&
               okey_float(vk_el[v]) > prio[t];
      };
      for (int t = lane; t < T; t += 32)
        if (victim_cand(t)) atomicMin(&vk_low[cvm[t]], okey(prio[t]));
      __syncwarp();
      for (int t = lane; t < T; t += 32)
        if (victim_cand(t) && prio[t] == okey_float(vk_low[cvm[t]]))
          atomicMax(&vvic[cvm[t]], t);
      __syncwarp();
    }

    // free PEs per VM, after completions and evictions
    if (is_space) {
      for (int v = lane; v < V; v += 32) {
        float ev_c = 0.f;
        if (pre_onl && vvic[v] >= 0) {
          f_ev[vvic[v]] = 1;
          ev_c = 1.f;
        }
        vfree[v] = vpes[v] - (von[v] - (float)vm_set(v).count(donem, W) - ev_c);
      }
      __syncwarp();
    }

    // evictions, starts (time-shared: every eligible task; space-shared:
    // by rank), and the lane's lost work
    bool map_shed = false;
    for (int t = lane; t < T; t += 32) {
      float lost = 0.f;
      if (f_ev[t]) {
        if (!res_onl) {
          lost = tlen[t] - rem[t];
          rem[t] = tlen[t];
        }
        f_run[t] = 0;
        start[t] = p.big;
        float rd = fmaxf(ready[t], t_next + redisp);
        if (!f_hit[t]) rd = rd + refetch[t];
        ready[t] = rd;
        f_hit[t] = 1;
        nev[t] += 1;
      }
      loste[t] = lost;
      lost_any |= lost != 0.f;
      bool go = false;
      if (has(elm, t)) {
        const int v = cvm[t];
        go = !is_space ||
             (v >= 0 && v < V &&
              admitted(t, vm_set(v), elm, W, prio, elig, f_urg,
                       vm_set(v).count(stallm, W) > 0, vfree[v], p.max_pes, p.big));
      }
      if (go) {
        start[t] = t_next;
        f_run[t] = 1;
      }
      f_st[t] = go;
      map_shed |= f_shedt[t] && !f_red[t];
    }
    map_shed = __any_sync(kFull, map_shed);
    if (__any_sync(kFull, lost_any)) {
      __syncwarp();
      if (lane == 0) {
        const float sf = fixed_sum(lostf, T);
        const float se = fixed_sum(loste, T);
        work_lost = work_lost + sf + se;
      }
      work_lost = __shfl_sync(kFull, work_lost, 0);
    }
    // a shed map dooms the lane's reduces (one job per lane): mark them
    for (int t = lane; t < T; t += 32) {
      const bool shed = f_shedt[t] || (f_valid[t] && f_red[t] && map_shed &&
                                       finish[t] >= p.half_big && !f_run[t]);
#ifdef MR_TRACE
      f_nshed[t] = shed && !f_shed[t];
#endif
      f_shed[t] = shed;
    }
#ifdef MR_TRACE
    {
      const float t_new = live ? t_next : time;
      auto put = [&](int slot, float at, int kind, int task, int vm) {
        p.ev_t_out[rE + slot] = at;
        p.ev_kind_out[rE + slot] = kind;
        p.ev_task_out[rE + slot] = task;
        p.ev_vm_out[rE + slot] = vm;
      };
      int c = log_events(ev_n, V, p.E, [&](int v) { return v_opm[v] != 0; },
                         [&](int s, int v) { put(s, time, kEvScaleOpen, -1, v); });
      c = log_events(c, V, p.E, [&](int v) { return v_clm[v] != 0; },
                     [&](int s, int v) { put(s, time, kEvScaleClose, -1, v); });
      c = log_events(c, T, p.E, [&](int t) { return has(donem, t); },
                     [&](int s, int t) { put(s, t_next, kEvFinish, t, cvm[t]); });
      const int c_kill = c;
      c = log_events(c, T, p.E, [&](int t) { return f_kill[t] != 0; },
                     [&](int s, int t) {
                       const int v = cvm[t];
                       put(s, v >= 0 && v < V ? vfail[v] : 0.f, kEvKill, t, v);
                     });
      const int n_kill = c - c_kill;
      c = log_events(c, T, p.E, [&](int t) { return f_ev[t] != 0; },
                     [&](int s, int t) { put(s, t_next, kEvPreempt, t, cvm[t]); });
      const int n_evict = c - c_kill - n_kill;
      c = log_events(c, T, p.E, [&](int t) { return f_st[t] != 0; },
                     [&](int s, int t) { put(s, t_next, kEvStart, t, cvm[t]); });
      const int c_shed = c;
      c = log_events(c, T, p.E, [&](int t) { return f_nshed[t] != 0; },
                     [&](int s, int t) { put(s, t_new, kEvShed, t, cvm[t]); });
      const int n_shed = c - c_shed;
      ev_n = c;
      if (lane == 0 && lane_ep < p.C) {
        float4* row = reinterpret_cast<float4*>(p.ts_out + rC + (long)lane_ep * 8);
        row[0] = make_float4(t_new, (float)q, busy_frac, (float)n_open);
        row[1] = make_float4(1.f, (float)n_kill, (float)n_shed, (float)n_evict);
      }
    }
#endif
    if (live) time = t_next;
    maps_left = maps_left_new;
    ++lane_ep;
    __syncwarp();
  }

  for (int t = lane; t < T; t += 32) {
    p.rem_out[rT + t] = rem[t];
    p.running_out[rT + t] = f_run[t];
    p.start_out[rT + t] = start[t];
    p.finish_out[rT + t] = finish[t];
    p.ready_out[rT + t] = ready[t];
    p.hit_out[rT + t] = f_hit[t];
    p.shed_out[rT + t] = f_shed[t];
    p.n_evict_out[rT + t] = nev[t];
  }
  for (int v = lane; v < V; v += 32) {
    p.vm_open_out[rV + v] = vopen[v];
    p.vm_close_out[rV + v] = vclose[v];
  }
  if (lane == 0) {
    p.time_out[n] = time;
    p.maps_left_out[n] = maps_left;
    p.n_epochs_out[n] = lane_ep;
    p.n_scale_out[n] = n_scale;
    p.work_lost_out[n] = work_lost;
#ifdef MR_TRACE
    p.ev_n_out[n] = ev_n;
#endif
  }
}

}  // namespace

// The trace instantiation takes the six trace leaves after each carry and
// the capacities C (time-series rows) and E (event rows) after
// lanes_per_block.  vm_sets is null, or N x 2 x V x W words of scratch for
// the VMs' task sets when they do not fit in shared memory.
extern "C" int MR_LAUNCH(
    const float* task_len, const int* task_vm, const int* is_red,
    const int* valid, const float* shuffle, const float* vm_mips,
    const float* vm_pes, const int* sched, const float* spinup,
    const float* prio, const int* vm_valid, const float* vm_fail,
    const float* vm_restore, const int* vm_auto, const int* ctl_policy,
    const float* ctl_queue, const float* ctl_busy, const float* redispatch,
    const int* task_vm2, const float* refetch, const float* task_deadline,
    const int* dl_policy, const float* dl_slack, const int* preempt,
    const int* preempt_resume,
    const float* time_in, const float* rem_in, const int* running_in,
    const float* start_in, const float* finish_in, const float* ready_in,
    const int* maps_left_in, const int* n_epochs_in, const int* hit_in,
    const float* vm_open_in, const float* vm_close_in, const int* n_scale_in,
    const int* shed_in, const int* n_evict_in, const float* work_lost_in,
#ifdef MR_TRACE
    const float* ts_in, const float* ev_t_in, const int* ev_kind_in,
    const int* ev_task_in, const int* ev_vm_in, const int* ev_n_in,
#endif
    float* time_out, float* rem_out, int* running_out, float* start_out,
    float* finish_out, float* ready_out, int* maps_left_out,
    int* n_epochs_out, int* hit_out, float* vm_open_out, float* vm_close_out,
    int* n_scale_out, int* shed_out, int* n_evict_out, float* work_lost_out,
#ifdef MR_TRACE
    float* ts_out, float* ev_t_out, int* ev_kind_out, int* ev_task_out,
    int* ev_vm_out, int* ev_n_out,
#endif
    unsigned* vm_sets, int N, int T, int V, int max_pes, int epoch_limit,
    int lanes_per_block,
#ifdef MR_TRACE
    int C, int E,
#endif
    float big, float half_big, float eps, float tiny, void* stream) {
  Params p{task_len, task_vm, is_red, valid, shuffle, vm_mips, vm_pes, sched,
           spinup, prio, vm_valid, vm_fail, vm_restore, vm_auto, ctl_policy,
           ctl_queue, ctl_busy, redispatch, task_vm2, refetch, task_deadline,
           dl_policy, dl_slack, preempt, preempt_resume,
           time_in, rem_in, running_in, start_in, finish_in, ready_in,
           maps_left_in, n_epochs_in, hit_in, vm_open_in, vm_close_in,
           n_scale_in, shed_in, n_evict_in, work_lost_in,
           time_out, rem_out, running_out, start_out, finish_out, ready_out,
           maps_left_out, n_epochs_out, hit_out, vm_open_out, vm_close_out,
           n_scale_out, shed_out, n_evict_out, work_lost_out, vm_sets,
           N, T, V, max_pes, epoch_limit, lanes_per_block,
           lane_smem_bytes(T, V, vm_sets == nullptr), big, half_big, eps, tiny};
#ifdef MR_TRACE
  p.ts_in = ts_in;
  p.ev_t_in = ev_t_in;
  p.ev_kind_in = ev_kind_in;
  p.ev_task_in = ev_task_in;
  p.ev_vm_in = ev_vm_in;
  p.ev_n_in = ev_n_in;
  p.ts_out = ts_out;
  p.ev_t_out = ev_t_out;
  p.ev_kind_out = ev_kind_out;
  p.ev_task_out = ev_task_out;
  p.ev_vm_out = ev_vm_out;
  p.ev_n_out = ev_n_out;
  p.C = C;
  p.E = E;
#endif
  const auto kernel =
      vm_sets ? mr_epoch_control_kernel<false> : mr_epoch_control_kernel<true>;
  const size_t smem = (size_t)p.lane_bytes * lanes_per_block;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(32 * lanes_per_block);
  const dim3 grid((N + lanes_per_block - 1) / lanes_per_block);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
