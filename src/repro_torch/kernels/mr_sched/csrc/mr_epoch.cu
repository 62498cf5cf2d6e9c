// mr_epoch: the IOTSim event-epoch loop for a batch of scenario lanes,
// open-loop lowering, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mr_sched/megakernel.py:_kernel (called through _mr_epoch_impl).
// The plain PyTorch version, megakernel.py:mr_epoch_plain, runs the same
// algorithm; the two agree bit for bit on all 8 carry leaves.
//
// What bounds it on this card.  The bytes a lane must move (lane data in,
// carry in and out) are a few KB for a whole history of up to 2T+2 epochs,
// and its operations a few dozen per task slot and epoch: neither HBM
// bandwidth nor the fp32 rate is the limit.  Each epoch depends on the one
// before (next-event min -> completions -> admission -> next epoch), so a
// launch lasts as long as its slowest lane's chain of epochs: the kernel is
// bound by the latency of one epoch.  The whole carry of a lane stays in
// shared memory for its entire history (one HBM read and one write per
// leaf); each lane has one warp, so the per-epoch reductions are warp
// shuffles and ballots with no block barrier; each warp stops at its own
// lane's last event (the TPU kernel stopped a whole tile at its slowest
// lane; a finished lane is a fixed point of the epoch body, so per-lane
// results, n_epochs included, are the same).
//
// What the first design lost.  It ran every per-VM reduction on one thread
// per VM walking that VM's task list through dependent shared-memory loads:
// the running and completion counts, and an admission scan of max_pes steps
// of three passes each (maximum priority, minimum eligible time, first
// index).  The grids have 1-9 VMs, so most of the warp idled, and a lane
// with most of its tasks on one VM paid 3 x max_pes x T dependent loads per
// epoch on one thread.
//
// What this design does.  No thread walks a VM's task list inside the
// epoch loop.  Each VM's task set is a bit mask (W = ceil(T/32) words,
// built once per launch, the binding being static); the running,
// completed and eligible sets are ballots, so a per-VM count is W popcounts.
// Admission is by per-task rank, the rule of the JAX engine
// (core/engine.py:953-955) that the Pallas scan reproduces: the scan picks
// a VM's eligible tasks in (priority desc, eligible time asc, index asc)
// order and admits the one picked at step s < max_pes iff s < the VM's
// free PEs, so each eligible task counts the eligible tasks of its VM ahead
// of it and is admitted iff that rank passes both tests.  Keys compare with
// the scan's float == and >: -0.0 ties 0.0, and a priority below -1e30 (the
// scan's starting maximum) or NaN is never picked.  Admission only compares
// and counts, so the rule changes no rounding.  When a lane does not fit a
// block with its VMs' task sets (a large fleet), the sets live in the
// lane's slice of a global scratch buffer (vm_sets); the kernel is a
// template on where they live, so the shared-memory instantiation keeps its
// code.
//
// Rounding: built with -fmad=false and IEEE division, so every op rounds on
// its own, except the two places where the reference's XLA:CPU lowering
// fuses a multiply into an add (rem - dt * r, and the tie threshold
// t + 1e-6 * max(t, 1)): those use fmaf, one rounding, as the reference.
//
// Built with -DMR_TRACE this source gives the trace instantiation (the
// trace=True lowering of the same Pallas kernel, megakernel.py:211-213,
// 236-239, 534-591, plus the event log of the JAX engine's recorder,
// engine.py:974-1074); without it the code below is the untraced kernel
// and nothing of the trace is compiled.  Each active epoch writes one
// 32-byte time-series row (clock, queue depth, busy fraction and open VMs
// taken on the epoch's opening carry, activity; no failures, sheds or
// preemptions on the open loop) at the lane's epoch index, and appends its
// completions, then its starts, in task order, at the lane's cursor: a warp
// ballot gives each event its slot, a row lands where the slot is below the
// log's capacity E, and the cursor counts every event.  Rows go straight to
// global memory; each lane first copies its incoming trace leaves to the
// outputs, so a resumed call appends to them.
#include <cuda_runtime.h>

#ifdef MR_TRACE
#define MR_LAUNCH mr_epoch_trace_launch
#else
#define MR_LAUNCH mr_epoch_launch
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  // lane data
  const int* task_vm;
  const int* is_red;
  const int* valid;
  const float* shuffle;
  const float* vm_mips;
  const float* vm_pes;
  const int* sched;
  const float* vm_start;
  const float* vm_stop;
  const float* spinup;
  const float* prio;
  // carry in
  const float* time_in;
  const float* rem_in;
  const int* running_in;
  const float* start_in;
  const float* finish_in;
  const float* ready_in;
  const int* maps_left_in;
  const int* n_epochs_in;
  // carry out
  float* time_out;
  float* rem_out;
  int* running_out;
  float* start_out;
  float* finish_out;
  float* ready_out;
  int* maps_left_out;
  int* n_epochs_out;
  unsigned* vm_sets;  // V x W words per lane, or null: see lane_smem_bytes
  int N, T, V, max_pes, epoch_limit, lanes_per_block, lane_bytes;
  float big, half_big, eps, tiny;
#ifdef MR_TRACE
  const int* vm_valid;
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

// Shared-memory bytes of one lane; megakernel.py:lane_smem_bytes agrees.
// Per task: f32 x 11, i32 x 1, 5 flag bytes; per VM: f32 x 5; the VMs'
// task sets, V x W words, unless they live in the lane's slice of the
// global scratch vm_sets (a large fleet: megakernel.py:block_layout); three
// per-epoch task sets, W words each.
__host__ __device__ inline int lane_smem_bytes(int T, int V, bool shared_sets) {
  const int W = (T + 31) / 32;
  const int vw = shared_sets ? V * W : 0;
  return (53 * T + 20 * V + 4 * vw + 12 * W + 15) / 16 * 16;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ bool has(const unsigned* set, int t) {
  return (set[t >> 5] >> (t & 31)) & 1u;
}

// |a & b| over W words
__device__ __forceinline__ int overlap(const unsigned* a, const unsigned* b, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popc(a[w] & b[w]);
  return c;
}

// Whether the admission scan admits eligible task t of VM v, whose task set
// is vset (W words): its rank, the eligible tasks of v that the scan picks
// before t, must be below max_pes and, as a float, below free_v.  Both
// tests are monotone in the rank, so counting stops at the first rank that
// fails them.
__device__ bool admitted(int t, const unsigned* vset, const unsigned* elm, int W,
                         const float* prio, const float* elig, float free_v,
                         int max_pes, float big) {
  const float pt = prio[t];
  if (!(pt >= -big)) return false;  // never equals the scan's maximum
  const auto ok = [&](int r) { return r < max_pes && (float)r < free_v; };
  if (ok(overlap(vset, elm, W) - 1)) return true;  // every rank passes
  if (!ok(0)) return false;
  const float et = elig[t];
  int rank = 0;
  for (int w = 0; w < W; ++w) {
    unsigned m = vset[w] & elm[w];
    while (m) {
      const int u = (w << 5) + __ffs(m) - 1;
      m &= m - 1;
      const float pu = prio[u], eu = elig[u];
      if ((pu > pt || (pu == pt && (eu < et || (eu == et && u < t)))) && !ok(++rank))
        return false;
    }
  }
  return true;
}

#ifdef MR_TRACE
constexpr int kEvStart = 0, kEvFinish = 1;  // telemetry.EV_*

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

template <bool kSharedSets>
__global__ void mr_epoch_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long n = (long)blockIdx.x * p.lanes_per_block + warp;
  if (n >= p.N) return;  // the whole warp leaves together
  const int T = p.T, V = p.V, W = (T + 31) / 32;

  // per-lane shared memory, in lane_smem_bytes order
  unsigned char* base = smem + (size_t)warp * p.lane_bytes;
  float* rem = reinterpret_cast<float*>(base);
  float* start = rem + T;
  float* finish = start + T;
  float* ready = finish + T;
  float* elig = ready + T;
  float* prio = elig + T;
  float* avail = prio + T;
  float* close_t = avail + T;
  float* tpes = close_t + T;
  float* rate = tpes + T;
  float* eta = rate + T;
  float* vmips = eta + T;
  float* vpes = vmips + V;
  float* von = vpes + V;     // running tasks at the epoch's start
  float* vshare = von + V;
  float* vfree = vshare + V; // free PEs after this epoch's completions
  int* tvm = reinterpret_cast<int*>(vfree + V);
  // tasks bound to each VM: in shared memory, or in the lane's scratch
  unsigned* vset = kSharedSets ? reinterpret_cast<unsigned*>(tvm + T)
                               : p.vm_sets + n * V * W;
  unsigned* runm = kSharedSets ? vset + V * W  // running at the epoch's start
                               : reinterpret_cast<unsigned*>(tvm + T);
  unsigned* donem = runm + W;     // completed this epoch
  unsigned* elm = donem + W;      // eligible this epoch
  unsigned char* f_valid = reinterpret_cast<unsigned char*>(elm + W);
  unsigned char* f_red = f_valid + T;
  unsigned char* f_run = f_red + T;
  unsigned char* f_ns = f_run + T;     // not started (epoch start)
  unsigned char* f_st = f_ns + T;      // started this epoch

  const long rT = n * T, rV = n * V;
  const float spin = p.spinup[n];
  for (int t = lane; t < T; t += 32) {
    const int v = p.task_vm[rT + t];
    const bool inr = v >= 0 && v < V;
    tvm[t] = v;
    rem[t] = p.rem_in[rT + t];
    start[t] = p.start_in[rT + t];
    finish[t] = p.finish_in[rT + t];
    ready[t] = p.ready_in[rT + t];
    prio[t] = p.prio[rT + t];
    // the reference gathers per-VM (vm_start + spinup), vm_stop, vm_pes
    // through one-hot sums: exact, 0 for a task bound out of range
    avail[t] = inr ? p.vm_start[rV + v] + spin : 0.f;
    close_t[t] = inr ? p.vm_stop[rV + v] : 0.f;
    tpes[t] = inr ? p.vm_pes[rV + v] : 0.f;
    f_valid[t] = p.valid[rT + t] != 0;
    f_red[t] = p.is_red[rT + t] != 0;
    f_run[t] = p.running_in[rT + t] != 0;
  }
  for (int v = lane; v < V; v += 32) {
    vmips[v] = p.vm_mips[rV + v];
    vpes[v] = p.vm_pes[rV + v];
  }
  for (int i = lane; i < V * W; i += 32) vset[i] = 0u;
  __syncwarp();
  for (int t = lane; t < T; t += 32) {
    const int v = tvm[t];
    if (v >= 0 && v < V) atomicOr(&vset[v * W + (t >> 5)], 1u << (t & 31));
  }
  __syncwarp();

  float time = p.time_in[n];
  int maps_left = p.maps_left_in[n];
  int lane_ep = p.n_epochs_in[n];
  const float shuffle = p.shuffle[n];
  const bool is_space = p.sched[n] != 0;
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
      unfinished |= in && f_valid[t] && finish[t] >= p.half_big;
      const unsigned m = __ballot_sync(kFull, in && f_run[t]);
      if (lane == 0) runm[b >> 5] = m;
    }
    if (!__any_sync(kFull, unfinished)) break;
    __syncwarp();

    // processor-sharing rates: per-VM running counts and shares
    for (int v = lane; v < V; v += 32) {
      const float c = (float)overlap(vset + v * W, runm, W);
      von[v] = c;
      vshare[v] = vmips[v] * fminf(1.f, vpes[v] / fmaxf(c, 1.f));
    }
    __syncwarp();
#ifdef MR_TRACE
    // the control hook's observables on the opening carry, over the
    // static lease windows: queue depth, open VMs, busy open VMs
    int tq = 0, topen = 0, tbusy = 0;
    for (int t = lane; t < T; t += 32)
      tq += f_valid[t] && finish[t] >= p.half_big && start[t] >= p.half_big &&
            ready[t] <= time;
    for (int v = lane; v < V; v += 32) {
      const bool open = p.vm_valid[rV + v] != 0 &&
                        p.vm_start[rV + v] + spin <= time && time < p.vm_stop[rV + v];
      topen += open;
      tbusy += open && von[v] > 0.5f;
    }
    const float q_d = (float)__reduce_add_sync(kFull, tq);
    const float n_o = (float)__reduce_add_sync(kFull, topen);
    const float b_f = (float)__reduce_add_sync(kFull, tbusy) / fmaxf(n_o, 1.f);
#endif

    // next event: completions and lease-gated arrivals
    float lmin = p.big;
    for (int t = lane; t < T; t += 32) {
      const int v = tvm[t];
      const bool inr = v >= 0 && v < V;
      const bool run = f_run[t];
      const float r = run && inr ? vshare[v] : 0.f;
      rate[t] = r;
      const float e = run ? time + rem[t] / fmaxf(r, p.tiny) : p.big;
      eta[t] = e;
      const bool ns = f_valid[t] && !run && finish[t] >= p.half_big &&
                      start[t] >= p.half_big;
      f_ns[t] = ns;
      const float el = fmaxf(ready[t], avail[t]);
      elig[t] = el;
      const float cand = fmaxf(el, time);
      const bool slot = (tpes[t] - (inr ? von[v] : 0.f)) > 0.5f;
      const float a = ns && (!is_space || slot) && cand < close_t[t] ? cand : p.big;
      lmin = fminf(lmin, fminf(e, a));
    }
    const float t_next = warp_min(lmin);
    const bool live = t_next < p.half_big;
    const float thr = fmaf(p.eps, fmaxf(t_next, 1.f), t_next);
    const float neg_dt = -(t_next - time);

    // advance the fluid state; fire every completion in the tie window
    int maps_done = 0;
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      bool done = false;
      if (t < T) {
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
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      bool e = false;
      if (t < T) {
        if (f_red[t] && phase_done) ready[t] = release;
        e = live && f_ns[t] && elig[t] <= thr && t_next < close_t[t];
      }
      const unsigned m = __ballot_sync(kFull, e);
      if (lane == 0) elm[b >> 5] = m;
    }
    __syncwarp();

    // starts: time-shared starts every eligible task; space-shared admits
    // by rank into each VM's PEs left free after the completions
    if (is_space) {
      for (int v = lane; v < V; v += 32)
        vfree[v] = vpes[v] - (von[v] - (float)overlap(vset + v * W, donem, W));
      __syncwarp();
    }
    for (int t = lane; t < T; t += 32) {
      bool go = false;
      if (has(elm, t)) {
        const int v = tvm[t];
        go = !is_space || (v >= 0 && v < V &&
                           admitted(t, vset + v * W, elm, W, prio, elig, vfree[v],
                                    p.max_pes, p.big));
      }
      if (go) {
        start[t] = t_next;
        f_run[t] = 1;
      }
      f_st[t] = go;
    }
#ifdef MR_TRACE
    {
      const float t_new = live ? t_next : time;
      if (lane == 0 && lane_ep < p.C) {
        float4* row = reinterpret_cast<float4*>(p.ts_out + rC + (long)lane_ep * 8);
        row[0] = make_float4(t_new, q_d, b_f, n_o);
        row[1] = make_float4(1.f, 0.f, 0.f, 0.f);
      }
      auto put = [&](int slot, int t, int kind) {
        p.ev_t_out[rE + slot] = t_next;
        p.ev_kind_out[rE + slot] = kind;
        p.ev_task_out[rE + slot] = t;
        p.ev_vm_out[rE + slot] = tvm[t];
      };
      ev_n = log_events(ev_n, T, p.E, [&](int t) { return has(donem, t); },
                        [&](int s, int t) { put(s, t, kEvFinish); });
      ev_n = log_events(ev_n, T, p.E, [&](int t) { return f_st[t] != 0; },
                        [&](int s, int t) { put(s, t, kEvStart); });
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
  }
  if (lane == 0) {
    p.time_out[n] = time;
    p.maps_left_out[n] = maps_left;
    p.n_epochs_out[n] = lane_ep;
#ifdef MR_TRACE
    p.ev_n_out[n] = ev_n;
#endif
  }
}

}  // namespace

// The trace instantiation takes vm_valid after prio, the six trace leaves
// after each carry, and the capacities C (time-series rows) and E (event
// rows) after lanes_per_block.  vm_sets is null, or N x V x W words of
// scratch for the VMs' task sets when they do not fit in shared memory.
extern "C" int MR_LAUNCH(
    const int* task_vm, const int* is_red, const int* valid,
    const float* shuffle, const float* vm_mips, const float* vm_pes,
    const int* sched, const float* vm_start, const float* vm_stop,
    const float* spinup, const float* prio,
#ifdef MR_TRACE
    const int* vm_valid,
#endif
    const float* time_in, const float* rem_in, const int* running_in,
    const float* start_in, const float* finish_in, const float* ready_in,
    const int* maps_left_in, const int* n_epochs_in,
#ifdef MR_TRACE
    const float* ts_in, const float* ev_t_in, const int* ev_kind_in,
    const int* ev_task_in, const int* ev_vm_in, const int* ev_n_in,
#endif
    float* time_out, float* rem_out, int* running_out, float* start_out,
    float* finish_out, float* ready_out, int* maps_left_out,
    int* n_epochs_out,
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
  Params p{task_vm, is_red, valid, shuffle, vm_mips, vm_pes, sched,
           vm_start, vm_stop, spinup, prio,
           time_in, rem_in, running_in, start_in, finish_in, ready_in,
           maps_left_in, n_epochs_in,
           time_out, rem_out, running_out, start_out, finish_out, ready_out,
           maps_left_out, n_epochs_out, vm_sets,
           N, T, V, max_pes, epoch_limit, lanes_per_block,
           lane_smem_bytes(T, V, vm_sets == nullptr), big, half_big, eps, tiny};
#ifdef MR_TRACE
  p.vm_valid = vm_valid;
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
  const auto kernel = vm_sets ? mr_epoch_kernel<false> : mr_epoch_kernel<true>;
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
