// mr_schedule: the fixed-epoch MapReduce schedule of a batch of scenario
// lanes, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's first Pallas TPU kernel,
// kernels/mr_sched/kernel.py:_kernel (called through mr_schedule): single-job
// lanes, both sched policies, no lease windows, no priorities.  Each epoch
// evaluates processor-sharing rates, takes the next-event min over
// completions and arrivals (a space-shared task defines an arrival only while
// its VM has a free PE), fires every completion inside the 1e-6 tie window,
// admits the eligible tasks (time-shared: all; space-shared: those whose
// (ready, index) rank among the eligible tasks of their VM is below the VM's
// free PEs after the completions) and releases the reduces after the shuffle
// delay from the next epoch on.  The plain PyTorch version,
// kernel.py:mr_schedule_plain, runs the same op sequence; the two agree bit
// for bit on (start, finish).
//
// The TPU kernel runs 2T+2 epochs for every lane; an epoch with no live
// event changes no state, so each warp stops at its lane's first such epoch
// and the result is the same.
//
// What bounds it on this card.  A lane moves a few bytes per task for its
// whole history and does a few dozen operations per task slot and epoch:
// neither HBM bandwidth nor the fp32 rate is the limit.  Each epoch depends
// on the one before (next-event min -> completions -> admission -> next
// epoch), so a launch lasts as long as its slowest lane's chain of epochs:
// the kernel is bound by the latency of one epoch, and by how evenly the
// lanes spread over the SMs.
//
// Layout: one warp per lane, task slot t owned by thread t % 32, the lane's
// state in shared memory for its whole history (kernel.py:block_layout
// picks the lanes per block from the lane's bytes).  No thread walks a VM's
// task list.  Each VM's task set is a bit mask of W = ceil(T/32) words,
// built once per launch with atomicOr (the binding is static); the running,
// completed and eligible sets are ballots, one word per 32 tasks, so a
// per-VM running or completion count is W popcounts, the same exact integer
// the reference sums in f32.  A space-shared task's admission rank counts
// only the set bits of its VM's eligible mask, under the reference's
// (ready, index) key with float < and == (-0.0 ties 0.0), and stops at the
// first rank that fails rank < free PEs; when even the largest possible
// rank passes, the task is admitted with no walk.  Admission only compares
// and counts, so the rounding is the reference's.  When a lane does not
// fit a block with its VMs' task sets, the sets live in the lane's slice
// of a global scratch buffer (vm_sets) that the wrapper allocates.
//
// Rounding: built with -fmad=false and IEEE division, so every op rounds on
// its own, except where the reference's XLA:CPU lowering fuses a multiply
// into an add (rem - dt * rate, and the tie threshold t + 1e-6 * max(t, 1)):
// those use fmaf, one rounding, as the reference.  An arrival's
// max(ready, time) orders -0.0 below 0.0, as XLA:CPU does.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* task_len;
  const int* task_vm;
  const float* ready0;
  const int* is_red;
  const int* valid;
  const float* shuffle;
  const float* vm_mips;
  const float* vm_pes;
  const int* sched;
  float* start_out;
  float* finish_out;
  unsigned* vm_sets;  // V x W words per lane, or null: see lane_smem_bytes
  int N, T, V, lanes_per_block, lane_bytes;
  float big, half_big, eps, tiny;
};

// Shared-memory bytes of one lane; kernel.py:lane_smem_bytes agrees.  Per
// task: f32 x 7, i32 x 1, 4 flag bytes; per VM: f32 x 5; the VMs' task
// sets, V x W words, unless they live in the lane's slice of vm_sets;
// three per-epoch task sets, W words each.
__host__ __device__ inline int lane_smem_bytes(int T, int V, bool shared_sets) {
  const int W = (T + 31) / 32;
  const int vw = shared_sets ? V * W : 0;
  return (36 * T + 20 * V + 4 * vw + 12 * W + 15) / 16 * 16;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// max(a, b) as the reference's XLA:CPU lowering takes it: -0.0 orders below
// 0.0 (fmaxf may return either zero)
__device__ __forceinline__ float max_of(float a, float b) {
  return a == b ? (signbit(a) ? b : a) : fmaxf(a, b);
}

// |a & b| over W words
__device__ __forceinline__ int overlap(const unsigned* a, const unsigned* b, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popc(a[w] & b[w]);
  return c;
}

// Whether eligible space-shared task t of a VM with task set vset (W words)
// and free_v free PEs starts: its rank, the eligible tasks of the VM with
// an earlier (ready, index) key, must be below free_v as a float.  The
// test is monotone in the rank, so counting stops at the first rank that
// fails it.
__device__ bool admitted(int t, const unsigned* vset, const unsigned* elm, int W,
                         const float* ready, float free_v) {
  const auto ok = [&](int r) { return (float)r < free_v; };
  if (ok(overlap(vset, elm, W) - 1)) return true;  // every rank passes
  if (!ok(0)) return false;
  const float rt = ready[t];
  int rank = 0;
  for (int w = 0; w < W; ++w) {
    unsigned m = vset[w] & elm[w];
    while (m) {
      const int u = (w << 5) + __ffs(m) - 1;
      m &= m - 1;
      const float ru = ready[u];
      if ((ru < rt || (ru == rt && u < t)) && !ok(++rank)) return false;
    }
  }
  return true;
}

template <bool kSharedSets>
__global__ void mr_schedule_kernel(const Params p) {
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
  float* rate = ready + T;
  float* eta = rate + T;
  float* tpes = eta + T;
  float* vmips = tpes + T;
  float* vpes = vmips + V;
  float* von = vpes + V;      // running tasks at the epoch's start
  float* vshare = von + V;
  float* vfree = vshare + V;  // free PEs after the epoch's completions
  int* tvm = reinterpret_cast<int*>(vfree + V);
  // tasks bound to each VM: in shared memory, or in the lane's scratch
  unsigned* vset = kSharedSets ? reinterpret_cast<unsigned*>(tvm + T)
                               : p.vm_sets + n * V * W;
  unsigned* runm = kSharedSets ? vset + V * W  // running at the epoch's start
                               : reinterpret_cast<unsigned*>(tvm + T);
  unsigned* donem = runm + W; // completed this epoch
  unsigned* elm = donem + W;  // eligible this epoch
  unsigned char* f_valid = reinterpret_cast<unsigned char*>(elm + W);
  unsigned char* f_red = f_valid + T;
  unsigned char* f_run = f_red + T;
  unsigned char* f_ns = f_run + T;  // not started (epoch start)

  const long rT = n * T, rV = n * V;
  for (int t = lane; t < T; t += 32) {
    const int v = p.task_vm[rT + t];
    tvm[t] = v;
    rem[t] = p.task_len[rT + t];
    start[t] = p.big;
    finish[t] = p.big;
    ready[t] = p.ready0[rT + t];
    // the reference gathers vm_pes through a one-hot sum: exact, 0 for a
    // task bound out of range
    tpes[t] = v >= 0 && v < V ? p.vm_pes[rV + v] : 0.f;
    f_valid[t] = p.valid[rT + t] != 0;
    f_red[t] = p.is_red[rT + t] != 0;
    f_run[t] = 0;
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

  float time = 0.f;
  const float shuffle = p.shuffle[n];
  const bool is_space = p.sched[n] != 0;

  // Loops that ballot a task set run b over [0, T) in steps of 32 on every
  // lane, so the whole warp takes part in each ballot.
  for (int ep = 0; ep < 2 * T + 2; ++ep) {
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      const unsigned m = __ballot_sync(kFull, t < T && f_run[t]);
      if (lane == 0) runm[b >> 5] = m;
    }
    __syncwarp();

    // processor-sharing rates: per-VM running counts and shares
    for (int v = lane; v < V; v += 32) {
      const float c = (float)overlap(vset + v * W, runm, W);
      von[v] = c;
      vshare[v] = vmips[v] * fminf(1.f, vpes[v] / fmaxf(c, 1.f));
    }
    __syncwarp();

    // next event: completions and arrivals
    float lmin = p.big;
    for (int t = lane; t < T; t += 32) {
      const int v = tvm[t];
      const bool inr = v >= 0 && v < V;
      const bool run = f_run[t];
      const float r = (inr ? vshare[v] : 0.f) * (run ? 1.f : 0.f);
      rate[t] = r;
      const float e = run ? time + rem[t] / fmaxf(r, p.tiny) : p.big;
      eta[t] = e;
      const bool ns = f_valid[t] && !run && finish[t] >= p.half_big &&
                      start[t] >= p.half_big;
      f_ns[t] = ns;
      const bool slot = (tpes[t] - (inr ? von[v] : 0.f)) > 0.5f;
      const float a = ns && (!is_space || slot) ? max_of(ready[t], time) : p.big;
      lmin = fminf(lmin, fminf(e, a));
    }
    const float t_next = warp_min(lmin);
    if (!(t_next < p.half_big)) break;  // no live event: a fixed point
    const float thr = fmaf(p.eps, fmaxf(t_next, 1.f), t_next);
    const float neg_dt = -(t_next - time);

    // advance the fluid state; fire every completion in the tie window;
    // eligibility reads the ready times this epoch opened with
    int maps_left = 0, maps_done = 0;
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      bool done = false, el = false;
      if (t < T) {
        bool run = f_run[t];
        float rm = rem[t];
        if (run) rm = fmaf(neg_dt, rate[t], rm);
        done = run && eta[t] <= thr;
        if (done) {
          finish[t] = t_next;
          run = false;
          rm = 0.f;
        }
        f_run[t] = run;
        rem[t] = rm;
        const bool map = f_valid[t] && !f_red[t];
        maps_left += map && finish[t] >= p.half_big;
        maps_done += map && done;
        el = f_ns[t] && ready[t] <= thr;
      }
      const unsigned md = __ballot_sync(kFull, done);
      const unsigned me = __ballot_sync(kFull, el);
      if (lane == 0) {
        donem[b >> 5] = md;
        elm[b >> 5] = me;
      }
    }
    maps_left = __reduce_add_sync(kFull, maps_left);
    maps_done = __reduce_add_sync(kFull, maps_done);
    const bool phase_done = maps_left == 0 && maps_done > 0;
    __syncwarp();

    // admission: time-shared starts every eligible task; space-shared the
    // eligible tasks whose (ready, index) rank on their VM is below its free
    // PEs after the completions
    if (is_space) {
      for (int v = lane; v < V; v += 32)
        vfree[v] = vpes[v] - (von[v] - (float)overlap(vset + v * W, donem, W));
      __syncwarp();
    }
    for (int t = lane; t < T; t += 32) {
      if (!((elm[t >> 5] >> (t & 31)) & 1u)) continue;
      const int v = tvm[t];
      if (!is_space || (v >= 0 && v < V &&
                        admitted(t, vset + v * W, elm, W, ready, vfree[v]))) {
        start[t] = t_next;
        f_run[t] = 1;
      }
    }
    // the release goes after every rank has read this epoch's ready times
    if (phase_done) {
      __syncwarp();
      const float release = t_next + shuffle;
      for (int t = lane; t < T; t += 32)
        if (f_red[t]) ready[t] = release;
    }
    time = t_next;
    __syncwarp();
  }

  for (int t = lane; t < T; t += 32) {
    p.start_out[rT + t] = start[t];
    p.finish_out[rT + t] = finish[t];
  }
}

}  // namespace

// vm_sets is null, or N x V x W words of scratch for the VMs' task sets
// when they do not fit in shared memory.
extern "C" int mr_schedule_launch(
    const float* task_len, const int* task_vm, const float* ready0,
    const int* is_red, const int* valid, const float* shuffle,
    const float* vm_mips, const float* vm_pes, const int* sched,
    float* start_out, float* finish_out, unsigned* vm_sets, int N, int T,
    int V, int lanes_per_block, float big, float half_big, float eps,
    float tiny, void* stream) {
  Params p{task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips, vm_pes,
           sched, start_out, finish_out, vm_sets, N, T, V, lanes_per_block,
           lane_smem_bytes(T, V, vm_sets == nullptr), big, half_big, eps,
           tiny};
  const auto kernel = vm_sets ? mr_schedule_kernel<false> : mr_schedule_kernel<true>;
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
