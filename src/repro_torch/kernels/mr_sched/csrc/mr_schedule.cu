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
// Layout: one warp per lane, task slot t owned by thread t % 32, the lane's
// state in shared memory for its whole history.  Per-VM running counts run
// one thread per VM over that VM's task list (built once, in index order);
// the admission rank of a task is counted by its own thread over its VM's
// list, which is the reference's T x T rank restricted to the tasks that can
// outrank it.
//
// Rounding: built with -fmad=false and IEEE division, so every op rounds on
// its own, except where the reference's XLA:CPU lowering fuses a multiply
// into an add (rem - dt * rate, and the tie threshold t + 1e-6 * max(t, 1)):
// those use fmaf, one rounding, as the reference.
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
  int N, T, V, lanes_per_block, lane_bytes;
  float big, half_big, eps, tiny;
};

// Shared-memory bytes of one lane: f32[T] x 7, f32[V] x 5, i32[T] x 2,
// i32[V+1], u8[T] x 7 (flags).
__host__ __device__ inline int lane_smem_bytes(int T, int V) {
  return (43 * T + 24 * V + 4 + 15) / 16 * 16;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__global__ void mr_schedule_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long n = (long)blockIdx.x * p.lanes_per_block + warp;
  if (n >= p.N) return;  // the whole warp leaves together
  const int T = p.T, V = p.V;

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
  int* vtasks = tvm + T;
  int* voff = vtasks + T;
  unsigned char* f_valid = reinterpret_cast<unsigned char*>(voff + V + 1);
  unsigned char* f_red = f_valid + T;
  unsigned char* f_run = f_red + T;
  unsigned char* f_ns = f_run + T;    // not started (epoch start)
  unsigned char* f_el = f_ns + T;     // eligible this epoch
  unsigned char* f_done = f_el + T;   // completed this epoch
  unsigned char* f_st = f_done + T;   // admitted this epoch

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
  __syncwarp();
  for (int v = lane; v < V; v += 32) {
    vmips[v] = p.vm_mips[rV + v];
    vpes[v] = p.vm_pes[rV + v];
    int c = 0;
    for (int t = 0; t < T; ++t) c += tvm[t] == v;
    voff[v + 1] = c;
  }
  __syncwarp();
  if (lane == 0) {
    voff[0] = 0;
    for (int v = 0; v < V; ++v) voff[v + 1] += voff[v];
  }
  __syncwarp();
  for (int v = lane; v < V; v += 32) {
    int k = voff[v];
    for (int t = 0; t < T; ++t)
      if (tvm[t] == v) vtasks[k++] = t;
  }
  __syncwarp();

  float time = 0.f;
  const float shuffle = p.shuffle[n];
  const bool is_space = p.sched[n] != 0;

  for (int ep = 0; ep < 2 * T + 2; ++ep) {
    // processor-sharing rates: per-VM running counts and shares
    for (int v = lane; v < V; v += 32) {
      float c = 0.f;
      for (int k = voff[v]; k < voff[v + 1]; ++k) c += f_run[vtasks[k]] ? 1.f : 0.f;
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
      const float a = ns && (!is_space || slot) ? fmaxf(ready[t], time) : p.big;
      lmin = fminf(lmin, fminf(e, a));
    }
    const float t_next = warp_min(lmin);
    if (!(t_next < p.half_big)) break;  // no live event: a fixed point
    const float thr = fmaf(p.eps, fmaxf(t_next, 1.f), t_next);
    const float neg_dt = -(t_next - time);

    // advance the fluid state; fire every completion in the tie window;
    // eligibility reads the ready times this epoch opened with
    int maps_left = 0, maps_done = 0;
    for (int t = lane; t < T; t += 32) {
      bool run = f_run[t];
      float rm = rem[t];
      if (run) rm = fmaf(neg_dt, rate[t], rm);
      const bool done = run && eta[t] <= thr;
      if (done) {
        finish[t] = t_next;
        run = false;
        rm = 0.f;
      }
      f_done[t] = done;
      f_run[t] = run;
      rem[t] = rm;
      const bool map = f_valid[t] && !f_red[t];
      maps_left += map && finish[t] >= p.half_big;
      maps_done += map && done;
      f_el[t] = f_ns[t] && ready[t] <= thr;
    }
    maps_left = __reduce_add_sync(kFull, maps_left);
    maps_done = __reduce_add_sync(kFull, maps_done);
    const bool phase_done = maps_left == 0 && maps_done > 0;
    __syncwarp();

    // free PEs per VM after the completions
    for (int v = lane; v < V; v += 32) {
      float done_c = 0.f;
      for (int k = voff[v]; k < voff[v + 1]; ++k) done_c += f_done[vtasks[k]] ? 1.f : 0.f;
      vfree[v] = vpes[v] - (von[v] - done_c);
    }
    __syncwarp();

    // admission: time-shared starts every eligible task; space-shared the
    // eligible tasks whose (ready, index) rank on their VM is below its free
    // PEs
    for (int t = lane; t < T; t += 32) {
      bool go = f_el[t];
      if (go && is_space) {
        const int v = tvm[t];
        float rank = 0.f, free_after = 0.f;
        if (v >= 0 && v < V) {
          const float rt = ready[t];
          for (int i = voff[v]; i < voff[v + 1]; ++i) {
            const int j = vtasks[i];
            if (f_el[j] && (ready[j] < rt || (ready[j] == rt && j < t))) rank += 1.f;
          }
          free_after = vfree[v];
        }
        go = rank < free_after;
      }
      f_st[t] = go;
    }
    __syncwarp();
    const float release = t_next + shuffle;
    for (int t = lane; t < T; t += 32) {
      if (f_st[t]) {
        start[t] = t_next;
        f_run[t] = 1;
      }
      if (phase_done && f_red[t]) ready[t] = release;
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

extern "C" int mr_schedule_launch(
    const float* task_len, const int* task_vm, const float* ready0,
    const int* is_red, const int* valid, const float* shuffle,
    const float* vm_mips, const float* vm_pes, const int* sched,
    float* start_out, float* finish_out, int N, int T, int V,
    int lanes_per_block, float big, float half_big, float eps, float tiny,
    void* stream) {
  Params p{task_len, task_vm, ready0, is_red, valid, shuffle, vm_mips, vm_pes,
           sched, start_out, finish_out, N, T, V, lanes_per_block,
           lane_smem_bytes(T, V), big, half_big, eps, tiny};
  const size_t smem = (size_t)p.lane_bytes * lanes_per_block;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mr_schedule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(32 * lanes_per_block);
  const dim3 grid((N + lanes_per_block - 1) / lanes_per_block);
  mr_schedule_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
