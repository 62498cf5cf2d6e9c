// wkv6: the RWKV6 (finch) WKV recurrence, written by hand for NVIDIA Hopper
// (sm_90a):
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]          (y taken before the update)
//
// Replaces the JAX package's Pallas TPU kernel kernels/rwkv6/kernel.py:_kernel
// (called through wkv6_bhts), and is the production path of the model's
// _wkv_scan (models/ssm.py), which the TPU kernel names: it takes an initial
// state s0 and writes the final state, so prefill (T = S) and each decode
// step (T = 1) run through it.  The TPU kernel keeps the (hs, hs) state in
// VMEM across time blocks on a sequential grid axis; here one block per
// (batch, head) loops over T inside the block with the f32 state in
// registers, so the state never leaves the SM.
//
// What bounds it on an H100: at rwkv6-3b's prefill (B 4, 40 heads, T 2048,
// head size 64) the function needs ~6.8 GFLOP and moves ~0.3 GB, both a
// fraction of a millisecond, but the time axis is a chain of T dependent
// steps.  The first design gave each column j of the state to one thread:
// B * H = 160 blocks of 64 threads, 320 warps for the 528 warp schedulers
// of 132 SMs, each warp issuing about 64 * (7 fp32 ops + 3-4 shared loads)
// ~ 700 instructions a step; 1.49 ms over 2048 steps is ~1,450 cycles a
// step at 1980 MHz, about two cycles per instruction of one warp.  Timed
// on an H100 SXM (700 W) with the loop's global loads taken out, that
// design's arithmetic and barriers alone take 0.89 ms, and this one's
// 0.88-0.92 ms: on the 28 SMs that hold two of the 160 blocks, its four
// warps already fed all four schedulers, and a step's instructions per SM
// are the same in both.  The rest of its time, 0.60 ms, was spent waiting
// for the next step's inputs, which one step's arithmetic did not cover.
//
// The split: a block has G threads per column, HS * G in all.  Thread (g, j)
// keeps the R = HS / G consecutive rows [g R, (g + 1) R) of column j in
// registers (G = HS / 16 from HS = 32 up, so R = 16, the fastest of G = 2, 4,
// 8 at HS = 64; G = 1, the first design's layout, below), and u for those
// rows; r, k and w are read from shared memory four rows per load.  Each step,
// r, k, v and w go through shared memory, double-buffered, behind one barrier.
// The next step's 4 HS values are loaded before the current step is computed,
// one per thread at HS = 64 (not four), by unconditional loads (the last step
// loads its own inputs again) whose values are first read when they are
// stored, a step later: a load that is converted from bf16 or selected at
// once, or sits under a branch, makes the thread wait for it before the
// barrier.  At HS = 64 this takes 1.07 ms against the first design's 1.49 in
// the same run, in f32 and bf16 alike.  Built with -fmad=false: every product
// and sum rounds on its own.  The state update is the reference's op sequence
// per entry, kv = k_i v_j, S = w_i S + kv, so the final state is the plain
// version's bit for bit.  y_j is taken in G partial sums, each over its rows
// in increasing i, part = part + r_i (S + u_i kv); one thread per column adds
// them in g order, ((p_0 + p_1) + p_2) + ..., after the next step's barrier,
// so the order is fixed and no atomic is needed.
//
// Layout: r, k, v (B, T, H, hs) in float32 or bfloat16, w (B, T, H, hs) and
// u (H, hs) float32, all contiguous; y (B, T, H, hs) float32; s0 and s_out
// (B, H, hs, hs) float32, S[i][j] at [.., i, j]; s0 may be null (zeros).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Threads per column of the state: each holds R = HS / G of its rows.
template <int HS>
__host__ __device__ constexpr int row_groups() {
  return HS > 16 ? HS / 16 : 1;
}

// Issue this thread's loads of a step at element offset `at`: slot l holds
// x[at + col[l]] of x = r, k, v, w (arr[l] = 0..3; 4: no value), raw in
// lt[l] (r, k, v) or lw[l] (w).  Nothing here reads what it loads, so the
// loads stay in flight until the slots are stored a step later.
template <typename T, int NL>
__device__ __forceinline__ void fetch(const T* const (&src)[NL],
                                      const float* __restrict__ w,
                                      const int (&arr)[NL],
                                      const int (&col)[NL], long long at,
                                      T (&lt)[NL], float (&lw)[NL]) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (arr[l] < 3) lt[l] = src[l][at + col[l]];
    if (arr[l] == 3) lw[l] = w[at + col[l]];
  }
}

// y_j from the G partial sums p[0], p[HS], ..., added in g order.
template <int G, int HS>
__device__ __forceinline__ float sum_parts(const float* p) {
  float yj = p[0];
#pragma unroll
  for (int q = 1; q < G; ++q) yj = yj + p[q * HS];
  return yj;
}

template <typename T, int HS>
__global__ void __launch_bounds__(HS * row_groups<HS>())
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int Tn, int H) {
  constexpr int G = row_groups<HS>(), R = HS / G, NT = HS * G;
  constexpr int NL = (4 * HS + NT - 1) / NT;  // values a thread loads a step
  static_assert(R % 4 == 0, "rows are read four at a time");
  __shared__ __align__(16) float xs[2][4][HS];  // r, k, v, w of a step
  __shared__ float ps[2][G][HS];                // y's partial sums
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x % HS, g = threadIdx.x / HS, i0 = g * R;

  float S[R], ur[R];
  const long long s_base = (long long)bh * HS * HS;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    S[i] = s0 != nullptr ? s0[s_base + (i0 + i) * HS + j] : 0.0f;
    ur[i] = u[h * HS + i0 + i];
  }

  const long long step = (long long)H * HS;  // elements between time steps
  const long long base = ((long long)b * Tn * H + h) * HS;  // t = 0, j = 0
  // This thread's share of a step's inputs: value e = threadIdx.x + l NT
  // (l < NL, e < 4 HS) is x[e % HS] of x = r, k, v, w (e / HS).
  const T* src[NL];
  int arr[NL], col[NL];
  T lt[NL] = {};
  float lw[NL] = {};
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int e = threadIdx.x + l * NT;
    arr[l] = e < 4 * HS ? e / HS : 4;
    col[l] = e % HS;
    src[l] = arr[l] == 0 ? r : arr[l] == 1 ? k : v;
  }
  if (Tn > 0) fetch<T, NL>(src, w, arr, col, base, lt, lw);
  for (int t = 0; t < Tn; ++t) {
    const int buf = t & 1;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (arr[l] < 4)
        (&xs[buf][0][0])[threadIdx.x + l * NT] =
            arr[l] == 3 ? lw[l] : to_f32(lt[l]);
    }
    // the next step's inputs (at the last step, its own again), in flight
    // during step t
    fetch<T, NL>(src, w, arr, col, base + min(t + 1, Tn - 1) * step, lt, lw);
    __syncthreads();
    if (t > 0 && g == 0)
      y[base + (t - 1) * step + j] = sum_parts<G, HS>(&ps[buf ^ 1][0][j]);
    const float vj = xs[buf][2][j];
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(&xs[buf][0][i0 + q]);
      const float4 k4 = *reinterpret_cast<const float4*>(&xs[buf][1][i0 + q]);
      const float4 w4 = *reinterpret_cast<const float4*>(&xs[buf][3][i0 + q]);
      const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
      const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q + c;
        const float kv = kq[c] * vj;
        part = part + rq[c] * (S[i] + ur[i] * kv);
        S[i] = wq[c] * S[i] + kv;
      }
    }
    ps[buf][g][j] = part;
  }
  if (Tn > 0) {
    __syncthreads();
    if (g == 0)
      y[base + (Tn - 1) * step + j] =
          sum_parts<G, HS>(&ps[(Tn - 1) & 1][0][j]);
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) s_out[s_base + (i0 + i) * HS + j] = S[i];
  }
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int Tn, int H, cudaStream_t stream) {
  wkv6_kernel<T, HS><<<B * H, HS * row_groups<HS>(), 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, s_out, Tn, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* y, float* s_out, int B,
             int Tn, int H, int hs, cudaStream_t st) {
  switch (hs) {
    case 4: return launch<T, 4>(r, k, v, w, u, s0, y, s_out, B, Tn, H, st);
    case 8: return launch<T, 8>(r, k, v, w, u, s0, y, s_out, B, Tn, H, st);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, Tn, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, Tn, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, Tn, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* s_out, int dtype, int B, int Tn,
                           int H, int hs, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, y, s_out, B, Tn, H, hs, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, Tn, H, hs,
                                   st);
  return (int)cudaErrorInvalidValue;
}
