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
// step (T = 1) run through it.  The plain PyTorch version,
// kernel.py:wkv6_scan_plain, runs the same op sequence.
//
// What bounds it on an H100: at rwkv6-3b's prefill (B 4, 40 heads, T 2048,
// head size 64) the recurrence needs ~6.8 GFLOP -- 5 per state entry per
// step (the y sum and the update; the u term factors as
// v[j] sum_i r[i] u[i] k[i], 5 per column) -- against ~0.3 GB of r, k, v, w,
// y and the states, both a fraction of a millisecond; but the time axis is a
// chain of T dependent steps, so a first version is bound by the latency of
// each step.  This version follows the reference's op sequence, 7 per entry
// (the u term per entry), which a faster version would factor out.  The TPU kernel keeps the
// (hs, hs) state in VMEM across time blocks on a sequential grid axis; here
// one block per (batch, head) loops over T inside the block, and each of its
// hs threads owns one column j of the f32 state in registers for the whole
// sequence, so the state never leaves the SM.  r, k, w of a step are
// broadcast through shared memory (double-buffered: one barrier per step),
// and the next step's inputs are loaded before the current step is computed,
// which hides the global-memory latency behind the step's arithmetic.  Built
// with -fmad=false: every product and sum rounds on its own, as in the
// reference's op sequence.
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

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int Tn, int H) {
  __shared__ float rs[2][HS], ks[2][HS], ws[2][HS], us[HS];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[HS];
  const long long s_base = (long long)bh * HS * HS;
#pragma unroll
  for (int i = 0; i < HS; ++i)
    S[i] = s0 != nullptr ? s0[s_base + i * HS + j] : 0.0f;
  us[j] = u[h * HS + j];

  const long long step = (long long)H * HS;  // elements between time steps
  long long idx = ((long long)b * Tn * H + h) * HS + j;
  float rn = 0.0f, kn = 0.0f, vn = 0.0f, wn = 0.0f;
  if (Tn > 0) {
    rn = to_f32(r[idx]);
    kn = to_f32(k[idx]);
    vn = to_f32(v[idx]);
    wn = w[idx];
  }
  for (int t = 0; t < Tn; ++t, idx += step) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    if (t + 1 < Tn) {  // the next step's inputs, in flight during this one
      rn = to_f32(r[idx + step]);
      kn = to_f32(k[idx + step]);
      vn = to_f32(v[idx + step]);
      wn = w[idx + step];
    }
    __syncthreads();
    float yj = 0.0f;
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      const float kv = ks[buf][i] * vj;
      yj = yj + rs[buf][i] * (S[i] + us[i] * kv);
      S[i] = ws[buf][i] * S[i] + kv;
    }
    y[idx] = yj;
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int i = 0; i < HS; ++i) s_out[s_base + i * HS + j] = S[i];
  }
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int Tn, int H, cudaStream_t stream) {
  wkv6_kernel<T, HS><<<B * H, HS, 0, stream>>>(
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
