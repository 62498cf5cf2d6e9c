// wkv6_bwd: the gradient of the RWKV6 (finch) WKV recurrence (csrc/wkv6.cu),
// written by hand for NVIDIA Hopper (sm_90a).  With the forward
//
//   y_t[j] = sum_i r_t[i] (S_t[i][j] + u[i] k_t[i] v_t[j])
//   S_{t+1}[i][j] = w_t[i] S_t[i][j] + k_t[i] v_t[j]        (S_0 = s0)
//
// and gy_t = dL/dy_t, G = dL/dS_{t+1} walks back from dL/dS_T (gs, or
// zeros) through
//
//   gw_t[i] = sum_j G[i][j] S_t[i][j]
//   gk_t[i] = sum_j G[i][j] v_t[j] + u[i] r_t[i] (gy_t . v_t)
//   gr_t[i] = sum_j gy_t[j] S_t[i][j] + u[i] k_t[i] (gy_t . v_t)
//   gv_t[j] = sum_i k_t[i] G[i][j] + (sum_i r_t[i] u[i] k_t[i]) gy_t[j]
//   gu[i]  += r_t[i] k_t[i] (gy_t . v_t)
//   G[i][j] <- w_t[i] G[i][j] + r_t[i] gy_t[j]              (= dL/dS_t)
//
// and gs0 = dL/dS_0.  It replaces no Pallas kernel: the JAX package gets
// this gradient by differentiating its lax.scan (models/ssm.py:_wkv_scan,
// through jax.value_and_grad in train/trainer.py); the port's forward is a
// kernel that autograd cannot see through, so its gradient is a kernel too
// (kernels/rwkv6/kernel.py:WKV6).
//
// The walk needs S_t in reverse order.  Inverting the update divides by w,
// which decays towards 0, so the forward under autograd keeps the state
// every WKV6_CHUNK = 64 steps (s_chk, written by wkv6.cu), and this kernel
// replays each chunk's states from its snapshot into a scratch buffer,
// then walks the chunk backwards.  The replay is the forward's update, op
// for op (kv = k_i v_j, S = w_i S + kv; built with -fmad=false), so the
// replayed states are the forward's bit for bit.
//
// One block per (batch, head), one thread per row i of the state: thread
// i keeps G[i][:] in registers, and during a replay S[i][:], and writes
// and reads back only its own entries of the scratch (stored [t][j][i], so
// a warp's accesses are contiguous).  gw, gk and gr are sums within the
// thread.  gv is a sum over rows: each thread stores its k_i G[i][j] in
// shared memory and thread j adds column j in increasing i.  Every sum has
// a fixed order and there is no atomic, so the gradients are the same bits
// from run to run; gu leaves as per-(batch, head) partials (gu_part), which
// the wrapper adds over the batch in a fixed order.
//
// What bounds it on an H100: per step and state entry about 14 float32
// operations (3 in the replay; G·S, G·v, gy·S, k·G, the update of G and
// the column sum in the walk), at rwkv6-3b's training shape (B 4, 40
// heads, T 512, head size 64) ~1.2 GFLOP, against ~84 MB of inputs and
// outputs: ~0.02 ms at either rate.  The time axis is a chain of T
// dependent steps per block, 160 blocks of two warps on 132 SMs, and the
// scratch round trip (160 x 64 x 16 KB per chunk, more than the L2 holds)
// adds ~2.7 GB of traffic; a first kernel, right and simple, not fast.
//
// Layout: r, k, v (B, T, H, hs) in float32 or bfloat16, w and gy (B, T, H,
// hs) float32, u (H, hs) float32; s_chk (B, H, ceil(T / 64), hs, hs) and
// gs / gs0 (B, H, hs, hs) float32, S[i][j] at [.., i, j]; gs may be null
// (zeros).  scratch (B, H, 64, hs, hs) float32.  Out: gr, gk, gv, gw (B, T,
// H, hs) float32, gu_part (B, H, hs) float32, gs0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WKV6_CHUNK 64  // steps between kept states (as in wkv6.cu)

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s_chk,
                const float* __restrict__ gy, const float* __restrict__ gs,
                float* __restrict__ scratch, float* __restrict__ gr,
                float* __restrict__ gk, float* __restrict__ gv,
                float* __restrict__ gw, float* __restrict__ gu_part,
                float* __restrict__ gs0, int Tn, int H) {
  __shared__ float kg[HS][HS + 1];  // k_i G[i][j]; padded: no bank conflict
  __shared__ float sv[2][HS], sgy[2][HS], sruk[2][HS];  // by step parity
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H, i = threadIdx.x;
  const long long s_base = (long long)bh * HS * HS;
  const long long step = (long long)H * HS;  // elements between time steps
  const long long base = ((long long)b * Tn * H + h) * HS;  // t = 0, j = 0
  const int nc = (Tn + WKV6_CHUNK - 1) / WKV6_CHUNK;
  const float ui = u[h * HS + i];
  float* scr = scratch + (long long)bh * WKV6_CHUNK * HS * HS + i;

  float G[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j)
    G[j] = gs != nullptr ? gs[s_base + i * HS + j] : 0.0f;
  float gu_acc = 0.0f;
  int par = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * WKV6_CHUNK, t1 = min(t0 + WKV6_CHUNK, Tn);
    {
      // replay S_t for t in [t0, t1) from the kept S_t0, row i
      float S[HS];
      const float* snap = s_chk + ((long long)bh * nc + c) * HS * HS + i * HS;
#pragma unroll
      for (int j = 0; j < HS; ++j) S[j] = snap[j];
      for (int t = t0; t < t1; ++t) {
        float* dst = scr + (long long)(t - t0) * HS * HS;
#pragma unroll
        for (int j = 0; j < HS; ++j) dst[j * HS] = S[j];
        if (t + 1 < t1) {
          const long long at = base + t * step;
          const float ki = to_f32(k[at + i]), wi = w[at + i];
#pragma unroll
          for (int j = 0; j < HS; ++j) {
            const float kv = ki * to_f32(v[at + j]);
            S[j] = wi * S[j] + kv;
          }
        }
      }
    }
    // walk the chunk backwards
    for (int t = t1 - 1; t >= t0; --t) {
      const long long at = base + t * step;
      const float ri = to_f32(r[at + i]), ki = to_f32(k[at + i]);
      const float wi = w[at + i];
      sv[par][i] = to_f32(v[at + i]);
      sgy[par][i] = gy[at + i];
      sruk[par][i] = ri * ui * ki;
      __syncthreads();
      float dot = 0.0f;  // gy_t . v_t, the same order in every thread
#pragma unroll
      for (int j = 0; j < HS; ++j) dot = dot + sgy[par][j] * sv[par][j];
      const float* src = scr + (long long)(t - t0) * HS * HS;
      float aw = 0.0f, ak = 0.0f, ar = 0.0f;
#pragma unroll
      for (int j = 0; j < HS; ++j) {
        const float s = src[j * HS], g = G[j], gyj = sgy[par][j];
        aw = aw + g * s;
        ak = ak + g * sv[par][j];
        ar = ar + gyj * s;
        kg[i][j] = ki * g;
        G[j] = wi * g + ri * gyj;
      }
      gw[at + i] = aw;
      gk[at + i] = ak + ui * ri * dot;
      gr[at + i] = ar + ui * ki * dot;
      gu_acc = gu_acc + ri * ki * dot;
      __syncthreads();
      float col = 0.0f, ruk = 0.0f;  // column i of k G, and sum r u k
#pragma unroll
      for (int q = 0; q < HS; ++q) {
        col = col + kg[q][i];
        ruk = ruk + sruk[par][q];
      }
      gv[at + i] = col + ruk * sgy[par][i];
      par ^= 1;
    }
  }
  gu_part[(long long)bh * HS + i] = gu_acc;
#pragma unroll
  for (int j = 0; j < HS; ++j) gs0[s_base + i * HS + j] = G[j];
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s_chk, const float* gy,
           const float* gs, float* scratch, float* gr, float* gk, float* gv,
           float* gw, float* gu_part, float* gs0, int B, int Tn, int H,
           cudaStream_t stream) {
  wkv6_bwd_kernel<T, HS><<<B * H, HS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s_chk, gy, gs, scratch, gr, gk, gv, gw,
      gu_part, gs0, Tn, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s_chk, const float* gy,
             const float* gs, float* scratch, float* gr, float* gk, float* gv,
             float* gw, float* gu_part, float* gs0, int B, int Tn, int H,
             int hs, cudaStream_t st) {
#define WKV6_BWD_CASE(HS_)                                                   \
  case HS_:                                                                  \
    return launch<T, HS_>(r, k, v, w, u, s_chk, gy, gs, scratch, gr, gk, gv, \
                          gw, gu_part, gs0, B, Tn, H, st);
  switch (hs) {
    WKV6_BWD_CASE(4)
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WKV6_BWD_CASE
}

}  // namespace

// dtype of r, k, v: 0 float32, 1 bfloat16; gs may be null.  Returns a
// cudaError_t.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* w, const float* u,
                               const float* s_chk, const float* gy,
                               const float* gs, float* scratch, float* gr,
                               float* gk, float* gv, float* gw,
                               float* gu_part, float* gs0, int dtype, int B,
                               int Tn, int H, int hs, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_chk, gy, gs, scratch, gr, gk, gv,
                           gw, gu_part, gs0, B, Tn, H, hs, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_chk, gy, gs, scratch, gr,
                                   gk, gv, gw, gu_part, gs0, B, Tn, H, hs,
                                   st);
  return (int)cudaErrorInvalidValue;
}
