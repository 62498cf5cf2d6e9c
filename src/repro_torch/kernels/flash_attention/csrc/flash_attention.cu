// flash_attention: causal / sliding-window GQA attention with an online
// softmax, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention/kernel.py:_kernel (called through
// flash_attention_bhsd): q-head h reads kv-head h / G; the running max m,
// denominator l and output accumulator acc are f32; masked scores are -1e30
// while m starts at -inf, so a live tile whose entries are all masked for a
// row adds exp(0) terms that the row's first real score wipes out through
// corr = exp(m_prev - m_new), exactly as the TPU kernel does; p stays f32 in
// the PV product; the output is acc / max(l, 1e-30).  The plain PyTorch
// version, kernel.py:flash_attention_plain, runs the same recurrence.
//
// What bounds it on an H100: operations.  At the yi-6b prefill shape (B 4,
// S = T = 2048, 32 q-heads, 4 kv-heads, head_dim 128, bf16) the causal
// pairs need ~137 GFLOP against ~151 MB of q, k, v and o.  The TPU kernel's
// sequential minor grid axis over kv blocks becomes a loop inside the block;
// blocks run one per (q-tile, q-head, batch), heaviest q-tiles first.  This
// first version computes in f32 on the CUDA cores (FMA-free, -fmad=false, so
// every product and sum rounds on its own as in the reference); the tensor
// cores (wgmma, TMA) are for a later version.
//
// Layout: a block of 256 threads owns 64 q rows and loops over 64-key tiles.
// Thread (ty, tx) = (tid / 16, tid % 16) computes the scores of rows
// 4 ty .. 4 ty + 3 against keys tx + 16 j (j < 4), reduces the row max and
// sum over the 16 lanes of its half-warp, writes p to shared memory, and
// accumulates head-dim columns tx + 16 j (j < DPT) of its four rows.  Q, K,
// V (converted to f32) and P live in shared memory, rows padded by one word
// against bank conflicts.  Tiles that the causal / window rule leaves
// without a live entry are skipped (the TPU kernel's pl.when guard); ragged
// edges are masked here: keys past T score -inf (p = 0), rows past S are
// not stored.  q, k, v are read in the model layout (B, S, H, Dh) through
// their strides; o is written contiguous (B, S, Hq, Dh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, Hq, Hkv, Dh, G, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = x + __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// Shared memory: Q [64][DP + 1], K [64][DP + 1], V [64][DP], P [64][65].
__host__ __device__ constexpr int smem_floats(int dp) {
  return kBQ * (dp + 1) + kBK * (dp + 1) + kBK * dp + kBQ * (kBK + 1);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  constexpr int DP = 16 * DPT;  // padded head dim
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][DP + 1]
  float* Ks = Qs + kBQ * (DP + 1);        // [kBK][DP + 1]
  float* Vs = Ks + kBK * (DP + 1);        // [kBK][DP]
  float* Ps = Vs + kBK * DP;              // [kBQ][kBK + 1]

  const int nq = (p.S + kBQ - 1) / kBQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.G;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q_start = qi * kBQ;
  const int q_last = min(p.S, q_start + kBQ) - 1;
  const int Dh = p.Dh;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < kBQ * Dh; idx += kThreads) {
    const int r = idx / Dh, d = idx % Dh;
    const int s = q_start + r;
    Qs[r * (DP + 1) + d] = s < p.S ? to_f32(q[s * p.q_ss + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  const int nk = (p.T + kBK - 1) / kBK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_start = ki * kBK;
    // the TPU kernel's block-live rule, on this kernel's tiles
    if (p.causal && q_last < k_start) continue;
    if (p.window > 0 && !(k_start + kBK - 1 > q_start - p.window)) continue;

    __syncthreads();  // the previous tile's K, V, P are consumed
    for (int idx = tid; idx < kBK * Dh; idx += kThreads) {
      const int c = idx / Dh, d = idx % Dh;
      const int t = k_start + c;
      const bool in = t < p.T;
      Ks[c * (DP + 1) + d] = in ? to_f32(k[t * p.k_ss + d]) : 0.0f;
      Vs[c * DP + d] = in ? to_f32(v[t * p.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + qv[i] * kv[j];
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kpos >= p.T) {
          x = -INFINITY;  // no such key: p = 0
        } else if ((p.causal && qpos < kpos) ||
                   (p.window > 0 && qpos - kpos >= p.window)) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = e;
        sum = sum + e;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < kBK; ++c) {
      float pr[4], vr[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vr[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) pv[i][j] = pv[i][j] + pr[i] * vr[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q_start + ty * 4 + i;
    if (s >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh)
        o[((long long)(b * p.S + s) * p.Hq + h) * Dh + d] =
            from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DPT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(16 * DPT);
  auto kernel = flash_attention_kernel<T, DPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.Dh <= 16) return launch<T, 1>(p, stream);
  if (p.Dh <= 32) return launch<T, 2>(p, stream);
  if (p.Dh <= 64) return launch<T, 4>(p, stream);
  if (p.Dh <= 128) return launch<T, 8>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no sliding window.  Strides in
// elements; the head dim must be contiguous.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int Hq, int Hkv, int Dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Dh <= 0 || Dh > 128)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  Params p{q, k, v, o, B, S, T, Hq, Hkv, Dh, Hq / Hkv, causal, window,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
