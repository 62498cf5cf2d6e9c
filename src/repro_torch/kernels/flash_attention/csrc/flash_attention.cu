// flash_attention: causal / sliding-window GQA attention with an online
// softmax, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention/kernel.py:_kernel (called through
// flash_attention_bhsd): q-head h reads kv-head h / G; scores (q.k) * scale
// are summed in f32; the running max m, denominator l and output
// accumulator acc are f32; masked scores are -1e30 while m starts at -inf,
// so a live tile whose entries are all masked for a row adds exp(0) terms
// that the row's first real score wipes out through corr = exp(m_prev -
// m_new), exactly as the TPU kernel does; p enters the PV product at f32
// precision; the output is acc / max(l, 1e-30).  The plain PyTorch
// version, kernel.py:flash_attention_plain, runs the same recurrence.
//
// What bounds it on an H100: operations.  At the yi-6b prefill shape (B 4,
// S = T = 2048, 32 q-heads, 4 kv-heads, head_dim 128, bf16) the causal
// pairs need ~137.5 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against ~151 MB of q, k, v and o (0.045 ms).  The TPU kernel's
// sequential minor grid axis over kv blocks becomes a loop inside the
// block; blocks run one per (q-tile of 64, q-head, batch), heaviest causal
// q-tiles first, and loop over the kv tiles that the block-live rule
// leaves (the TPU kernel's pl.when guard, on each kernel's own tiles: 64
// keys in f32, 32 in bf16).  Keys past T score -inf (p = 0); rows past S
// are not stored.  q, k, v are read in the model layout (B, S, H, Dh) through their
// strides; o is written contiguous (B, S, Hq, Dh).
//
// Head dims: each kernel is instantiated for a padded head dim DP of 16,
// 32, 64, 80, 128 and 160 (kMaxDh; stablelm-12b's and pixtral-12b's 5120 /
// 32), and a head dim runs in the smallest DP that holds it.  Above 160 the
// launch is refused (the Pallas kernel takes any head dim; no configuration
// of the repo has one above 160).
//
// bf16 (flash_attention_tc_kernel): the products run on the tensor cores.
// Four warps own 16 q rows each and loop over 32-key tiles.  Q once, and K
// and V per tile, go from global to shared memory by 16-byte cp.async, K
// and V in two stages so that tile i + 1 loads while tile i computes; rows
// are padded by 16 bytes (conflict-free ldmatrix) and the head dim by
// zeros to a multiple of 16, which leaves the dot products exact.  S = Q
// K^T is mma.sync m16n8k16 bf16 x bf16 -> f32 on ldmatrix fragments (bf16
// products are exact in f32, so the scores are the reference's up to
// summation order) and stays in registers; the online softmax runs on the
// accumulator fragment (the row max and sum over the four lanes that share
// a row, expf as the reference).  The reference multiplies f32 p by v, so
// p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi) (relative error
// <= 2^-18) and PV is two mma.sync per fragment against V loaded by
// ldmatrix.trans; the accumulator layout of S is the A-fragment layout of
// P, so p never leaves the registers.  The epilogue stages o through the
// warp's own Q rows for 16-byte stores.  32-key tiles (not 64) keep the
// registers at ~165, so three blocks share an SM instead of two; on the
// card that was a little faster, and 128-row blocks were not.  What holds
// it back: the hi/lo split makes the executed products 1.5x the
// function's, mma.sync reaches only part of Hopper's tensor-core rate, and
// every block re-reads its K and V tiles from L2.  wgmma with TMA and
// mbarriers (warpgroup products from shared memory, copies that cost no
// registers, larger q tiles per K/V load) is the next step.
//
// float32 (flash_attention_kernel): the first version, on the CUDA cores
// in f32, FMA-free (-fmad=false, so every product and sum rounds on its own
// as in the reference); the parity contract forbids TF32.  A block of 256
// threads owns 64 q rows and loops over 64-key tiles.  Thread (ty, tx) =
// (tid / 16, tid % 16) computes the scores of rows 4 ty .. 4 ty + 3 against
// keys tx + 16 j (j < 4), reduces the row max and sum over the 16 lanes of
// its half-warp, writes p to shared memory, and accumulates head-dim
// columns tx + 16 j (j < DPT) of its four rows.  Q, K, V and P live in
// shared memory, rows padded by one word against bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxDh = 160;    // the largest head dim of an instantiation
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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
  if (p.Dh <= 80) return launch<T, 5>(p, stream);
  if (p.Dh <= 128) return launch<T, 8>(p, stream);
  if (p.Dh <= kMaxDh) return launch<T, 10>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 of the block's 64 q rows
constexpr int kTcBK = 32;        // keys per tile

// Shared memory of the bf16 kernel, in bf16 elements: Q (64 rows), then K
// in two stages, then V in two stages (32 rows each); rows of DP + 8.
__host__ __device__ constexpr int tc_ld(int dp) { return dp + 8; }
__host__ __device__ constexpr int tc_smem_elems(int dp) {
  return (kBQ + 4 * kTcBK) * tc_ld(dp);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes < 16 fills the rest with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.  Not
// volatile: it has no side effect, so the compiler may schedule it.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) -> the bf16 pairs hi = bf16(x) and lo = bf16(x - hi); x - hi is
// exact in f32, so hi + lo is x to within 2^-18 of x.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - __low2float(h),
                                         x1 - __high2float(h)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows start .. start + R - 1 of one head of x (row stride ss elements,
// the first Dh columns, Dh a multiple of 8) into an [R][DP + 8] tile by
// 16-byte cp.async; rows at or past `limit` become zeros.
template <int DP, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int start, int limit,
                                          int Dh, int tid) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int idx = tid; idx < R * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (c * 8 >= Dh) continue;
    const int s = start + r;
    const bool in = s < limit;
    cp_async16(dst + r * tc_ld(DP) + c * 8,
               src + (in ? s * ss : 0) + c * 8, in ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = kBQ, BK = kTcBK;
  constexpr int LD = tc_ld(DP);
  constexpr int TILE = BK * LD;  // one K or V stage
  constexpr int NK = DP / 16;    // k-steps of QK^T, d-tile pairs of PV
  constexpr int NS = BK / 8;     // n-tiles of S
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + BQ * LD;   // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages

  const int nq = (p.S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row, column pair
  const int q_start = qi * BQ;
  const int q_last = min(p.S, q_start + BQ) - 1;
  const int Dh = p.Dh;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // The live kv tiles form one range: causal drops the tiles past the
  // block's last row, the window those before its first.
  const int nk = (p.T + BK - 1) / BK;
  int k_begin = 0, k_end = nk;
  if (p.causal) k_end = min(nk, q_last / BK + 1);
  if (p.window > 0) {
    // live iff k_start + BK - 1 > q_start - window
    const int x = q_start - p.window - (BK - 2);
    if (x > 0) k_begin = (x + BK - 1) / BK;
  }

  // zero the head-dim padding of every tile (cp.async never writes it)
  constexpr int kChunks = DP / 8;
  for (int idx = tid; idx < (BQ + 4 * BK) * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (c * 8 >= Dh)
      *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = make_uint4(0, 0, 0, 0);
  }
  load_tile<DP, BQ>(Qs, q, p.q_ss, q_start, p.S, Dh, tid);
  if (k_begin < k_end) {
    load_tile<DP, BK>(Ks, k, p.k_ss, k_begin * BK, p.T, Dh, tid);
    load_tile<DP, BK>(Vs, v, p.v_ss, k_begin * BK, p.T, Dh, tid);
  }
  cp_async_commit();

  float acc[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // rows g and g + 8 of the warp's 16
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int row0 = q_start + warp * 16 + g;

  for (int ki = k_begin; ki < k_end; ++ki) {
    const int st = (ki - k_begin) & 1;
    if (ki + 1 < k_end) {  // the next tile into the other stage
      load_tile<DP, BK>(Ks + (st ^ 1) * TILE, k, p.k_ss, (ki + 1) * BK,
                            p.T, Dh, tid);
      load_tile<DP, BK>(Vs + (st ^ 1) * TILE, v, p.v_ss, (ki + 1) * BK,
                            p.T, Dh, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;

    // S = Q K^T: 16 rows x BK keys per warp, as NS n-tiles of 8 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, Qs + (warp * 16 + lane % 16) * LD + kk * 16
                         + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, Kt + (np * 16 + (lane / 16) * 8 + lane % 8) * LD
                            + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, then mask where the tile reaches past T, above the diagonal
    // or out of the window (a block-uniform test)
    const int k_start = ki * BK;
    const bool edge = k_start + BK > p.T ||
                      (p.causal && k_start + BK - 1 > q_start) ||
                      (p.window > 0 && q_start + BQ - 1 - k_start >= p.window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (edge) {
          const int qpos = row0 + (e / 2) * 8;
          const int kpos = k_start + j * 8 + 2 * t + (e % 2);
          if (kpos >= p.T) {
            x = -INFINITY;  // no such key: p = 0
          } else if ((p.causal && qpos < kpos) ||
                     (p.window > 0 && qpos - kpos >= p.window)) {
            x = kMasked;
          }
        }
        s[j][e] = x;
      }

    // online softmax on the fragment: row r = 0 (g) holds entries 0, 1,
    // row r = 1 (g + 8) entries 2, 3 of each n-tile
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          sum = sum + s[j][e];
        }
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + quad_sum(sum);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      acc[j][0] = acc[j][0] * corr[0];
      acc[j][1] = acc[j][1] * corr[0];
      acc[j][2] = acc[j][2] * corr[1];
      acc[j][3] = acc[j][3] * corr[1];
    }

    // acc += P V, P = p_hi + p_lo: keys 16 kb .. 16 kb + 15 are n-tiles
    // 2 kb and 2 kb + 1 of S, which is the A fragment's layout
#pragma unroll
    for (int kb = 0; kb < NS / 2; ++kb) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
      split_bf16(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
      split_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NK; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, Vt + (kb * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * LD + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // o = acc / max(l, 1e-30) in bf16, staged through the warp's own Q rows
  cp_async_wait<0>();
  __syncthreads();
  const float denom[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
    const int d = j * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8 * r) * LD + d) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom[r],
                                acc[j][2 * r + 1] / denom[r]);
  }
  __syncwarp();
  bf16* o = static_cast<bf16*>(p.o);
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int s = q_start + warp * 16 + r;
    if (c * 8 < Dh && s < p.S)
      *reinterpret_cast<uint4*>(
          o + ((long long)(b * p.S + s) * p.Hq + h) * Dh + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <int DP>
int launch_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * tc_smem_elems(DP);
  auto kernel = flash_attention_tc_kernel<DP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16: the head dim must be a multiple of 8, every row 16-byte aligned
// (the wrapper checks the pointers and strides).
int dispatch_tc(const Params& p, cudaStream_t stream) {
  if (p.Dh % 8 != 0) return (int)cudaErrorInvalidValue;
  if (p.Dh <= 16) return launch_tc<16>(p, stream);
  if (p.Dh <= 32) return launch_tc<32>(p, stream);
  if (p.Dh <= 64) return launch_tc<64>(p, stream);
  if (p.Dh <= 80) return launch_tc<80>(p, stream);
  if (p.Dh <= 128) return launch_tc<128>(p, stream);
  if (p.Dh <= kMaxDh) return launch_tc<kMaxDh>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; Dh a multiple of
// 8, pointers and strides 16-byte aligned).  window <= 0: no sliding
// window.  Strides in elements; the head dim must be contiguous.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int Hq, int Hkv, int Dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Dh <= 0 || Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  Params p{q, k, v, o, B, S, T, Hq, Hkv, Dh, Hq / Hkv, causal, window,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, st);
  if (dtype == 1) return dispatch_tc(p, st);
  return (int)cudaErrorInvalidValue;
}
