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
// every WKV6_CHUNK = K steps (s_chk, written by wkv6.cu's CHK
// instantiation; serving keeps nothing; K is kernels/rwkv6/kernel.py's
// CHUNK, 4, passed by kernels/_build.py), and this kernel replays each
// K-step sub-chunk once from its kept state into shared memory, then walks
// it backwards: no state goes back to device memory.  K = 4 is the most
// the shared memory takes with two blocks an SM.  The replay is the
// forward's update, op for op (kv = k_i v_j, S = w_i S + kv; built with
// -fmad=false), so the replayed states are the forward's bit for bit.
//
// The route was chosen by measurement (tools/ab_wkv6_bwd.py and
// tools/ab_wkv6.py in one call, NVIDIA H100 80GB HBM3 at 700 W, rwkv6-3b's
// training shape (4, 512, 40, 64), bf16).  The other route keeps the
// states every 64 steps, as the first design did, and replays each 64-step
// chunk twice here: once to write its sub-chunk starts to a scratch that
// stays in L2 (40 MB), then each sub-chunk as below.  Its backward took
// 1.1263 ms against this kernel's 0.8102 (4.4617 against 3.1951 at T =
// 2048), its forward's keep launch 0.2848 ms against 0.3416 here.  At 32
// backward and 64 keep launches a train step, that is 10.1 ms more against
// 3.6 ms less, so this route, by 6.5 ms a step.  Its cost is memory: one
// layer's kept states take B H ceil(T / 4) hs^2 4 bytes, 336 MB at T = 512
// and 2.68 GB at T = 4096 (every 64 steps 21 MB and 168 MB); remat holds
// one layer's at a time.
//
// Threads: one block per (batch, head); each state row is split over G =
// HS / 16 threads from HS = 32 up (G = 1 below), thread (i, g) holding the C
// = 16 columns [16 g, 16 g + 16) of row i of G in registers, so 256 threads
// (8 warps) at HS = 64.  A sub-chunk's states are thread-owned in shared
// memory ((K - 1) x 16 KB; the latest stays in registers).  Per step, gw,
// gk and gr are sums over the thread's 16 columns, stored as G partial
// sums; k G's column sums are reduced over the warp's 8 rows by shuffles
// that halve the columns at each stage, leaving per-warp partials.  After
// the sub-chunk a barrier, then every thread adds one step's row partials
// in g order and one column's warp partials in warp order, with the u
// terms: the block meets twice a sub-chunk, not twice a step.  gy.v and
// sum r u k are taken once a step, by one warp each (a shuffle tree).
// Every sum has a fixed order and there is no atomic, so the gradients are
// the same bits from run to run; gu leaves as per-(batch, head) partials
// (gu_part), which the wrapper adds over the batch in a fixed order.  G's
// update stays elementwise, so gs0 is the plain version's bit for bit.  A
// sub-chunk's inputs are staged in shared memory (as float32) at its
// start, and its kept state is copied there by cp.async.  Loading both a
// sub-chunk ahead measured no faster (0.8089 against 0.8053 ms per launch
// in one call), and plain loads of the kept state into registers 2.8%
// slower (0.8280 ms, another call), so neither was kept.
//
// Sizes at HS = 64: 96,544 bytes of dynamic shared memory and at most 128
// registers a thread (__launch_bounds__(256, 2); ptxas: 96, no spill), so
// two blocks fit an SM and all 160 blocks of rwkv6-3b's training shape
// run at once on the 132 SMs (wkv6_bwd_occupancy reports 2 blocks an SM).
// Those 28 SMs set the time: at 132 blocks (33 heads), one an SM, a launch
// takes 0.5493 ms, at 160 0.8385 and at 264 0.8505 (one call).
//
// What bounds it on an H100: per step and state entry 14 float32
// operations (3 in the replay; G S, G v, gy S, k G, the update of G and the
// column sum in the walk), at rwkv6-3b's training shape (B 4, 40 heads, T
// 512, head size 64) 4.70 GFLOP, 0.0701 ms at the fp32 rate, which bounds
// it; its inputs and outputs are 163 MB, 0.0485 ms at the HBM rate
// (chip_smoke.py: wkv6_bwd_bound_ms; s0 is counted, not the kept states,
// which the replay's operations stand for).  The time axis is a chain of
// T dependent steps per block, so the design spreads each step over 8
// warps and keeps the chain on chip: 0.8053 ms per launch against the
// first design's 1.8073 in one call, 11.5x the bound.
//
// No tensor cores: a step is a rank-1 update of G and row and column dot
// products of length hs, with no product of depth >= 16 for wgmma or
// mma.sync.  A chunked matrix form needs ratios of decays that divide by
// w -> 0, which is why the forward keeps states; it would also move the
// gradients away from the plain version's tolerances.
//
// Layout: r, k, v (B, T, H, hs) in float32 or bfloat16, w and gy (B, T, H,
// hs) float32, u (H, hs) float32; s_chk (B, H, ceil(T / K), hs, hs) and
// gs / gs0 (B, H, hs, hs) float32, S[i][j] at [.., i, j]; gs may be null
// (zeros).  Out: gr, gk, gv, gw (B, T, H, hs) float32, gu_part (B, H, hs)
// float32, gs0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// WKV6_CHUNK, the steps between kept states (as in wkv6.cu), is
// kernels/rwkv6/kernel.py's CHUNK, passed by kernels/_build.py.
#ifndef WKV6_CHUNK
#error "build with -DWKV6_CHUNK (kernels/_build.py)"
#endif

namespace {

constexpr int K = WKV6_CHUNK;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Columns of a row per thread, threads per row, threads and warps a block.
template <int HS>
__host__ __device__ constexpr int cols() {
  return HS < 16 ? HS : 16;
}
template <int HS>
__host__ __device__ constexpr int row_groups() {
  return HS / cols<HS>();
}
template <int HS>
__host__ __device__ constexpr int threads() {
  return HS * row_groups<HS>();
}
template <int HS>
__host__ __device__ constexpr int warps() {
  return (threads<HS>() + 31) / 32;
}

// Offsets of the shared arrays, in floats (each a multiple of 4).
template <int HS>
struct Smem {
  static constexpr int NT = threads<HS>();
  static constexpr int ST = 0;                          // (K-1) states
  static constexpr int SNAP = ST + (K - 1) * HS * HS;   // the kept state
  static constexpr int XS = SNAP + HS * HS;             // [2][K][5][HS]
  static constexpr int RP = XS + 2 * K * 5 * HS;        // [K][3][NT]
  static constexpr int CP = RP + K * 3 * NT;            // [K][W][HS]
  static constexpr int DR = CP + K * warps<HS>() * HS;  // [K][2]
  static constexpr int US = DR + 2 * K;                 // [HS]
  static constexpr int BYTES = (US + HS) * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One thread's share of a sub-chunk's inputs: column j of steps q0, q0 + G,
// ... of r, k, v (raw) and w, gy.  All of them are loaded, unconditionally
// (steps past the sub-chunk's nk load its last step again), before any is
// stored, so the loads are in flight together.
template <typename T, int HS>
struct Inputs {
  static_assert(K % row_groups<HS>() == 0,
                "a sub-chunk's steps are split evenly over a row's threads");
  static constexpr int NQ = K / row_groups<HS>();
  T rkv[NQ][3];
  float wg[NQ][2];

  __device__ __forceinline__ void fetch(const T* r, const T* k, const T* v,
                                        const float* w, const float* gy,
                                        long long at0, long long step,
                                        int nk) {
    const int j = threadIdx.x % HS, q0 = threadIdx.x / HS;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int q = min(q0 + n * row_groups<HS>(), nk - 1);
      const long long at = at0 + q * step + j;
      rkv[n][0] = r[at];
      rkv[n][1] = k[at];
      rkv[n][2] = v[at];
      wg[n][0] = w[at];
      wg[n][1] = gy[at];
    }
  }

  // into xs[q] = r, k, w, v, gy (HS each), as float32
  __device__ __forceinline__ void stash(float* xs) const {
    const int j = threadIdx.x % HS, q0 = threadIdx.x / HS;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float* x = xs + (q0 + n * row_groups<HS>()) * 5 * HS + j;
      x[0] = to_f32(rkv[n][0]);
      x[HS] = to_f32(rkv[n][1]);
      x[2 * HS] = wg[n][0];
      x[3 * HS] = to_f32(rkv[n][2]);
      x[4 * HS] = wg[n][1];
    }
  }
};

// Column sums of kg over the RW rows a warp holds (lane = g + G il): each
// stage swaps half of the N columns a lane holds with the lane whose il
// differs in one bit (lane mask m) and adds, so after log2(RW) stages a
// lane holds C / RW columns, summed over the warp's rows in a fixed tree,
// starting at column c0 + off.
template <int C, int G, int RW, int N>
__device__ __forceinline__ void col_stages(float (&kg)[C], int lane,
                                           int& off, unsigned mask) {
  if constexpr (N > C / RW) {
    constexpr int m = G * RW / 2 * N / C;
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int c = 0; c < N / 2; ++c) {
      const float send = up ? kg[c] : kg[c + N / 2];
      const float keep = up ? kg[c + N / 2] : kg[c];
      kg[c] = keep + __shfl_xor_sync(mask, send, m);
    }
    if (up) off += N / 2;
    col_stages<C, G, RW, N / 2>(kg, lane, off, mask);
  }
}

// One step of the walk, for thread (i, g): x is the step's r, k, w, v, gy
// in shared memory, S its state S_t (row i, the thread's columns), Gr this
// thread's part of G (in: dL/dS_{t+1}, out: dL/dS_t).  Leaves gw, gk and
// gr's partial sums in rp (3 x NT) and k G's warp partials in cp (W x HS).
template <int HS>
__device__ __forceinline__ void walk_step(const float* x,
                                          const float (&S)[cols<HS>()],
                                          float (&Gr)[cols<HS>()], float* rp,
                                          float* cp, int i, int c0,
                                          unsigned mask) {
  constexpr int C = cols<HS>(), G = row_groups<HS>(), NT = threads<HS>();
  constexpr int RW = (NT < 32 ? NT : 32) / G;
  const int tid = threadIdx.x, lane = tid & 31;
  const float ri = x[i], ki = x[HS + i], wi = x[2 * HS + i];
  float v[C], gy[C];
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(x + 3 * HS + c0 + c);
    const float4 g4 = *reinterpret_cast<const float4*>(x + 4 * HS + c0 + c);
    v[c] = v4.x, v[c + 1] = v4.y, v[c + 2] = v4.z, v[c + 3] = v4.w;
    gy[c] = g4.x, gy[c + 1] = g4.y, gy[c + 2] = g4.z, gy[c + 3] = g4.w;
  }
  float aw = 0.0f, ak = 0.0f, ar = 0.0f, kg[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float g = Gr[c];
    aw = aw + g * S[c];
    ak = ak + g * v[c];
    ar = ar + gy[c] * S[c];
    kg[c] = ki * g;
    Gr[c] = wi * g + ri * gy[c];
  }
  rp[tid] = aw;
  rp[NT + tid] = ak;
  rp[2 * NT + tid] = ar;
  int off = 0;
  col_stages<C, G, RW, C>(kg, lane, off, mask);
#pragma unroll
  for (int c = 0; c < C / RW; ++c) cp[(tid >> 5) * HS + c0 + off + c] = kg[c];
}

template <typename T, int HS>
__global__ void __launch_bounds__(threads<HS>(), HS == 64 ? 2 : 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s_chk,
                const float* __restrict__ gy, const float* __restrict__ gs,
                float* __restrict__ gr, float* __restrict__ gk,
                float* __restrict__ gv, float* __restrict__ gw,
                float* __restrict__ gu_part, float* __restrict__ gs0, int Tn,
                int H) {
  constexpr int C = cols<HS>(), G = row_groups<HS>(), NT = threads<HS>();
  constexpr int W = warps<HS>(), C4 = C / 4;
  using L = Smem<HS>;
  extern __shared__ __align__(16) float sm[];
  float4* st = reinterpret_cast<float4*>(sm + L::ST);
  float4* snap = reinterpret_cast<float4*>(sm + L::SNAP);
  float* xs = sm + L::XS;
  float* rp = sm + L::RP;
  float* cp = sm + L::CP;
  float* dr = sm + L::DR;
  float* us = sm + L::US;

  const int tid = threadIdx.x, i = tid / G, c0 = (tid % G) * C;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned mask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const long long s_base = (long long)bh * HS * HS;
  const long long step = (long long)H * HS;  // elements between time steps
  const long long base = ((long long)b * Tn * H + h) * HS;  // t = 0, j = 0
  const int nc = (Tn + K - 1) / K;
  // this thread's columns of a kept state
  const float* chk = s_chk + s_base * nc + (long long)i * HS + c0;
  if (tid < HS) us[tid] = u[h * HS + tid];

  float Gr[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    Gr[c] = gs != nullptr ? gs[s_base + i * HS + c0 + c] : 0.0f;
  float gu_acc = 0.0f;
  Inputs<T, HS> in;
  for (int n = nc - 1; n >= 0; --n) {
    const int t0 = n * K, nk = min(K, Tn - t0);
    // by parity: a thread may stage here while another still combines the
    // last sub-chunk from the other buffer
    float* xb = xs + (n & 1) * K * 5 * HS;
    in.fetch(r, k, v, w, gy, base + t0 * step, step, nk);
#pragma unroll
    for (int c = 0; c < C4; ++c)  // the kept state S_t0, this thread's part
      cp_async16(&snap[c * NT + tid], chk + (long long)n * HS * HS + 4 * c);
    in.stash(xb);
    cp_async_wait_all();
    float S[C];
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 s4 = snap[c * NT + tid];
      S[4 * c] = s4.x, S[4 * c + 1] = s4.y, S[4 * c + 2] = s4.z;
      S[4 * c + 3] = s4.w;
    }
    __syncthreads();  // xs[n & 1] in place; the last combine done
    // gy.v and sum r u k of each step, one warp each, in a fixed tree
    for (int s = warp; s < 2 * nk; s += W) {
      const float* x = xb + (s >> 1) * 5 * HS;
      float p = 0.0f;
      for (int j = lane; j < HS; j += 32)
        p = p + ((s & 1) ? x[j] * us[j] * x[HS + j]
                         : x[4 * HS + j] * x[3 * HS + j]);
#pragma unroll
      for (int m = (NT < 32 ? NT : 32) / 2; m >= 1; m >>= 1)
        p = p + __shfl_xor_sync(mask, p, m);
      if (lane == 0) dr[s] = p;
    }
    // replay S_t0 .. S_{t0+nk-2} into this thread's slots; S_{t0+nk-1}
    // stays in registers
    for (int q = 0; q < nk - 1; ++q) {
      const float* x = xb + q * 5 * HS;
      const float ki = x[HS + i], wi = x[2 * HS + i];
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        st[(q * C4 + c) * NT + tid] =
            make_float4(S[4 * c], S[4 * c + 1], S[4 * c + 2], S[4 * c + 3]);
        const float4 v4 =
            *reinterpret_cast<const float4*>(x + 3 * HS + c0 + 4 * c);
        const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = ki * vq[e];
          S[4 * c + e] = wi * S[4 * c + e] + kv;
        }
      }
    }
    // walk the sub-chunk backwards
    walk_step<HS>(xb + (nk - 1) * 5 * HS, S, Gr, rp + (nk - 1) * 3 * NT,
                  cp + (nk - 1) * W * HS, i, c0, mask);
    for (int q = nk - 2; q >= 0; --q) {
      float Sq[C];
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 s4 = st[(q * C4 + c) * NT + tid];
        Sq[4 * c] = s4.x, Sq[4 * c + 1] = s4.y, Sq[4 * c + 2] = s4.z;
        Sq[4 * c + 3] = s4.w;
      }
      walk_step<HS>(xb + q * 5 * HS, Sq, Gr, rp + q * 3 * NT,
                    cp + q * W * HS, i, c0, mask);
    }
    __syncthreads();  // the sub-chunk's partial sums in place
    // one step's row i2 and column i2 per task
    for (int task = tid; task < nk * HS; task += NT) {
      const int q = task / HS, i2 = task % HS;
      const float* x = xb + q * 5 * HS;
      const float* p = rp + q * 3 * NT + G * i2;
      float aw = p[0], ak = p[NT], ar = p[2 * NT];
#pragma unroll
      for (int g = 1; g < G; ++g) {
        aw = aw + p[g];
        ak = ak + p[NT + g];
        ar = ar + p[2 * NT + g];
      }
      const float dot = dr[2 * q], ruk = dr[2 * q + 1], ui = us[i2];
      float col = cp[q * W * HS + i2];
#pragma unroll
      for (int wp = 1; wp < W; ++wp) col = col + cp[(q * W + wp) * HS + i2];
      const long long at = base + (t0 + q) * step + i2;
      gw[at] = aw;
      gk[at] = ak + ui * x[i2] * dot;
      gr[at] = ar + ui * x[HS + i2] * dot;
      gv[at] = col + ruk * x[4 * HS + i2];
    }
    if (tid < HS) {
      for (int q = nk - 1; q >= 0; --q) {
        const float* x = xb + q * 5 * HS;
        gu_acc = gu_acc + x[tid] * x[HS + tid] * dr[2 * q];
      }
    }
  }
  if (tid < HS) gu_part[(long long)bh * HS + tid] = gu_acc;
#pragma unroll
  for (int c = 0; c < C; ++c) gs0[s_base + i * HS + c0 + c] = Gr[c];
}

template <typename T, int HS>
int prepare() {
  return (int)cudaFuncSetAttribute(wkv6_bwd_kernel<T, HS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Smem<HS>::BYTES);
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s_chk, const float* gy,
           const float* gs, float* gr, float* gk, float* gv, float* gw,
           float* gu_part, float* gs0, int B, int Tn, int H,
           cudaStream_t stream) {
  const int err = prepare<T, HS>();
  if (err != 0) return err;
  wkv6_bwd_kernel<T, HS><<<B * H, threads<HS>(), Smem<HS>::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s_chk, gy, gs, gr, gk, gv, gw, gu_part,
      gs0, Tn, H);
  return (int)cudaGetLastError();
}

// out: blocks resident per SM, threads a block, dynamic shared bytes.
template <typename T, int HS>
int occupancy(int* out) {
  int err = prepare<T, HS>();
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], wkv6_bwd_kernel<T, HS>, threads<HS>(), Smem<HS>::BYTES);
  out[1] = threads<HS>();
  out[2] = Smem<HS>::BYTES;
  return err;
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s_chk, const float* gy,
             const float* gs, float* gr, float* gk, float* gv, float* gw,
             float* gu_part, float* gs0, int B, int Tn, int H, int hs,
             cudaStream_t st) {
#define WKV6_BWD_CASE(HS_)                                                 \
  case HS_:                                                                \
    return launch<T, HS_>(r, k, v, w, u, s_chk, gy, gs, gr, gk, gv, gw,    \
                          gu_part, gs0, B, Tn, H, st);
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

template <typename T>
int occupancy_of(int hs, int* out) {
  switch (hs) {
    case 4: return occupancy<T, 4>(out);
    case 8: return occupancy<T, 8>(out);
    case 16: return occupancy<T, 16>(out);
    case 32: return occupancy<T, 32>(out);
    case 64: return occupancy<T, 64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 float32, 1 bfloat16; gs may be null.  Returns a
// cudaError_t.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const float* w, const float* u,
                               const float* s_chk, const float* gy,
                               const float* gs, float* gr, float* gk,
                               float* gv, float* gw, float* gu_part,
                               float* gs0, int dtype, int B, int Tn, int H,
                               int hs, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_chk, gy, gs, gr, gk, gv, gw,
                           gu_part, gs0, B, Tn, H, hs, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_chk, gy, gs, gr, gk, gv,
                                   gw, gu_part, gs0, B, Tn, H, hs, st);
  return (int)cudaErrorInvalidValue;
}

// The kernel's residency for (dtype, hs): out[0] blocks per SM as the card
// reports it (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1]
// threads a block, out[2] dynamic shared bytes.  Returns a cudaError_t.
extern "C" int wkv6_bwd_occupancy(int dtype, int hs, int* out) {
  if (dtype == 0) return occupancy_of<float>(hs, out);
  if (dtype == 1) return occupancy_of<__nv_bfloat16>(hs, out);
  return (int)cudaErrorInvalidValue;
}
