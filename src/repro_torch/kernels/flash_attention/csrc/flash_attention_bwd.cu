// K4b `flash_attention_bwd`: the gradient of K4's online-softmax attention,
// fp32 math, for q / dq (B, Hq, Tq, D), k / v / dk / dv (B, Hkv, Tk, D),
// D <= 256, fp32 or bf16 storage, with K4's masks letter for letter: causal
// (kpos <= qpos), sliding window (qpos - kpos < window), keys at or past the
// true Tk, and GQA (query head h reads KV head h * Hkv / Hq).
//
// The JAX package has no Pallas kernel for this: its training path takes
// the gradient of the plain jnp attention (models/layers.py
// _masked_attention) by autodiff.  The port's training forward runs K4 on
// the card, so its gradient is this kernel; it computes what jax.grad of
// that attention computes, from K4's output O and its per-row log-sum-exp
// L = m + log(l) (l clamped to 1e-30 as in K4, so a fully masked row has
// p = 0 everywhere and a zero gradient):
//   P = exp(S - L) where live, else 0      S = scale * Q K^T
//   delta = rowsum(dO * O)
//   dV = P^T dO      dS = P * (dO V^T - delta)
//   dQ = scale * dS K      dK = scale * dS^T Q
//
// What bounds it on an H100: operations.  Per live (query, key) pair it does
// 7 D fp32 FMAs (S and dP twice, once in each of the two main kernels, and
// dV, dK, dQ once), 3.5x K4's 2 D, on the CUDA cores; the bytes it moves
// are a few times K4's.  This first version keeps fp32 on the CUDA cores as
// K4 does; tensor cores are for a later version.
//
// Design: three kernels on the caller's stream, one call.
//   * delta: one warp per query row, rowsum(dO * O) in fp32.
//   * dK / dV: one block of 8 warps per (KV tile of BKV = 32 keys, KV head,
//     batch).  K and V of the tile are staged once; the block walks every
//     query head of its GQA group and, for each, the live query tiles of
//     BQ = 64 rows (tiles wholly outside the mask are skipped, as in K4), so
//     dK and dV are summed in registers without atomics.  Per query tile:
//     Q and dO are staged; warp w computes S and dP for rows 8 w .. 8 w + 7
//     (lane (rg, kg) = (lane / 8, lane % 8) a 2 x 4 micro-tile: rows
//     2 rg + i, keys kg + 8 j) and writes P and dS to shared memory; after a
//     barrier warp w accumulates dV and dK for keys 4 w .. 4 w + 3 over the
//     tile's rows, lane l columns 4 l + 128 j.  Blocks are dispatched in
//     index order, the first KV tiles (the heaviest under a causal mask)
//     first.
//   * dQ: one block per (query tile of BQ = 64 rows, query head, batch),
//     heaviest tiles first as in K4.  Q and dO are staged once; the block
//     walks the live KV tiles of BKV = 32 keys: S and dP as above, dS to
//     shared memory, then warp w accumulates dQ for rows 8 w .. 8 w + 7.
// Every sum runs in a fixed order, so two calls on the same inputs give
// bitwise-equal dQ, dK and dV.  Shared memory: K and V tiles, Q and dO
// tiles, P and dS, L and delta, in fp32: 218,624 B at D <= 256 (one block an
// SM), above the 48 KB default, hence cudaFuncSetAttribute on every launch.
// Ragged Tq, Tk and D are masked in the kernels (zeros staged past them, no
// row past Tq or Tk written).  bf16 is widened to fp32 on load and dQ, dK,
// dV are rounded to bf16 on store; L and delta stay fp32.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BKV = 32;                // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;    // 256
constexpr int ROWS_W = BQ / WARPS;     // 8 query rows per warp
constexpr int KEYS_W = BKV / WARPS;    // 4 keys per warp (dK / dV)
constexpr int LDS = BKV + 4;           // row stride of the P and dS tiles

enum Mode { VEC = 0, SCALAR = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                    // (B, Hq, Tq)
  float* delta;                        // (B, Hq, Tq), written by the pre-pass
  void* dq;                            // (B, Hq, Tq, D), contiguous
  void* dk;                            // (B, Hkv, Tk, D), contiguous
  void* dv;
  int batch, hq, hkv, tq, tk, d;
  long long sq_b, sq_h, sq_t;          // element strides (last dim is 1)
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  long long so_b, so_h, so_t;
  long long sg_b, sg_h, sg_t;          // dO
  float scale;
  int causal;
  int window;                          // <= 0: no window
};

template <int DMAX>
constexpr int smem_floats() {
  return (2 * BKV + 2 * BQ) * (DMAX + 4) + 2 * BQ * LDS + 2 * BQ;
}
static_assert(smem_floats<256>() * 4 <= 232448,
              "K4b's shared memory at D = 256 exceeds an H100 block's");

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 load4_aligned(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_aligned(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// K4's predicates, plus the row bound (rows past Tq are staged as zeros).
__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.tq && kpos < p.tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

// Does any key of [k_lo, k_lo + nk) reach any row of [q_lo, q_lo + nq)?
__device__ __forceinline__ bool any_live(const Params& p, int q_lo, int nq,
                                         int k_lo, int nk) {
  bool any = q_lo < p.tq && k_lo < p.tk;
  if (p.causal) any = any && k_lo <= q_lo + nq - 1;
  if (p.window > 0) any = any && q_lo - (k_lo + nk - 1) < p.window;
  return any;
}

// Rows [lo, lo + ROWS) of a (T, D) head into shared memory with row stride
// DMAX + 4, zeros past t and past d.  All of a thread's loads are issued
// before its first store.
template <typename T, int DMAX, int ROWS, int MODE>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int lo, int t, int d) {
  constexpr int ld = DMAX + 4;
  constexpr int C4 = DMAX / 4;
  constexpr int PER = ROWS * C4 / THREADS;
  static_assert(ROWS * C4 % THREADS == 0, "stage: uneven split");
  float4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / C4, c = (i - r * C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lo + r < t && c < d) {
      const T* row = src + (lo + r) * st;
      if (MODE == VEC) {
        x = load4_aligned(row + c);
      } else {
        x.x = load_f(row + c);
        if (c + 1 < d) x.y = load_f(row + c + 1);
        if (c + 2 < d) x.z = load_f(row + c + 2);
        if (c + 3 < d) x.w = load_f(row + c + 3);
      }
    }
    buf[u] = x;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / C4, c = (i - r * C4) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) = buf[u];
  }
}

// L and delta of rows [lo, lo + BQ) (zeros past Tq).
__device__ __forceinline__ void stage_rows(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, int lo,
                                           int tq) {
  if (threadIdx.x < BQ) {
    const int r = lo + threadIdx.x;
    sL[threadIdx.x] = r < tq ? lse[r] : 0.f;
    sD[threadIdx.x] = r < tq ? delta[r] : 0.f;
  }
}

// P and dS of a BQ x BKV tile into shared memory: warp w, rows
// 8 w .. 8 w + 7; lane (rg, kg) rows 2 rg + i, keys kg + 8 j.  Masked
// entries (and every entry of a warp whose rows see no key of the tile) are
// zero.  sP may be null (dQ needs dS only).
template <int DMAX>
__device__ __forceinline__ void scores_and_ds(
    const Params& p, const float* sQ, const float* sG, const float* sK,
    const float* sV, const float* sL, const float* sD, float* sP, float* sS,
    int q_lo, int k_lo) {
  constexpr int ld = DMAX + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, kg = lane & 7;
  const int wr = warp * ROWS_W;                 // the warp's first row
  const int nc4 = (p.d + 3) / 4;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  if (any_live(p, q_lo + wr, ROWS_W, k_lo, BKV)) {   // warp-uniform
    const float* qrow = sQ + (wr + 2 * rg) * ld;
    const float* grow = sG + (wr + 2 * rg) * ld;
    const float* krow = sK + kg * ld;
    const float* vrow = sV + kg * ld;
#pragma unroll 2
    for (int c4 = 0; c4 < nc4; ++c4) {
      float4 qa[2], ga[2], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(qrow + i * ld + 4 * c4);
        ga[i] = *reinterpret_cast<const float4*>(grow + i * ld + 4 * c4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(krow + 8 * j * ld + 4 * c4);
        vb[j] = *reinterpret_cast<const float4*>(vrow + 8 * j * ld + 4 * c4);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qa[i], kb[j], s[i][j]);
          dp[i][j] = dot4(ga[i], vb[j], dp[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + 2 * rg + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kg + 8 * j;
      float pv = 0.f, ds = 0.f;
      if (live(p, q_lo + r, k_lo + key)) {
        pv = expf(s[i][j] * p.scale - sL[r]);
        ds = pv * (dp[i][j] - sD[r]);
      }
      if (sP != nullptr) sP[r * LDS + key] = pv;
      sS[r * LDS + key] = ds;
    }
  }
}

// delta = rowsum(dO * O), one warp per row of the (B * Hq * Tq) rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.tq;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int t = static_cast<int>(row % p.tq);
  const int h = static_cast<int>((row / p.tq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.tq) * p.hq));
  const T* o = static_cast<const T*>(p.o) + b * p.so_b + h * p.so_h +
               t * p.so_t;
  const T* g = static_cast<const T*>(p.dout) + b * p.sg_b + h * p.sg_h +
               t * p.sg_t;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32)
    acc = fmaf(load_f(g + c), load_f(o + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <int DMAX>
struct Smem {
  float *sK, *sV, *sQ, *sG, *sP, *sS, *sL, *sD;
  __device__ explicit Smem(float* base) {
    constexpr int ld = DMAX + 4;
    sK = base;
    sV = sK + BKV * ld;
    sQ = sV + BKV * ld;
    sG = sQ + BQ * ld;
    sP = sG + BQ * ld;
    sS = sP + BQ * LDS;
    sL = sS + BQ * LDS;
    sD = sL + BQ;
  }
};

template <typename T, int DMAX, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const Params p) {
  constexpr int ld = DMAX + 4;
  constexpr int NJ = DMAX / 128;                // 4-wide column strips
  extern __shared__ float4 smem4[];
  const Smem<DMAX> sm(reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int heads = p.hkv * p.batch;
  const int k_lo = static_cast<int>(blockIdx.x / heads) * BKV;
  const int hk = static_cast<int>(blockIdx.x % heads) % p.hkv;
  const int b = static_cast<int>(blockIdx.x % heads) / p.hkv;
  const int group = p.hq / p.hkv;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;

  // the live query rows of this KV tile: [q_start, q_end)
  int q_start = 0, q_end = p.tq;
  if (p.causal) q_start = k_lo;
  if (p.window > 0) q_end = min(q_end, k_lo + BKV - 1 + p.window);
  q_start = (q_start / BQ) * BQ;

  stage<T, DMAX, BKV, MODE>(sm.sK, k, p.sk_t, k_lo, p.tk, p.d);
  stage<T, DMAX, BKV, MODE>(sm.sV, v, p.sv_t, k_lo, p.tk, p.d);

  // acc*[kk][j][e]: key k_lo + 4 warp + kk, column 4 lane + 128 j + e
  float accK[KEYS_W][NJ][4], accV[KEYS_W][NJ][4];
#pragma unroll
  for (int kk = 0; kk < KEYS_W; ++kk)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accK[kk][j][e] = accV[kk][j][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;              // h * Hkv / Hq == hk
    const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
    const T* g = static_cast<const T*>(p.dout) + b * p.sg_b + h * p.sg_h;
    const long long rbase = (static_cast<long long>(b) * p.hq + h) * p.tq;
    for (int q_lo = q_start; q_lo < q_end; q_lo += BQ) {
      if (!any_live(p, q_lo, BQ, k_lo, BKV)) continue;   // block-uniform
      stage<T, DMAX, BQ, MODE>(sm.sQ, q, p.sq_t, q_lo, p.tq, p.d);
      stage<T, DMAX, BQ, MODE>(sm.sG, g, p.sg_t, q_lo, p.tq, p.d);
      stage_rows(sm.sL, sm.sD, p.lse + rbase, p.delta + rbase, q_lo, p.tq);
      __syncthreads();
      scores_and_ds<DMAX>(p, sm.sQ, sm.sG, sm.sK, sm.sV, sm.sL, sm.sD, sm.sP,
                          sm.sS, q_lo, k_lo);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(sm.sP + r * LDS + 4 * warp);
        const float4 dd =
            *reinterpret_cast<const float4*>(sm.sS + r * LDS + 4 * warp);
        const float pk[4] = {pp.x, pp.y, pp.z, pp.w};
        const float dk[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 g4 = *reinterpret_cast<const float4*>(
              sm.sG + r * ld + 4 * lane + 128 * j);
          const float4 q4 = *reinterpret_cast<const float4*>(
              sm.sQ + r * ld + 4 * lane + 128 * j);
#pragma unroll
          for (int kk = 0; kk < KEYS_W; ++kk) {
            accV[kk][j][0] = fmaf(pk[kk], g4.x, accV[kk][j][0]);
            accV[kk][j][1] = fmaf(pk[kk], g4.y, accV[kk][j][1]);
            accV[kk][j][2] = fmaf(pk[kk], g4.z, accV[kk][j][2]);
            accV[kk][j][3] = fmaf(pk[kk], g4.w, accV[kk][j][3]);
            accK[kk][j][0] = fmaf(dk[kk], q4.x, accK[kk][j][0]);
            accK[kk][j][1] = fmaf(dk[kk], q4.y, accK[kk][j][1]);
            accK[kk][j][2] = fmaf(dk[kk], q4.z, accK[kk][j][2]);
            accK[kk][j][3] = fmaf(dk[kk], q4.w, accK[kk][j][3]);
          }
        }
      }
      __syncthreads();                          // before the next staging
    }
  }

  T* dk = static_cast<T*>(p.dk) +
          (static_cast<long long>(b) * p.hkv + hk) * p.tk * p.d;
  T* dv = static_cast<T*>(p.dv) +
          (static_cast<long long>(b) * p.hkv + hk) * p.tk * p.d;
#pragma unroll
  for (int kk = 0; kk < KEYS_W; ++kk) {
    const int key = k_lo + KEYS_W * warp + kk;
    if (key >= p.tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * j + e;
        if (c < p.d) {
          store_f(dk + static_cast<long long>(key) * p.d + c,
                  accK[kk][j][e] * p.scale);
          store_f(dv + static_cast<long long>(key) * p.d + c,
                  accV[kk][j][e]);
        }
      }
  }
}

template <typename T, int DMAX, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const Params p) {
  constexpr int ld = DMAX + 4;
  constexpr int NJ = DMAX / 128;
  extern __shared__ float4 smem4[];
  const Smem<DMAX> sm(reinterpret_cast<float*>(smem4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the heaviest query tiles (the last, under a causal mask) go first
  const int ntq = (p.tq + BQ - 1) / BQ;
  const int heads = p.hq * p.batch;
  const int q_lo = (ntq - 1 - static_cast<int>(blockIdx.x / heads)) * BQ;
  const int h = static_cast<int>(blockIdx.x % heads) % p.hq;
  const int b = static_cast<int>(blockIdx.x % heads) / p.hq;
  const int hk = static_cast<int>(static_cast<long long>(h) * p.hkv / p.hq);
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* g = static_cast<const T*>(p.dout) + b * p.sg_b + h * p.sg_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const long long rbase = (static_cast<long long>(b) * p.hq + h) * p.tq;

  // the live KV tiles of this query tile, as in K4
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, q_lo + BQ);
  if (p.window > 0) kv_lo = max(0, q_lo - (p.window - 1));
  kv_lo = (kv_lo / BKV) * BKV;

  stage<T, DMAX, BQ, MODE>(sm.sQ, q, p.sq_t, q_lo, p.tq, p.d);
  stage<T, DMAX, BQ, MODE>(sm.sG, g, p.sg_t, q_lo, p.tq, p.d);
  stage_rows(sm.sL, sm.sD, p.lse + rbase, p.delta + rbase, q_lo, p.tq);

  // acc[r][j][e]: row q_lo + 8 warp + r, column 4 lane + 128 j + e
  float acc[ROWS_W][NJ][4];
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int k_lo = kv_lo; k_lo < kv_hi; k_lo += BKV) {
    if (!any_live(p, q_lo, BQ, k_lo, BKV)) continue;     // block-uniform
    stage<T, DMAX, BKV, MODE>(sm.sK, k, p.sk_t, k_lo, p.tk, p.d);
    stage<T, DMAX, BKV, MODE>(sm.sV, v, p.sv_t, k_lo, p.tk, p.d);
    __syncthreads();
    scores_and_ds<DMAX>(p, sm.sQ, sm.sG, sm.sK, sm.sV, sm.sL, sm.sD, nullptr,
                        sm.sS, q_lo, k_lo);
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float ds[ROWS_W][4];
#pragma unroll
      for (int r = 0; r < ROWS_W; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            sm.sS + (warp * ROWS_W + r) * LDS + c);
        ds[r][0] = x.x;
        ds[r][1] = x.y;
        ds[r][2] = x.z;
        ds[r][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kb = *reinterpret_cast<const float4*>(
              sm.sK + (c + cc) * ld + 4 * lane + 128 * j);
#pragma unroll
          for (int r = 0; r < ROWS_W; ++r) {
            acc[r][j][0] = fmaf(ds[r][cc], kb.x, acc[r][j][0]);
            acc[r][j][1] = fmaf(ds[r][cc], kb.y, acc[r][j][1]);
            acc[r][j][2] = fmaf(ds[r][cc], kb.z, acc[r][j][2]);
            acc[r][j][3] = fmaf(ds[r][cc], kb.w, acc[r][j][3]);
          }
        }
    }
    __syncthreads();                            // before the next staging
  }

  T* dq = static_cast<T*>(p.dq) + rbase * p.d;
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r) {
    const int row = q_lo + warp * ROWS_W + r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * j + e;
        if (c < p.d)
          store_f(dq + static_cast<long long>(row) * p.d + c,
                  acc[r][j][e] * p.scale);
      }
  }
}

template <typename T, int DMAX, int MODE>
int launch(const Params& p, cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DMAX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, DMAX, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.tq;
  const long long n_delta = (rows + WARPS - 1) / WARPS;
  const long long n_dkdv =
      static_cast<long long>((p.tk + BKV - 1) / BKV) * p.hkv * p.batch;
  const long long n_dq =
      static_cast<long long>((p.tq + BQ - 1) / BQ) * p.hq * p.batch;
  if (n_delta > 0x7fffffffLL || n_dkdv > 0x7fffffffLL ||
      n_dq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(n_delta), THREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, DMAX, MODE>
      <<<static_cast<unsigned>(n_dkdv), THREADS, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DMAX, MODE>
      <<<static_cast<unsigned>(n_dq), THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int by_width(const Params& p, cudaStream_t s) {
  if (p.d <= 128) return launch<T, 128, MODE>(p, s);
  return launch<T, 256, MODE>(p, s);
}

// 4-wide loads need D, every row stride and every base pointer to be
// multiples of four elements.
template <typename T>
bool vector_ok(const Params& p) {
  const long long strides[] = {p.sq_b, p.sq_h, p.sq_t, p.sk_b, p.sk_h,
                               p.sk_t, p.sv_b, p.sv_h, p.sv_t, p.sg_b,
                               p.sg_h, p.sg_t};
  if (p.d % 4 != 0) return false;
  for (long long st : strides)
    if (st % 4 != 0) return false;
  const uintptr_t align = 4 * sizeof(T);
  return reinterpret_cast<uintptr_t>(p.q) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.k) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.v) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.dout) % align == 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, dout, dq, dk, dv alike; lse and
// delta fp32).  Strides are in elements; each input's last dimension is
// contiguous; dq, dk, dv, lse and delta are contiguous.  window <= 0 means
// no window.  Runs the delta pre-pass, then dK / dV, then dQ.  Returns the
// launches' cudaError_t.
extern "C" int flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int tq, int tk, int d,
    long long sq_b, long long sq_h, long long sq_t,
    long long sk_b, long long sk_h, long long sk_t,
    long long sv_b, long long sv_h, long long sv_t,
    long long so_b, long long so_h, long long so_t,
    long long sg_b, long long sg_h, long long sg_t,
    float scale, int causal, int window, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 1 ||
      d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, batch, hq, hkv, tq, tk,
           d, sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b,
           so_h, so_t, sg_b, sg_h, sg_t, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_ok<float>(p) ? by_width<float, VEC>(p, s)
                               : by_width<float, SCALAR>(p, s);
  if (dtype == 1)
    return vector_ok<__nv_bfloat16>(p) ? by_width<__nv_bfloat16, VEC>(p, s)
                                       : by_width<__nv_bfloat16, SCALAR>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
