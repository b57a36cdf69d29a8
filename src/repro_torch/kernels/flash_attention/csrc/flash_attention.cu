// K4 `flash_attention`: online-softmax attention, fp32 math, for
//   q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), D <= 256, fp32 or bf16,
// with a causal mask (kpos <= qpos), a sliding window (qpos - kpos < window),
// the mask of keys at or past the true Tk, and GQA (query head h reads KV
// head h * Hkv / Hq in place: KV is never repeated in memory).
//
// Replaces flash_attention_pallas (_flash_kernel) of
// src/repro/kernels/flash_attention/kernel.py, and the same body relaunched
// by ops._call_kernel (ops.py) with the true KV length.  It computes what
// ops.flash_attention computes: masked scores are -1e30, p is zeroed where
// masked, l is clamped to 1e-30 (a fully masked row gives 0), and the scale
// is taken by the caller from the true D.  For training it also writes
// each row's log-sum-exp L = m + log(l) (scaled scores; l clamped to 1e-30,
// so a fully masked row gets L ~ -1e30 and K4b gives it a zero gradient)
// into an optional fp32 (B, Hq, Tq) array; serving passes none, and the
// output is the same bits either way.
//
// What bounds it on an H100: operations.  At the served shape of gemma3-1b
// (B 8, Hq 4, Hkv 1, T 1024, D 256, fp32) a causal layer does 17.2 GFLOP
// of fp32 FMA on 84 MB of q, k, v and out: 0.26 ms at 67 TFLOP/s against
// 0.025 ms at 3.35 TB/s.  This version keeps the Pallas kernel's fp32
// arithmetic (the served dtype, and preferred_element_type=float32 there)
// and so runs on the CUDA cores; tensor cores (TF32, or bf16 wgmma) are for
// a later version.  So the design spends its issue slots on FMAs, keeps the
// shared-memory traffic per FMA low, and hides the loads behind arithmetic.
//
// Design: one block of 8 warps per (query tile of BQ = 64 rows, query
// head, batch).  Blocks are dispatched in index order, and the index puts
// the heaviest query tiles (the last, under a causal mask) of every head
// and batch first, so the light ones fill the tail.  The TPU kernel walked
// the KV panels as its sequential 4th grid axis with m, l and acc in VMEM
// scratch; here a loop inside the block walks the live KV tiles of
// BKV = 64 keys (tiles wholly above the causal frontier or left of the
// window are never visited):
//   * K and V go through a ring of two slots in shared memory, one for K
//     and one for V, filled by 16-byte cp.async with zero fill past Tk:
//     V of tile t loads while its scores are computed, K of tile t + 1
//     while P V of tile t is accumulated.  One block barrier per slot
//     hand-over, two per tile.  Q is staged once.
//   * Each warp owns 8 query rows end to end: their scores, running max m,
//     running sum l and output accumulator.  Lane (rg, kg) = (lane / 16,
//     lane % 16) computes a 4 x 4 micro-tile of scores, rows 4 rg + i and
//     keys kg + 16 j: per 4 of D, four broadcast 16-byte loads of Q and
//     four of K feed 64 FMAs, issued one column of D at a time across the
//     16 sums so that no FMA waits on the one before it.  Row max and sum
//     are shuffles among the 16 lanes of a row group; p goes to the warp's
//     own 8 x 64 slice of shared memory (no block barrier), and each lane
//     accumulates 8 rows x D / 32 columns of P V, reading p as broadcasts
//     and V rows as 16-byte loads.
//   * A warp whose 8 rows see no live key of a tile (the causal frontier,
//     the window's edge, rows past Tq) skips it: masked keys add nothing.
// Shared memory: Q, one K and one V stage, and P, in fp32: 217,088 B at
// D <= 256, 118,784 B at D <= 128, one block per SM; above the 48 KB
// default, hence cudaFuncSetAttribute(MaxDynamicSharedMemorySize), set on
// every launch (the attribute is per device).  Ragged Tq, Tk and D are
// masked in the kernel (zeros are staged past Tk and D, rows past Tq are
// not written), so the caller pads nothing.  bf16 is widened to fp32 on
// load (plain loads, not cp.async) and the output is rounded to bf16 on
// store; when D or a stride is not a multiple of 4, or a pointer is not
// aligned to 4 elements, the staging loads element by element.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BKV = 64;                // keys per K or V stage
constexpr int ROWS_W = 8;              // query rows per warp
constexpr int RI = ROWS_W / 2;         // score rows per lane
constexpr int WARPS = BQ / ROWS_W;     // 8
constexpr int THREADS = 32 * WARPS;    // 256
constexpr int LDP = BKV + 4;           // row stride of a warp's p tile
constexpr float NEG_INF = -1e30f;

// How K and V reach shared memory: cp.async (fp32, 16-byte aligned rows),
// 4-wide plain loads (bf16, aligned) or element by element.
enum Mode { ASYNC = 0, VEC = 1, SCALAR = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                          // (B, Hq, Tq) or null
  int batch, hq, hkv, tq, tk, d;
  int ntq;                             // query tiles: ceil(tq / BQ)
  long long sq_b, sq_h, sq_t;          // element strides (last dim is 1)
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  long long so_b, so_h, so_t;
  float scale;
  int causal;
  int window;                          // <= 0: no window
};

// Q, one K stage, one V stage, and each warp's p tile, in floats.
template <int DMAX>
constexpr int smem_floats() {
  return (BQ + 2 * BKV) * (DMAX + 4) + WARPS * ROWS_W * LDP;
}
// an H100 block may take at most 232,448 bytes of shared memory
static_assert(smem_floats<256>() * 4 <= 232448,
              "K4's shared memory at D = 256 exceeds an H100 block's");

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements as fp32; p is aligned to four elements.
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

// 16 bytes global -> shared, zero-filled when `bytes` is 0.
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

// Stage rows [lo, lo + ROWS) of a (T, D) head into shared memory with row
// stride DMAX + 4, the first ceil(d / 4) groups of 4 columns of each, zeros
// past t and past d.  The plain-load modes start all of a thread's loads
// before its first store.
template <typename T, int DMAX, int ROWS, int MODE>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int lo, int t, int d) {
  constexpr int ld = DMAX + 4;
  constexpr int C4 = DMAX / 4;                 // 4-wide groups per row
  constexpr int PER = ROWS * C4 / THREADS;     // groups per thread
  const int nc4 = (d + 3) / 4;
  if (MODE == ASYNC) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / C4, c = (i - r * C4) * 4;
      if (c >= 4 * nc4) continue;
      const bool in = lo + r < t;
      cp_async16(dst + r * ld + c, in ? src + (lo + r) * st + c : src,
                 in ? 16 : 0);
    }
    return;
  }
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
    if (c < 4 * nc4) *reinterpret_cast<float4*>(dst + r * ld + c) = buf[u];
  }
}

template <typename T, int DMAX, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const Params p) {
  constexpr int ld = DMAX + 4;
  constexpr int NJ = DMAX / 128;       // 4-wide column strips per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;                    // BQ x ld
  float* sK = sQ + BQ * ld;            // BKV x ld: the ring's K slot
  float* sV = sK + BKV * ld;           // BKV x ld: the ring's V slot
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sP = sV + BKV * ld + warp * ROWS_W * LDP;   // this warp's p

  // blocks are dispatched in index order: the heaviest query tiles (the
  // last, under a causal mask) of every head and batch go first
  const int heads = p.hq * p.batch;
  const int q_lo = (p.ntq - 1 - static_cast<int>(blockIdx.x / heads)) * BQ;
  const int h = static_cast<int>(blockIdx.x % heads) % p.hq;
  const int b = static_cast<int>(blockIdx.x % heads) / p.hq;
  const int hk = static_cast<int>(static_cast<long long>(h) * p.hkv / p.hq);
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  T* o = static_cast<T*>(p.o) + b * p.so_b + h * p.so_h;

  // the live KV tiles of this query tile (the Pallas kernel's panel skip)
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, q_lo + BQ);
  if (p.window > 0) kv_lo = max(0, q_lo - (p.window - 1));
  kv_lo = (kv_lo / BKV) * BKV;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  stage<T, DMAX, BQ, MODE>(sQ, q, p.sq_t, q_lo, p.tq, p.d);
  if (ntiles > 0) stage<T, DMAX, BKV, MODE>(sK, k, p.sk_t, kv_lo, p.tk, p.d);
  cp_async_commit();

  // scores: lane (rg, kg) = (lane / 16, lane % 16) takes rows 4 rg + i and
  // keys kg + 16 j of the warp's 8 x 64 tile
  const int rg = lane >> 4, kg = lane & 15;
  const int r0 = q_lo + warp * ROWS_W;          // the warp's first row
  const int nc4 = (p.d + 3) / 4;
  float m[RI], l[RI];                           // rows RI rg + i
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // acc[r][j][e]: row r0 + r, column 4 lane + 128 j + e
  float acc[ROWS_W][NJ][4];
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k_lo = kv_lo + t * BKV;
    // K of tile t is in; every warp is done with V of tile t - 1: V of
    // tile t goes into its slot while the scores are computed
    cp_async_wait_all();
    __syncthreads();
    stage<T, DMAX, BKV, MODE>(sV, v, p.sv_t, k_lo, p.tk, p.d);
    cp_async_commit();

    // does any key of this tile reach any of the warp's rows?
    bool any = r0 < p.tq && k_lo < p.tk;
    if (p.causal) any = any && k_lo <= r0 + ROWS_W - 1;
    if (p.window > 0) any = any && r0 - (k_lo + BKV - 1) < p.window;

    float alpha[RI];
    if (any) {
      // S = Q K^T, D four at a time
      float s[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* qrow = sQ + (warp * ROWS_W + RI * rg) * ld;
      const float* krow = sK + kg * ld;
#pragma unroll 4
      for (int c4 = 0; c4 < nc4; ++c4) {
        float4 qa[RI], kb[4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
          qa[i] = *reinterpret_cast<const float4*>(qrow + i * ld + 4 * c4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kb[j] =
              *reinterpret_cast<const float4*>(krow + 16 * j * ld + 4 * c4);
        // one column of D across all 16 sums before the next: no FMA
        // waits on the one before it
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
      }
      // online softmax over the 16 lanes of a row group
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int qpos = r0 + RI * rg + i;
        bool ok[4];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ok[j] = live(p, qpos, k_lo + kg + 16 * j);
          s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int x = 1; x < 16; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
          sP[(RI * rg + i) * LDP + kg + 16 * j] = e;
          sum += e;
        }
#pragma unroll
        for (int x = 1; x < 16; x <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, x);
        alpha[i] = expf(m[i] - m_new);
        l[i] = alpha[i] * l[i] + sum;
        m[i] = m_new;
      }
    }

    // V of tile t is in; every warp is done with K of tile t: K of tile
    // t + 1 goes into its slot while P V is accumulated
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles)
      stage<T, DMAX, BKV, MODE>(sK, k, p.sk_t, k_lo + BKV, p.tk, p.d);
    cp_async_commit();
    if (!any) continue;                // warp-uniform

    // acc = acc * alpha + P V: every lane, all 8 rows, its D / 32 columns
#pragma unroll
    for (int r = 0; r < ROWS_W; ++r) {
      const float a = __shfl_sync(0xffffffffu, alpha[r % RI], (r / RI) * 16);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float pa[ROWS_W][4];
#pragma unroll
      for (int r = 0; r < ROWS_W; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sP + r * LDP + c);
        pa[r][0] = x.x;
        pa[r][1] = x.y;
        pa[r][2] = x.z;
        pa[r][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vb = *reinterpret_cast<const float4*>(
              sV + (c + cc) * ld + 4 * lane + 128 * j);
#pragma unroll
          for (int r = 0; r < ROWS_W; ++r) {
            acc[r][j][0] = fmaf(pa[r][cc], vb.x, acc[r][j][0]);
            acc[r][j][1] = fmaf(pa[r][cc], vb.y, acc[r][j][1]);
            acc[r][j][2] = fmaf(pa[r][cc], vb.z, acc[r][j][2]);
            acc[r][j][3] = fmaf(pa[r][cc], vb.w, acc[r][j][3]);
          }
        }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < ROWS_W; ++r) {
    const float lr =
        fmaxf(__shfl_sync(0xffffffffu, l[r % RI], (r / RI) * 16), 1e-30f);
    const float mr = __shfl_sync(0xffffffffu, m[r % RI], (r / RI) * 16);
    if (r0 + r >= p.tq) continue;
    if (p.lse != nullptr && lane == 0)
      p.lse[(static_cast<long long>(b) * p.hq + h) * p.tq + r0 + r] =
          mr + logf(lr);
    T* orow = o + (r0 + r) * p.so_t;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + 128 * j + e;
        if (c < p.d) store_f(orow + c, acc[r][j][e] / lr);
      }
  }
}

template <typename T, int DMAX, int MODE>
int launch(const Params& p, int batch, cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(p.ntq) * p.hq * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<T, DMAX, MODE>
      <<<static_cast<unsigned>(blocks), THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int by_width(const Params& p, int batch, cudaStream_t s) {
  if (p.d <= 128) return launch<T, 128, MODE>(p, batch, s);
  return launch<T, 256, MODE>(p, batch, s);
}

// 4-wide loads need D, every row stride and every base pointer (with its
// batch and head offsets) to be multiples of four elements.
template <typename T>
bool vector_ok(const Params& p) {
  const long long strides[] = {p.sq_b, p.sq_h, p.sq_t, p.sk_b, p.sk_h,
                               p.sk_t, p.sv_b, p.sv_h, p.sv_t};
  if (p.d % 4 != 0) return false;
  for (long long st : strides)
    if (st % 4 != 0) return false;
  const uintptr_t align = 4 * sizeof(T);
  return reinterpret_cast<uintptr_t>(p.q) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.k) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.v) % align == 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  Strides are in
// elements; each tensor's last dimension is contiguous.  window <= 0 means
// no window.  lse: null, or a contiguous fp32 (B, Hq, Tq) array for the
// rows' log-sum-exp.  Returns the launch's cudaError_t.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o,
    float* lse, int batch, int hq, int hkv, int tq, int tk, int d,
    long long sq_b, long long sq_h, long long sq_t,
    long long sk_b, long long sk_h, long long sk_t,
    long long sv_b, long long sv_h, long long sv_t,
    long long so_b, long long so_h, long long so_t,
    float scale, int causal, int window, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 1 ||
      d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, batch, hq, hkv, tq, tk, d, (tq + BQ - 1) / BQ,
           sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
           so_b, so_h, so_t, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_ok<float>(p) ? by_width<float, ASYNC>(p, batch, s)
                               : by_width<float, SCALAR>(p, batch, s);
  if (dtype == 1)
    return vector_ok<__nv_bfloat16>(p)
               ? by_width<__nv_bfloat16, VEC>(p, batch, s)
               : by_width<__nv_bfloat16, SCALAR>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
