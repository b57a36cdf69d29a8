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
// What bounds it on an H100: operations.  At moonshot's served layer (B 8,
// Hq = Hkv 16, T 1024, D 128, fp32, causal) it does 17.2 GFLOP of products
// on 67 MB of q, k, v and out: 0.26 ms at 67 TFLOP/s on the CUDA cores
// against 0.020 ms at 3.35 TB/s.  Three instances, chosen by D alone (the
// wrapper's kernel.instance() picks one and passes it; instance_of() below
// mirrors that choice and refuses a mismatch):
//
//   "tc64" (D <= 64) and "tc128" (D <= 128): the tensor cores.  Every
//   product, S = Q K^T and P V, runs as mma.sync.m16n8k8 TF32 with the
//   3xTF32 split, as K4b does (flash_attention_bwd.cu): each fp32 operand x
//   is cut into hi = x with its low 13 bits cleared and lo = x - hi, and a
//   product is lo*hi + hi*lo + hi*hi in fp32, within ~2^-20 of fp32's own.
//   bf16 inputs widen exactly into TF32, so their lo parts are 0 and those
//   products are skipped: S takes one product, P V two (P is fp32).  The
//   tensor core does not round its accumulator to nearest, so a long chain
//   in one accumulator drifts toward zero (~2^-23 of the sum a product): no
//   accumulator runs over more than 12 products.  S is summed over D in
//   32-column chunks, each from zero, added by an fp32 add; P V over a
//   64-key tile in two 32-key halves, each from zero (and in each, the
//   hi x hi products apart from the small ones: four independent chains a
//   column block, which the tensor core's latency needs), and the tile's
//   sum is added to the running output by an fp32 FMA with the rescale
//   alpha.
//     Design: a block of 8 warps takes TC_BQ = 128 query rows of one head,
//   16 rows a warp (the mma's m16), heaviest query tiles first in block
//   order.  Q is staged once; K and V walk the live 64-key tiles through a
//   ring of two stages filled by 16-byte cp.async (zero fill past Tk and
//   past D), one block barrier a tile: tile t + 1 loads while tile t is
//   computed.  The fp32 tiles have row stride DMAX and no pad; the 16-byte
//   chunk c of row r is stored at chunk c ^ (r & 7), so that the ldmatrix
//   loads of Q (the A operand) and of K (the B operand of S), and the
//   scalar loads of V (the B operand of P V: rows 2t, 2t + 1, column g),
//   are free of bank conflicts.  The score fragment stays in registers
//   (C layout: lane (g, t) holds rows g and g + 8, keys 2t and 2t + 1 of
//   each 8-key block), the online softmax runs on it (a row's max and sum
//   are shuffles among the 4 lanes that hold it), and P is the A operand
//   of P V as it stands: the mma's k index t is taken to be key 2t and
//   t + 4 key 2t + 1, and V's rows are read in the same order.  A warp
//   accumulates its 16 x D output in registers (16 x 8 columns a lane at
//   D = 128).  The k steps of S and the column blocks of P V stop at D
//   rounded up to 8 (a warp-uniform branch: a predicate on each mma
//   instead lets the compiler hoist past it and spill): at D = 64 and 112
//   no mma is spent on columns past D.  A warp whose 16 rows see no live
//   key of a tile skips it.  Shared memory: Q and two stages of K and V,
//   196,608 B at D <= 128 (one block an SM: 222 registers a thread),
//   98,304 B at D <= 64 (two: 128 registers, a few spilled, still 1.25x
//   faster than one block an SM).
//
//   "simt256" (D <= 256, gemma3-1b's layers): fp32 FMAs on the CUDA cores,
//   tuned for D = 256.  One block of 8 warps per 64 query rows; K and V go
//   through a ring of two slots in shared memory, one for K and one for V,
//   filled by 16-byte cp.async with zero fill past Tk: V of tile t loads
//   while its scores are computed, K of tile t + 1 while P V of tile t is
//   accumulated (one block barrier per slot hand-over, two per tile).  Each
//   warp owns 8 query rows end to end: lane (rg, kg) = (lane / 16, lane %
//   16) computes a 4 x 4 micro-tile of scores, rows 4 rg + i and keys kg +
//   16 j, from broadcast 16-byte loads of Q and K, one column of D at a
//   time across the 16 sums; row max and sum are shuffles among the 16
//   lanes of a row group; p goes to the warp's own 8 x 64 slice of shared
//   memory and each lane accumulates 8 rows x D / 32 columns of P V.
//   Shared memory: Q, one K and one V stage, and P: 217,088 B.
//
// Every instance: blocks are dispatched in index order and the index puts
// the heaviest query tiles (the last, under a causal mask) of every head and
// batch first, so the light ones fill the tail; KV tiles wholly above the
// causal frontier or left of the window are never visited.  Shared memory
// above the 48 KB default needs cudaFuncSetAttribute
// (MaxDynamicSharedMemorySize), set on every launch (the attribute is per
// device).  Ragged Tq, Tk and D are masked in the kernel (zeros are staged
// past Tk and D, rows past Tq are not written), so the caller pads nothing.
// bf16 is widened to fp32 on load (plain loads, not cp.async) and the output
// is rounded to bf16 on store; when D or a stride is not a multiple of 4, or
// a pointer is not aligned to 4 elements, the staging loads element by
// element.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;           // 8 warps, every instance
constexpr float NEG_INF = -1e30f;

// "simt256"
constexpr int BQ = 64;                 // query rows per block
constexpr int BKV = 64;                // keys per K or V stage
constexpr int ROWS_W = 8;              // query rows per warp
constexpr int RI = ROWS_W / 2;         // score rows per lane
constexpr int WARPS = BQ / ROWS_W;     // 8
constexpr int LDP = BKV + 4;           // row stride of a warp's p tile

// "tc64" / "tc128"
constexpr int TC_BQ = 128;             // query rows per block, 16 a warp
constexpr int TC_BKV = 64;             // keys per K or V stage
constexpr int TC_STAGES = 2;           // stages of the K / V ring
constexpr int TC_D_SMALL = 64;         // "tc64" takes D <= 64
constexpr int TC_D_MAX = 128;          // "tc128" takes D <= 128
constexpr int TC64_BLOCKS = 2;         // "tc64" blocks an SM (registers)

static_assert(TC_BQ == 16 * (THREADS / 32), "a warp takes 16 query rows");

// The instances, codes shared with kernel.INSTANCES.
enum Instance { TC64 = 0, TC128 = 1, SIMT256 = 2 };

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
  int ntq;                             // query tiles of the instance's size
  long long sq_b, sq_h, sq_t;          // element strides (last dim is 1)
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  long long so_b, so_h, so_t;
  float scale;
  int causal;
  int window;                          // <= 0: no window
};

// "simt256": Q, one K stage, one V stage, and each warp's p tile, in floats.
template <int DMAX>
constexpr int smem_floats() {
  return (BQ + 2 * BKV) * (DMAX + 4) + WARPS * ROWS_W * LDP;
}
// "tc64" / "tc128": Q and TC_STAGES stages of K and of V, in floats.
template <int DMAX>
constexpr int tc_smem_floats() {
  return (TC_BQ + 2 * TC_STAGES * TC_BKV) * DMAX;
}
// an H100 block may take at most 232,448 bytes of shared memory
static_assert(smem_floats<256>() * 4 <= 232448,
              "K4's shared memory at D = 256 exceeds an H100 block's");
static_assert(tc_smem_floats<TC_D_MAX>() * 4 <= 232448,
              "K4's shared memory at D = 128 exceeds an H100 block's");

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

// Four elements from column c of a row of d, zeros past d (4-wide when
// MODE is VEC, element by element when SCALAR).
template <typename T, int MODE>
__device__ __forceinline__ float4 load4(const T* row, int c, int d) {
  if (MODE == VEC) return load4_aligned(row + c);
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  x.x = load_f(row + c);
  if (c + 1 < d) x.y = load_f(row + c + 1);
  if (c + 2 < d) x.z = load_f(row + c + 2);
  if (c + 3 < d) x.w = load_f(row + c + 3);
  return x;
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

// Does any key of [k_lo, k_lo + nk) reach any row of [q_lo, q_lo + nq)?
__device__ __forceinline__ bool any_live(const Params& p, int q_lo, int nq,
                                         int k_lo, int nk) {
  bool any = q_lo < p.tq && k_lo < p.tk;
  if (p.causal) any = any && k_lo <= q_lo + nq - 1;
  if (p.window > 0) any = any && q_lo - (k_lo + nk - 1) < p.window;
  return any;
}

// Is every key of [k_lo, k_lo + nk) live for every row of [q_lo, q_lo + nq)?
__device__ __forceinline__ bool all_live(const Params& p, int q_lo, int nq,
                                         int k_lo, int nk) {
  bool all = k_lo + nk <= p.tk;
  if (p.causal) all = all && k_lo + nk - 1 <= q_lo;
  if (p.window > 0) all = all && q_lo + nq - 1 - k_lo < p.window;
  return all;
}

// The query tile, head and batch of this block (heaviest tiles first), and
// the live KV range [kv_lo, kv_hi) of that tile, kv_lo on a tile of bkv.
struct Tile {
  int q_lo, h, b, hk, kv_lo, ntiles;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int bq, int bkv) {
  Tile w;
  const int heads = p.hq * p.batch;
  w.q_lo = (p.ntq - 1 - static_cast<int>(blockIdx.x / heads)) * bq;
  w.h = static_cast<int>(blockIdx.x % heads) % p.hq;
  w.b = static_cast<int>(blockIdx.x % heads) / p.hq;
  w.hk = static_cast<int>(static_cast<long long>(w.h) * p.hkv / p.hq);
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, w.q_lo + bq);
  if (p.window > 0) kv_lo = max(0, w.q_lo - (p.window - 1));
  w.kv_lo = (kv_lo / bkv) * bkv;
  w.ntiles = kv_hi > w.kv_lo ? (kv_hi - w.kv_lo + bkv - 1) / bkv : 0;
  return w;
}

// ---------------------------------------------------------------- simt256

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
    if (lo + r < t && c < d) x = load4<T, MODE>(src + (lo + r) * st, c, d);
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

  const Tile w = tile_of(p, BQ, BKV);
  const int q_lo = w.q_lo, kv_lo = w.kv_lo, ntiles = w.ntiles;
  const T* q = static_cast<const T*>(p.q) + w.b * p.sq_b + w.h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + w.b * p.sk_b + w.hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + w.b * p.sv_b + w.hk * p.sv_h;
  T* o = static_cast<T*>(p.o) + w.b * p.so_b + w.h * p.so_h;

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

    const bool any = any_live(p, r0, ROWS_W, k_lo, BKV);

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
      p.lse[(static_cast<long long>(w.b) * p.hq + w.h) * p.tq + r0 + r] =
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

// ---------------------------------------------------------- tc64 / tc128

// The XOR of row r's 16-byte chunks: chunk c is stored at c ^ (r & 7).
__device__ __forceinline__ int swz(int r) { return (r & 7) << 2; }

// Four 8 x 4 fp32 blocks (8 x 8 b16 to ldmatrix) into one register each:
// lane l gets row l / 4, word l % 4 of block j in r[j]; lanes 8 j .. 8 j + 7
// give block j's row addresses.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x with its low 13 bits cleared (TF32), lo the rest.
__device__ __forceinline__ void split(unsigned x, unsigned& hi,
                                      unsigned& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// Rows [lo, lo + ROWS) of a (T, D) head into a swizzled ROWS x DMAX tile:
// columns [0, d8), d8 = D rounded up to 8, zeros past t and past d (the
// columns past d8 are never read).  The plain-load modes issue all of a
// thread's loads before its first store.
template <typename T, int DMAX, int ROWS, int MODE>
__device__ __forceinline__ void stage_tc(float* dst, const T* src,
                                         long long st, int lo, int t, int d,
                                         int d8) {
  constexpr int C4 = DMAX / 4;
  constexpr int PER = ROWS * C4 / THREADS;
  static_assert(ROWS * C4 % THREADS == 0, "stage_tc: uneven split");
  if constexpr (MODE == ASYNC) {
    static_assert(sizeof(T) == 4, "cp.async stages fp32 only");
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / C4, c = (i - r * C4) * 4;
      if (c >= d8) continue;
      const bool in = lo + r < t && c < d;
      cp_async16(dst + r * DMAX + (c ^ swz(r)),
                 in ? src + (lo + r) * st + c : src, in ? 16 : 0);
    }
  } else {
    float4 buf[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / C4, c = (i - r * C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lo + r < t && c < d) x = load4<T, MODE>(src + (lo + r) * st, c, d);
      buf[u] = x;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / C4, c = (i - r * C4) * 4;
      if (c < d8)
        *reinterpret_cast<float4*>(dst + r * DMAX + (c ^ swz(r))) = buf[u];
    }
  }
}

template <typename T, int DMAX, int MODE>
__global__ void
__launch_bounds__(THREADS, DMAX <= TC_D_SMALL ? TC64_BLOCKS : 1)
flash_attention_tc(const Params p) {
  constexpr bool SPLIT = sizeof(T) == 4;       // bf16 is exact in TF32
  constexpr int NB = DMAX / 8;                 // 8-column blocks of D
  constexpr int KB = TC_BKV / 8;               // 8-key blocks of a tile
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);           // TC_BQ x DMAX
  float* sK = sQ + TC_BQ * DMAX;               // TC_STAGES x TC_BKV x DMAX
  float* sV = sK + TC_STAGES * TC_BKV * DMAX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const Tile w = tile_of(p, TC_BQ, TC_BKV);
  const T* q = static_cast<const T*>(p.q) + w.b * p.sq_b + w.h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + w.b * p.sk_b + w.hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + w.b * p.sv_b + w.hk * p.sv_h;
  T* o = static_cast<T*>(p.o) + w.b * p.so_b + w.h * p.so_h;
  const int d8 = (p.d + 7) & ~7;
  const int nb_d = d8 / 8;             // k steps of S, column blocks of P V

  stage_tc<T, DMAX, TC_BQ, MODE>(sQ, q, p.sq_t, w.q_lo, p.tq, p.d, d8);
  if (w.ntiles > 0) {
    stage_tc<T, DMAX, TC_BKV, MODE>(sK, k, p.sk_t, w.kv_lo, p.tk, p.d, d8);
    stage_tc<T, DMAX, TC_BKV, MODE>(sV, v, p.sv_t, w.kv_lo, p.tk, p.d, d8);
  }
  cp_async_commit();

  const int r0 = w.q_lo + 16 * warp;           // the warp's first row
  // ldmatrix lanes: lane 8 j + r gives row r of block j
  const int lj = lane >> 3, lr = lane & 7;
  // Q, the A operand of S: blocks (rows 0-7 | 8-15) x (k 0-3 | 4-7)
  const float* qa = sQ + (16 * warp + lr + 8 * (lj & 1)) * DMAX;
  const int qa_c = 4 * (lj >> 1), qa_sw = swz(lr);
  // K, the B operand of S: blocks (keys 0-7, k 0-3), (0-7, 4-7), (8-15,
  // 0-3), (8-15, 4-7) of each 16 keys
  const int kb_r = lr + 8 * (lj >> 1), kb_c = 4 * (lj & 1), kb_sw = swz(lr);
  // V, the B operand of P V: rows 2t and 2t + 1 of each 8-key block,
  // column g of each 8-column block; vo[n] its offset in a 32-column chunk
  int vo0[4], vo1[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    vo0[n] = (8 * n + g) ^ swz(2 * t);
    vo1[n] = (8 * n + g) ^ swz(2 * t + 1);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8
  // acc[n]: rows r0 + g (+ 8), columns 8 n + 2 t (+ 1)
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < w.ntiles; ++it) {
    const int buf = it % TC_STAGES;
    const int k_lo = w.kv_lo + it * TC_BKV;
    // tile it is in, and every warp is done with tile it - 1, whose stage
    // tile it + 1 takes while this one is computed
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < w.ntiles) {
      const int nxt = ((it + 1) % TC_STAGES) * TC_BKV * DMAX;
      stage_tc<T, DMAX, TC_BKV, MODE>(sK + nxt, k, p.sk_t, k_lo + TC_BKV,
                                      p.tk, p.d, d8);
      stage_tc<T, DMAX, TC_BKV, MODE>(sV + nxt, v, p.sv_t, k_lo + TC_BKV,
                                      p.tk, p.d, d8);
    }
    cp_async_commit();
    if (!any_live(p, r0, 16, k_lo, TC_BKV)) continue;     // warp-uniform
    const float* sk = sK + buf * TC_BKV * DMAX;
    const float* sv = sV + buf * TC_BKV * DMAX;

    // S = Q K^T: s[j] the C fragment of keys 8 j .. 8 j + 7; each
    // 32-column chunk of D from zero, added by an fp32 add (the first
    // chunk's sum is s itself)
    auto chunk = [&](float(&dst)[KB][4], int c0) {
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int c = c0 + 8 * mm;
        if (c >= d8) break;                  // no product past D
        unsigned a[4], ah[4], al[4];
        ldsm4(a, qa + ((c + qa_c) ^ qa_sw));
        if constexpr (SPLIT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
        }
#pragma unroll
        for (int pr = 0; pr < KB / 2; ++pr) {
          unsigned b[4];
          ldsm4(b, sk + (16 * pr + kb_r) * DMAX + ((c + kb_c) ^ kb_sw));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float(&pj)[4] = dst[2 * pr + hf];
            if constexpr (SPLIT) {
              unsigned b0h, b0l, b1h, b1l;
              split(b[2 * hf], b0h, b0l);
              split(b[2 * hf + 1], b1h, b1l);
              mma(pj, al, b0h, b1h);
              mma(pj, ah, b0l, b1l);
              mma(pj, ah, b0h, b1h);
            } else {
              mma(pj, a, b[2 * hf], b[2 * hf + 1]);
            }
          }
        }
      }
    };
    float s[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    chunk(s, 0);
#pragma unroll
    for (int kc = 1; kc < DMAX / 32; ++kc) {
      if (32 * kc >= d8) break;
      float part[KB][4];
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      chunk(part, 32 * kc);
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }

    // online softmax: a row's 64 scores are 16 in each of 4 lanes
    const bool all = all_live(p, r0, 16, k_lo, TC_BKV);
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = r0 + g + 8 * hr;
      unsigned ok = 0;                         // bit 2 j + e: key 8 j + 2t + e
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = all || live(p, qpos, k_lo + 8 * j + 2 * t + e);
          ok |= static_cast<unsigned>(in) << (2 * j + e);
          float& x = s[j][2 * hr + e];
          x = in ? x * p.scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * hr + e];
          x = (ok >> (2 * j + e)) & 1u ? expf(x - m_new) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hr] = expf(m[hr] - m_new);
      l[hr] = alpha[hr] * l[hr] + sum;
      m[hr] = m_new;
    }

    // P as the A operand of P V: the mma's k index t is key 8 j + 2 t and
    // t + 4 key 8 j + 2 t + 1, so a = (c0, c2, c1, c3) of s[j], split once
    // acc = acc * alpha + P V, each 32-key half of the tile from zero
    const float* v0 = sv + 2 * t * DMAX;       // rows 2t, 2t + 1 of block 0
    const float* v1 = v0 + DMAX;
    // big += the hi x hi products, small += the lo x hi and hi x lo ones,
    // of P[:, keys of blocks j0 .. j0 + KB/2) and V[those keys, column
    // block n]: four chains of products a column block, not two
    auto pv_half = [&](float(&big)[4], float(&small)[4],
                       const unsigned(&ph)[KB / 2][4],
                       const unsigned(&pl)[KB / 2][4], int j0, int n) {
      const int col = 32 * (n >> 2);
#pragma unroll
      for (int jj = 0; jj < KB / 2; ++jj) {
        const int j = j0 + jj;
        const unsigned b0 =
            __float_as_uint(v0[8 * j * DMAX + col + vo0[n & 3]]);
        const unsigned b1 =
            __float_as_uint(v1[8 * j * DMAX + col + vo1[n & 3]]);
        if constexpr (SPLIT) {
          unsigned b0h, b0l, b1h, b1l;
          split(b0, b0h, b0l);
          split(b1, b1h, b1l);
          mma(small, pl[jj], b0h, b1h);
          mma(small, ph[jj], b0l, b1l);
          mma(big, ph[jj], b0h, b1h);
        } else {
          mma(small, pl[jj], b0, b1);
          mma(big, ph[jj], b0, b1);
        }
      }
    };
    auto split_p = [&](unsigned(&ph)[KB / 2][4], unsigned(&pl)[KB / 2][4],
                       int j0) {
#pragma unroll
      for (int jj = 0; jj < KB / 2; ++jj) {
        const float(&x)[4] = s[j0 + jj];
        split(__float_as_uint(x[0]), ph[jj][0], pl[jj][0]);
        split(__float_as_uint(x[2]), ph[jj][1], pl[jj][1]);
        split(__float_as_uint(x[1]), ph[jj][2], pl[jj][2]);
        split(__float_as_uint(x[3]), ph[jj][3], pl[jj][3]);
      }
    };
    unsigned ph0[KB / 2][4], pl0[KB / 2][4], ph1[KB / 2][4], pl1[KB / 2][4];
    split_p(ph0, pl0, 0);
    split_p(ph1, pl1, KB / 2);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n >= nb_d) break;                  // no product past D
      float h[4][4] = {};                    // big, small of each half
      pv_half(h[0], h[1], ph0, pl0, 0, n);
      pv_half(h[2], h[3], ph1, pl1, KB / 2, n);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1],
                         (h[0][e] + h[1][e]) + (h[2][e] + h[3][e]));
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    const float lsum = fmaxf(l[hr], 1e-30f);
    if (row >= p.tq) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<long long>(w.b) * p.hq + w.h) * p.tq + row] =
          m[hr] + logf(lsum);
    T* orow = o + row * p.so_t;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n >= nb_d) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c < p.d) store_f(orow + c, acc[n][2 * hr + e] / lsum);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename T, int DMAX, int MODE>
int launch_simt(Params p, cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.ntq = (p.tq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(p.ntq) * p.hq * p.batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<T, DMAX, MODE>
      <<<static_cast<unsigned>(blocks), THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX, int MODE>
int launch_tc(Params p, cudaStream_t s) {
  constexpr int bytes =
      tc_smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<T, DMAX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.ntq = (p.tq + TC_BQ - 1) / TC_BQ;
  const long long blocks = static_cast<long long>(p.ntq) * p.hq * p.batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc<T, DMAX, MODE>
      <<<static_cast<unsigned>(blocks), THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int by_instance(int instance, const Params& p, cudaStream_t s) {
  if (instance == TC64) return launch_tc<T, TC_D_SMALL, MODE>(p, s);
  if (instance == TC128) return launch_tc<T, TC_D_MAX, MODE>(p, s);
  return launch_simt<T, 256, MODE>(p, s);
}

// The instance that takes head width d, as kernel.instance() picks it.
int instance_of(int d) {
  if (d <= TC_D_SMALL) return TC64;
  if (d <= TC_D_MAX) return TC128;
  return SIMT256;
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

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  instance: 0 "tc64",
// 1 "tc128", 2 "simt256", which must be the one D takes (refused
// otherwise).  Strides are in elements; each tensor's last dimension is
// contiguous.  window <= 0 means no window.  lse: null, or a contiguous
// fp32 (B, Hq, Tq) array for the rows' log-sum-exp.  Returns the launch's
// cudaError_t.
extern "C" int flash_attention(
    int dtype, int instance, const void* q, const void* k, const void* v,
    void* o, float* lse, int batch, int hq, int hkv, int tq, int tk, int d,
    long long sq_b, long long sq_h, long long sq_t,
    long long sk_b, long long sk_h, long long sk_t,
    long long sv_b, long long sv_h, long long sv_t,
    long long so_b, long long so_h, long long so_t,
    float scale, int causal, int window, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 1 ||
      d < 1 || d > 256 || instance != instance_of(d))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, batch, hq, hkv, tq, tk, d, 0,
           sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
           so_b, so_h, so_t, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_ok<float>(p) ? by_instance<float, ASYNC>(instance, p, s)
                               : by_instance<float, SCALAR>(instance, p, s);
  if (dtype == 1)
    return vector_ok<__nv_bfloat16>(p)
               ? by_instance<__nv_bfloat16, VEC>(instance, p, s)
               : by_instance<__nv_bfloat16, SCALAR>(instance, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
