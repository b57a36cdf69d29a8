// K6 `decode_attention`: one query position against a KV cache, for
//   q (B, Hq, D) fp32, k / v (B, Hkv, S, D) fp32, bf16 or float8_e4m3fn,
// GQA with g = Hq / Hkv query heads a KV head, output (B, Hq, D) fp32.
//
// Replaces no Pallas kernel.  The JAX package decodes through plain jnp:
// _masked_attention (src/repro/models/layers.py:79, called at :221) over
// the cache upcast to fp32, with kv_valid[i] = pos - ((pos - i) mod S) (the
// absolute position slot i holds: the latest <= pos) and the mask
// 0 <= kv_valid <= pos and, for a local layer, pos - kv_valid < window.
// This kernel computes that function: scale 1/sqrt(D) on the fp32 dot,
// softmax in fp32 over the valid slots, P V in fp32.  With r = (pos - i)
// mod S, slot i is valid iff r <= pos and (no window or r < window), so
// pos and window are arguments and no mask or position tensor exists.
//
// Why it exists: the plain path widens the whole cache to fp32 in device
// memory at every layer of every decode step (an fp8 element is read as 1
// byte, written as 4 and read again as 4), so an fp8 cache would move more
// bytes than the fp32 one it replaces.  Here K and V are read once, in
// their stored type, and widened on chip: bf16 by a shift, fp8 e4m3 by the
// hardware's exact conversion to fp16 (cuda_fp8.h; every e4m3 value is an
// fp16 value, 0x7f / 0xff are NaN), then to fp32.
//
// What bounds it on an H100: bytes.  Each cached element is read once and
// takes 2 g FLOP of dot and P V: pixtral-12b's decode (B 8, Hkv 8, g 4,
// D 128, S 8192) reads 134 MB of fp32 K/V, 0.040 ms at 3.35 TB/s in fp8,
// 0.16 ms in fp32.  So the instructions an element costs must stay few,
// or the narrow caches are bound by issue instead of bytes.
//
// Design:
//   * Grid (C, B * Hkv) of CTAs of W warps, launched as clusters of C CTAs
//     (C = 1, 2, 4, 8 or 16, W = 4 or 8, picked on the host from B * Hkv,
//     S and how many CTAs and clusters of each size the card holds at
//     once: the most warps in one wave): the C CTAs of one (b, KV head)
//     split its ceil(S / TS) tiles of TS slots into C contiguous spans of
//     floor or ceil of tiles / C, and warp w of a CTA takes the span's
//     tiles w, w + W, ...  (TS: 4 KB of K a tile, 8 to 32 slots.)
//   * Staging: each warp keeps a ring of STAGES tiles of K and V in shared
//     memory, filled by 16-byte cp.async (coalesced, 512 bytes a warp an
//     instruction, whatever the dtype), rows padded to DP = D rounded up
//     to 32, 64, 128 or 256 elements and their 16-byte chunks XOR-swizzled
//     by row so that the fragment reads below meet no bank conflict.  Dead
//     slots (unwritten, out of the window, past S) and the padding are
//     zero-filled by cp.async without a global read: they never reach the
//     result, and an old fp8 NaN row in a dead slot is never read.  A row
//     of D x size not a multiple of 16 bytes (or an unaligned cache) is
//     staged element by element with the same layout.
//   * Products on the tensor cores, mma.sync.m16n8k8 TF32 with fp32
//     accumulation.  Rows 0..7 of the 16-row A operand hold the g query
//     rows' TF32 high parts and rows 8..15 their low parts (x = hi + lo,
//     hi = x with its 13 low bits cleared), so one mma gives hi . y and
//     lo . y, whose sum is x . y to ~2^-22: every bf16 and every e4m3
//     value, subnormals included, is exact in TF32, so one mma a product
//     on those caches; an fp32 cache splits its own values too (two mmas,
//     y = y_hi + y_lo).  Scores: A = q (hi / lo), B = K^T (8 slots), C =
//     the scores of query row lane / 4 at slots 2 (lane % 4) and + 1; the
//     D index of the k steps is permuted so that a lane reads LK
//     consecutive elements of its slot's row with one shared-memory load.
//     P V: A = P (hi / lo) straight from those scores (the k index t is
//     slot 2t, t + 4 slot 2t + 1: no shuffle), B = V (8 columns), the
//     columns permuted likewise so that a lane reads LV consecutive
//     elements of a row.  q's fragments stay in registers (in shared
//     memory at DP = 256).  Every accumulator restarts within 8 mmas: the
//     scores a 16-column chunk at a time, P V a tile at a time, then
//     added in fp32 on the CUDA cores.
//   * Online softmax per warp in the log2 domain (q pre-scaled by
//     log2(e) / sqrt(D), exp2): a tile max over the 4 lanes of a row by
//     two shuffles, p = 0 for a dead slot.
//   * Merge: the warps' (m, l, acc) in warp order through shared memory;
//     with C > 1 the CTAs' states, after one cluster barrier, in rank
//     order through distributed shared memory, each CTA finishing a
//     strided share of the g x D outputs.  No partials in device memory,
//     one launch, no atomics: two calls give the same bits.
//   * Partial form (decode_attention_partial): the cache holds slots s0 ..
//     s0 + S - 1 of a cache of s_all slots split over ranks by slot, so
//     local slot i is whole slot s0 + i and takes its absolute position
//     from s_all; the merge writes, beside the output normalised over those
//     slots, its log-sum-exp (natural log) per (b, query head), -inf with a
//     zero output where no slot is valid.  The ranks' results then merge by
//     their log-sum-exps.  The whole-cache call is s0 = 0, s_all = S and no
//     log-sum-exp: the same instructions on the same values.
// Instances: dtype {fp32, bf16, fp8} x DP {32, 64, 128, 256}; g is an
// argument (1 to 8 query rows a KV head).

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace cg = cooperative_groups;

// A knob for tools/torch_k6_variants.py; the default is the shipped design.
#ifndef K6_STAGES               // tiles a warp's ring holds (2 or more)
#define K6_STAGES 3
#endif

namespace {

constexpr int WARPS_MIN = 4;         // warps a CTA: 4 or 8, by launch
constexpr int WARPS_MAX = 8;
constexpr int STAGES = K6_STAGES;
constexpr int D_MAX = 256;
constexpr int G_MAX = 8;             // query rows in an mma's half
constexpr int TILE_BYTES = 4096;     // K bytes a warp's tile aims at
constexpr int TILE_MIN = 8;          // slots a tile: one mma's 8 ...
constexpr int TILE_MAX = 32;         // ... to four
constexpr int CLUSTER_MAX = 16;
constexpr int SMEM_MAX = 232448;     // shared memory a CTA may have
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;          // (B, Hkv * g, D)
  const void* k;           // (B, Hkv, S, D)
  const void* v;
  float* out;              // (B, Hkv * g, D)
  float* lse;              // (B, Hkv * g) or null: the partial form's
  int n_bh, g, d, s, pos, window, cluster, warps;   // n_bh = B * Hkv
  int s0, s_all;           // local slot i is slot s0 + i of s_all
  float qscale;            // log2(e) / sqrt(D)
};

struct Fp8 {};             // tag: float8_e4m3fn bytes

template <typename T> struct Bytes { static constexpr int n = sizeof(T); };
template <> struct Bytes<Fp8> { static constexpr int n = 1; };

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// An instance's geometry: DP the padded width, TS slots a warp's tile.
template <typename T, int DP>
struct Geo {
  static constexpr int SZ = Bytes<T>::n;
  static constexpr int ROWB = DP * SZ;               // a staged row's bytes
  static constexpr int NCH = ROWB / 16;              // its 16-byte chunks
  static constexpr int TS = cmax(TILE_MIN, cmin(TILE_MAX, TILE_BYTES / ROWB));
  static constexpr int NG = TS / 8;                  // 8-slot groups a tile
  static constexpr int TILEB = TS * ROWB;
  static constexpr int STAGEB = 2 * TILEB;           // K then V
  static constexpr int E = 16 / SZ;                  // elements a chunk
  static constexpr int LK = cmin(E, DP / 4);         // K elements a read
  static constexpr int UK = DP / (4 * LK);           // K reads a row
  static constexpr int LV = cmin(cmin(E, 8), DP / 8);   // V elements a read
  static constexpr int UV = DP / (8 * LV);           // V reads a row
  static constexpr int KSTEPS = DP / 8;
  static constexpr bool SPLIT = SZ == 4;             // fp32: y = hi + lo
  static constexpr bool QREG = DP <= 128;            // q fragments in regs
  static constexpr bool SWZ = ROWB >= 128;
  // shared memory of a CTA of w warps: the rings (reused by the warps'
  // merge), the CTA's state (read by the cluster), q's fragments at DP =
  // 256
  static constexpr int STATE = 4 * G_MAX * (2 + DP);
  static constexpr int QSMEM = QREG ? 0 : KSTEPS * 32 * 16;
  __host__ __device__ static constexpr int area(int w) {
    return cmax(w * STAGES * STAGEB, 4 * w * G_MAX * (2 + DP));
  }
  __host__ __device__ static constexpr int smem(int w) {
    return area(w) + STATE + QSMEM;
  }
  static_assert(DP % 32 == 0 && DP <= D_MAX, "DP");
  static_assert(NCH >= 2 && TS % 8 == 0 && LK % 2 == 0, "geometry");
  static_assert(UK * 4 * LK == DP && UV * 8 * LV == DP, "reads");
};

// Physical 16-byte chunk of logical chunk c of staged row `row`: rows of
// 128 bytes or more swizzle within each 8-chunk (128-byte) span so that
// the score reads (rows n, n ^ 1 at chunks t + 4u) and the P V reads
// (rows 2t, chunk n) of 8 lanes hit 8 distinct bank groups.
template <bool SWZ>
__device__ __forceinline__ int phys(int row, int c) {
  if constexpr (!SWZ) return c;
  const int r = row & 7;
  return c ^ (((r & 1) << 2) ^ (r & 6));
}

template <typename G>
__device__ __forceinline__ int soff(int row, int byte) {
  return row * G::ROWB + (phys<G::SWZ>(row, byte >> 4) << 4) + (byte & 15);
}

__device__ __forceinline__ void cp_async16(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NB bytes of shared memory (4, 8 or 16) as 32-bit words.
template <int NB>
__device__ __forceinline__ void lds(const unsigned char* p,
                                    unsigned (&w)[NB / 4]) {
  if constexpr (NB == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (NB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    static_assert(NB == 4, "lds");
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

// N stored elements (N * size / 4 words) widened to fp32 bits.
template <typename T, int N>
__device__ __forceinline__ void widen(const unsigned* w, unsigned* f) {
  if constexpr (Bytes<T>::n == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = w[i];
  } else if constexpr (Bytes<T>::n == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      f[2 * i] = w[i] << 16;
      f[2 * i + 1] = w[i] & 0xffff0000u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3)));
        f[4 * i + 2 * h] = __float_as_uint(x.x);
        f[4 * i + 2 * h + 1] = __float_as_uint(x.y);
      }
    }
  }
}

// x = hi + lo: hi is x with its low 13 bits cleared (TF32), lo the rest.
__device__ __forceinline__ void split(unsigned x, unsigned& hi,
                                      unsigned& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint4& a,
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// c += a (y0, y1), splitting y into TF32 hi + lo when SPLIT.
template <bool SPLIT>
__device__ __forceinline__ void mma_y(float (&c)[4], const uint4& a,
                                      unsigned y0, unsigned y1) {
  if constexpr (SPLIT) {
    unsigned h0, l0, h1, l1;
    split(y0, h0, l0);
    split(y1, h1, l1);
    mma(c, a, h0, h1);
    mma(c, a, l0, l1);
  } else {
    mma(c, a, y0, y1);
  }
}

// A fragment of two values of one row: (hi x0, lo x0, hi x1, lo x1), the
// order of a0..a3 (rows r and r + 8, columns t and t + 4).
__device__ __forceinline__ uint4 hilo(float x0, float x1) {
  uint4 a;
  split(__float_as_uint(x0), a.x, a.y);
  split(__float_as_uint(x1), a.z, a.w);
  return a;
}

__device__ __forceinline__ bool live(const Params& p, int pm, int i) {
  if (i >= p.s) return false;
  const int j = p.s0 + i;                            // the whole cache's slot
  const int r = j <= pm ? pm - j : pm - j + p.s_all;   // steps back from pos
  return r <= p.pos && (p.window <= 0 || r < p.window);
}

// The normalised output and, in the partial form, the log-sum-exp (natural
// log) of query row r of (b, KV head) bh from its merged state: running max
// top (log2 domain), sum `sum` and accumulator `a` at column d.
__device__ __forceinline__ void finish(const Params& p, int bh, int r, int d,
                                       float top, float sum, float a) {
  const long long row = static_cast<long long>(bh) * p.g + r;
  p.out[row * p.d + d] = sum == 0.0f ? 0.0f : a / sum;
  if (p.lse != nullptr && d == 0)
    p.lse[row] = sum == 0.0f ? -INFINITY
                             : (top + log2f(sum)) * 0.6931471805599453f;
}

// The factor that brings a state of running max m (log2 domain) to the
// common max top: 0 for a state that saw no slot.
__device__ __forceinline__ float rescale(float m, float top) {
  return m == -INFINITY ? 0.0f : exp2f(m - top);
}

template <typename T>
__device__ __forceinline__ void copy_elem(unsigned char* dst,
                                          const unsigned char* src, bool on) {
  constexpr int SZ = Bytes<T>::n;
  if constexpr (SZ == 4)
    *reinterpret_cast<unsigned*>(dst) =
        on ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
  else if constexpr (SZ == 2)
    *reinterpret_cast<unsigned short*>(dst) =
        on ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
  else
    *dst = on ? __ldg(src) : 0;
}

// Warp-wide: stage the K and V rows of slots [i0, i0 + TS) of one (b, KV
// head) (kg / vg its rows' base) into ks / vs, dead slots and padding as
// zeros.  vec: 16-byte cp.async (rows of a multiple of 16 bytes, aligned
// cache); else element by element.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(const Params& p,
                                           const unsigned char* kg,
                                           const unsigned char* vg,
                                           unsigned char* ks,
                                           unsigned char* vs, int i0, int pm,
                                           int lane, bool vec) {
  using G = Geo<T, DP>;
  const int rowb = p.d * G::SZ;
  if (vec) {
    const int nchr = rowb >> 4;
#pragma unroll
    for (int j = 0; j < (G::TS * G::NCH + 31) / 32; ++j) {
      const int c = lane + 32 * j;
      if (G::TS * G::NCH % 32 != 0 && c >= G::TS * G::NCH) break;
      const int row = c / G::NCH, ch = c % G::NCH;
      const bool on = ch < nchr && live(p, pm, i0 + row);
      const long long off =
          on ? static_cast<long long>(i0 + row) * rowb + 16 * ch : 0;
      const int so = row * G::ROWB + (phys<G::SWZ>(row, ch) << 4);
      cp_async16(ks + so, kg + off, on ? 16 : 0);
      cp_async16(vs + so, vg + off, on ? 16 : 0);
    }
  } else {
    for (int e = lane; e < G::TS * DP; e += 32) {
      const int row = e / DP, col = e % DP;
      const bool on = col < p.d && live(p, pm, i0 + row);
      const long long off =
          on ? (static_cast<long long>(i0 + row) * p.d + col) * G::SZ : 0;
      const int so = soff<G>(row, col * G::SZ);
      copy_elem<T>(ks + so, kg + off, on);
      copy_elem<T>(vs + so, vg + off, on);
    }
  }
}

// q's A fragment of k step j for this lane: rows lane / 4 (hi) and + 8
// (lo) at the two D indices the score reads give k columns t, t + 4.
template <typename G>
__device__ __forceinline__ uint4 qfrag(const Params& p, const float* qb,
                                       int j, int lane) {
  const int r = lane >> 2, t = lane & 3;
  const int u = j / (G::LK / 2), e2 = j % (G::LK / 2);
  const int d0 = G::LK * (t + 4 * u) + 2 * e2;
  const bool row = r < p.g;
  const float x0 = row && d0 < p.d ? qb[r * p.d + d0] * p.qscale : 0.0f;
  const float x1 = row && d0 + 1 < p.d ? qb[r * p.d + d0 + 1] * p.qscale
                                       : 0.0f;
  return hilo(x0, x1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * WARPS_MAX)
decode_attention_kernel(Params p) {
  using G = Geo<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, rank = blockIdx.x, nc = p.cluster;
  const int nw = p.warps, threads = 32 * nw;
  const int ntiles = (p.s + G::TS - 1) / G::TS;
  const int t_lo = static_cast<int>(static_cast<long long>(rank) * ntiles / nc);
  const int t_hi =
      static_cast<int>(static_cast<long long>(rank + 1) * ntiles / nc);
  const int mine = t_hi - t_lo > warp ? (t_hi - t_lo - warp + nw - 1) / nw
                                      : 0;
  const long long head = static_cast<long long>(bh) * p.s * p.d * G::SZ;
  const unsigned char* kg = static_cast<const unsigned char*>(p.k) + head;
  const unsigned char* vg = static_cast<const unsigned char*>(p.v) + head;
  const bool vec = (p.d * G::SZ) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.v) & 15) == 0;
  const int pm = p.pos % p.s_all;               // the slot pos writes
  unsigned char* ring = smem + warp * STAGES * G::STAGEB;

  auto issue = [&](int k) {
    if (k < mine) {
      unsigned char* st = ring + (k % STAGES) * G::STAGEB;
      stage_tile<T, DP>(p, kg, vg, st, st + G::TILEB,
                        (t_lo + warp + k * nw) * G::TS, pm, lane, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);

  // q's fragments, pre-scaled to the log2 domain
  const float* qb = p.q + static_cast<long long>(bh) * p.g * p.d;
  uint4 qr[G::QREG ? G::KSTEPS : 1];
  uint4* qs = reinterpret_cast<uint4*>(smem + G::area(nw) + G::STATE);
  if constexpr (G::QREG) {
#pragma unroll
    for (int j = 0; j < G::KSTEPS; ++j) qr[j] = qfrag<G>(p, qb, j, lane);
  } else {
    for (int i = threadIdx.x; i < G::KSTEPS * 32; i += threads)
      qs[i] = qfrag<G>(p, qb, i >> 5, i & 31);
    __syncthreads();
  }

  float m = -INFINITY, l = 0.0f;
  float run[G::UV][G::LV][2];
#pragma unroll
  for (int w = 0; w < G::UV; ++w)
#pragma unroll
    for (int e = 0; e < G::LV; ++e) run[w][e][0] = run[w][e][1] = 0.0f;

  for (int k = 0; k < mine; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    const unsigned char* ks = ring + (k % STAGES) * G::STAGEB;
    const unsigned char* vs = ks + G::TILEB;
    const int i0 = (t_lo + warp + k * nw) * G::TS;
    bool lv[G::NG][2];
    bool any = false;
#pragma unroll
    for (int gi = 0; gi < G::NG; ++gi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lv[gi][h] = live(p, pm, i0 + 8 * gi + 2 * t + h);
        any = any || lv[gi][h];
      }
    if (__any_sync(full, any)) {
      // the scores of query row n (= lane / 4) at slots 8 gi + 2t and + 1,
      // from K row 8 gi + n as B's column n
      float sc[G::NG][2];
#pragma unroll
      for (int gi = 0; gi < G::NG; ++gi) {
        const int row = 8 * gi + n;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int u = 0; u < G::UK; ++u) {
          unsigned kw[G::LK * G::SZ / 4], kf[G::LK];
          lds<G::LK * G::SZ>(ks + soff<G>(row, G::LK * (t + 4 * u) * G::SZ),
                             kw);
          widen<T, G::LK>(kw, kf);
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int e2 = 0; e2 < G::LK / 2; ++e2) {
            const int j = u * (G::LK / 2) + e2;
            uint4 a;
            if constexpr (G::QREG) a = qr[j];
            else a = qs[j * 32 + lane];
            mma_y<G::SPLIT>(c, a, kf[2 * e2], kf[2 * e2 + 1]);
          }
          s0 += c[0] + c[2];
          s1 += c[1] + c[3];
        }
        sc[gi][0] = s0;
        sc[gi][1] = s1;
      }
      // the tile's softmax for row lane / 4: its max over the row's 4 lanes
      float mx = -INFINITY;
#pragma unroll
      for (int gi = 0; gi < G::NG; ++gi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (lv[gi][h]) mx = fmaxf(mx, sc[gi][h]);
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 2));
      const float top = fmaxf(m, mx);
      const float alpha = rescale(m, top);
      uint4 pa[G::NG];
      float psum = 0.0f;
#pragma unroll
      for (int gi = 0; gi < G::NG; ++gi) {
        const float p0 = lv[gi][0] ? exp2f(sc[gi][0] - top) : 0.0f;
        const float p1 = lv[gi][1] ? exp2f(sc[gi][1] - top) : 0.0f;
        psum += p0 + p1;
        pa[gi] = hilo(p0, p1);
      }
      l = fmaf(l, alpha, psum);
      m = top;
      // P V: V rows 8 gi + 2t and + 1, columns LV (n + 8 w) + e
#pragma unroll
      for (int w = 0; w < G::UV; ++w) {
        float acc[G::LV][4];
#pragma unroll
        for (int e = 0; e < G::LV; ++e)
          acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.0f;
#pragma unroll
        for (int gi = 0; gi < G::NG; ++gi) {
          const int r0 = 8 * gi + 2 * t;
          const int byte = G::LV * (n + 8 * w) * G::SZ;
          unsigned w0[G::LV * G::SZ / 4], w1[G::LV * G::SZ / 4];
          unsigned v0[G::LV], v1[G::LV];
          lds<G::LV * G::SZ>(vs + soff<G>(r0, byte), w0);
          lds<G::LV * G::SZ>(vs + soff<G>(r0 + 1, byte), w1);
          widen<T, G::LV>(w0, v0);
          widen<T, G::LV>(w1, v1);
#pragma unroll
          for (int e = 0; e < G::LV; ++e)
            mma_y<G::SPLIT>(acc[e], pa[gi], v0[e], v1[e]);
        }
#pragma unroll
        for (int e = 0; e < G::LV; ++e) {
          run[w][e][0] = fmaf(run[w][e][0], alpha, acc[e][0] + acc[e][2]);
          run[w][e][1] = fmaf(run[w][e][1], alpha, acc[e][1] + acc[e][3]);
        }
      }
    }
    __syncwarp();
    issue(k + STAGES - 1);
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(full, l, 1);
  l += __shfl_xor_sync(full, l, 2);
  __syncthreads();                       // every ring is drained

  // the warps' states, merged in warp order
  float* mml = reinterpret_cast<float*>(smem);          // [nw][G_MAX][2]
  float* macc = mml + nw * G_MAX * 2;                   // [nw][G_MAX][DP]
  float* sml = reinterpret_cast<float*>(smem + G::area(nw));   // [G_MAX][2]
  float* sacc = sml + G_MAX * 2;                           // [G_MAX][DP]
  if (n < p.g) {
    if (t == 0) {
      mml[(warp * G_MAX + n) * 2] = m;
      mml[(warp * G_MAX + n) * 2 + 1] = l;
    }
#pragma unroll
    for (int w = 0; w < G::UV; ++w)
#pragma unroll
      for (int e = 0; e < G::LV; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = G::LV * (2 * t + h + 8 * w) + e;
          if (d < p.d) macc[(warp * G_MAX + n) * DP + d] = run[w][e][h];
        }
  }
  __syncthreads();
  const int gd = p.g * p.d;
  for (int i = threadIdx.x; i < gd; i += threads) {
    const int r = i / p.d, d = i % p.d;
    float top = -INFINITY;
    for (int w = 0; w < nw; ++w)
      top = fmaxf(top, mml[(w * G_MAX + r) * 2]);
    float sum = 0.0f, a = 0.0f;
    for (int w = 0; w < nw; ++w) {
      const float c = rescale(mml[(w * G_MAX + r) * 2], top);
      sum = fmaf(mml[(w * G_MAX + r) * 2 + 1], c, sum);
      a = fmaf(macc[(w * G_MAX + r) * DP + d], c, a);
    }
    if (nc == 1) {
      finish(p, bh, r, d, top, sum, a);
    } else {
      sacc[r * DP + d] = a;
      if (d == 0) {
        sml[r * 2] = top;
        sml[r * 2 + 1] = sum;
      }
    }
  }
  if (nc == 1) return;

  // the cluster's CTAs, merged in rank order through distributed shared
  // memory; CTA `rank` finishes outputs rank * threads + tid, + nc threads
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = rank * threads + threadIdx.x; i < gd; i += nc * threads) {
    const int r = i / p.d, d = i % p.d;
    float top = -INFINITY;
    for (int c = 0; c < nc; ++c)
      top = fmaxf(top, cluster.map_shared_rank(sml, c)[r * 2]);
    float sum = 0.0f, a = 0.0f;
    for (int c = 0; c < nc; ++c) {
      const float* o = cluster.map_shared_rank(sml, c);
      const float f = rescale(o[r * 2], top);
      sum = fmaf(o[r * 2 + 1], f, sum);
      a = fmaf(o[G_MAX * 2 + r * DP + d], f, a);
    }
    finish(p, bh, r, d, top, sum, a);
  }
  cluster.sync();           // no CTA leaves while another reads its state
}

template <typename T, int DP>
cudaError_t prepare(int warps, void (*&kern)(Params), int& smem) {
  using G = Geo<T, DP>;
  kern = decode_attention_kernel<T, DP>;
  smem = G::smem(warps);
  // room for the largest CTA that fits (8 warps where the rings allow)
  constexpr int most = G::smem(WARPS_MAX) <= SMEM_MAX ? G::smem(WARPS_MAX)
                                                      : G::smem(WARPS_MIN);
  if (smem > most) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T>
cudaError_t by_width(int d, int warps, void (*&kern)(Params), int& smem) {
  if (d <= 32) return prepare<T, 32>(warps, kern, smem);
  if (d <= 64) return prepare<T, 64>(warps, kern, smem);
  if (d <= 128) return prepare<T, 128>(warps, kern, smem);
  return prepare<T, 256>(warps, kern, smem);
}

cudaError_t instance(int dtype, int d, int warps, void (*&kern)(Params),
                     int& smem) {
  if (d < 1 || d > D_MAX || (warps != WARPS_MIN && warps != WARPS_MAX))
    return cudaErrorInvalidValue;
  if (dtype == 0) return by_width<float>(d, warps, kern, smem);
  if (dtype == 1) return by_width<__nv_bfloat16>(d, warps, kern, smem);
  if (dtype == 2) return by_width<Fp8>(d, warps, kern, smem);
  return cudaErrorInvalidValue;
}

cudaLaunchConfig_t config(int cluster, int n_bh, int warps, int smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_bh);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

}  // namespace

// The CTAs of `warps` warps (4 or 8) of the instance for (dtype, d) one
// SM holds at once, by their registers and shared memory, into
// *ctas_per_sm (0: a CTA that size does not fit), and for each cluster
// size 2, 4, 8 and 16 the clusters the card holds at once (0: a size it
// cannot launch) into clusters[0..3].  Returns the queries' cudaError_t.
extern "C" int decode_attention_limits(int dtype, int d, int warps,
                                       int* ctas_per_sm, int* clusters) {
  void (*kern)(Params) = nullptr;
  int smem = 0;
  *ctas_per_sm = 0;
  for (int i = 0; i < 4; ++i) clusters[i] = 0;
  cudaError_t err = instance(dtype, d, warps, kern, smem);
  if (err == cudaErrorInvalidValue && d >= 1 && d <= D_MAX &&
      (warps == WARPS_MIN || warps == WARPS_MAX))
    return static_cast<int>(cudaSuccess);     // too big: holds none
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern,
                                                      32 * warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0, c = 2; c <= CLUSTER_MAX; ++i, c <<= 1) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(c, 1, warps, smem, nullptr, attr);
    if (cudaOccupancyMaxActiveClusters(&clusters[i], kern, &cfg) !=
        cudaSuccess) {
      clusters[i] = 0;
      cudaGetLastError();    // a size the card refuses is not an error here
    }
  }
  return static_cast<int>(cudaSuccess);
}

namespace {

int launch(int dtype, const float* q, const void* k, const void* v,
           float* out, float* lse, int batch, int hkv, int g, int d, int s,
           int s0, int s_all, int pos, int window, int cluster, int warps,
           float scale, void* stream) {
  if (batch < 1 || hkv < 1 || g < 1 || g > G_MAX || d < 1 || d > D_MAX ||
      s < 1 || s0 < 0 || s_all < s0 + s || pos < 0 || cluster < 1 ||
      cluster > CLUSTER_MAX || (cluster & (cluster - 1)) != 0 ||
      batch * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(Params) = nullptr;
  int smem = 0;
  cudaError_t err = instance(dtype, d, warps, kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{q, k, v, out, lse, batch * hkv, g, d, s, pos, window, cluster,
           warps, s0, s_all, LOG2E * scale};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(cluster, batch * hkv, warps, smem,
                                  static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 float8_e4m3fn (the cache's; q and out are
// fp32).  window <= 0: a global layer.  cluster: CTAs a (b, KV head), 1
// to 16, a power of two; warps: a CTA's, 4 or 8.  scale: 1 / sqrt(D).
// Returns the launch's cudaError_t (a cluster or CTA the card cannot hold
// fails to launch).
extern "C" int decode_attention(int dtype, const float* q, const void* k,
                                const void* v, float* out, int batch,
                                int hkv, int g, int d, int s, int pos,
                                int window, int cluster, int warps,
                                float scale, void* stream) {
  return launch(dtype, q, k, v, out, nullptr, batch, hkv, g, d, s, 0, s,
                pos, window, cluster, warps, scale, stream);
}

// The partial form: k / v hold slots s0 .. s0 + s - 1 of a cache of s_all
// slots; lse (B, Hkv * g) fp32 receives each row's log-sum-exp.
extern "C" int decode_attention_partial(int dtype, const float* q,
                                        const void* k, const void* v,
                                        float* out, float* lse, int batch,
                                        int hkv, int g, int d, int s, int s0,
                                        int s_all, int pos, int window,
                                        int cluster, int warps, float scale,
                                        void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, q, k, v, out, lse, batch, hkv, g, d, s, s0, s_all,
                pos, window, cluster, warps, scale, stream);
}
