// K4b `flash_attention_bwd`: the gradient of K4's online-softmax attention
// for q / dq (B, Hq, Tq, D), k / v / dk / dv (B, Hkv, Tk, D), D <= 256, fp32
// or bf16 storage, with K4's masks letter for letter: causal
// (kpos <= qpos), sliding window (qpos - kpos < window), keys at or past the
// true Tk, and GQA (query head h reads KV head h * Hkv / Hq in place).
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
// 7 D multiply-adds: S and dP twice (once for dK / dV, once for dQ), dV,
// dK and dQ once.  On the CUDA cores (67 TFLOP/s fp32) that is ~6x the
// bytes' time at the training shape.  So every product runs on the tensor
// cores, as `mma.sync.m16n8k8` TF32 with the 3xTF32 split: each fp32
// operand x is cut into hi = x with its low 13 bits cleared (a TF32 value)
// and lo = x - hi (exact in fp32; the tensor core reads its top 19 bits),
// and a product is hi*hi + lo*hi + hi*lo in fp32 (lo*lo, ~2^-20 of the
// product, is dropped).  That keeps each product within ~2^-20 relative
// of fp32's, where one TF32 product would keep ~2^-11: the 3xTF32 sum
// holds fp32's tolerance (5e-5 x max |grad|), one TF32 product would not.
// bf16 inputs widen exactly into TF32, so their lo parts are 0 and those
// products are skipped (S and dP take one product, dV / dK / dQ two: P
// and dS are fp32 values and keep their split).  The tensor core does not
// round its accumulator to nearest: a sum kept in one accumulator drifts
// toward zero by ~2^-23 of the sum a product, ~1e-5 over dV's 512 k steps
// (4 heads x 1024 rows), which a model's gradient norm shows.  So no
// accumulator runs longer than 12 products: each 32 columns of S and dP,
// and each 16-row step of dV, dK and dQ, start from zero and are added to
// the fp32 total by an fp32 add (a lean of ~1e-6 is left).
//
// Design: three kernels on the caller's stream, one call, no atomics.
//   * delta: one warp per query row, rowsum(dO * O) in fp32 (4-wide loads
//     where D, strides and pointers allow).
//   * main: one launch of two kinds of block, interleaved heavy-first in
//     block order so that the light blocks of both fill the wave's tail.
//     Both kinds keep a resident tile of 64 rows of two operands in shared
//     memory and stream 16-row tiles of the other two through a ring of
//     two stages filled by 16-byte cp.async (zero fill past T and D):
//       dK / dV block, per (64-key tile, query head, batch): K and V stay,
//         Q and dO stream over the tile's live query rows;
//       dQ block, per (64-row query tile, query head, batch): Q, dO, L and
//         delta stay, K and V stream over the tile's live keys.
//     8 warps in 4 pairs; pair p owns 16 of the 64 resident rows.  Warp A
//     of a pair computes the scores (S^T for dK / dV, S for dQ) and P;
//     warp B computes dP and, from A's P, dS.  P (and for dQ, dS back)
//     goes between the two through a 1 KB slot of shared memory in the
//     fragment's own register order, behind a 64-thread named barrier.
//     The score fragment (C layout: rows g, g + 8, columns 2t, 2t + 1 of
//     each 8-column block) is the next product's A operand as it stands:
//     its k index t is taken to be column 2t and t + 4 column 2t + 1, and
//     the B operand is read from shared memory in the same order.  So:
//       dK / dV: A: S^T, P^T, dV += P^T dO (16 x D in registers);
//                B: dP^T, dS^T, dK += dS^T Q.  2 D products each a pair.
//       dQ:      A: S, P, then dQ[:, :D/2] += dS K;
//                B: dP, dS, then dQ[:, D/2:] += dS K.  1.5 D each.
//     A and B run one copy of the products' code on selected operands, and
//     the fully unrolled k loops run over all of D_MAX (zeros past D) with
//     no branch: the hot code of a block then fits the instruction cache,
//     and the compiler can schedule the loads of one step under the
//     products of the one before.  A pair whose 16 rows see no live entry
//     of a streamed tile skips it.
//     The dK / dV block of query head h writes its fp32 partial dK and dV
//     (B, Hq, Tk, D) when Hq > Hkv; with Hq == Hkv it writes dK and dV.
//   * reduce (Hq > Hkv only): one thread per 4 elements of dK and dV (per
//     element when D % 4 != 0) adds the group's heads' partials in head
//     order.
// Every sum runs in a fixed order (k steps, tiles, heads), with no
// atomics, so two calls on the same inputs give bitwise-equal dQ, dK, dV.
// At the training shape (4, 4, 1024, 256), Hkv 1, causal, the grid is 256
// dK / dV and 256 dQ blocks of 4 to 64 streamed tiles each, one block an
// SM, heaviest first: the heaviest is ~1.9x the mean, and the light ones
// of both kinds fill the tail (with a launch per kind, the local layer's
// blocks of at most 36 tiles would run in two uneven waves).
//
// Shared memory, fp32, row stride D_MAX with no pad: the column of a row r
// is XORed with ((r & 6) << 2) | ((r & 1) << 2), which keeps 16-byte chunks
// whole and makes both read patterns conflict-free: ldmatrix rows (8 rows,
// one 16-byte chunk each) and the transposed B loads (row 2t or 2t + 1,
// column g).  At D_MAX = 256: two resident 64-row tiles (128 KB), two
// stages of two 16-row tiles (64 KB), two 4 x 1 KB exchange slots, 64 L and
// 64 delta: 205,568 B of the 232,448 an H100 block may take; one block of
// 256 threads per SM (up to 255 registers a thread: a warp's 16 x 256
// accumulator is 128 of them).  At D_MAX = 128: 102,784 B.  Ragged Tq, Tk
// and D are masked in the kernel (zeros staged past them, no row past Tq or
// Tk written).  bf16 is widened to fp32 on load (plain loads, not
// cp.async) and dQ, dK, dV are rounded to bf16 once on store; L, delta and
// the partials stay fp32.  When D, a stride or a pointer is not a multiple
// of 4 elements, the staging loads element by element.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BR = 64;                 // resident rows per block
constexpr int BS = 16;                 // streamed rows per step
constexpr int PAIRS = 4;
constexpr int WARPS = 2 * PAIRS;       // 8
constexpr int THREADS = 32 * WARPS;    // 256
constexpr int XF = 256;                // floats of one pair's exchange slot

// How tiles reach shared memory: cp.async (fp32, 16-byte aligned rows),
// 4-wide plain loads (bf16, aligned) or element by element.
enum Mode { ASYNC = 0, VEC = 1, SCALAR = 2 };

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
  float* part_k;                       // (B, Hq, Tk, D) fp32 when Hq > Hkv
  float* part_v;                       //   (else null)
  int batch, hq, hkv, tq, tk, d;
  int ntq, ntk;                        // 64-row tiles of Tq and of Tk
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
  return (2 * BR + 4 * BS) * DMAX + 2 * PAIRS * XF + 2 * BR;
}
// an H100 block may take at most 232,448 bytes of shared memory
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

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The two warps of pair p (warps p and p + PAIRS) meet; barrier 0 is
// __syncthreads.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(pair + 1), "r"(64) : "memory");
}

// The swizzle of row r: XORed into bits 2..4 of the column.
__device__ __forceinline__ int swz(int r) {
  return ((r & 6) << 2) | ((r & 1) << 2);
}

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

// Rows [lo, lo + ROWS) of a (T, D) head into a swizzled ROWS x DMAX tile,
// zeros past t and past d.  The plain-load modes issue all of a thread's
// loads before its first store.
template <typename T, int DMAX, int ROWS, int MODE>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int lo, int t, int d) {
  constexpr int C4 = DMAX / 4;
  constexpr int PER = ROWS * C4 / THREADS;
  static_assert(ROWS * C4 % THREADS == 0, "stage: uneven split");
  if constexpr (MODE == ASYNC) {
    static_assert(sizeof(T) == 4, "cp.async stages fp32 only");
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / C4, c = (i - r * C4) * 4;
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
      *reinterpret_cast<float4*>(dst + r * DMAX + (c ^ swz(r))) = buf[u];
    }
  }
}

// n fp32 values [lo, lo + n) of a length-t row (zeros past t).
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int lo, int n, int t) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool in = lo + i < t;
    cp_async4(dst + i, in ? src + lo + i : src, in ? 4 : 0);
  }
}

// c (16 x 16) = rows [xr, xr + 16) of tile X times rows [0, 16) of tile Y,
// transposed, over all DMAX columns (zeros past d): c[nb] is the C fragment
// of columns 8 nb .. 8 nb + 7 (lane (g, t) = (lane / 4, lane % 4): rows g
// and g + 8, columns 2 t and 2 t + 1).  The tensor core adds into its
// accumulator without rounding to nearest, so a long chain of products in
// one accumulator drifts toward zero (~2^-23 of the sum a product): the
// products of each 32 columns start from zero and their sum is added to
// the total by an fp32 add.
template <int DMAX, bool SPLIT>
__device__ __forceinline__ void scores16(float (&c)[2][4], const float* X,
                                         int xr, const float* Y, int lane) {
  const int j = lane >> 3, r = lane & 7;
  const int ra = xr + r + 8 * (j & 1);      // A: rows 0-7 / 8-15, k 0-3 / 4-7
  const int rb = r + 8 * (j >> 1);          // B: n 0-7 / 8-15, k 0-3 / 4-7
  const float* pa = X + ra * DMAX;
  const float* pb = Y + rb * DMAX;
  int oa[4], ob[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    oa[m] = (8 * m + 4 * (j >> 1)) ^ swz(ra);
    ob[m] = (8 * m + 4 * (j & 1)) ^ swz(rb);
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
  for (int k32 = 0; k32 < DMAX / 32; ++k32) {
    float part[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      unsigned a[4], b[4];
      ldsm4(a, pa + 32 * k32 + oa[m]);
      ldsm4(b, pb + 32 * k32 + ob[m]);
      if constexpr (SPLIT) {
        unsigned ah[4], al[4], bh[4], bl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(a[i], ah[i], al[i]);
          split(b[i], bh[i], bl[i]);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          mma(part[nb], al, bh[2 * nb], bh[2 * nb + 1]);
          mma(part[nb], ah, bl[2 * nb], bl[2 * nb + 1]);
          mma(part[nb], ah, bh[2 * nb], bh[2 * nb + 1]);
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          mma(part[nb], a, b[2 * nb], b[2 * nb + 1]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nb][e] += part[nb][e];
  }
}

// acc[n] += a (16 x 16, the C fragments of scores16) times rows [0, 16) of
// tile Y, columns 8 (nb0 + n) .. + 7.  The A fragment's k index t is column
// 2 t of a and t + 4 column 2 t + 1, so B's row of k index t is 2 t and of
// t + 4 is 2 t + 1.  a is fp32 (split); Y's values are split when SPLIT_Y.
// Each column block's products of the 16 rows start from zero and are
// added to acc by an fp32 add (see scores16): acc sums every streamed tile
// of the block, up to 4 heads x Tq rows.
template <int DMAX, int NB, bool SPLIT_Y>
__device__ __forceinline__ void accum16(float (&acc)[NB][4],
                                        const float (&a)[2][4],
                                        const float* Y, int nb0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  unsigned ah[2][4], al[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    split(__float_as_uint(a[ks][0]), ah[ks][0], al[ks][0]);
    split(__float_as_uint(a[ks][2]), ah[ks][1], al[ks][1]);
    split(__float_as_uint(a[ks][1]), ah[ks][2], al[ks][2]);
    split(__float_as_uint(a[ks][3]), ah[ks][3], al[ks][3]);
  }
  // B's rows 8 ks + 2 t and 8 ks + 2 t + 1: the swizzle of a row depends
  // on its index mod 8 only, so both k steps share the column offsets
  const float* y0 = Y + 2 * t * DMAX;
  const float* y1 = y0 + DMAX;
  int o0[4], o1[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    o0[m] = (8 * m + g) ^ swz(2 * t);
    o1[m] = (8 * m + g) ^ swz(2 * t + 1);
  }
  // nb0 is a multiple of 4: column block nb0 + n reads o0 / o1[n & 3]
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = 32 * ((nb0 + n) >> 2);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int row = 8 * ks * DMAX + col;
      const unsigned b0 = __float_as_uint(y0[row + o0[n & 3]]);
      const unsigned b1 = __float_as_uint(y1[row + o1[n & 3]]);
      if constexpr (SPLIT_Y) {
        unsigned b0h, b0l, b1h, b1l;
        split(b0, b0h, b0l);
        split(b1, b1h, b1l);
        mma(part, al[ks], b0h, b1h);
        mma(part, ah[ks], b0l, b1l);
        mma(part, ah[ks], b0h, b1h);
      } else {
        mma(part, al[ks], b0, b1);
        mma(part, ah[ks], b0, b1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// A pair's exchange slot: lane l's 8 values as two float4, conflict-free.
__device__ __forceinline__ void put8(float* slot, const float (&c)[2][4],
                                     int lane) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
    *reinterpret_cast<float4*>(slot + (nb * 32 + lane) * 4) =
        make_float4(c[nb][0], c[nb][1], c[nb][2], c[nb][3]);
}
__device__ __forceinline__ void get8(float (&c)[2][4], const float* slot,
                                     int lane) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    const float4 x =
        *reinterpret_cast<const float4*>(slot + (nb * 32 + lane) * 4);
    c[nb][0] = x.x;
    c[nb][1] = x.y;
    c[nb][2] = x.z;
    c[nb][3] = x.w;
  }
}

template <int DMAX>
struct Smem {
  float *r1, *r2, *ring, *xp, *xs, *rowl, *rowd;
  __device__ explicit Smem(float* base) {
    r1 = base;                           // resident 64 x DMAX
    r2 = r1 + BR * DMAX;
    ring = r2 + BR * DMAX;               // streamed 16 x DMAX, 2 x 2 stages
    xp = ring + 4 * BS * DMAX;           // P, a slot per pair
    xs = xp + PAIRS * XF;                // dS (dQ blocks)
    rowl = xs + PAIRS * XF;              // L: 64 resident or 2 x 16 rows
    rowd = rowl + BR;                    // delta, alike
  }
  // the two streamed tiles of stage buf
  __device__ float* s1(int buf) const { return ring + buf * 2 * BS * DMAX; }
  __device__ float* s2(int buf) const { return s1(buf) + BS * DMAX; }
};

// delta = rowsum(dO * O), one warp per row of the (B * Hq * Tq) rows: 4-wide
// loads when VEC (D, the strides of O and dO and their pointers multiples
// of 4 elements), else element by element.
template <typename T, bool VEC>
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
  if constexpr (VEC) {
    for (int c = 4 * lane; c < p.d; c += 128) {
      const float4 x = load4_aligned(g + c), y = load4_aligned(o + c);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  } else {
    for (int c = lane; c < p.d; c += 32)
      acc = fmaf(load_f(g + c), load_f(o + c), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// dK and dV of keys [64 tile, 64 tile + 64) from query head h of batch b.
template <typename T, int DMAX, int MODE>
__device__ __forceinline__ void dkdv_block(const Params& p,
                                           const Smem<DMAX>& sm, int tile,
                                           int h, int b) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NB = DMAX / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % PAIRS;
  const bool is_a = warp < PAIRS;
  const int g = lane >> 2, t = lane & 3;
  const int k_lo = tile * BR;
  const int kw = 16 * pair;                     // the pair's keys in the tile
  const int hk = static_cast<int>(static_cast<long long>(h) * p.hkv / p.hq);
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* gq = static_cast<const T*>(p.dout) + b * p.sg_b + h * p.sg_h;
  const long long rbase = (static_cast<long long>(b) * p.hq + h) * p.tq;

  // the live query rows of this key tile: [q_start, q_end)
  int q_start = p.causal ? k_lo : 0, q_end = p.tq;
  if (p.window > 0) q_end = min(q_end, k_lo + BR - 1 + p.window);
  q_start = (q_start / BS) * BS;
  const int nsteps = q_end > q_start ? (q_end - q_start + BS - 1) / BS : 0;

  if (nsteps > 0) {
    stage<T, DMAX, BR, MODE>(sm.r1, k, p.sk_t, k_lo, p.tk, p.d);
    stage<T, DMAX, BR, MODE>(sm.r2, v, p.sv_t, k_lo, p.tk, p.d);
    stage<T, DMAX, BS, MODE>(sm.s1(0), q, p.sq_t, q_start, p.tq, p.d);
    stage<T, DMAX, BS, MODE>(sm.s2(0), gq, p.sg_t, q_start, p.tq, p.d);
    stage_row(sm.rowl, p.lse + rbase, q_start, BS, p.tq);
    stage_row(sm.rowd, p.delta + rbase, q_start, BS, p.tq);
  }
  cp_async_commit();

  // acc[nb]: keys k_lo + kw + g (+ 8), columns 8 nb + 2 t (+ 1); dV in
  // warp A, dK (unscaled) in warp B
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    const int q_lo = q_start + step * BS;
    // stage `step` is in, and every warp is done with stage step - 1:
    // stage step + 1 goes into its buffer while this one is computed
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < nsteps) {
      const int nq = q_lo + BS;
      stage<T, DMAX, BS, MODE>(sm.s1(buf ^ 1), q, p.sq_t, nq, p.tq, p.d);
      stage<T, DMAX, BS, MODE>(sm.s2(buf ^ 1), gq, p.sg_t, nq, p.tq, p.d);
      stage_row(sm.rowl + (buf ^ 1) * BS, p.lse + rbase, nq, BS, p.tq);
      stage_row(sm.rowd + (buf ^ 1) * BS, p.delta + rbase, nq, BS, p.tq);
    }
    cp_async_commit();
    if (!any_live(p, q_lo, BS, k_lo + kw, 16)) continue;   // pair-uniform

    const float* sl = sm.rowl + buf * BS;
    const float* sd = sm.rowd + buf * BS;
    float* slot = sm.xp + pair * XF;
    // A: S^T = K Q^T, then P^T = exp(scale S^T - L) where live, dV += P^T dO;
    // B: dP^T = V dO^T, then dS^T = P^T (dP^T - delta), dK += dS^T Q.  One
    // copy of the products' code for both (selected operands), so that the
    // block's hot code stays small.
    float c[2][4];
    scores16<DMAX, SPLIT>(c, is_a ? sm.r1 : sm.r2, kw,
                          is_a ? sm.s1(buf) : sm.s2(buf), lane);
    if (is_a) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k_lo + kw + g + 8 * (e >> 1);
          const int qi = 8 * nb + 2 * t + (e & 1);
          c[nb][e] = live(p, q_lo + qi, key)
                         ? expf(c[nb][e] * p.scale - sl[qi])
                         : 0.f;
        }
      put8(slot, c, lane);
      pair_sync(pair);
    } else {
      pair_sync(pair);
      float pt[2][4];
      get8(pt, slot, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[nb][e] = pt[nb][e] * (c[nb][e] - sd[8 * nb + 2 * t + (e & 1)]);
    }
    accum16<DMAX, NB, SPLIT>(acc, c, is_a ? sm.s2(buf) : sm.s1(buf), 0,
                             lane);
  }
  cp_async_wait_all();

  // warp A writes dV, warp B dK: the fp32 partial of head h, or the
  // result when Hq == Hkv
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k_lo + kw + g + 8 * half;
    if (key >= p.tk) continue;
    if (p.part_k != nullptr) {
      float* out = (is_a ? p.part_v : p.part_k) +
                   ((static_cast<long long>(b) * p.hq + h) * p.tk + key) *
                       p.d;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nb + 2 * t + e;
          if (col < p.d) out[col] = acc[nb][2 * half + e];
        }
    } else {
      T* out = static_cast<T*>(is_a ? p.dv : p.dk) +
               ((static_cast<long long>(b) * p.hkv + hk) * p.tk + key) * p.d;
      const float f = is_a ? 1.f : p.scale;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nb + 2 * t + e;
          if (col < p.d) store_f(out + col, acc[nb][2 * half + e] * f);
        }
    }
  }
}

// dQ of query rows [64 tile, 64 tile + 64) of head h, batch b.
template <typename T, int DMAX, int MODE>
__device__ __forceinline__ void dq_block(const Params& p,
                                         const Smem<DMAX>& sm, int tile,
                                         int h, int b) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NH = DMAX / 16;                 // 8-column blocks a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % PAIRS;
  const bool is_a = warp < PAIRS;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = tile * BR;
  const int rw = 16 * pair;                     // the pair's rows in the tile
  const int hk = static_cast<int>(static_cast<long long>(h) * p.hkv / p.hq);
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* gq = static_cast<const T*>(p.dout) + b * p.sg_b + h * p.sg_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const long long rbase = (static_cast<long long>(b) * p.hq + h) * p.tq;

  // the live keys of this query tile, as in K4
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, q_lo + BR);
  if (p.window > 0) kv_lo = max(0, q_lo - (p.window - 1));
  kv_lo = (kv_lo / BS) * BS;
  const int nsteps = kv_hi > kv_lo ? (kv_hi - kv_lo + BS - 1) / BS : 0;

  if (nsteps > 0) {
    stage<T, DMAX, BR, MODE>(sm.r1, q, p.sq_t, q_lo, p.tq, p.d);
    stage<T, DMAX, BR, MODE>(sm.r2, gq, p.sg_t, q_lo, p.tq, p.d);
    stage_row(sm.rowl, p.lse + rbase, q_lo, BR, p.tq);
    stage_row(sm.rowd, p.delta + rbase, q_lo, BR, p.tq);
    stage<T, DMAX, BS, MODE>(sm.s1(0), k, p.sk_t, kv_lo, p.tk, p.d);
    stage<T, DMAX, BS, MODE>(sm.s2(0), v, p.sv_t, kv_lo, p.tk, p.d);
  }
  cp_async_commit();

  // acc[n]: rows q_lo + rw + g (+ 8), columns 8 (nb0 + n) + 2 t (+ 1),
  // warp A the first half of D, warp B the second
  const int nb0 = is_a ? 0 : NH;
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    const int k_lo = kv_lo + step * BS;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < nsteps) {
      stage<T, DMAX, BS, MODE>(sm.s1(buf ^ 1), k, p.sk_t, k_lo + BS, p.tk,
                               p.d);
      stage<T, DMAX, BS, MODE>(sm.s2(buf ^ 1), v, p.sv_t, k_lo + BS, p.tk,
                               p.d);
    }
    cp_async_commit();
    if (!any_live(p, q_lo + rw, 16, k_lo, BS)) continue;   // pair-uniform

    float* pslot = sm.xp + pair * XF;
    float* sslot = sm.xs + pair * XF;
    // A: S = Q K^T, P = exp(scale S - L) where live, to B; dS back from B.
    // B: dP = dO V^T, dS = P (dP - delta), to A.  Both: dQ += dS K, A the
    // first half of D, B the second.  One copy of the products' code.
    float c[2][4];
    scores16<DMAX, SPLIT>(c, is_a ? sm.r1 : sm.r2, rw,
                          is_a ? sm.s1(buf) : sm.s2(buf), lane);
    if (is_a) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = rw + g + 8 * (e >> 1);
          const int key = k_lo + 8 * nb + 2 * t + (e & 1);
          c[nb][e] = live(p, q_lo + ri, key)
                         ? expf(c[nb][e] * p.scale - sm.rowl[ri])
                         : 0.f;
        }
      put8(pslot, c, lane);
      pair_sync(pair);
      pair_sync(pair);
      get8(c, sslot, lane);
    } else {
      pair_sync(pair);
      float pr[2][4];
      get8(pr, pslot, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[nb][e] = pr[nb][e] * (c[nb][e] - sm.rowd[rw + g + 8 * (e >> 1)]);
      put8(sslot, c, lane);
      pair_sync(pair);
    }
    accum16<DMAX, NH, SPLIT>(acc, c, sm.s1(buf), nb0, lane);  // dQ
  }
  cp_async_wait_all();

  T* dq = static_cast<T*>(p.dq) + rbase * p.d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_lo + rw + g + 8 * half;
    if (row >= p.tq) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * (nb0 + n) + 2 * t + e;
        if (col < p.d)
          store_f(dq + static_cast<long long>(row) * p.d + col,
                  acc[n][2 * half + e] * p.scale);
      }
  }
}

// One launch, both kinds of block: blocks 2 i and 2 i + 1 are the i-th
// heaviest dK / dV and dQ blocks (the first key tiles and the last query
// tiles under a causal mask, of every head and batch), the rest of the
// longer kind after them, so that the light blocks of both fill the tail.
template <typename T, int DMAX, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Smem<DMAX> sm(reinterpret_cast<float*>(smem4));
  const int heads = p.hq * p.batch;
  const int n_kv = p.ntk * heads, n_q = p.ntq * heads;
  const int both = min(n_kv, n_q);
  const int bid = static_cast<int>(blockIdx.x);
  bool kv;
  int idx;
  if (bid < 2 * both) {
    kv = (bid & 1) == 0;
    idx = bid >> 1;
  } else {
    kv = n_kv > n_q;
    idx = bid - both;
  }
  const int order = idx / heads;
  const int h = (idx % heads) % p.hq, b = (idx % heads) / p.hq;
  if (kv)
    dkdv_block<T, DMAX, MODE>(p, sm, order, h, b);
  else
    dq_block<T, DMAX, MODE>(p, sm, p.ntq - 1 - order, h, b);
}

// dK = scale * sum of the group's partials, dV = their sum, heads in order;
// W consecutive elements a thread (4 when D is a multiple of 4, else 1).
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const Params p) {
  const int group = p.hq / p.hkv;
  const long long per_head = static_cast<long long>(p.tk) * p.d;
  const long long n = static_cast<long long>(p.batch) * p.hkv * per_head;
  for (long long i = (static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x) * W;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS * W) {
    const long long bh = i / per_head;          // b * Hkv + hk
    const long long src = bh * group * per_head + (i - bh * per_head);
    float sk[W], sv[W];
#pragma unroll
    for (int e = 0; e < W; ++e) sk[e] = sv[e] = 0.f;
    for (int j = 0; j < group; ++j) {
      float xk[W], xv[W];
      if constexpr (W == 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            p.part_k + src + j * per_head);
        const float4 c = *reinterpret_cast<const float4*>(
            p.part_v + src + j * per_head);
        xk[0] = a.x; xk[1] = a.y; xk[2] = a.z; xk[3] = a.w;
        xv[0] = c.x; xv[1] = c.y; xv[2] = c.z; xv[3] = c.w;
      } else {
        xk[0] = p.part_k[src + j * per_head];
        xv[0] = p.part_v[src + j * per_head];
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        sk[e] += xk[e];
        sv[e] += xv[e];
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      store_f(static_cast<T*>(p.dk) + i + e, sk[e] * p.scale);
      store_f(static_cast<T*>(p.dv) + i + e, sv[e]);
    }
  }
}

// The delta pre-pass's 4-wide loads: D, the strides of O and dO and their
// pointers multiples of four elements.
template <typename T>
bool delta_vec_ok(const Params& p) {
  const uintptr_t align = 4 * sizeof(T);
  return p.d % 4 == 0 && p.so_b % 4 == 0 && p.so_h % 4 == 0 &&
         p.so_t % 4 == 0 && p.sg_b % 4 == 0 && p.sg_h % 4 == 0 &&
         p.sg_t % 4 == 0 && reinterpret_cast<uintptr_t>(p.o) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.dout) % align == 0;
}

template <typename T, int DMAX, int MODE>
int launch(const Params& p, cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<T, DMAX, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.tq;
  const long long n_delta = (rows + WARPS - 1) / WARPS;
  const long long n_main =
      static_cast<long long>(p.ntk + p.ntq) * p.hq * p.batch;
  if (n_delta > 0x7fffffffLL || n_main > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (delta_vec_ok<T>(p))
    delta_kernel<T, true><<<static_cast<unsigned>(n_delta), THREADS, 0, s>>>(
        p);
  else
    delta_kernel<T, false><<<static_cast<unsigned>(n_delta), THREADS, 0, s>>>(
        p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<T, DMAX, MODE>
      <<<static_cast<unsigned>(n_main), THREADS, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.part_k == nullptr)
    return static_cast<int>(err);
  const int w = p.d % 4 == 0 ? 4 : 1;
  const long long n = static_cast<long long>(p.batch) * p.hkv * p.tk * p.d;
  const long long per_block = static_cast<long long>(THREADS) * w;
  const long long n_red = (n + per_block - 1) / per_block < 4096
                              ? (n + per_block - 1) / per_block
                              : 4096;
  if (w == 4)
    reduce_kernel<T, 4><<<static_cast<unsigned>(n_red), THREADS, 0, s>>>(p);
  else
    reduce_kernel<T, 1><<<static_cast<unsigned>(n_red), THREADS, 0, s>>>(p);
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

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, dout, dq, dk, dv alike; lse,
// delta and the partials fp32).  Strides are in elements; each input's last
// dimension is contiguous; dq, dk, dv, lse, delta and the partials are
// contiguous.  part_k / part_v: (B, Hq, Tk, D) fp32 scratch, required when
// Hq > Hkv, else null.  window <= 0 means no window.  Runs the delta
// pre-pass, the dK / dV and dQ blocks, and the partials' sum.  Returns the
// launches' cudaError_t.
extern "C" int flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* part_k, float* part_v, int batch, int hq, int hkv,
    int tq, int tk, int d,
    long long sq_b, long long sq_h, long long sq_t,
    long long sk_b, long long sk_h, long long sk_t,
    long long sv_b, long long sv_h, long long sv_t,
    long long so_b, long long so_h, long long so_t,
    long long sg_b, long long sg_h, long long sg_t,
    float scale, int causal, int window, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 1 ||
      d < 1 || d > 256 || ((hq > hkv) != (part_k != nullptr)) ||
      ((part_k == nullptr) != (part_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, part_k, part_v,
           batch, hq, hkv, tq, tk, d, (tq + BR - 1) / BR, (tk + BR - 1) / BR,
           sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b,
           so_h, so_t, sg_b, sg_h, sg_t, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vector_ok<float>(p) ? by_width<float, ASYNC>(p, s)
                               : by_width<float, SCALAR>(p, s);
  if (dtype == 1)
    return vector_ok<__nv_bfloat16>(p) ? by_width<__nv_bfloat16, VEC>(p, s)
                                       : by_width<__nv_bfloat16, SCALAR>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
