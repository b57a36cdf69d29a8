// K3b `rmsnorm_bwd`: the gradient of K3's RMSNorm over the rows of a
// (rows, d) matrix,
//   r  = rsqrt(mean(x^2) + eps)            (recomputed per row)
//   dx = r * (g * (1 + s) - x * r^2 * mean(g * (1 + s) * x))
//   ds = sum over rows of g * x * r
// in fp32, for x and g in fp32 or bf16 (dx in x's type, ds in scale's).
//
// The JAX package has no Pallas kernel for this: its training path takes
// the gradient of the plain jnp rms_norm (models/layers.py) by autodiff,
// and this computes what jax.grad of it computes.  The port's training
// forward runs every norm through K3 on the card (ln1, ln2, the final norm
// at d = 1152 for gemma3-1b; q_norm and k_norm over (B T H, 256) rows), so
// its gradient is this kernel.
//
// What bounds it on an H100: bytes.  It must read x and g and write dx
// (plus d-sized scale and ds), with ~10 operations per element, far below
// the ~20 fp32 operations per byte where arithmetic would bound it.  So the
// design reads each row once, as K3 forward does.
//
// Design: four variants of one entry point, chosen by the wrapper from
// shape and alignment before the launch (as K3's):
//   "warp"   d <= D_MAX, every row and pointer 16-byte aligned, d a multiple
//            of the vector width: two kernels.
//     * rows: as many blocks as the card holds at once (the wrapper asks
//       rmsnorm_bwd_blocks_per_sm), one wave; block i owns the contiguous
//       chunk of rows [i c, i c + c), warp w its rows i c + w, + 8, ... .
//       1 + scale is read once a block into shared memory.  For each row a
//       warp issues all of its 16-byte loads of x and g (NV vectors a lane;
//       NV a template parameter the wrapper picks from d) and, while two
//       rows fit in registers (d <= 1152 fp32), those of its next row
//       before it reduces this one.  It keeps the row in registers, sums
//       x^2 and g (1 + s) x by warp shuffles and writes dx: device memory
//       is read once and written once, on the evict-first cache path.  Each
//       lane also sums g x r of its own columns over the warp's rows in
//       registers; at the end the 8 warps add theirs in warp order through
//       shared memory and the block writes its partial row to an fp32
//       (chunks, d) scratch.
//     * ds: block (column strip of 32) of 32 x 32 threads; thread (ty, tx)
//       adds the partials of chunks ty, ty + 32, ... of its column in
//       order, and the 32 sums are added in order.  A programmatic
//       dependent launch: it waits on the rows kernel in the kernel, so its
//       launch overlaps that kernel's tail.
//   "block"  d > D_MAX, aligned, at most BLOCK_WARPS x 32 x BLOCK_NV vectors:
//            two kernels.
//     * rows: a row over the W warps of one block (W x 32 x NV >= the
//       row's vectors, NV <= BLOCK_NV 16-byte vectors a lane: thread i
//       holds vectors i, i + 32 W, ...); as many blocks as the card holds
//       at once, block i walking the contiguous rows [i c, i c + c) and
//       issuing the next row's loads before it reduces this one (where
//       two rows fit in its registers).  x and g are read once into
//       registers, 1 + scale once a block; the two row sums go by warp
//       shuffles and then over the block in warp order through shared
//       memory (one barrier a row); dx is written once, evict-first; each
//       thread sums g x r of its own columns over the block's rows in
//       registers and the block writes its partial row to the (chunks, d)
//       scratch.  No rinv scratch, no second read of x or g.
//     * ds: as for "warp".
//   "loop" (d past what "block" holds, aligned) and "scalar" (a row or
//   pointer not 16-byte aligned, or d not a multiple of the vector width):
//   three kernels.
//     * rows: one warp per row, two strided passes over it (16-byte or
//       single-element loads): the first sums x^2 and g (1 + s) x, the
//       second writes dx; the row's r goes to an fp32 (rows,) scratch.
//     * partial ds: block (column strip of 32, row chunk) of 32 x 8
//       threads; thread (ty, tx) sums g x r of column 32 strip + tx over
//       rows chunk_lo + ty, + 8, ... in order, and the 8 sums are added in
//       order into the (chunks, d) scratch (x and g read again).
//     * ds: as above.
// The C entry rmsnorm_bwd_ext differentiates rmsnorm_ext (a row split
// across ranks by columns, its mean square from the whole row's sum): it
// runs every variant's EXT instance, which takes r from that sum, writes dx
// with the statistic held and each row's gradient of the statistic
// (ext_stats).  The default entry runs the !EXT instances, whose code is
// the variants' without it; the blocks-an-SM query asks of those.
// Every sum runs in a fixed order, so two calls on the same inputs give
// bitwise-equal dx and ds.  At (4096, 1152) fp32 the "warp" variant moves
// 56.6 MB of x, g and dx and 1.2 MB of partials (132 chunks on an H100:
// one 256-thread block of ~200 registers a thread an SM).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STRIP = 32;             // columns per partial block
constexpr int D_MAX = 2048;           // largest d kept in registers
constexpr int BLOCK_NV = 8;           // "block": the most vectors a lane
constexpr int BLOCK_WARPS = 16;       // "block": the most warps a row
constexpr int VARIANT_WARP = 0, VARIANT_LOOP = 1, VARIANT_SCALAR = 2,
              VARIANT_BLOCK = 3;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as EPV floats (K3 forward's loads and stores).  The
// STREAM forms (the "warp" variant's rows, read or written once) take the
// evict-first cache path, so that they do not push out of L2 what the
// rest of the call still reads.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int EPV = 4;
  template <bool STREAM = false>
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 r = STREAM ? __ldcs(q) : __ldg(q);
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  template <bool STREAM = false>
  __device__ __forceinline__ static void store(float* p, const float* f) {
    const float4 r = make_float4(f[0], f[1], f[2], f[3]);
    if (STREAM) __stcs(reinterpret_cast<float4*>(p), r);
    else *reinterpret_cast<float4*>(p) = r;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int EPV = 8;
  template <bool STREAM = false>
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 r = STREAM ? __ldcs(q) : __ldg(q);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  template <bool STREAM = false>
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    const uint4 r = make_uint4(w[0], w[1], w[2], w[3]);
    if (STREAM) __stcs(reinterpret_cast<uint4*>(p), r);
    else *reinterpret_cast<uint4*>(p) = r;
  }
};

// 16 loaded bytes as EPV floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r,
                                                      float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row `row` of x and g into registers when row < hi: lane l takes the
// row's 16-byte vectors l, l + 32, ... (NV of them, zeros past the row).
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* x, long long ldx,
                                         const T* g, long long ldg, int row,
                                         int hi, int nvec, int lane,
                                         float (&xv)[NV][Vec<T>::EPV],
                                         float (&gv)[NV][Vec<T>::EPV]) {
  const T* xr = x + static_cast<long long>(row) * ldx;
  const T* gr = g + static_cast<long long>(row) * ldg;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (row < hi && c < nvec) {
      Vec<T>::template load<true>(xr + c * Vec<T>::EPV, xv[i]);
      Vec<T>::template load<true>(gr + c * Vec<T>::EPV, gv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < Vec<T>::EPV; ++e) xv[i][e] = gv[i][e] = 0.f;
    }
  }
}

// EPV floats of shared memory as float4s (16-byte aligned).
template <int EPV>
__device__ __forceinline__ void lds(const float* p, float (&f)[EPV]) {
#pragma unroll
  for (int j = 0; j < EPV / 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(p)[j];
    f[4 * j] = v.x;
    f[4 * j + 1] = v.y;
    f[4 * j + 2] = v.z;
    f[4 * j + 3] = v.w;
  }
}
template <int EPV>
__device__ __forceinline__ void sts(float* p, const float (&f)[EPV]) {
#pragma unroll
  for (int j = 0; j < EPV / 4; ++j)
    reinterpret_cast<float4*>(p)[j] =
        make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}

// The EXT instances (a row split across ranks by columns: x holds d of
// its d_all; rmsnorm_bwd_ext): r is the whole row's, from ssx[row] /
// d_all, and k is 0, so dx = r g (1 + s) is the gradient with the
// statistic held; the writer stores the statistic's own gradient from this
// block's columns, dss[row] = -r^3 t / (2 d_all) with t = sum g (1 + s) x,
// for the caller to sum across ranks.
__device__ __forceinline__ void ext_stats(float t, int row, float eps,
                                          const float* ssx, float* dss,
                                          int d_all, bool writer, float& r,
                                          float& k) {
  r = 1.0f / sqrtf(ssx[row] / static_cast<float>(d_all) + eps);
  k = 0.f;
  if (writer)
    dss[row] = -0.5f * (r * r * r) * (t / static_cast<float>(d_all));
}

// "warp": lane l holds the row's 16-byte vectors l, l + 32, ... (NV of
// them, the last ones masked when the row has fewer than 32 NV).  The next
// row is loaded before this one is reduced while the two fit in registers
// (NV * EPV <= 36: d <= 1152 fp32, d <= 1024 bf16).
template <typename T, int NV, bool EXT>
__global__ void __launch_bounds__(THREADS)
rows_warp(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
          long long ldg, const T* __restrict__ scale, T* __restrict__ dx,
          float* __restrict__ partial, int rows, int d, int chunk_rows,
          float eps, const float* __restrict__ ssx, float* __restrict__ dss,
          int d_all) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr bool PREFETCH = NV * EPV <= 36;
  __shared__ __align__(16) float s_w[D_MAX];      // 1 + scale
  __shared__ __align__(16) float s_part[D_MAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / EPV;
  const int lo = blockIdx.x * chunk_rows;
  const int hi = min(rows, lo + chunk_rows);
  float xv[NV][EPV], gv[NV][EPV];
  load_row<T, NV>(x, ldx, g, ldg, lo + warp, hi, nvec, lane, xv, gv);
  for (int c = threadIdx.x; c < nvec; c += THREADS) {
    float f[EPV];
    Vec<T>::load(scale + c * EPV, f);
#pragma unroll
    for (int e = 0; e < EPV; ++e) f[e] = 1.0f + f[e];
    sts<EPV>(s_w + c * EPV, f);
  }
  __syncthreads();

  float ds[NV][EPV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < EPV; ++e) ds[i][e] = 0.f;
  for (int row = lo + warp; row < hi; row += WARPS) {
    float xn[PREFETCH ? NV : 1][EPV], gn[PREFETCH ? NV : 1][EPV];
    if constexpr (PREFETCH)
      load_row<T, NV>(x, ldx, g, ldg, row + WARPS, hi, nvec, lane, xn, gn);
    float ss = 0.f, t = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float w[EPV];
        lds<EPV>(s_w + c * EPV, w);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          ss = fmaf(xv[i][e], xv[i][e], ss);
          t = fmaf(gv[i][e] * w[e], xv[i][e], t);
        }
      }
    }
    float r, k;
    if constexpr (!EXT) {
      // K3 forward's r: 1 / sqrtf(mean + eps) by IEEE sqrt and division
      r = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
      k = r * r * (warp_sum(t) / static_cast<float>(d));
    } else {
      ext_stats(warp_sum(t), row, eps, ssx, dss, d_all, lane == 0, r, k);
    }
    T* orow = dx + static_cast<long long>(row) * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        float w[EPV], y[EPV];
        lds<EPV>(s_w + c * EPV, w);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          y[e] = r * (gv[i][e] * w[e] - xv[i][e] * k);
          ds[i][e] = fmaf(gv[i][e] * xv[i][e], r, ds[i][e]);
        }
        Vec<T>::template store<true>(orow + c * EPV, y);
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          xv[i][e] = xn[i][e];
          gv[i][e] = gn[i][e];
        }
    } else {
      load_row<T, NV>(x, ldx, g, ldg, row + WARPS, hi, nvec, lane, xv, gv);
    }
  }

  // the warps' partials, added in warp order
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          float acc[EPV];
          if (w == 0) {
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[e] = ds[i][e];
          } else {
            lds<EPV>(s_part + c * EPV, acc);
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[e] += ds[i][e];
          }
          sts<EPV>(s_part + c * EPV, acc);
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += THREADS)
    partial[static_cast<long long>(blockIdx.x) * d + c] = s_part[c];
}

// "block": thread i of the W = blockDim.x / 32 warps holds the row's
// 16-byte vectors i + 32 W j (j < NV) of x and g as loaded (raw bits);
// block b walks rows [b c, b c + c).  The next row is loaded before this
// one is reduced, and 1 + scale kept in registers, while they fit in the
// 128 registers a thread has at 512 threads (NV <= 4 fp32, NV <= 3 bf16;
// past NV EPV = 16, 1 + scale is read again a row, from L1).
template <typename T, int NV, bool EXT>
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
rows_block(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
           long long ldg, const T* __restrict__ scale, T* __restrict__ dx,
           float* __restrict__ partial, int rows, int d, int chunk_rows,
           float eps, const float* __restrict__ ssx, float* __restrict__ dss,
           int d_all) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr bool PREFETCH = NV * (16 + 2 * EPV) <= 96;
  constexpr bool WREG = NV * EPV <= 16;
  __shared__ float part[2][2][BLOCK_WARPS];   // [row parity][sum][warp]
  const int nvec = d / EPV, stride = blockDim.x, warps = stride >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk_rows;
  const int hi = min(rows, lo + chunk_rows);
  auto load = [&](int row, uint4 (&xr)[NV], uint4 (&gr)[NV]) {
    const T* xp = x + static_cast<long long>(row) * ldx;
    const T* gp = g + static_cast<long long>(row) * ldg;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = threadIdx.x + stride * j;
      const bool on = row < hi && c < nvec;
      xr[j] = on ? __ldcs(reinterpret_cast<const uint4*>(xp + c * EPV))
                 : make_uint4(0u, 0u, 0u, 0u);
      gr[j] = on ? __ldcs(reinterpret_cast<const uint4*>(gp + c * EPV))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 xr[NV], gr[NV];
  load(lo, xr, gr);
  // 1 + scale of vector j (held, or read again)
  float wr[WREG ? NV : 1][EPV], ds[NV][EPV];
  auto weight = [&](int j, float (&w)[EPV]) {
    const int c = threadIdx.x + stride * j;
    if (c < nvec) {
      Vec<T>::load(scale + c * EPV, w);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) w[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPV; ++e) w[e] = 1.0f + w[e];
  };
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if constexpr (WREG) weight(j, wr[j]);
#pragma unroll
    for (int e = 0; e < EPV; ++e) ds[j][e] = 0.f;
  }
  for (int row = lo; row < hi; ++row) {
    uint4 xn[PREFETCH ? NV : 1], gn[PREFETCH ? NV : 1];
    if constexpr (PREFETCH) load(row + 1, xn, gn);
    float ss = 0.f, t = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float xv[EPV], gv[EPV], w[EPV];
      unpack<T>(xr[j], xv);
      unpack<T>(gr[j], gv);
      if constexpr (WREG) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) w[e] = wr[j][e];
      } else {
        weight(j, w);
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        t = fmaf(gv[e] * w[e], xv[e], t);
      }
    }
    ss = warp_sum(ss);
    t = warp_sum(t);
    if (lane == 0) {
      part[row & 1][0][warp] = ss;
      part[row & 1][1][warp] = t;
    }
    __syncthreads();
    float s_all = 0.f, t_all = 0.f;
    for (int i = 0; i < warps; ++i) {
      s_all += part[row & 1][0][i];
      t_all += part[row & 1][1][i];
    }
    float r, k;
    if constexpr (!EXT) {
      // K3 forward's r: 1 / sqrtf(mean + eps) by IEEE sqrt and division
      r = 1.0f / sqrtf(s_all / static_cast<float>(d) + eps);
      k = r * r * (t_all / static_cast<float>(d));
    } else {
      ext_stats(t_all, row, eps, ssx, dss, d_all, threadIdx.x == 0, r, k);
    }
    T* orow = dx + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = threadIdx.x + stride * j;
      if (c < nvec) {
        float xv[EPV], gv[EPV], w[EPV], y[EPV];
        unpack<T>(xr[j], xv);
        unpack<T>(gr[j], gv);
        if constexpr (WREG) {
#pragma unroll
          for (int e = 0; e < EPV; ++e) w[e] = wr[j][e];
        } else {
          weight(j, w);
        }
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          y[e] = r * (gv[e] * w[e] - xv[e] * k);
          ds[j][e] = fmaf(gv[e] * xv[e], r, ds[j][e]);
        }
        Vec<T>::template store<true>(orow + c * EPV, y);
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        xr[j] = xn[j];
        gr[j] = gn[j];
      }
    } else {
      load(row + 1, xr, gr);
    }
  }
  float* prow = partial + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = threadIdx.x + stride * j;
    if (c < nvec) sts<EPV>(prow + c * EPV, ds[j]);
  }
}

// W elements at p (16 bytes when VEC, else one).
template <typename T, bool VEC>
__device__ __forceinline__ void load_w(const T* p, float* f) {
  if constexpr (VEC) Vec<T>::load(p, f);
  else f[0] = load_f(p);
}

// "loop" (VEC) and "scalar" (!VEC): two strided passes of one warp over
// its row; r to the rinv scratch.
template <typename T, bool VEC, bool EXT>
__global__ void __launch_bounds__(THREADS)
rows_loop(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
          long long ldg, const T* __restrict__ scale, T* __restrict__ dx,
          float* __restrict__ rinv, int rows, int d, float eps,
          const float* __restrict__ ssx, float* __restrict__ dss, int d_all) {
  constexpr int W = VEC ? Vec<T>::EPV : 1;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = d / W;
  const T* xr = x + static_cast<long long>(row) * ldx;
  const T* gr = g + static_cast<long long>(row) * ldg;
  T* orow = dx + static_cast<long long>(row) * d;

  float ss = 0.f, t = 0.f;
  for (int c = lane; c < n; c += 32) {
    float xv[W], gv[W], sv[W];
    load_w<T, VEC>(xr + c * W, xv);
    load_w<T, VEC>(gr + c * W, gv);
    load_w<T, VEC>(scale + c * W, sv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      ss = fmaf(xv[e], xv[e], ss);
      t = fmaf(gv[e] * (1.0f + sv[e]), xv[e], t);
    }
  }
  float r, k;
  if constexpr (!EXT) {
    r = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    k = r * r * (warp_sum(t) / static_cast<float>(d));
  } else {
    ext_stats(warp_sum(t), row, eps, ssx, dss, d_all, lane == 0, r, k);
  }
  if (lane == 0) rinv[row] = r;

  for (int c = lane; c < n; c += 32) {
    float xv[W], gv[W], sv[W], y[W];
    load_w<T, VEC>(xr + c * W, xv);
    load_w<T, VEC>(gr + c * W, gv);
    load_w<T, VEC>(scale + c * W, sv);
#pragma unroll
    for (int e = 0; e < W; ++e)
      y[e] = r * (gv[e] * (1.0f + sv[e]) - xv[e] * k);
    if constexpr (VEC) Vec<T>::store(orow + c * W, y);
    else store_f(orow + c, y[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ x, long long ldx,
               const T* __restrict__ g, long long ldg,
               const float* __restrict__ rinv, float* __restrict__ partial,
               int rows, int d, int chunk_rows) {
  __shared__ float sums[WARPS][STRIP];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * STRIP + tx;
  const int lo = blockIdx.y * chunk_rows;
  const int hi = min(rows, lo + chunk_rows);
  float acc = 0.f;
  if (col < d)
    for (int row = lo + ty; row < hi; row += WARPS)
      acc = fmaf(load_f(g + static_cast<long long>(row) * ldg + col) *
                     load_f(x + static_cast<long long>(row) * ldx + col),
                 rinv[row], acc);
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float s = sums[0][tx];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += sums[w][tx];
    partial[static_cast<long long>(blockIdx.y) * d + col] = s;
  }
}

// ds: block (column strip of 32) of 32 x 32 threads; thread (ty, tx) adds
// the partials of chunks ty, ty + 32, ... of column 32 strip + tx in order,
// and the 32 sums are added in order.
constexpr int DS_ROWS = 32;
template <typename T>
__global__ void __launch_bounds__(32 * DS_ROWS)
dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale,
              int chunks, int d) {
  __shared__ float sums[DS_ROWS][STRIP];
  // launched as a programmatic dependent of the partial pass: wait for it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * STRIP + tx;
  float acc = 0.f;
  if (col < d)
#pragma unroll 4
    for (int c = ty; c < chunks; c += DS_ROWS)
      acc += partial[static_cast<long long>(c) * d + col];
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float s = sums[0][tx];
#pragma unroll
    for (int w = 1; w < DS_ROWS; ++w) s += sums[w][tx];
    store_f(dscale + col, s);
  }
}

template <typename T>
using WarpPtr = void (*)(const T*, long long, const T*, long long, const T*,
                         T*, float*, int, int, int, float, const float*,
                         float*, int);

template <typename T, bool EXT, int... NV>
WarpPtr<T> warp_instance(int nv, std::integer_sequence<int, NV...>) {
  WarpPtr<T> k = nullptr;
  ((k = (nv == NV + 1) ? &rows_warp<T, NV + 1, EXT> : k), ...);
  return k;
}

template <typename T, bool EXT, int... NV>
WarpPtr<T> block_instance(int nv, std::integer_sequence<int, NV...>) {
  WarpPtr<T> k = nullptr;
  ((k = (nv == NV + 1) ? &rows_block<T, NV + 1, EXT> : k), ...);
  return k;
}

// The "block" variant's warps for a row of nvec vectors at nv a lane: 0
// when nv is past BLOCK_NV or the row would need more than BLOCK_WARPS.
int block_warps(int nvec, int nv) {
  if (nv < 1 || nv > BLOCK_NV) return 0;
  const int warps = (nvec + 32 * nv - 1) / (32 * nv);
  return warps <= BLOCK_WARPS ? warps : 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool EXT>
int launch(int variant, int nv, const void* x, long long ldx, const void* g,
           long long ldg, const void* scale, void* dx, float* rinv,
           float* partial, void* dscale, int rows, int d, int chunks,
           float eps, const float* ssx, float* dss, int d_all,
           cudaStream_t s) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr int NV_MAX = D_MAX / (32 * EPV);
  const bool vec_ok = d % EPV == 0 && (ldx * sizeof(T)) % 16 == 0 &&
                      (ldg * sizeof(T)) % 16 == 0 && aligned16(x) &&
                      aligned16(g) && aligned16(scale) && aligned16(dx);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* st = static_cast<const T*>(scale);
  T* dxt = static_cast<T*>(dx);
  const int chunk_rows = (rows + chunks - 1) / chunks;
  cudaError_t err;
  if (variant == VARIANT_WARP) {
    // nv must be exactly what d needs, so that every vector is covered
    WarpPtr<T> k = nullptr;
    if (vec_ok && d <= D_MAX && nv == (d / EPV + 31) / 32)
      k = warp_instance<T, EXT>(nv,
                                std::make_integer_sequence<int, NV_MAX>());
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    k<<<chunks, THREADS, 0, s>>>(xt, ldx, gt, ldg, st, dxt, partial, rows,
                                 d, chunk_rows, eps, ssx, dss, d_all);
  } else if (variant == VARIANT_BLOCK) {
    const int warps = block_warps(d / EPV, nv);
    if (!vec_ok || d <= D_MAX || warps == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    WarpPtr<T> k = block_instance<T, EXT>(
        nv, std::make_integer_sequence<int, BLOCK_NV>());
    k<<<chunks, 32 * warps, 0, s>>>(xt, ldx, gt, ldg, st, dxt, partial,
                                    rows, d, chunk_rows, eps, ssx, dss,
                                    d_all);
  } else {
    const unsigned row_blocks = (rows + WARPS - 1) / WARPS;
    if (rinv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (variant == VARIANT_LOOP && vec_ok && d > D_MAX)
      rows_loop<T, true, EXT><<<row_blocks, THREADS, 0, s>>>(
          xt, ldx, gt, ldg, st, dxt, rinv, rows, d, eps, ssx, dss, d_all);
    else if (variant == VARIANT_SCALAR && !vec_ok)
      rows_loop<T, false, EXT><<<row_blocks, THREADS, 0, s>>>(
          xt, ldx, gt, ldg, st, dxt, rinv, rows, d, eps, ssx, dss, d_all);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((d + STRIP - 1) / STRIP, chunks);
    partial_kernel<T><<<grid, THREADS, 0, s>>>(xt, ldx, gt, ldg, rinv,
                                               partial, rows, d, chunk_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a programmatic dependent launch: its launch overlaps the partial
  // pass's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + STRIP - 1) / STRIP);
  cfg.blockDim = dim3(32 * DS_ROWS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, dscale_kernel<T>, static_cast<const float*>(partial),
      static_cast<T*>(dscale), chunks, d));
}

template <typename T>
int blocks_per_sm(int variant, int nv, int d, int* blocks) {
  constexpr int NV_MAX = D_MAX / (32 * Vec<T>::EPV);
  WarpPtr<T> k = nullptr;
  int threads = THREADS;
  if (variant == VARIANT_WARP && nv >= 1 && nv <= NV_MAX) {
    k = warp_instance<T, false>(nv, std::make_integer_sequence<int, NV_MAX>());
  } else if (variant == VARIANT_BLOCK) {
    threads = 32 * block_warps(d / Vec<T>::EPV, nv);
    if (threads > 0)
      k = block_instance<T, false>(
          nv, std::make_integer_sequence<int, BLOCK_NV>());
  }
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads, 0));
}

}  // namespace

// The blocks of the "warp" or "block" variant's rows kernel (nv vectors a
// lane; d, for "block", sets its warps) that one SM holds at once, by
// their registers and shared memory, into *blocks.  Returns the query's
// cudaError_t.
extern "C" int rmsnorm_bwd_blocks_per_sm(int dtype, int variant, int nv,
                                         int d, int* blocks) {
  if (dtype == 0) return blocks_per_sm<float>(variant, nv, d, blocks);
  if (dtype == 1)
    return blocks_per_sm<__nv_bfloat16>(variant, nv, d, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = fp32, 1 = bf16 (x, g, scale, dx and dscale alike).  variant:
// 0 "warp" (nv = 16-byte vectors per lane, d <= 2048), 1 "loop", 2
// "scalar", 3 "block" (d > 2048, nv vectors a lane over at most
// BLOCK_WARPS warps); a variant that does not fit the shape and
// alignment is refused.  x and g take any row stride with a unit inner
// stride; dx is a contiguous (rows, d); rinv an fp32 (rows,) scratch
// ("loop" and "scalar"; null for "warp" and "block"); partial an fp32
// (chunks, d) scratch, 1 <= chunks <= 65535: the row blocks of "warp" and
// "block", the row chunks of the others' partial pass.
// Returns the launches' cudaError_t.
extern "C" int rmsnorm_bwd(int dtype, int variant, int nv, const void* x,
                           long long ldx, const void* g, long long ldg,
                           const void* scale, void* dx, float* rinv,
                           float* partial, void* dscale, int rows, int d,
                           int chunks, float eps, void* stream) {
  if (rows < 1 || d < 1 || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(variant, nv, x, ldx, g, ldg, scale, dx, rinv,
                                partial, dscale, rows, d, chunks, eps,
                                nullptr, nullptr, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(variant, nv, x, ldx, g, ldg, scale,
                                        dx, rinv, partial, dscale, rows, d,
                                        chunks, eps, nullptr, nullptr, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of rmsnorm_ext (K3 over a row split across ranks by
// columns; ssx (rows,) fp32 each whole row's sum of squares, d_all its
// columns): dx with the statistic held, r g (1 + s), dscale as above, and
// dss (rows,) fp32, the statistic's gradient from these columns,
// -r^3 sum(g (1 + s) x) / (2 d_all).  The rest is rmsnorm_bwd's.
extern "C" int rmsnorm_bwd_ext(int dtype, int variant, int nv, const void* x,
                               long long ldx, const void* g, long long ldg,
                               const void* scale, void* dx, float* rinv,
                               float* partial, void* dscale, int rows, int d,
                               int chunks, float eps, const float* ssx,
                               float* dss, int d_all, void* stream) {
  if (rows < 1 || d < 1 || chunks < 1 || chunks > 65535 || d_all < d ||
      ssx == nullptr || dss == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(variant, nv, x, ldx, g, ldg, scale, dx, rinv,
                               partial, dscale, rows, d, chunks, eps, ssx,
                               dss, d_all, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(variant, nv, x, ldx, g, ldg, scale,
                                       dx, rinv, partial, dscale, rows, d,
                                       chunks, eps, ssx, dss, d_all, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
