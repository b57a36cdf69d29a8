// K3 `rmsnorm`: fused RMSNorm forward over the rows of a (rows, d) matrix,
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// with the moment taken in fp32 and y cast back to x's type (fp32 or bf16).
//
// Replaces rmsnorm_pallas (_rmsnorm_kernel) of
// src/repro/kernels/rmsnorm/kernel.py, which computes exactly
// repro.models.layers.rms_norm.  The port's rms_norm runs every norm of the
// served model through it: ln1, ln2 and the final norm on the residual
// (d = 1152 for gemma3-1b) and q_norm / k_norm per head (d = 256).
//
// What bounds it on an H100: bytes.  It reads each element once and writes
// it once (plus d scale values), and does ~4 operations per element, far
// below the ~20 fp32 operations per byte at which the card's arithmetic,
// and not its 3.35 TB/s, would be the limit.  So the only levers are the
// bytes in flight and the bytes moved.
//
// Design: four variants of one entry point, chosen by the wrapper
// (kernel.variant) from (rows, d, dtype, alignment) before the launch and
// refused here when they do not fit.  The first two keep the row in
// registers, so that device memory is read once and written once:
//   "warp"   d <= D_MAX, rows enough to fill the card: one warp per row, 8
//            rows per 256-thread block, no barrier.  Each lane issues all
//            of its 16-byte loads of the row (4 fp32 or 8 bf16 each; NV of
//            them, a template parameter the wrapper picks from d) before it
//            reduces, so a warp keeps NV x 512 bytes in flight.  The sum of
//            squares is a warp-shuffle butterfly in fp32.
//   "block"  d > D_MAX, or rows too few to fill the card with a warp a row:
//            one block of W = ceil(d / (EPV x 32 NV)) warps per row (W <=
//            32), NV <= 8 16-byte vectors a lane, kept as loaded (4 words
//            of 16 bytes, fp32 or bf16), so the row is read once however
//            wide.  Each warp's butterfly sum goes to shared memory; after
//            one block barrier every thread adds the W partials in warp
//            order (no atomics: a fixed order, the same in every thread).
//            At decode (8 rows) W is as large as d allows, so that the
//            loads of a row are spread over up to 1,024 threads.
//   "loop"   d > D_MAX, 16-byte aligned: two strided passes of one warp
//            over its row in 16-byte loads (the second reads it again from
//            L2); the wrapper takes it only for rows too wide for "block"
//            (more than 32 x 32 x 8 vectors);
//   "scalar" a pointer or row stride not 16-byte aligned, or d not a
//            multiple of the vector width: two strided passes of scalar
//            loads, a warp per row.
// Every variant writes x * inv * (1 + scale) in the reference's order of
// operations, with inv = 1 / sqrtf(var + eps) by IEEE sqrt and division
// (no fast math), which rounds like the reference's rsqrt; only the order
// of the sum of squares differs from the reference, and it is fixed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int WARPS = 8;              // rows per block ("warp", "loop")
constexpr int THREADS = 32 * WARPS;
constexpr int D_MAX = 2048;           // largest d of "warp"
constexpr int BLOCK_NV = 8;           // most 16-byte vectors a lane, "block"
constexpr int BLOCK_WARPS = 32;       // most warps a row, "block"
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

// 16 bytes of T as EPV floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int EPV = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int EPV = 8;
  // A bf16 is the upper half of the fp32 with the same bits: exact.
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
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
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A 16-byte vector as loaded, and its EPV values as floats.
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
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

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
}

// "warp": lane l holds the row's 16-byte vectors l, l + 32, ... (NV of
// them, the last ones masked when the row has fewer than 32 NV).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_warp(const T* __restrict__ x, long long ldx,
             const T* __restrict__ scale, T* __restrict__ out,
             long long ldo, int rows, int d, float eps) {
  constexpr int EPV = Vec<T>::EPV;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = d / EPV;
  const T* xr = x + static_cast<long long>(row) * ldx;
  T* orow = out + static_cast<long long>(row) * ldo;

  float v[NV][EPV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      Vec<T>::load(xr + c * EPV, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) v[i][e] = 0.0f;
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < EPV; ++e) ss = fmaf(v[i][e], v[i][e], ss);
  const float inv = inv_rms(warp_sum(ss), d, eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float s[EPV], y[EPV];
      Vec<T>::load(scale + c * EPV, s);
#pragma unroll
      for (int e = 0; e < EPV; ++e) y[e] = v[i][e] * inv * (1.0f + s[e]);
      Vec<T>::store(orow + c * EPV, y);
    }
  }
}

// "block": the row's 16-byte vectors c = i + T j (T = blockDim.x, j < NV)
// in thread i, as loaded; warp partials summed in warp order.
template <typename T, int NV>
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
rmsnorm_block(const T* __restrict__ x, long long ldx,
              const T* __restrict__ scale, T* __restrict__ out,
              long long ldo, int rows, int d, float eps) {
  constexpr int EPV = Vec<T>::EPV;
  __shared__ float part[BLOCK_WARPS];
  const int row = blockIdx.x;
  const int nvec = d / EPV, stride = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xr = x + static_cast<long long>(row) * ldx;
  T* orow = out + static_cast<long long>(row) * ldo;

  uint4 raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = threadIdx.x + stride * j;
    raw[j] = c < nvec ? load_raw(xr + c * EPV) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v[EPV];
    unpack<T>(raw[j], v);
#pragma unroll
    for (int e = 0; e < EPV; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  float total = 0.0f;
  const int warps = stride >> 5;
  for (int w = 0; w < warps; ++w) total += part[w];
  const float inv = inv_rms(total, d, eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = threadIdx.x + stride * j;
    if (c < nvec) {
      float v[EPV], sc[EPV], y[EPV];
      unpack<T>(raw[j], v);
      Vec<T>::load(scale + c * EPV, sc);
#pragma unroll
      for (int e = 0; e < EPV; ++e) y[e] = v[e] * inv * (1.0f + sc[e]);
      Vec<T>::store(orow + c * EPV, y);
    }
  }
}

// "loop" (VEC) and "scalar" (!VEC): two strided passes of one warp over its
// row, in 16-byte vectors or in single elements.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_loop(const T* __restrict__ x, long long ldx,
             const T* __restrict__ scale, T* __restrict__ out,
             long long ldo, int rows, int d, float eps) {
  constexpr int W = VEC ? Vec<T>::EPV : 1;
  constexpr int UNROLL = 4;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = d / W;
  const T* xr = x + static_cast<long long>(row) * ldx;
  T* orow = out + static_cast<long long>(row) * ldo;

  float ss = 0.0f;
  for (int c0 = lane; c0 < n; c0 += 32 * UNROLL) {
    float v[UNROLL][W];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + 32 * u;
#pragma unroll
      for (int e = 0; e < W; ++e) v[u][e] = 0.0f;
      if (c < n) {
        if constexpr (VEC) Vec<T>::load(xr + c * W, v[u]);
        else v[u][0] = load_f(xr + c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < W; ++e) ss = fmaf(v[u][e], v[u][e], ss);
  }
  const float inv = inv_rms(warp_sum(ss), d, eps);

  for (int c = lane; c < n; c += 32) {
    float v[W], s[W], y[W];
    if constexpr (VEC) {
      Vec<T>::load(xr + c * W, v);
      Vec<T>::load(scale + c * W, s);
    } else {
      v[0] = load_f(xr + c);
      s[0] = load_f(scale + c);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) y[e] = v[e] * inv * (1.0f + s[e]);
    if constexpr (VEC) Vec<T>::store(orow + c * W, y);
    else store_f(orow + c, y[0]);
  }
}

template <typename T>
using KernelPtr = void (*)(const T*, long long, const T*, T*, long long, int,
                           int, float);

template <typename T, int... NV>
KernelPtr<T> warp_instance(int nv, std::integer_sequence<int, NV...>) {
  KernelPtr<T> k = nullptr;
  ((k = (nv == NV + 1) ? &rmsnorm_warp<T, NV + 1> : k), ...);
  return k;
}

template <typename T, int... NV>
KernelPtr<T> block_instance(int nv, std::integer_sequence<int, NV...>) {
  KernelPtr<T> k = nullptr;
  ((k = (nv == NV + 1) ? &rmsnorm_block<T, NV + 1> : k), ...);
  return k;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(int variant, int nv, const void* x, long long ldx,
           const void* scale, void* out, long long ldo, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr int NV_MAX = D_MAX / (32 * EPV);
  const bool vec_ok = d % EPV == 0 && (ldx * sizeof(T)) % 16 == 0 &&
                      (ldo * sizeof(T)) % 16 == 0 && aligned16(x) &&
                      aligned16(scale) && aligned16(out);
  const int nvec = d / EPV;
  KernelPtr<T> k = nullptr;
  unsigned blocks = (rows + WARPS - 1) / WARPS, threads = THREADS;
  if (variant == VARIANT_WARP) {
    // nv must be exactly what d needs, so that every vector is covered
    if (vec_ok && d <= D_MAX && nv == (nvec + 31) / 32)
      k = warp_instance<T>(nv, std::make_integer_sequence<int, NV_MAX>());
  } else if (variant == VARIANT_BLOCK) {
    // a row's W warps of nv vectors a lane cover it: W = ceil(nvec / 32 nv)
    const int w = nv >= 1 ? (nvec + 32 * nv - 1) / (32 * nv) : 0;
    if (vec_ok && nv >= 1 && nv <= BLOCK_NV && w <= BLOCK_WARPS) {
      k = block_instance<T>(nv, std::make_integer_sequence<int, BLOCK_NV>());
      blocks = rows;
      threads = 32 * w;
    }
  } else if (variant == VARIANT_LOOP) {
    if (vec_ok && d > D_MAX) k = rmsnorm_loop<T, true>;
  } else if (variant == VARIANT_SCALAR) {
    if (!vec_ok) k = rmsnorm_loop<T, false>;
  }
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(scale),
      static_cast<T*>(out), ldo, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, scale and out alike).  variant: 0 "warp"
// (nv = 16-byte vectors per lane, d <= 2048), 1 "loop", 2 "scalar", 3
// "block" (nv = 16-byte vectors per lane, 1..8; the block has
// ceil(d / (EPV x 32 nv)) <= 32 warps); a variant that does not fit the
// shape and alignment is refused.  Returns the launch's cudaError_t.
extern "C" int rmsnorm(int dtype, int variant, int nv, const void* x,
                       long long ldx, const void* scale, void* out,
                       long long ldo, int rows, int d, float eps,
                       void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(variant, nv, x, ldx, scale, out, ldo, rows, d, eps,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(variant, nv, x, ldx, scale, out, ldo, rows,
                                 d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
