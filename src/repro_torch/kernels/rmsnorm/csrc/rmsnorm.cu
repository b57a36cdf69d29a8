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
// Design: one warp per row, 8 rows per 256-thread block, no shared memory
// and no block barrier.  In the main variant ("warp", d <= D_MAX) each lane
// issues all of its 16-byte loads of the row (4 fp32 or 8 bf16 each; NV of
// them, a template parameter the wrapper picks from d) before it reduces:
// the row then stays in registers, so device memory is read once and
// written once, and a warp keeps NV x 512 bytes in flight.  The sum of
// squares is a warp-shuffle butterfly in fp32.  Two variants of the same
// entry point, chosen by the wrapper from shape and alignment before the
// launch, take what the main one does not:
//   "loop"   d > D_MAX, 16-byte aligned: two strided passes of 16-byte loads
//            over the row (the second reads it again from L2);
//   "scalar" a pointer or row stride not 16-byte aligned, or d not a
//            multiple of the vector width: two strided passes of scalar loads.
// Every variant writes x * inv * (1 + scale) in the reference's order of
// operations, with inv = 1 / sqrtf(var + eps) by IEEE sqrt and division
// (no fast math), which rounds like the reference's rsqrt; only the order
// of the sum of squares differs from the reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int WARPS = 8;              // rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int D_MAX = 2048;           // largest d kept in registers
constexpr int VARIANT_WARP = 0, VARIANT_LOOP = 1, VARIANT_SCALAR = 2;

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
  KernelPtr<T> k = nullptr;
  if (variant == VARIANT_WARP) {
    // nv must be exactly what d needs, so that every vector is covered
    if (vec_ok && d <= D_MAX && nv == (d / EPV + 31) / 32)
      k = warp_instance<T>(nv, std::make_integer_sequence<int, NV_MAX>());
  } else if (variant == VARIANT_LOOP) {
    if (vec_ok && d > D_MAX) k = rmsnorm_loop<T, true>;
  } else if (variant == VARIANT_SCALAR) {
    if (!vec_ok) k = rmsnorm_loop<T, false>;
  }
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(scale),
      static_cast<T*>(out), ldo, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, scale and out alike).  variant: 0 "warp"
// (nv = 16-byte vectors per lane, d <= 2048), 1 "loop", 2 "scalar"; a
// variant that does not fit the shape and alignment is refused.  Returns
// the launch's cudaError_t.
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
