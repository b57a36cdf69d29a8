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
// and not its 3.35 TB/s, would be the limit.
//
// Design: one block per row, so any row count runs with no padding (the
// Pallas kernel needed rows padded to its 256-row block).  The block takes
// the row's sum of squares in fp32 (each thread strides over the row, then
// a warp shuffle and a shared-memory pass across warps), and then writes
// x * inv * (1 + scale) in the reference's order of operations.  The second
// pass re-reads the row from L1/L2, not from device memory: a row is at
// most a few tens of KB.  inv is 1 / sqrtf(var + eps) with IEEE sqrt and
// division (no fast math), which rounds like the reference's rsqrt.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, long long ldx,
               const T* __restrict__ scale, T* __restrict__ out,
               long long ldo, int d, float eps) {
  __shared__ float partial[MAX_THREADS / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * ldx;
  T* orow = out + static_cast<long long>(blockIdx.x) * ldo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v = load_f(xr + i);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < nwarps ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(partial[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v = load_f(xr + i);
    store_f(orow + i, v * inv * (1.0f + load_f(scale + i)));
  }
}

template <typename T>
int launch(const void* x, long long ldx, const void* scale, void* out,
           long long ldo, int rows, int d, float eps, cudaStream_t s) {
  int threads = ((d + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  rmsnorm_kernel<T><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(scale),
      static_cast<T*>(out), ldo, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, scale and out alike).  Returns the launch's
// cudaError_t.
extern "C" int rmsnorm(int dtype, const void* x, long long ldx,
                       const void* scale, void* out, long long ldo, int rows,
                       int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ldx, scale, out, ldo, rows, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ldx, scale, out, ldo, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
