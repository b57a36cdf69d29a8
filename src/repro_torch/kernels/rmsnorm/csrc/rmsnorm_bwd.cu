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
// What bounds it on an H100: bytes.  It reads x and g and writes dx (plus
// d-sized scale and ds), with ~10 operations per element.
//
// Design: three kernels on the caller's stream, one call, no atomics.
//   * rows: one warp per row, 8 rows per 256-thread block, as K3 forward.
//     Two strided passes over the row (16-byte loads when every row and
//     pointer is 16-byte aligned and d is a multiple of the vector width,
//     else element by element): the first sums x^2 and g (1 + s) x, the
//     second writes dx.  The row's r goes to an fp32 (rows,) scratch.
//   * partial ds: block (column strip of 32, row chunk) of 32 x 8 threads;
//     thread (ty, tx) sums g x r of column 32 strip + tx over rows
//     chunk_lo + ty, + 8, ... in order, the 8 sums are added in order, and
//     the strip's partial row of the chunk goes to an fp32 (chunks, d)
//     scratch.  Warps read 32 consecutive columns of a row: coalesced.
//   * ds: one thread per column adds the chunks' partials in order.
// Every sum runs in a fixed order, so two calls on the same inputs give
// bitwise-equal dx and ds.  The second pass of the row kernel and the
// partial kernel read x and g again (from L2 where they fit).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STRIP = 32;             // columns per partial block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as EPV floats (K3 forward's loads and stores).
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

// W elements at p (16 bytes when VEC, else one).
template <typename T, bool VEC>
__device__ __forceinline__ void load_w(const T* p, float* f) {
  if constexpr (VEC) Vec<T>::load(p, f);
  else f[0] = load_f(p);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ g,
            long long ldg, const T* __restrict__ scale, T* __restrict__ dx,
            float* __restrict__ rinv, int rows, int d, float eps) {
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
  // K3 forward's r: 1 / sqrtf(mean + eps) by IEEE sqrt and division
  const float r = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  const float k = r * r * (warp_sum(t) / static_cast<float>(d));
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale,
              int chunks, int d) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c)
    s += partial[static_cast<long long>(c) * d + col];
  store_f(dscale + col, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* x, long long ldx, const void* g, long long ldg,
           const void* scale, void* dx, float* rinv, float* partial,
           void* dscale, int rows, int d, int chunks, float eps,
           cudaStream_t s) {
  constexpr int EPV = Vec<T>::EPV;
  const bool vec = d % EPV == 0 && (ldx * sizeof(T)) % 16 == 0 &&
                   (ldg * sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(g) && aligned16(scale) && aligned16(dx);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const unsigned row_blocks = (rows + WARPS - 1) / WARPS;
  if (vec)
    rows_kernel<T, true><<<row_blocks, THREADS, 0, s>>>(
        xt, ldx, gt, ldg, static_cast<const T*>(scale), static_cast<T*>(dx),
        rinv, rows, d, eps);
  else
    rows_kernel<T, false><<<row_blocks, THREADS, 0, s>>>(
        xt, ldx, gt, ldg, static_cast<const T*>(scale), static_cast<T*>(dx),
        rinv, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk_rows = (rows + chunks - 1) / chunks;
  const dim3 grid((d + STRIP - 1) / STRIP, chunks);
  partial_kernel<T><<<grid, THREADS, 0, s>>>(xt, ldx, gt, ldg, rinv, partial,
                                             rows, d, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dscale_kernel<T><<<(d + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, static_cast<T*>(dscale), chunks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, g, scale, dx and dscale alike).  x and g
// take any row stride with a unit inner stride; dx is a contiguous
// (rows, d); rinv an fp32 (rows,) scratch; partial an fp32 (chunks, d)
// scratch, 1 <= chunks <= 65535.  Returns the launches' cudaError_t.
extern "C" int rmsnorm_bwd(int dtype, const void* x, long long ldx,
                           const void* g, long long ldg, const void* scale,
                           void* dx, float* rinv, float* partial,
                           void* dscale, int rows, int d, int chunks,
                           float eps, void* stream) {
  if (rows < 1 || d < 1 || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ldx, g, ldg, scale, dx, rinv, partial, dscale,
                         rows, d, chunks, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ldx, g, ldg, scale, dx, rinv, partial,
                                 dscale, rows, d, chunks, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
