// K2 `fw_tile`: Floyd-Warshall closure of one T x T diagonal tile (T <= 256)
// in one thread block, sequential over the T pivots:
//   for k in 0..T-1:  d = min(d, d[:, k] + d[k, :])
// with pivot row k and pivot column k read before any element of pivot k is
// updated (the plain version, ref.fw_tile_ref, takes them from the
// un-updated tile).
//
// Replaces _fw_diag_kernel of apsp_tiled_pallas in
// src/repro/kernels/minplus/kernel.py (phase 1 of the blocked
// Floyd-Warshall; the panels and the outer update are K1 `minplus_acc`).
//
// What bounds it on an H100: the pivots form a chain, so the whole closure
// is one block on one of the 132 SMs, and its floor is that SM's
// instruction rate for T^3 relaxations of two instructions each plus one
// block barrier per pivot.  Device memory is touched once (one tile in,
// one tile out).
//
// Design: the Pallas kernel kept the tile in 16 MiB of VMEM.  An fp32 tile
// at T = 256 is 256 KiB: more than the 227 KiB of shared memory a block may
// have, and exactly the SM's register file.  So the tile is split.  512
// threads each own one column j = tid % 256 and, with g = tid / 256, the
// rows i = g + 2r (r < 64): rows 0..127 live in 64 registers per thread,
// rows 128..255 in shared memory (a 257-float row stride keeps the pivot
// column read free of bank conflicts).  Per pivot, the pivot row and column
// are copied into two small shared buffers, a barrier, then every thread
// relaxes its 128 elements against them, and a second barrier.
//
// Exactness as K1: __fadd_rn, fminf; bf16 sums are rounded to bf16 before the
// min, and the tile is held in fp32, where every bf16 value is exact.  `out`
// may alias the input: every element is read before the first barrier.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TMAX = 256;
constexpr int THREADS = 512;
constexpr int RROWS = 64;         // register rows per thread
constexpr int SPLIT = 2 * RROWS;  // rows below SPLIT live in registers
constexpr int LDS = TMAX + 1;     // shared row stride (floats)

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float relax(float a, float b, float) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float relax(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fw_tile_kernel(const T* in, int ldi, T* out, int ldo, int t) {
  extern __shared__ float S[];              // rows SPLIT..t-1, stride LDS
  __shared__ float prow[TMAX];
  __shared__ float pcol[TMAX];

  const int tid = threadIdx.x;
  const int j = tid % TMAX;
  const int g = tid / TMAX;
  const bool live = j < t;

  float v[RROWS];
#pragma unroll
  for (int r = 0; r < RROWS; ++r) {
    const int i = g + 2 * r;
    v[r] = (live && i < t) ? load_f(in + (long long)i * ldi + j) : 0.0f;
  }
  if (live) {
    for (int i = SPLIT + g; i < t; i += 2)
      S[(i - SPLIT) * LDS + j] = load_f(in + (long long)i * ldi + j);
  }
  __syncthreads();

  for (int k = 0; k < t; ++k) {
    // snapshot pivot row k
    if (k < SPLIT) {
      if (live && g == (k & 1)) {
        const int kr = k >> 1;
        float x = v[0];
#pragma unroll
        for (int r = 1; r < RROWS; ++r) x = (r == kr) ? v[r] : x;
        prow[j] = x;
      }
    } else if (live && g == 0) {
      prow[j] = S[(k - SPLIT) * LDS + j];
    }
    // snapshot pivot column k
    if (j == k) {
#pragma unroll
      for (int r = 0; r < RROWS; ++r) {
        const int i = g + 2 * r;
        if (i < t) pcol[i] = v[r];
      }
    }
    if (tid < TMAX - SPLIT && SPLIT + tid < t)
      pcol[SPLIT + tid] = S[tid * LDS + k];
    __syncthreads();

    if (live) {
      const float pr = prow[j];
#pragma unroll
      for (int r = 0; r < RROWS; ++r) {
        const int i = g + 2 * r;
        if (i < t) v[r] = fminf(v[r], relax(pcol[i], pr, T()));
      }
      for (int i = SPLIT + g; i < t; i += 2) {
        float* s = &S[(i - SPLIT) * LDS + j];
        *s = fminf(*s, relax(pcol[i], pr, T()));
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < RROWS; ++r) {
      const int i = g + 2 * r;
      if (i < t) store_f(out + (long long)i * ldo + j, v[r]);
    }
    for (int i = SPLIT + g; i < t; i += 2)
      store_f(out + (long long)i * ldo + j, S[(i - SPLIT) * LDS + j]);
  }
}

template <typename T>
int launch(const void* in, int ldi, void* out, int ldo, int t,
           cudaStream_t stream) {
  const int smem_rows = t > SPLIT ? t - SPLIT : 0;
  const size_t smem = sizeof(float) * smem_rows * LDS;
  cudaError_t err = cudaFuncSetAttribute(
      fw_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * (TMAX - SPLIT) * LDS));
  if (err != cudaSuccess) return static_cast<int>(err);
  fw_tile_kernel<T><<<1, THREADS, smem, stream>>>(
      static_cast<const T*>(in), ldi, static_cast<T*>(out), ldo, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 1 <= t <= 256.  Returns the cudaError_t
// of the launch (0 = cudaSuccess).
extern "C" int fw_tile(int dtype, const void* in, int ldi, void* out, int ldo,
                       int t, void* stream) {
  if (t < 1 || t > TMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, ldi, out, ldo, t, s);
  if (dtype == 1) return launch<__nv_bfloat16>(in, ldi, out, ldo, t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
