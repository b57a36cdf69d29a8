// K1 `minplus_acc`: out[b] = min(init[b], A[b] (x) B[b]), the batched
// tropical (min-plus) product, C[i, j] = min_k A[i, k] + B[k, j].
//
// Replaces the Pallas TPU kernels in src/repro/kernels/minplus/kernel.py:
//   * minplus_pallas_batched (body _minplus_kernel_batched) -- every step of
//     batcheval's "squaring" method;
//   * minplus_pallas (body _minplus_kernel) -- the unbatched product, here
//     the B = 1 case;
//   * the three min-plus bodies of apsp_tiled_pallas that share
//     _slab_minplus: the row panel min(p, diag (x) p), the column panel
//     min(p, p (x) diag) and the outer update min(d, colp (x) rowp), here
//     with `init` set to the panel or to d.
//
// What bounds it on an H100: no tensor-core or wgmma instruction computes
// min-plus, so each relaxation costs two fp32 instructions on the CUDA
// cores (an add and a min).  At every shape the main path gives it (K >= 64)
// the kernel does ~K/2 instructions per byte it must move, far above the
// card's ~10 fp32 instructions per byte of device memory, so it is bound by
// instruction throughput, not by bytes.
//
// Design: an SGEMM-style register-blocked tile.  Each block of 256 threads
// owns a 64 x 64 output tile and walks K in 16-wide slices staged through
// shared memory (A transposed, so each thread reads its four rows as one
// 16-byte load).  Each thread keeps a 4 x 4 micro-tile of running minima in
// registers, so one pair of 16-byte shared loads feeds 16 relaxations.
// Ragged edges are masked in the kernel: rows and columns past M / N are not
// stored, and k past K reads +inf, which never wins a min.  The accumulator
// starts at +inf, so with no `init` the result is exactly the min over k
// (the plain version, ref.minplus_ref).
//
// Exactness: a min over the same set of sums is exact, so the kernel is
// bit-equal to its plain version.  The add is __fadd_rn (no contraction,
// built without --use_fast_math).  bf16 operands are widened to fp32, added,
// and each sum is rounded to bf16 (round to nearest even) before the min --
// the rounding torch applies to a bf16 add on the CPU.
//
// The operands are read through row strides (lda, ldb, ...) and batch
// strides, so views such as a column panel of the distance matrix need no
// copy.  The output must not alias A or B (the Python wrapper checks): the
// panels are reduced against frozen operands.  `out` may alias `init`.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;                          // keeps float4 alignment

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // v is already bf16-representable
}
__device__ __forceinline__ float relax(float a, float b, float) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float relax(float a, float b, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
minplus_acc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const T* init, T* out, int M, int K, int N,
                   long long sa, int lda, long long sb, int ldb,
                   long long si, int ldi, long long so, int ldo) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int bz = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  A += bz * sa;
  B += bz * sb;
  out += bz * so;
  if (init != nullptr) init += bz * si;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const float kInf = __int_as_float(0x7f800000);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = kInf;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): consecutive threads read consecutive k of one row.
#pragma unroll
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? load_f(A + (long long)gr * lda + gc)
                                    : kInf;
    }
    // B tile (BK x BN): consecutive threads read consecutive columns.
#pragma unroll
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? load_f(B + (long long)gr * ldb + gc)
                                    : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fminf(acc[i][j], relax(a[i], b[j], T()));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= N) continue;
      float v = acc[i][j];
      if (init != nullptr)
        v = fminf(load_f(init + (long long)gr * ldi + gc), v);
      store_f(out + (long long)gr * ldo + gc, v);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* init, void* out,
           int batch, int m, int k, int n, long long sa, int lda,
           long long sb, int ldb, long long si, int ldi, long long so,
           int ldo, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  minplus_acc_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(init), static_cast<T*>(out), m, k, n, sa, lda,
      sb, ldb, si, ldi, so, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `init` may be null.  Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int minplus_acc(int dtype, const void* a, const void* b,
                           const void* init, void* out, int batch, int m,
                           int k, int n, long long sa, int lda, long long sb,
                           int ldb, long long si, int ldi, long long so,
                           int ldo, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, init, out, batch, m, k, n, sa, lda, sb, ldb,
                         si, ldi, so, ldo, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, init, out, batch, m, k, n, sa, lda,
                                 sb, ldb, si, ldi, so, ldo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
