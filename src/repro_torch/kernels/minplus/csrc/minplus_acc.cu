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
// cores (an add and a min): at best 64 relaxations per SM per clock.  At
// every shape the main path gives it (K >= 64) the kernel does ~K/2
// instructions per byte it must move, far above the card's ~10 fp32
// instructions per byte of device memory, so it is bound by instruction
// issue, and the design spends as few issue slots as it can on anything but
// the add and the min, and keeps every warp fed while the next slice loads.
//
// Design: an SGEMM-style register-blocked tile in two sizes, chosen per
// shape on the host (kernel.variant):
//   * BM = 128: a 128 x 128 output tile, 256 threads, each holding an 8 x 8
//     micro-tile of running minima (rows ty + 16 i, columns 4 tx + 64 j + e);
//     per k, four 16-byte shared loads feed 64 relaxations.  For the outer
//     update of the blocked Floyd-Warshall, the shape that counts.
//   * BM = 64: a 64 x 64 tile with a 4 x 4 micro-tile, for shapes with too
//     few 128 x 128 tiles to fill 132 SMs (the row panel, adapt's squaring).
// K is walked in slices of BK = 16 through a ring of STAGES = 4 slices in
// shared memory filled by 16-byte cp.async.cg: slices k + 1 .. k + 3 are
// in flight while slice k is reduced, and one block barrier per slice
// guards the ring.  A stays row-major in shared memory with a padded
// stride of 20 floats: a warp's lanes read the same k of four consecutive
// rows, which the stride puts in four different bank groups, so every
// shared read is a conflict-free 16-byte load (4 k of one row) with no
// transposing store.
// B is read row-major as it lies.  (Storing A transposed from registers
// one slice ahead, the classic SGEMM pipeline, was slower on the H100 at the
// outer update: PERF.md, section 6.)  A tile inside the matrix
// takes each whole slice by unchecked cp.async; chunks that cross a ragged
// edge, or operands that are bf16 or not 16-byte aligned, are staged by
// plain loads (bf16 widened to fp32) with +inf past the edge, which never
// wins a min.  Per k, a thread forms a row's 8 sums before their 8 mins,
// so no min waits on the add just before it; the epilogue loads a strip's
// init values before it stores any, so their reads overlap.
//
// Split K (splits > 1): the k range is cut into `splits` chunks of whole
// slices, each block reduces one chunk of one tile into a float workspace,
// and a second kernel of this file takes, per element, the min over the
// chunks in order and then the min with `init`.  A min over chunks of the
// same set of sums visits the same candidates, so this is exact; it lets a
// small product (adapt's N = 256 squaring) fill the card.
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

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;          // k per slice
constexpr int STAGES = 4;       // slices in the shared-memory ring
constexpr int LDA = BK + 4;     // row stride of the A tile (floats)

template <int BM>
struct Tile {
  static constexpr int TM = BM / 16;      // rows per thread: ty + 16 i
  static constexpr int NS = BM / 64;      // 4-wide column strips per thread
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BM;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static constexpr int A_CHUNKS = BM * BK / 4 / THREADS;   // per thread
  static constexpr int B_CHUNKS = BK * BM / 4 / THREADS;
};
// kernel.variant takes the 128 x 128 tile where it gives two blocks an SM:
// two blocks (and the 1 KB the runtime reserves for each) fit an H100 SM's
// 228 KB of shared memory
static_assert(2 * (Tile<128>::SMEM_BYTES + 1024) <= 228 * 1024,
              "two 128 x 128 blocks no longer fit an SM");

struct Args {
  const void* a;
  const void* b;
  const void* init;
  void* out;
  float* ws;                  // split K: (splits, batch, m, n) partial minima
  int batch, m, k, n;
  int kchunk;                 // k per split, a multiple of BK
  long long sa, sb, si, so;   // batch strides (elements)
  int lda, ldb, ldi, ldo;     // row strides (elements)
  int vec_a, vec_b, vec_o;    // 16-byte paths allowed (fp32, aligned)
};

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

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements [c, c + 4) of a row into dst, +inf at and past
// `lim`: by one cp.async when `fast` and the chunk is whole, else by loads.
template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* row, int c,
                                       int lim, bool fast) {
  if (fast && c + 3 < lim) {
    cp_async16(dst, row + c);
    return;
  }
  const float inf = __int_as_float(0x7f800000);
  float4 v;
  v.x = c < lim ? load_f(row + c) : inf;
  v.y = c + 1 < lim ? load_f(row + c + 1) : inf;
  v.z = c + 2 < lim ? load_f(row + c + 2) : inf;
  v.w = c + 3 < lim ? load_f(row + c + 3) : inf;
  *reinterpret_cast<float4*>(dst) = v;
}

// Slice [k0, k0 + BK) of the block's A rows and B columns into one stage.
// Rows of A past m (columns of B past n) are staged as +inf too: their
// results are never stored.  `whole`: the block's rows and columns and the
// slice are all in range and both operands take 16-byte copies, so every
// chunk is one cp.async with no test (the outer update's every slice).
template <typename T, int BM>
__device__ __forceinline__ void load_slice(float* st, const T* A, const T* B,
                                           const Args& p, int row0, int col0,
                                           int k0, bool whole) {
  using L = Tile<BM>;
  float* As = st;
  float* Bs = st + L::A_FLOATS;
  if (whole) {
#pragma unroll
    for (int u = 0; u < L::A_CHUNKS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      cp_async16(As + r * LDA + c,
                 A + static_cast<long long>(row0 + r) * p.lda + k0 + c);
    }
#pragma unroll
    for (int u = 0; u < L::B_CHUNKS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int r = e / (BM / 4), c = (e % (BM / 4)) * 4;
      cp_async16(Bs + r * BM + c,
                 B + static_cast<long long>(k0 + r) * p.ldb + col0 + c);
    }
    return;
  }
  const bool fa = p.vec_a, fb = p.vec_b;
#pragma unroll
  for (int u = 0; u < L::A_CHUNKS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
    const int gr = min(row0 + r, p.m - 1);
    stage4(As + r * LDA + c, A + static_cast<long long>(gr) * p.lda, k0 + c,
           row0 + r < p.m ? p.k : 0, fa);
  }
#pragma unroll
  for (int u = 0; u < L::B_CHUNKS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = e / (BM / 4), c = (e % (BM / 4)) * 4;
    const int gk = min(k0 + r, p.k - 1);
    stage4(Bs + r * BM + c, B + static_cast<long long>(gk) * p.ldb, col0 + c,
           k0 + r < p.k ? p.n : 0, fb);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS, 2)
minplus_acc_kernel(const Args p) {
  using L = Tile<BM>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int split = blockIdx.z / p.batch;
  const int bz = blockIdx.z - split * p.batch;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BM;
  const T* A = static_cast<const T*>(p.a) + bz * p.sa;
  const T* B = static_cast<const T*>(p.b) + bz * p.sb;

  // warps as 4 x 2, lanes as 4 x 8: a warp reads 4 rows of A and 8
  // neighbouring 16-byte columns of B per k
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const float kInf = __int_as_float(0x7f800000);

  float acc[L::TM][4 * L::NS];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * L::NS; ++j) acc[i][j] = kInf;

  const int k_begin = split * p.kchunk;
  const int k_len = min(p.k - k_begin, p.kchunk);
  const int nk = k_len > 0 ? (k_len + BK - 1) / BK : 0;

  // every slice but a ragged last one is whole when the tile is inside
  const bool inside = p.vec_a && p.vec_b && row0 + BM <= p.m &&
                      col0 + BM <= p.n;
  const int k_whole = k_begin + (k_len / BK) * BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    const int k0 = k_begin + s * BK;
    if (s < nk)
      load_slice<T, BM>(smem + s * L::STAGE_FLOATS, A, B, p, row0, col0, k0,
                        inside && k0 < k_whole);
    cp_async_commit();
  }
  int use = 0, fill = STAGES - 1;  // ring slots of slices kt, kt + 3
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's part of slice kt is in
    __syncthreads();               // everyone's is; slice kt - 1 is read
    const int nx = kt + STAGES - 1;
    if (nx < nk) {
      const int k0 = k_begin + nx * BK;
      load_slice<T, BM>(smem + fill * L::STAGE_FLOATS, A, B, p, row0, col0,
                        k0, inside && k0 < k_whole);
    }
    cp_async_commit();
    fill = fill == STAGES - 1 ? 0 : fill + 1;

    const float* As = smem + use * L::STAGE_FLOATS;
    use = use == STAGES - 1 ? 0 : use + 1;
    const float* Bs = As + L::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[L::TM][4];
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA + kq);
        a[i][0] = t.x;
        a[i][1] = t.y;
        a[i][2] = t.z;
        a[i][3] = t.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[4 * L::NS];
#pragma unroll
        for (int j = 0; j < L::NS; ++j) {
          const float4 t = *reinterpret_cast<const float4*>(
              Bs + (kq + kk) * BM + 4 * tx + 64 * j);
          b[4 * j] = t.x;
          b[4 * j + 1] = t.y;
          b[4 * j + 2] = t.z;
          b[4 * j + 3] = t.w;
        }
        // a row's sums, then its mins: no instruction waits on the one
        // before it
#pragma unroll
        for (int i = 0; i < L::TM; ++i) {
          float sum[4 * L::NS];
#pragma unroll
          for (int j = 0; j < 4 * L::NS; ++j)
            sum[j] = relax(a[i][kk], b[j], T());
#pragma unroll
          for (int j = 0; j < 4 * L::NS; ++j)
            acc[i][j] = fminf(acc[i][j], sum[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split_k = p.ws != nullptr;
  const T* init = static_cast<const T*>(p.init);
  if (init != nullptr) init += bz * p.si;
  T* out = static_cast<T*>(p.out) + bz * p.so;
  float* ws = split_k ? p.ws + (static_cast<long long>(split) * p.batch + bz) *
                               p.m * p.n
                      : nullptr;
#pragma unroll
  for (int j = 0; j < L::NS; ++j) {
    const int gc = col0 + 4 * tx + 64 * j;
    const bool vec = !split_k && p.vec_o && gc + 3 < p.n;
    // a strip's init values are all loaded before any is stored, so their
    // reads overlap (out may be init: each element is this thread's alone)
    float4 c[L::TM];
    if (vec && init != nullptr) {
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const int gr = row0 + ty + 16 * i;
        if (gr < p.m)
          c[i] = *reinterpret_cast<const float4*>(
              init + static_cast<long long>(gr) * p.ldi + gc);
      }
    }
#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      const int gr = row0 + ty + 16 * i;
      if (gr >= p.m) continue;
      const float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                                   acc[i][4 * j + 2], acc[i][4 * j + 3]);
      if (split_k) {
        float* w = ws + static_cast<long long>(gr) * p.n + gc;
        if (gc + 3 < p.n && (p.n & 3) == 0) {
          *reinterpret_cast<float4*>(w) = v;
        } else {
          if (gc < p.n) w[0] = v.x;
          if (gc + 1 < p.n) w[1] = v.y;
          if (gc + 2 < p.n) w[2] = v.z;
          if (gc + 3 < p.n) w[3] = v.w;
        }
        continue;
      }
      T* o = out + static_cast<long long>(gr) * p.ldo + gc;
      if (vec) {
        float4 r = v;
        if (init != nullptr)
          r = make_float4(fminf(c[i].x, r.x), fminf(c[i].y, r.y),
                          fminf(c[i].z, r.z), fminf(c[i].w, r.w));
        *reinterpret_cast<float4*>(o) = r;
        continue;
      }
      const T* in = init == nullptr
                        ? nullptr
                        : init + static_cast<long long>(gr) * p.ldi + gc;
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gc + e >= p.n) continue;
        store_f(o + e, in != nullptr ? fminf(load_f(in + e), x[e]) : x[e]);
      }
    }
  }
}

// Split K's second pass, one thread per element: the min over the chunks
// in order, then the min with init.
template <typename T>
__global__ void __launch_bounds__(THREADS)
minplus_combine_kernel(const Args p, int splits) {
  const long long per = static_cast<long long>(p.m) * p.n;
  const long long total = per * p.batch;
  const long long idx =
      blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (idx >= total) return;
  const T* init = static_cast<const T*>(p.init);
  T* out = static_cast<T*>(p.out);
  const long long bz = idx / per, rem = idx - bz * per;
  const long long r = rem / p.n, c = rem - r * p.n;
  float v = p.ws[idx];
  for (int s = 1; s < splits; ++s) v = fminf(v, p.ws[s * total + idx]);
  if (init != nullptr) v = fminf(load_f(init + bz * p.si + r * p.ldi + c), v);
  store_f(out + bz * p.so + r * p.ldo + c, v);
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, int BM>
int launch(Args p, int splits, cudaStream_t s) {
  using L = Tile<BM>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      minplus_acc_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n + BM - 1) / BM, (p.m + BM - 1) / BM, p.batch * splits);
  minplus_acc_kernel<T, BM><<<grid, THREADS, L::SMEM_BYTES, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(p.batch) * p.m * p.n;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  minplus_combine_kernel<T>
      <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tile(const Args& p, int tile, int splits, cudaStream_t s) {
  if (tile == 128) return launch<T, 128>(p, splits, s);
  if (tile == 64) return launch<T, 64>(p, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  tile: 128 or 64 (the output tile's
// side).  splits >= 1: the number of k chunks, each of ceil(slices /
// splits) slices of BK (the wrapper passes a count that leaves no chunk
// empty); with splits > 1, `ws` points to splits * batch * m * n floats of
// workspace and a second kernel combines the chunks.  `init` may be null.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int minplus_acc(int dtype, int tile, int splits, const void* a,
                           const void* b, const void* init, void* out,
                           void* ws, int batch, int m, int k, int n,
                           long long sa, int lda, long long sb, int ldb,
                           long long si, int ldi, long long so, int ldo,
                           void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  const int slices = (k + BK - 1) / BK;
  if (splits < 1 || splits > slices || batch * splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (slices + splits - 1) / splits;
  const bool f32 = dtype == 0;
  Args p{a, b, init, out, splits > 1 ? static_cast<float*>(ws) : nullptr,
         batch, m, k, n, per * BK, sa, sb, si, so, lda, ldb, ldi, ldo,
         f32 && aligned16(a) && lda % 4 == 0 && (batch == 1 || sa % 4 == 0),
         f32 && aligned16(b) && ldb % 4 == 0 && (batch == 1 || sb % 4 == 0),
         f32 && aligned16(out) && ldo % 4 == 0 &&
             (batch == 1 || so % 4 == 0) &&
             (init == nullptr || (aligned16(init) && ldi % 4 == 0 &&
                                  (batch == 1 || si % 4 == 0)))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_tile<float>(p, tile, splits, s);
  if (dtype == 1) return by_tile<__nv_bfloat16>(p, tile, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
