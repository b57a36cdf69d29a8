// K2 `fw_tile`: Floyd-Warshall closure of one T x T diagonal tile (T <= 256)
// by one thread-block cluster, sequential over the T pivots:
//   for k in 0..T-1:  d = min(d, d[:, k] + d[k, :])
// with pivot row k and pivot column k read before any element of pivot k is
// updated (the plain version, ref.fw_tile_ref, takes them from the
// un-updated tile).
//
// Replaces _fw_diag_kernel of apsp_tiled_pallas in
// src/repro/kernels/minplus/kernel.py (phase 1 of the blocked
// Floyd-Warshall; the panels and the outer update are K1 `minplus_acc`).
//
// What bounds it on an H100: the pivots form a chain of T dependent steps,
// and each step is tiny (T^2 relaxations), so the floor is T x (the cost
// of handing pivot k's row and column to every thread + the relaxations
// of one step).  Device memory is touched once (one tile in, one out).
// An fp32 tile at T = 256 is 256 KiB, exactly one SM's register file, so
// one block cannot hold it without spilling.  Handing over a pivot across
// SMs costs a cluster barrier (~900 cycles on the H100) and a DSMEM read
// (~200–800 more), far more than the relaxations of a step.
//
// Design: a cluster of C CTAs on C SMs holds the tile in registers.  CTA
// c owns the R = 256 / C rows c R .. c R + R - 1; its 256 threads each own
// a 4-column group (one float4 of a row) of R / 4 consecutive rows, so a
// thread holds R floats and no element lives in shared memory.  The
// pivots go P at a time (a step), and a step crosses one cluster barrier,
// split into its arrive and its wait:
//   1. (before the arrive) the owner CTA of the step's rows has published
//      them, as pivot k finds them, into a double-buffered slot prow[s & 1]
//      of its shared memory, and in every CTA the 4 threads whose column
//      group holds the step's columns have published those columns of
//      their rows into a local slot pcol[s & 1] (one float4 store per 4
//      rows each);
//   2. wait: the CTA reads the P rows from the owner's shared memory once
//      (DSMEM, cluster.map_shared_rank; P floats a thread) into its own,
//      then a block barrier, and every thread takes its float4 of each row
//      and its column values locally;
//   3. every thread brings row and column k + m (m < P) to the state pivot
//      k + m finds them in, by the operations the sequential closure would
//      apply to them: a closure of the step's P x P block, then P (P - 1)
//      / 2 corrections of its row and column values;
//   4. it relaxes first what the next step needs -- its rows in their
//      owner, its columns in their holders -- against all P pivots and
//      publishes them into the other slots; then arrive; then it relaxes
//      the rest of its R x 4 elements while the barrier completes.  (An
//      element relaxed twice against the same candidates keeps its value.)
// One barrier per step is enough because the slots are double-buffered:
// the writes of step s + 2 come after the wait of step s + 1, which no
// thread passes before every thread has arrived there, and every thread
// has read step s before that arrive (arrive.release orders its loads).
// The pivot loop runs in groups of R / 4 pivots, unrolled, so a thread
// reads rows and columns out of its registers with compile-time indices;
// only the test "is this my row group / column group" is taken at run
// time.  C (2, 4, 8, 16) and P (1, 2, 4) are template parameters; fw_tile
// launches the pair that kernel.py's FW_TILE_CLUSTER and FW_TILE_PIVOTS
// name, chosen by timing every pair on the H100 (PERF.md): more CTAs relax
// less each, but the owner of a step's rows serves C x P KB of DSMEM
// reads; more pivots a step pay the barrier and the read's latency less
// often, for P^3 + P (P - 1) (R + 4) / 2 more relaxations a thread.  The
// last wait keeps every CTA's shared memory alive until no CTA can still
// read it.
//
// Exactness as K1: __fadd_rn, fminf; bf16 sums are rounded to bf16 before the
// min, and the tile is held in fp32, where every bf16 value is exact.  `out`
// may alias the input: every element is read before the first barrier and
// written after the last.  Rows and columns >= T are never stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TMAX = 256;
constexpr int THREADS = 256;
constexpr int JG = TMAX / 4;        // column groups of 4 (one float4)
constexpr int RG = THREADS / JG;    // row groups per CTA

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

// The two halves of a cluster barrier.  Not .aligned: the threads that
// publish a pivot diverge just before the arrive.  arrive.release orders
// every earlier load and store of the thread before it; wait.acquire
// orders every later one after the arrives of all threads of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename T, int C, int P>
__global__ void __launch_bounds__(THREADS, 1)
fw_tile_kernel(const T* in, int ldi, T* out, int ldo, int t) {
  constexpr int R = TMAX / C;       // rows per CTA
  constexpr int RPT = R / RG;       // rows per thread
  constexpr int NQ = RPT / 4;       // float4s of a thread's column slice
  static_assert(RPT % 4 == 0 && 4 % P == 0,
                "a step's pivots lie in one row group and one column group");
  // [slot: step & 1][pivot of the step][...]
  __shared__ __align__(16) float4 prow[2][P][JG];
  __shared__ __align__(16) float4 pcol[2][P][R / 4];
  __shared__ __align__(16) float rowk[P][TMAX];  // this CTA's copy of prow

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int jg = threadIdx.x % JG;
  const int rg = threadIdx.x / JG;
  const int j0 = 4 * jg;
  const int i0 = rank * R + rg * RPT;     // this thread's first row

  float v[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[r][c] = (i0 + r < t && j0 + c < t)
          ? load_f(in + (long long)(i0 + r) * ldi + j0 + c) : 0.0f;

  // Publish step 0: rows 0 .. P-1 (CTA 0, row group 0, slots 0 .. P-1) and
  // columns 0 .. P-1 (column group 0, slots 0 .. P-1) of every CTA.
  if (rank == 0 && rg == 0) {
#pragma unroll
    for (int m = 0; m < P; ++m)
      prow[0][m][jg] = make_float4(v[m][0], v[m][1], v[m][2], v[m][3]);
  }
  if (jg == 0) {
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        pcol[0][m][rg * NQ + q] = make_float4(
            v[4 * q][m], v[4 * q + 1][m], v[4 * q + 2][m], v[4 * q + 3][m]);
  }
  cluster_arrive();

  int b = 0;                            // the slots of this step
  for (int kb = 0; kb < t; kb += RPT) {
    // Pivots kb .. kb + RPT - 1, P at a time.  Row k is slot k - kb of one
    // row group of one CTA; column k is slot k % 4 of column group k / 4.
    const int owner = kb / R;
    const bool row_owner = rank == owner && rg == (kb % R) / RPT;
    const int kn = kb + RPT;           // first pivot of the next group
    const bool next_row_owner = rank == kn / R && rg == (kn % R) / RPT;
    const float* remote = cluster.map_shared_rank(
        reinterpret_cast<const float*>(&prow[0][0][0]), owner);
#pragma unroll
    for (int r = 0; r < RPT; r += P) {
      const int k = kb + r;             // this step's pivots: k .. k + np - 1
      if (k >= t) break;
      const int np = min(P, t - k);
      cluster_wait();                   // the step is published
      // The CTA reads the P rows from the owner once, P floats a thread,
      // and shares them: each row group needs the same float4s.
#pragma unroll
      for (int m = 0; m < P; ++m)
        rowk[m][threadIdx.x] = remote[(b * P + m) * TMAX + threadIdx.x];
      __syncthreads();
      float pr[P][4], pc[P][RPT];
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const float4 p = reinterpret_cast<const float4*>(rowk[m])[jg];
        pr[m][0] = p.x; pr[m][1] = p.y; pr[m][2] = p.z; pr[m][3] = p.w;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 c4 = pcol[b][m][rg * NQ + q];
          pc[m][4 * q] = c4.x; pc[m][4 * q + 1] = c4.y;
          pc[m][4 * q + 2] = c4.z; pc[m][4 * q + 3] = c4.w;
        }
      }
      // The step's pivots were published as pivot k found them.  Bring
      // pivot k + m's row and column to the state pivot k + m finds them
      // in, by the same operations on the same values as the sequential
      // closure: first the P x P block of the step (brow[q][n], bcol[q][n]
      // = d[k+q][k+n], d[k+n][k+q] as pivot k + q finds them), then the
      // thread's own part of each row and column.
      float blk[P][P], brow[P][P], bcol[P][P];
#pragma unroll
      for (int m = 0; m < P; ++m)
#pragma unroll
        for (int n = 0; n < P; ++n) blk[m][n] = rowk[m][k + n];
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int n = 0; n < P; ++n) {
          brow[q][n] = blk[q][n];
          bcol[q][n] = blk[n][q];
        }
#pragma unroll
        for (int m = 0; m < P; ++m)
#pragma unroll
          for (int n = 0; n < P; ++n)
            blk[m][n] = fminf(blk[m][n], relax(bcol[q][m], brow[q][n], T()));
      }
#pragma unroll
      for (int m = 1; m < P; ++m)
#pragma unroll
        for (int q = 0; q < m; ++q) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pr[m][c] = fminf(pr[m][c], relax(bcol[q][m], pr[q][c], T()));
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            pc[m][i] = fminf(pc[m][i], relax(pc[q][i], brow[q][m], T()));
        }
      // First what the next step needs: its rows and its columns, relaxed
      // against this step, published into the other slots.
      if (k + P < t) {                  // then this step has all P pivots
        const int r2 = (r + P) % RPT;   // rows k+P ..: slots r2 .. r2+P-1
        const int c2 = (r + P) & 3;     // columns: slots c2 .. c2+P-1
        if (r + P < RPT ? row_owner : next_row_owner) {
#pragma unroll
          for (int u = r2; u < r2 + P; ++u) {
#pragma unroll
            for (int m = 0; m < P; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[u][c] = fminf(v[u][c], relax(pc[m][u], pr[m][c], T()));
            prow[b ^ 1][u - r2][jg] =
                make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          }
        }
        if (jg == ((k + P) >> 2)) {
#pragma unroll
          for (int c = c2; c < c2 + P; ++c) {
#pragma unroll
            for (int m = 0; m < P; ++m)
#pragma unroll
              for (int i = 0; i < RPT; ++i)
                v[i][c] = fminf(v[i][c], relax(pc[m][i], pr[m][c], T()));
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              pcol[b ^ 1][c - c2][rg * NQ + q] =
                  make_float4(v[4 * q][c], v[4 * q + 1][c],
                              v[4 * q + 2][c], v[4 * q + 3][c]);
          }
        }
      }
      // The next step may start (or, after the last, the CTAs may leave);
      // the rest of this step's relaxation overlaps the barrier.  An element
      // relaxed twice against the same candidates keeps its value.
      cluster_arrive();
      b ^= 1;
#pragma unroll
      for (int m = 0; m < P; ++m) {
        if (m >= np) break;
        // (the pivot row passes through an empty volatile asm after the
        // arrive, so the compiler cannot hoist the relaxation above it)
        asm volatile("" : "+f"(pr[m][0]), "+f"(pr[m][1]), "+f"(pr[m][2]),
                     "+f"(pr[m][3]));
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[i][c] = fminf(v[i][c], relax(pc[m][i], pr[m][c], T()));
      }
    }
  }
  cluster_wait();   // no CTA leaves while another may still read its prow

#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i0 + r < t && j0 + c < t)
        store_f(out + (long long)(i0 + r) * ldo + j0 + c, v[r][c]);
}

// Back-to-back cluster barriers of a C-CTA cluster of THREADS threads
// each, as K2 runs them; with `remote`, each barrier is followed by K2's
// read of a pivot row: each thread reads one float from the shared memory
// of CTA i % C into its own, then a block barrier.  Rank 0 reports the SM
// cycles and nanoseconds they took.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
barrier_probe_kernel(int iters, int remote, long long* out) {
  __shared__ float buf[TMAX], copy[TMAX];
  cg::cluster_group cluster = cg::this_cluster();
  buf[threadIdx.x] = static_cast<float>(threadIdx.x);
  cluster_arrive();
  cluster_wait();
  long long c0 = clock64(), n0, n1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n0));
  for (int i = 0; i < iters; ++i) {
    cluster_arrive();
    cluster_wait();
    if (remote) {
      copy[threadIdx.x] = cluster.map_shared_rank(buf, i % C)[threadIdx.x];
      __syncthreads();
    }
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n1));
  cluster_arrive();
  cluster_wait();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = n1 - n0;
    out[2] = static_cast<long long>(copy[TMAX - 1]);
  }
}

template <typename... Args>
int launch_cluster(void (*kernel)(Args...), int c, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaSuccess;
  if (c > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_c(int p, const T* in, int ldi, T* out, int ldo, int t,
             cudaStream_t s) {
  switch (p) {
    case 1: return launch_cluster(fw_tile_kernel<T, C, 1>, C, s, in, ldi,
                                  out, ldo, t);
    case 2: return launch_cluster(fw_tile_kernel<T, C, 2>, C, s, in, ldi,
                                  out, ldo, t);
    case 4:
      if constexpr (C > 2)   // at C = 2 a thread's registers cannot hold it
        return launch_cluster(fw_tile_kernel<T, C, 4>, C, s, in, ldi, out,
                              ldo, t);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(int c, int p, const void* in, int ldi, void* out, int ldo, int t,
           cudaStream_t s) {
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  switch (c) {
    case 2: return launch_c<T, 2>(p, src, ldi, dst, ldo, t, s);
    case 4: return launch_c<T, 4>(p, src, ldi, dst, ldo, t, s);
    case 8: return launch_c<T, 8>(p, src, ldi, dst, ldo, t, s);
    case 16: return launch_c<T, 16>(p, src, ldi, dst, ldo, t, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cluster: 2, 4, 8 or 16 CTAs; pivots
// per barrier: 1, 2 or 4 (not 4 with 2 CTAs); 1 <= t <= 256.  Returns the
// cudaError_t of the launch (0 = cudaSuccess; a cluster the card cannot
// schedule is an error, never a smaller one).
extern "C" int fw_tile(int dtype, int cluster, int pivots, const void* in,
                       int ldi, void* out, int ldo, int t, void* stream) {
  if (t < 1 || t > TMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(cluster, pivots, in, ldi, out, ldo, t, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(cluster, pivots, in, ldi, out, ldo, t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// `iters` cluster barriers of a `cluster`-CTA cluster, each followed by
// K2's pivot-row read when `remote`; out (device, 3 int64): SM cycles and
// nanoseconds on rank 0, and a checksum.  For measuring K2's floor.
extern "C" int fw_tile_barrier_probe(int cluster, int iters, int remote,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  switch (cluster) {
    case 2: return launch_cluster(barrier_probe_kernel<2>, 2, s, iters,
                                  remote, o);
    case 4: return launch_cluster(barrier_probe_kernel<4>, 4, s, iters,
                                  remote, o);
    case 8: return launch_cluster(barrier_probe_kernel<8>, 8, s, iters,
                                  remote, o);
    case 16: return launch_cluster(barrier_probe_kernel<16>, 16, s, iters,
                                   remote, o);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
