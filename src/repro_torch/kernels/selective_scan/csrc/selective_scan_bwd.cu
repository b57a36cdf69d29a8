// K5b `selective_scan_bwd`: the backward of K5 (selective_scan.cu), per
// (batch b, channel c) and state n < N, from the cotangents dout of K5's
// output and dh_last of its last state.  With dy = dout * silu(z) (dout
// itself without the gate) and g_t = dL/dh_t:
//   g_t      = C_t[n] dy_t + exp(dt_{t+1} A) g_{t+1}, g_S = dh_last + C_S dy_S
//   d dt_t   = sum_n g_t (A exp(dt_t A) h_{t-1} + x_t B_t[n])
//   dx_t     = dt_t sum_n g_t B_t[n]  (+ D dy_t)
//   dB_t[n]  = sum_c g_t dt_t x_t,      dC_t[n] = sum_c dy_t h_t
//   dA       = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1},  dh0 = exp(dt_1 A) g_1
//   dz_t     = dout_t (y_t + D x_t) silu'(z_t),  dD = sum_{b,t} dy_t x_t
// in fp32 throughout.  Its contract is that of its plain version,
// kernels/selective_scan/ref.py: selective_scan_bwd_ref.
//
// Port-only, as K5: the JAX package differentiates its plain jnp
// _ssm_scan_chunked (src/repro/models/mamba.py:82) and the gate after it
// (:144-145) by autodiff, through the lax.associative_scan.
//
// What bounds it on an H100: at falcon-mamba-7b's training layer (B 4,
// S 1024, d 8192, N 16), gated, the backward reads dt, x, z and dout and
// writes ddt, dx and dz (7 x 134.2 MB; B_t, C_t, A, D, h0 and their
// gradients add ~6 MB): 946 MB, 0.28 ms at 3.35 TB/s.  It needs one exp
// per (b, t, c, n), 5.4e8 on the special-function units (0.14 ms), and
// ~22 fp32 operations per (b, t, c, n) (0.18 ms).  So bytes first.  This
// design adds the saved states read (134.2 MB) and the dB / dC partials
// written (2 x 33.6 MB), 1.15 GB in all (0.34 ms), and takes the decay
// twice, once to run the step forward again and once in reverse (0.26 ms
// on the SFUs).
//
// Design.  The lane split is K5's: a block is 64 channels of one batch
// row, a channel's N states split over 2 neighbouring lanes (P =
// ceil(N / 2) each), and the decay is K5's ex2.approx of a rounded
// dt * A log2 e, so the recomputed states are K5's bitwise.  Given hs, K5
// saves the state at the start of every 16-step tile of its ring, (B,
// ceil(S / 16), d, N).  K5b walks the tiles
// last to first; per tile it stages dt, x, dout (and z) for its 64
// channels and B_t, C_t in shared memory, runs the 16 steps forward again
// from the saved state with every state kept in shared memory (17 x 8 x
// 128 floats, laid out so a warp's lanes read neighbouring words) and,
// gated, the pre-gate y of each step, then walks the tile in reverse
// carrying g in registers.  Why a state every 16 steps and not every 128
// (a chunk): with 128, the 8 tile starts of a chunk would have to be
// found by a forward pass in K5b and kept on chip too (another 64 KB a
// block, one block of 128 threads an SM) or in a scratch buffer; saving
// every tile costs K5 134 MB more stores at the training layer (0.2974
// against 0.2570 ms gated, chip_smoke.py on an H100 80GB HBM3 at 700 W)
// and K5b as many loads, and keeps two blocks an SM.
//
// Its time there (the same run): 3.35 ms, 8.4% of the backward's bytes
// bound.  It runs 8 warps an SM, each lane's reverse step a chain per
// state and a 15-shuffle channel sum; fewer states on chip a lane (more
// warps) is the lever for a later change.
//
// Sums, with no atomics, so that two runs are bitwise equal.  The sums
// over n of d dt and dx are taken per lane, then across the 2 lanes.
// dB_t and dC_t sum over the d channels: per step a warp reduces its 16
// channels' 2 x 8 values at once, transposed (after shuffles at lane
// distances 16, 8, 4, 2 each lane keeps one value's full sum: 15 shuffles,
// not 64), the 4 warps' sums are added in order after the tile, and each
// block writes its partial into (B, S, d / 64, N); the wrapper sums the
// partials over the blocks (torch.sum, a fixed order).  dA and dD sum
// over the batch: each block owns its (b, channels), accumulates over
// the steps in registers and writes a partial of batch row b; the
// wrapper sums them over b.
//
// Every staged copy reads only the rows that exist (min(TILE, seqlen -
// t0)), the lesson of K5's overread (PERF.md).  Dead channels past
// d are staged as zeros, so they add nothing to the channel sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int LANES = 2;               // lanes of one channel, as K5
constexpr int CH = 64;                 // channels per block, as K5
constexpr int THREADS = CH * LANES;    // 128
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;               // K5's STATE_EVERY: steps between
                                       // its saved states (kernel.py too)
constexpr int N_MAX = 16;
constexpr int SLOTS = 16;              // dB and dC of up to 8 states a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CH % 16 == 0 && LANES == 2, "16 channels a warp, 2 lanes each");

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int N, bool GATED>
struct alignas(16) Smem {
  static constexpr int P = (N + LANES - 1) / LANES;
  static constexpr int NP = P * LANES;
  static constexpr int ROWS = GATED ? 4 : 3;   // dt, x, dout (, z)
  float seq[ROWS][TILE][CH];
  float y[GATED ? TILE : 1][CH];               // the pre-gate y of a step
  float bc[2][TILE][NP];                       // B_t, C_t; padded with 0
  float h[TILE + 1][P][THREADS];               // at the start, each step
  float red[TILE][WARPS][LANES][SLOTS];        // a warp's channel sums
};

template <int N, bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const float* __restrict__ bmat,
                          const float* __restrict__ cmat,
                          const float* __restrict__ a,
                          const float* __restrict__ hs,
                          const float* __restrict__ dskip,
                          const float* __restrict__ z,
                          const float* __restrict__ dout,
                          const float* __restrict__ dh_last,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          float* __restrict__ dz, float* __restrict__ dbp,
                          float* __restrict__ dcp, float* __restrict__ dap,
                          float* __restrict__ ddp, float* __restrict__ dh0,
                          int seqlen, int d) {
  using S = Smem<N, GATED>;
  constexpr int P = S::P, NP = S::NP, ROWS = S::ROWS;
  static_assert(P <= SLOTS / 2, "N <= 16");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid & (LANES - 1);
  const int ch = tid / LANES;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + ch;
  const int b = blockIdx.y;
  const bool live = c < d;
  const size_t row0 = static_cast<size_t>(b) * seqlen;   // row of (b, 0)
  const int ntiles = (seqlen + TILE - 1) / TILE;
  const float* const src[4] = {dt, x, dout, z};

  if constexpr (NP > N) {      // padded states read B = C = 0
    for (int i = tid; i < 2 * TILE * (NP - N); i += THREADS) {
      const int col = N + i % (NP - N), rest = i / (NP - N);
      (&sm.bc[0][0][0])[rest * NP + col] = 0.f;
    }
  }
  const size_t state = (static_cast<size_t>(b) * d + c) * N;
  float av[P], a2[P], gs[P], da[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g * P + p;
    const bool on = live && n < N;
    av[p] = on ? __ldg(a + static_cast<size_t>(c) * N + n) : 0.f;
    a2[p] = av[p] * LOG2E;
    gs[p] = (on && dh_last != nullptr) ? __ldg(dh_last + state + n) : 0.f;
    da[p] = 0.f;
  }
  const float dd = (GATED && live) ? __ldg(dskip + c) : 0.f;
  float dsum = 0.f;

  for (int kt = ntiles - 1; kt >= 0; --kt) {
    const int t0 = kt * TILE;
    const int steps = min(TILE, seqlen - t0);
    __syncthreads();           // every lane is done with the last tile
    for (int k = 0; k < ROWS; ++k)
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int j = i / CH, q = i % CH;
        sm.seq[k][j][q] = c0 + q < d
            ? __ldg(src[k] + (row0 + t0 + j) * d + c0 + q) : 0.f;
      }
    for (int i = tid; i < steps * N; i += THREADS) {
      const int j = i / N, n = i - j * N;
      sm.bc[0][j][n] = __ldg(bmat + (row0 + t0) * N + i);
      sm.bc[1][j][n] = __ldg(cmat + (row0 + t0) * N + i);
    }
    const float* from = hs + ((static_cast<size_t>(b) * ntiles + kt) * d
                              + c) * N;
#pragma unroll
    for (int p = 0; p < P; ++p)
      sm.h[0][p][tid] = (live && g * P + p < N) ? __ldg(from + g * P + p)
                                                : 0.f;
    __syncthreads();

    // the tile forward again from its saved state, as K5 steps it
    {
      float h[P];
#pragma unroll
      for (int p = 0; p < P; ++p) h[p] = sm.h[0][p][tid];
      for (int j = 0; j < steps; ++j) {
        const float dtv = sm.seq[0][j][ch];
        const float dxv = dtv * sm.seq[1][j][ch];
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float decay = ex2(dtv * a2[p]);
          h[p] = fmaf(decay, h[p], dxv * sm.bc[0][j][g * P + p]);
          acc = fmaf(h[p], sm.bc[1][j][g * P + p], acc);
          sm.h[j + 1][p][tid] = h[p];
        }
        if constexpr (GATED) {
          const float yv = acc + __shfl_xor_sync(FULL, acc, 1);
          if (g == 0) sm.y[j][ch] = yv;
        }
      }
    }
    __syncwarp();              // a channel's y is read by both its lanes

    // the tile in reverse, carrying g
    for (int j = steps - 1; j >= 0; --j) {
      const float dtv = sm.seq[0][j][ch];
      const float xv = sm.seq[1][j][ch];
      const float dov = sm.seq[2][j][ch];
      float dy = dov, dzv = 0.f;
      if constexpr (GATED) {
        const float zv = sm.seq[3][j][ch];
        const float sig = 1.f / (1.f + __expf(-zv));
        const float yg = __fadd_rn(sm.y[j][ch], __fmul_rn(dd, xv));
        dy = dov * (zv * sig);
        dzv = dov * yg * (sig * (1.f + zv * (1.f - sig)));
        dsum = fmaf(dy, xv, dsum);
      }
      const float dxv = dtv * xv;
      float v[SLOTS];
      float sdt = 0.f, sdx = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float bv = sm.bc[0][j][g * P + p];
        const float cv = sm.bc[1][j][g * P + p];
        const float decay = ex2(dtv * a2[p]);
        const float gt = fmaf(cv, dy, gs[p]);
        const float dprev = decay * sm.h[j][p][tid];
        v[p] = gt * dxv;                                    // dB_t
        v[SLOTS / 2 + p] = dy * sm.h[j + 1][p][tid];        // dC_t
        sdt = fmaf(gt, fmaf(av[p], dprev, xv * bv), sdt);
        sdx = fmaf(gt, bv, sdx);
        da[p] = fmaf(gt * dtv, dprev, da[p]);
        gs[p] = decay * gt;
      }
#pragma unroll
      for (int p = P; p < SLOTS / 2; ++p) v[p] = v[SLOTS / 2 + p] = 0.f;
      sdt += __shfl_xor_sync(FULL, sdt, 1);
      sdx += __shfl_xor_sync(FULL, sdx, 1);
      // the warp's 16 channels summed, transposed: at lane distance m a
      // lane keeps the half of its w values that bit m picks and adds its
      // partner's sums of them; lane 2 i + g ends with value i's sum
#pragma unroll
      for (int m = 16, w = SLOTS; m >= LANES; m /= 2, w /= 2) {
        const bool hi = lane & m;
#pragma unroll
        for (int i = 0; i < w / 2; ++i) {
          const float keep = hi ? v[i + w / 2] : v[i];
          const float send = hi ? v[i] : v[i + w / 2];
          v[i] = keep + __shfl_xor_sync(FULL, send, m);
        }
      }
      sm.red[j][warp][g][(lane >> 1) & (SLOTS - 1)] = v[0];
      if (live) {
        const size_t o = (row0 + t0 + j) * d + c;
        if (g == 0) {
          ddt[o] = sdt;
          if constexpr (GATED) dz[o] = dzv;
        } else {
          dx[o] = GATED ? fmaf(dd, dy, dtv * sdx) : dtv * sdx;
        }
      }
    }
    __syncthreads();
    // this block's partials of dB_t and dC_t: its warps' sums in order
    for (int i = tid; i < steps * 2 * N; i += THREADS) {
      const int j = i / (2 * N), r = i - j * 2 * N;
      const int which = r / N, n = r - which * N;
      const int gn = n / P, p = n - gn * P;
      float sum = sm.red[j][0][gn][which * (SLOTS / 2) + p];
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        sum += sm.red[j][w][gn][which * (SLOTS / 2) + p];
      (which ? dcp : dbp)[((row0 + t0 + j) * gridDim.x + blockIdx.x) * N
                          + n] = sum;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g * P + p;
    if (live && n < N) {
      dh0[state + n] = gs[p];
      dap[state + n] = da[p];
    }
  }
  if (GATED && live && g == 0) ddp[static_cast<size_t>(b) * d + c] = dsum;
}

using KernelPtr = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*,
                           float*, float*, float*, float*, int, int);

template <bool GATED, int... I>
KernelPtr instance(int n, std::integer_sequence<int, I...>) {
  KernelPtr k = nullptr;
  ((k = (n == I + 1) ? &selective_scan_bwd_kernel<I + 1, GATED> : k), ...);
  return k;
}

template <bool GATED, int... I>
size_t smem_size(int n, std::integer_sequence<int, I...>) {
  size_t bytes = 0;
  ((bytes = (n == I + 1) ? sizeof(Smem<I + 1, GATED>) : bytes), ...);
  return bytes;
}

}  // namespace

// dt, x, dout: (batch, seqlen, d); bmat, cmat: (batch, seqlen, n); a:
// (d, n); hs: (batch, ceil(seqlen / 16), d, n), K5's saved states (from
// selective_scan given hs); dh_last: (batch, d, n) or null (zero); dskip
// (d,) and z (batch, seqlen, d), both given or both null -- all
// contiguous fp32.  Writes ddt, dx (and, gated, dz): (batch, seqlen, d);
// dbp, dcp: (batch, seqlen, blocks, n), the partial sums of each block of
// 64 channels; dap: (batch, d, n) and (gated) ddp: (batch, d), the
// partial sums of each batch row; dh0: (batch, d, n).  ``blocks`` must be
// ceil(d / 64).  1 <= n <= 16.  Returns the launch's cudaError_t.
extern "C" int selective_scan_bwd(
    const void* dt, const void* x, const void* bmat, const void* cmat,
    const void* a, const void* hs, const void* dskip, const void* z,
    const void* dout, const void* dh_last, void* ddt, void* dx, void* dz,
    void* dbp, void* dcp, void* dap, void* ddp, void* dh0, int batch,
    int seqlen, int d, int n, int blocks, void* stream) {
  const bool gated = dskip != nullptr;
  if (batch < 1 || batch > 65535 || seqlen < 1 || d < 1 || n < 1 ||
      n > N_MAX || blocks != (d + CH - 1) / CH || gated != (z != nullptr) ||
      gated != (dz != nullptr) || gated != (ddp != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto seq = std::make_integer_sequence<int, N_MAX>();
  const KernelPtr k = gated ? instance<true>(n, seq)
                            : instance<false>(n, seq);
  const int smem = static_cast<int>(
      gated ? smem_size<true>(n, seq) : smem_size<false>(n, seq));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(blocks, batch);
  k<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat),
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(dskip), static_cast<const float*>(z),
      static_cast<const float*>(dout), static_cast<const float*>(dh_last),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dz), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(dap),
      static_cast<float*>(ddp), static_cast<float*>(dh0), seqlen, d);
  return static_cast<int>(cudaGetLastError());
}
