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
// written (2 x 16.8 MB at 128 channels a block), 1.11 GB in all (0.33
// ms), and takes the decay twice, once to run a step forward again and
// once in reverse (0.26 ms on the SFUs).  What it spends most is issue
// slots: a lane issues ~130 instructions a step for its 4 states (~15
// fp32 operations and 2 exps a state, the channel sums of dB and dC by
// warp shuffles, the lane sums of y, d dt and dx, the shared-memory loads
// of a step), ~0.55 ms of the SMs' issue slots; the copies and the stores
// overlap them but for ~0.1 ms each.
//
// Design.  Given hs, K5 saves the state at the start of every 16-step
// tile (STATE_EVERY), (B, ceil(S / 16), d, N).  K5b walks the tiles last
// to first.  A block is CH channels of one batch row, a channel's states
// split over LANES neighbouring lanes, P = N / LANES (rounded up to a
// power of two) each: state n = g P + p on lane g.  For each tile:
//   * staging: dt, x, dout (and z) for the block's channels, B_t, C_t and
//     the tile's saved states come through a two-stage shared-memory ring
//     filled by cp.async (16-byte copies when d and the pointers allow),
//     so tile kt - 1 is in flight while tile kt is computed and the one
//     barrier a tile waits on no load.  Every copy reads only rows and
//     channels that exist (the lesson of K5's overread, PERF.md); dead
//     channels past d and a ragged last tile's missing steps are zeros.
//   * gated, each lane first takes dy = dout silu(z) for TILE / LANES of
//     the tile's steps into shared memory, and its share of dD.
//   * forward: each lane runs its P states through the 16 steps again
//     from the saved state, as K5 steps them (decay = ex2.approx of the
//     rounded dt A log2 e, h = fma(decay, h, dt x B)), so the states are
//     K5's bitwise, and keeps the 16 states before each step in
//     registers (16 P floats; the loops are unrolled over the tile).  In
//     the same pass it forms dy h (dC) and, gated, y: y is summed over the
//     channel's lanes transposed over LANES steps, so lane g ends with
//     step j0 + g's y and stores that step's dz.
//   * reverse: the 16 steps last to first, g carried in registers; per
//     state one ex2, and the sums over n of d dt and dx as two per-lane
//     partials, summed over the lanes transposed like y, so lane g stores
//     step j0 + g's ddt and dx.
// A zero step (dt = x = dout = 0, B = C = 0) leaves the state, g, dA and
// dD unchanged bit for bit (decay = ex2(0) = 1, every added term 0), so a
// ragged last tile is staged as zero steps and run whole: no step
// branches, only the stores are masked.  N is a template parameter (1..16);
// states past N are padded with zeros (A = B = C = h = 0).
//
// Sums, with no atomics, so that two runs are bitwise equal.  dB_t and
// dC_t sum over the d channels: a warp covers 32 / LANES channels, and
// per group of steps that gives each lane as many values as the warp has
// channels (2 steps x 4 states at LANES = 4), a transposed shuffle
// reduction leaves each lane one full sum (7 shuffles for 8 values), the
// warps' sums go to shared memory, and after the next tile's barrier
// they are added in warp order and each block writes its partial into
// (B, S, ceil(d / CH), N); the wrapper sums the partials over the blocks
// (torch.sum, a fixed order).  dA and dD sum over the batch: each block
// owns its (b, channels), accumulates over the steps in registers and
// writes a partial of batch row b; the wrapper sums them over b.
//
// Why these choices (tools/torch_k5_variants.py --bwd builds each K5B_*
// value and probe and times it against the others at falcon's training
// layer, gated; H100 80GB HBM3 at 700 W, PERF.md §6): 0.98 ms shipped,
// against 3.28 ms for the first version in the same call (a tile's
// states in shared memory, two blocks of 4 warps an SM, tiles staged by
// plain loads behind a barrier, 15 shuffles a step for dB / dC).  4 lanes
// x 4 states take 128 registers, no spills, and run 16 warps an SM; 8
// lanes x 2 states (80 registers, 24 warps) take 1.62 ms, their loads,
// sums and stores covering half as many states, and 4 x 4 held to 85
// registers (24 warps) spills and takes 1.59 ms.  128 channels a block
// (one block of 16 warps an SM) beat 64 (two of 8) by 0.5-1.2% and halve
// the partials.  Probes: the per-state arithmetic costs ~0.32 ms, the dB
// / dC sums ~0.16 ms, the copies ~0.11 ms, the stores ~0.09 ms; a
// one-stage ring costs 11% at one block an SM.  Sums without selects (each lane's
// states in an order that pairs them across lanes, B_t / C_t staged in 4
// orders) were 3.7% slower and spilled: the shuffles, not the selects,
// are the sums' cost.  ddt, dx and dz staged in the ring's slots and
// written as whole 16-byte rows were 0.8% slower than each lane storing
// its own 32-byte runs.  The gate's sigmoid by
// __fdividef saved 1.2% but spilled 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

// The design's constants; tools/torch_k5_variants.py builds other values
// with -D to time them against these.
#ifndef K5B_LANES              // lanes of one channel: 2, 4 or 8
#define K5B_LANES 4
#endif
#ifndef K5B_CH                 // channels a block (kernel.py's BWD_CH)
#define K5B_CH 128
#endif
#ifndef K5B_OCC                // threads an SM to bound registers for
#define K5B_OCC 512
#endif
#ifndef K5B_STAGES             // 2: the cp.async ring; 1: each tile copied
#define K5B_STAGES 2           // and waited for before it is used
#endif
#ifndef K5B_PROBE              // probes, whose outputs are not gradients:
#define K5B_PROBE 0            // 1 no channel sums of dB / dC, 2 no
#endif                         // per-state arithmetic, 3 ddt / dx / dz
                               // computed but not stored, 4 no tile
                               // copied after the first two

constexpr int LANES = K5B_LANES;
constexpr int CH = K5B_CH;
constexpr int THREADS = CH * LANES;    // 512
constexpr int WARPS = THREADS / 32;
constexpr int CPW = 32 / LANES;        // channels a warp
constexpr int SROW = CH + CPW;         // a staged row, padded so that a
                                       // warp's LANES steps x CPW channels
                                       // fall in 32 banks
constexpr int TILE = 16;               // K5's STATE_EVERY: steps between
                                       // its saved states (kernel.py too)
constexpr int STAGES = K5B_STAGES;
constexpr int OCC = K5B_OCC;
constexpr int N_MAX = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert((LANES == 2 || LANES == 4 || LANES == 8) && CH % CPW == 0 &&
              THREADS % 32 == 0 && THREADS <= 1024 && CH % 4 == 0,
              "LANES 2, 4 or 8; whole warps of channels");
static_assert(STAGES == 1 || STAGES == 2, "a ring of one or two stages");

constexpr int pow2ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Sums v over the lanes that differ in lane bits HI down to LO (powers of
// two), transposed: at bit m a lane keeps the half of its values that its
// bit m picks and adds its partner's sums of that half, so of W = K x
// 2 HI / LO values the lane ends with the K of block (its bits HI..LO read
// as a number), each summed over the 2 HI / LO lanes.
template <int W, int K, int HI, int LO>
__device__ __forceinline__ void tsum(float (&v)[W], int lane) {
  static_assert(W == K * (2 * HI / LO), "one halving a lane bit");
#pragma unroll
  for (int m = HI, w = W; m >= LO; m /= 2, w /= 2) {
    const bool hi = lane & m;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float keep = hi ? v[i + w / 2] : v[i];
      const float send = hi ? v[i] : v[i + w / 2];
      v[i] = keep + __shfl_xor_sync(FULL, send, m);
    }
  }
}

template <int P>
__device__ __forceinline__ void lds(float (&v)[P], const float* s) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int p = 0; p < P; p += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + p);
      v[p] = q.x; v[p + 1] = q.y; v[p + 2] = q.z; v[p + 3] = q.w;
    }
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = s[0];
  }
}

// The ring (per stage: dt, x, dout (, z) for TILE steps x CH channels,
// B_t and C_t padded to NP states, the tile's saved states as hs holds
// them), dy of the tile (gated), and the warps' dB / dC sums of a tile,
// two buffers so that one tile's are added while the next is computed.
template <int N, bool GATED>
struct alignas(16) Smem {
  static constexpr int P = pow2ceil((N + LANES - 1) / LANES);
  static constexpr int NP = P * LANES;
  static constexpr int ROWS = GATED ? 4 : 3;
  static constexpr int HROW = (CH * N + 3) / 4 * 4;
  float seq[STAGES][ROWS][TILE][SROW];
  float bc[STAGES][2][TILE][NP];
  float h0[STAGES][HROW];
  float dy[GATED ? TILE : 1][SROW];
  float red[2][TILE][WARPS][2 * N];
};

// Queue the copies of tile rows [row, row + steps) into ``stage``: dt, x,
// dout (, z) of the block's cn live channels from c0, B_t, C_t, and the
// cn x N saved states at ``h``.
template <int N, bool GATED>
__device__ __forceinline__ void load_tile(
    Smem<N, GATED>& sm, int stage, const float* const (&seq)[4],
    const float* bmat, const float* cmat, const float* h, size_t row,
    int steps, int c0, int cn, int d, bool vec) {
  constexpr int ROWS = Smem<N, GATED>::ROWS;
  const int tid = threadIdx.x;
  if (vec) {               // d % 4 == 0 and the pointers 16-byte aligned
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      for (int i = tid; i < steps * (CH / 4); i += THREADS) {
        const int s = i / (CH / 4), q = 4 * (i % (CH / 4));
        if (q < cn)
          cp_async16(&sm.seq[stage][k][s][q],
                     seq[k] + (row + s) * d + c0 + q);
      }
    for (int i = tid; i < cn * N / 4; i += THREADS)
      cp_async16(&sm.h0[stage][4 * i], h + 4 * i);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int s = i / CH, q = i % CH;
        if (q < cn)
          cp_async4(&sm.seq[stage][k][s][q], seq[k] + (row + s) * d + c0 + q);
      }
    for (int i = tid; i < cn * N; i += THREADS)
      cp_async4(&sm.h0[stage][i], h + i);
  }
  for (int i = tid; i < steps * N; i += THREADS) {
    const int s = i / N, n = i - s * N;
    cp_async4(&sm.bc[stage][0][s][n], bmat + row * N + i);
    cp_async4(&sm.bc[stage][1][s][n], cmat + row * N + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N, bool GATED>
__global__ void __launch_bounds__(THREADS, OCC / THREADS)
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
                          int seqlen, int d, int vec) {
  using S = Smem<N, GATED>;
  constexpr int P = S::P, NP = S::NP, ROWS = S::ROWS;
  constexpr int GS = CPW / P;          // steps of one dB / dC shuffle sum
  static_assert(P <= CPW && TILE % GS == 0 && TILE % LANES == 0,
                "whole groups of steps in a tile");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid & (LANES - 1);
  const int ch = tid / LANES;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + ch;
  const int cn = min(CH, d - c0);      // live channels of the block
  const int b = blockIdx.y;
  const bool live = c < d;
  const size_t row0 = static_cast<size_t>(b) * seqlen;   // row of (b, 0)
  const int ntiles = (seqlen + TILE - 1) / TILE;
  const int last = seqlen - (ntiles - 1) * TILE;         // its real steps
  const float* const seq[4] = {dt, x, dout, z};
  const float* const hs_b =
      hs + (static_cast<size_t>(b) * ntiles * d + c0) * N;
  const size_t hs_tile = static_cast<size_t>(d) * N;     // a tile's states

  if constexpr (STAGES == 2)
    load_tile<N, GATED>(sm, 0, seq, bmat, cmat, hs_b + (ntiles - 1) * hs_tile,
                        row0 + (ntiles - 1) * TILE, last, c0, cn, d,
                        vec != 0);
  // zeros that no copy overwrites: dead channels, padded states, and the
  // steps missing from the last tile (the first walked, in stage 0)
  if (cn < CH) {
    for (int i = tid; i < STAGES * ROWS * TILE * (CH - cn); i += THREADS)
      (&sm.seq[0][0][0][0])[i / (CH - cn) * SROW + cn + i % (CH - cn)] = 0.f;
    for (int i = tid; i < STAGES * (CH - cn) * N; i += THREADS)
      sm.h0[i / ((CH - cn) * N)][cn * N + i % ((CH - cn) * N)] = 0.f;
  }
  if constexpr (NP > N) {
    for (int i = tid; i < STAGES * 2 * TILE * (NP - N); i += THREADS)
      (&sm.bc[0][0][0][0])[i / (NP - N) * NP + N + i % (NP - N)] = 0.f;
  }
  if (last < TILE) {
    const int gap = TILE - last;
    for (int i = tid; i < ROWS * gap * CH; i += THREADS) {
      const int r = i / CH;
      sm.seq[0][r / gap][last + r % gap][i % CH] = 0.f;
    }
    for (int i = tid; i < 2 * gap * N; i += THREADS) {
      const int r = i / N;
      sm.bc[0][r / gap][last + r % gap][i % N] = 0.f;
    }
  }

  const size_t state = (static_cast<size_t>(b) * d + c) * N;
  float a2[P], gs[P], da[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g * P + p;
    const bool on = live && n < N;
    a2[p] = on ? __ldg(a + static_cast<size_t>(c) * N + n) * LOG2E : 0.f;
    gs[p] = (on && dh_last != nullptr) ? __ldg(dh_last + state + n) : 0.f;
    da[p] = 0.f;
  }
  const float dd = (GATED && live) ? __ldg(dskip + c) : 0.f;
  float dsum = 0.f;

  // this block's partials of dB_t and dC_t for tile kt: the warps' sums
  // from red[kt & 1], in warp order
  auto partials = [&](int kt) {
    const int steps = min(TILE, seqlen - kt * TILE);
    const float(*red)[WARPS][2 * N] = sm.red[kt & 1];
    for (int i = tid; i < steps * 2 * N; i += THREADS) {
      const int j = i / (2 * N), r = i - j * 2 * N;
      float sum = red[j][0][r];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += red[j][w][r];
      const int n = r < N ? r : r - N;
      (r < N ? dbp : dcp)[((row0 + kt * TILE + j) * gridDim.x + blockIdx.x)
                          * N + n] = sum;
    }
  };

  for (int kt = ntiles - 1, it = 0; kt >= 0; --kt, ++it) {
    const int stage = STAGES == 2 ? (it & 1) : 0;
    const int t0 = kt * TILE;
    if constexpr (STAGES == 2) {
      // tile kt is in and, after the barrier, every lane is done with tile
      // kt + 1: its partials are summed and its stage refilled with tile
      // kt - 1 (red[kt & 1] was last read for tile kt + 2)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (kt + 1 < ntiles) partials(kt + 1);
      if (kt > 0 && (K5B_PROBE != 4 || it == 0))
        load_tile<N, GATED>(sm, stage ^ 1, seq, bmat, cmat,
                            hs_b + (kt - 1) * hs_tile, row0 + t0 - TILE,
                            TILE, c0, cn, d, vec != 0);
    } else {
      __syncthreads();
      if (kt + 1 < ntiles) partials(kt + 1);
      load_tile<N, GATED>(sm, 0, seq, bmat, cmat, hs_b + kt * hs_tile,
                          row0 + t0, min(TILE, seqlen - t0), c0, cn, d,
                          vec != 0);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }

    const float(*rows)[TILE][SROW] = sm.seq[stage];
    const float(*bcs)[TILE][NP] = sm.bc[stage];
    const float(*dyr)[SROW] = GATED ? sm.dy : sm.seq[stage][2];
    float(*red)[WARPS][2 * N] = sm.red[kt & 1];

    if constexpr (GATED) {       // dy of steps g, g + LANES, ...; dD
#pragma unroll
      for (int i = 0; i < TILE / LANES; ++i) {
        const int j = i * LANES + g;
        const float zv = rows[3][j][ch];
        const float sig = 1.f / (1.f + __expf(-zv));
        const float dyv = rows[2][j][ch] * (zv * sig);
        sm.dy[j][ch] = dyv;
        dsum = fmaf(dyv, rows[1][j][ch], dsum);
      }
      __syncwarp();              // a channel's dy is read by all its lanes
    }

    // the tile forward again from its saved state, as K5 steps it: the
    // states before each step kept, dC and (gated) y and dz on the way
    float h[TILE][P];
    if constexpr (NP == N) {
      lds<P>(h[0], &sm.h0[stage][ch * N + g * P]);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
        h[0][p] = g * P + p < N ? sm.h0[stage][ch * N + g * P + p] : 0.f;
    }
    float vc[GS * P], part[LANES];
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float dtv = rows[0][j][ch];
      const float dxv = dtv * rows[1][j][ch];
      const float dyv = dyr[j][ch];
      float bv[P], cv[P];
      lds<P>(bv, &bcs[0][j][g * P]);
      lds<P>(cv, &bcs[1][j][g * P]);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if constexpr (K5B_PROBE == 2) {
          if (j + 1 < TILE) h[j + 1][p] = h[j][p];
          vc[(j % GS) * P + p] = dyv;
          acc = dxv;
        } else {
          const float hn = fmaf(ex2(dtv * a2[p]), h[j][p], dxv * bv[p]);
          if (j + 1 < TILE) h[j + 1][p] = hn;
          acc = fmaf(hn, cv[p], acc);
          vc[(j % GS) * P + p] = dyv * hn;
        }
      }
      part[j % LANES] = acc;
      if (j % GS == GS - 1) {    // dC of the group, summed over the warp
        if constexpr (K5B_PROBE != 1) tsum<GS * P, 1, 16, LANES>(vc, lane);
        const int idx = lane / LANES, n = g * P + idx % P;
        if (n < N) red[j - (GS - 1) + idx / P][warp][N + n] = vc[0];
      }
      if constexpr (GATED) {
        if (j % LANES == LANES - 1) {   // lane g: y, then dz, of step jj
          tsum<LANES, 1, LANES / 2, 1>(part, lane);
          const int jj = j - (LANES - 1) + g;
          const float xv = rows[1][jj][ch], zv = rows[3][jj][ch];
          const float sig = 1.f / (1.f + __expf(-zv));
          const float yg = __fadd_rn(part[0], __fmul_rn(dd, xv));
          if ((K5B_PROBE == 3 ? vec < 0 : live) && t0 + jj < seqlen)
            dz[(row0 + t0 + jj) * d + c] =
                rows[2][jj][ch] * yg * (sig * (1.f + zv * (1.f - sig)));
        }
      }
    }

    // the tile in reverse, carrying g
    float vb[GS * P], sv[2 * LANES];
#pragma unroll
    for (int j = TILE - 1; j >= 0; --j) {
      const float dtv = rows[0][j][ch];
      const float dxv = dtv * rows[1][j][ch];
      const float dyv = dyr[j][ch];
      float bv[P], cv[P];
      lds<P>(bv, &bcs[0][j][g * P]);
      lds<P>(cv, &bcs[1][j][g * P]);
      float sa = 0.f, sb = 0.f;  // sum_n g A log2(e) decay h, sum_n g B
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if constexpr (K5B_PROBE == 2) {
          vb[(j % GS) * P + p] = dxv;
          sa = dtv;
          sb = dyv;
        } else {
          const float decay = ex2(dtv * a2[p]);
          const float gt = fmaf(cv[p], dyv, gs[p]);
          const float gd = gt * (decay * h[j][p]);
          da[p] = fmaf(dtv, gd, da[p]);
          sa = fmaf(a2[p], gd, sa);
          sb = fmaf(gt, bv[p], sb);
          vb[(j % GS) * P + p] = gt * dxv;                  // dB_t
          gs[p] = decay * gt;
        }
      }
      sv[2 * (j % LANES)] = sa;
      sv[2 * (j % LANES) + 1] = sb;
      if (j % GS == 0) {         // dB of the group, summed over the warp
        if constexpr (K5B_PROBE != 1) tsum<GS * P, 1, 16, LANES>(vb, lane);
        const int idx = lane / LANES, n = g * P + idx % P;
        if (n < N) red[j + idx / P][warp][n] = vb[0];
      }
      if (j % LANES == 0) {      // lane g: ddt and dx of step jj
        tsum<2 * LANES, 2, LANES / 2, 1>(sv, lane);
        const int jj = j + g;
        const float dtj = rows[0][jj][ch], xj = rows[1][jj][ch];
        if ((K5B_PROBE == 3 ? vec < 0 : live) && t0 + jj < seqlen) {
          const size_t o = (row0 + t0 + jj) * d + c;
          ddt[o] = fmaf(xj, sv[1], LN2 * sv[0]);
          dx[o] = GATED ? fmaf(dd, dyr[jj][ch], dtj * sv[1]) : dtj * sv[1];
        }
      }
    }
  }
  __syncthreads();
  partials(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g * P + p;
    if (live && n < N) {
      dh0[state + n] = gs[p];
      dap[state + n] = da[p];
    }
  }
  if constexpr (GATED) {
#pragma unroll
    for (int m = 1; m < LANES; m *= 2) dsum += __shfl_xor_sync(FULL, dsum, m);
    if (live && g == 0) ddp[static_cast<size_t>(b) * d + c] = dsum;
  }
}

using KernelPtr = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*,
                           float*, float*, float*, float*, int, int, int);

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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The instance for (n, gated), its shared memory set as its dynamic
// limit; null for an n the kernel is not built for.
KernelPtr prepare(int n, bool gated, int* smem) {
  if (n < 1 || n > N_MAX) return nullptr;
  const auto seq = std::make_integer_sequence<int, N_MAX>();
  const KernelPtr k = gated ? instance<true>(n, seq)
                            : instance<false>(n, seq);
  *smem = static_cast<int>(gated ? smem_size<true>(n, seq)
                                 : smem_size<false>(n, seq));
  if (*smem > 48 * 1024 &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem) != cudaSuccess)
    return nullptr;
  return k;
}

}  // namespace

// dt, x, dout: (batch, seqlen, d); bmat, cmat: (batch, seqlen, n); a:
// (d, n); hs: (batch, ceil(seqlen / 16), d, n), K5's saved states (from
// selective_scan given hs); dh_last: (batch, d, n) or null (zero); dskip
// (d,) and z (batch, seqlen, d), both given or both null -- all
// contiguous fp32.  Writes ddt, dx (and, gated, dz): (batch, seqlen, d);
// dbp, dcp: (batch, seqlen, blocks, n), the partial sums of each block of
// K5B_CH channels; dap: (batch, d, n) and (gated) ddp: (batch, d), the
// partial sums of each batch row; dh0: (batch, d, n).  ``blocks`` must be
// ceil(d / K5B_CH).  1 <= n <= 16.  Returns the launch's cudaError_t.
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
  int smem = 0;
  const KernelPtr k = prepare(n, gated, &smem);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && aligned16(dt) && aligned16(x) &&
                  aligned16(dout) && aligned16(hs) &&
                  (!gated || aligned16(z));
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
      static_cast<float*>(ddp), static_cast<float*>(dh0), seqlen, d, vec);
  return static_cast<int>(cudaGetLastError());
}

// What the instance for (n, gated) gets on the current device: out[0]
// blocks an SM (the occupancy calculator's), out[1] threads a block,
// out[2] dynamic shared memory a block (bytes), out[3] registers a
// thread, out[4] local memory a thread (bytes: spills), out[5] channels a
// block (K5B_CH).  Returns a cudaError_t.
extern "C" int selective_scan_bwd_info(int n, int gated, int* out) {
  int smem = 0;
  const KernelPtr k = prepare(n, gated != 0, &smem);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, THREADS,
                                                      smem);
  out[1] = THREADS;
  out[2] = smem;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = CH;
  return static_cast<int>(err);
}
