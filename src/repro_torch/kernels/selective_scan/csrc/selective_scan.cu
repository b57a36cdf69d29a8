// K5 `selective_scan`: Mamba1's selective-scan recurrence over a whole
// sequence, per (batch b, channel c) and state index n < N,
//   h_t[n] = exp(dt_t * A[c, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n C_t[n] * h_t[n]
// from h0, in fp32 throughout; it returns y and the last state.  Given D
// and z it writes Mamba1's gated output in place of y,
//   out_t  = (y_t + D[c] * x_t) * silu(z_t),
// the two lines that follow the scan in src/repro/models/mamba.py:144-145,
// in their order.  Its contract is that of the plain versions it is held
// to (kernels/selective_scan/ref.py: selective_scan_ref and
// selective_scan_gated_ref).
//
// Port-only: the JAX package has no Pallas kernel here.  It replaces the
// plain jnp _ssm_scan_chunked of src/repro/models/mamba.py:82, which runs
// a lax.associative_scan inside a lax.scan over chunks of 128 steps
// because the TPU has no recurrent kernel: log-depth passes over
// (B, 128, d, N) decay and drive tensors, ~50 of them a chunk.  On a GPU
// the recurrence is one pass with the state in registers.  The decode
// step calls it at S = 1 with the cache's state as h0.
//
// What bounds it on an H100: at falcon-mamba-7b's prefill (B 8, S 1024,
// d 8192, N 16) it takes 1.07e9 exps, one per (b, t, c, n), on the
// special-function units (MUFU), 16 per SM a clock: ~0.26 ms.  Scan-only
// it moves dt and x in and y out, 805 MB (0.24 ms at 3.35 TB/s); gated,
// z as well, 1.07 GB (0.32 ms).  So the scan sits where the MUFU and the
// bytes meet, and the gated kernel on the bytes.
//
// Design.  A channel's N states are split over LANES = 2 neighbouring
// lanes, P = ceil(N / 2) states each (state n = g * P + p on lane g); a
// block is 64 channels (128 threads) of one batch row.  Per step a lane
// does, per state, one FMUL (dt * A log2 e), one MUFU ex2.approx (the
// decay), one FMUL (dx * B) and two FFMAs (the state, its share of y):
// A * log2(e) is kept per state in registers, so the decay is one FMUL and
// one MUFU instead of expf's range reduction of ~8 instructions.  The
// lanes' partial sums of y are reduced over LANES steps at once,
// transposed: after a shuffle-xor each lane keeps one step's full sum and
// stores it (one shuffle and one add per 2 steps, not 2 and 2), so a
// warp's stores fill whole 32-byte sectors.  Everything a step reads -- dt, x
// (and z) for the block's 64 channels, B_t and C_t -- comes through a
// two-stage shared-memory ring of TILE = 16 steps filled by cp.async
// (16-byte copies when d and the pointers allow): the next tile is in
// flight while this one is used, so the one barrier per tile waits on no
// load, and a lane reads its 8 values of B_t and of C_t as two float4s.
// N is a template parameter (1..16); states past N are padded with zeros
// (A = B = C = h0 = 0).
//
// Why these choices (tools/torch_k5_variants.py builds each with its
// -D K5_* macros and times it against the others at falcon's prefill
// shape, scan-only / gated, on an H100 80GB HBM3 at 700 W): shipped
// 0.41 / 0.48 ms.  With the math cut out, the copies, barrier and stores
// take 0.32 / 0.44 ms; with the tiles not reloaded, the math takes 0.37 /
// 0.40 ms; an FFMA in the MUFU's place saves 11%.  Each lane walks its
// states in order, so a step's LDS -> FMUL -> MUFU -> FFMA chain is
// hidden only by the lane's other states and the other warps: 4 lanes x
// 4 states (64 registers, 2 waves of 32 warps an SM) take 0.49 / 0.56 ms,
// 1 lane x 16 states (128 registers, one wave of 16 warps) 0.38 / 0.50
// ms, its epilogue on every lane.  The gated output is what the model
// runs, so 2 lanes.  IEEE expf for the decay takes 0.67 / 0.74 ms, an
// IEEE sigmoid 0.52 ms gated.  At batch 1 and at S = 1 (decode) 4 lanes
// are faster (0.12 against 0.14 ms gated; 6.7 against 10.4 us); decode is
// bound by the host, so one lane count serves both.
//
// The lookahead copy takes only the rows that exist (min(TILE, seqlen -
// ahead)).  Copied whole (K5_PROBE=4), the last batch row's reads TILE
// rows past the end of dt, x and z (512 KB each at d = 8192), and at the
// prefill shape that faults: no memory is mapped after them.  With TILE
// rows of slack after each, or at (2, 1024, 8192), (8, 256, 8192) or
// (8, 1024, 2048), the same reads land in mapped memory and do not fault.
// A fixed-trip-count copy path for whole tiles, tried and dropped, faulted
// at the prefill shape only, the pattern this overread shows.

// Training: given hs, K5 also stores the state at the start of every ring
// tile (every TILE = STATE_EVERY = 16 steps, h0 first) into hs (batch,
// ceil(seqlen / 16), d, n).  K5b (selective_scan_bwd.cu) runs each tile
// forward again from it.  Serving passes hs null; the arithmetic is the
// same either way, so the output is bitwise unchanged.
//
// The order of operations is the plain version's per step (decay, decay *
// h + dx * B, C . h), with the sum over n taken per lane and then across
// the lanes, the decay from ex2.approx of a rounded dt * A log2 e, and the
// gate's sigmoid from __expf and __fdividef: the two agree to rounding
// (~5e-7 x max |want| at the prefill's shape; the checks hold 1e-5).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

// The design's constants; tools/torch_k5_variants.py builds other values
// with -D to time them against these.
#ifndef K5_LANES
#define K5_LANES 2
#endif
#ifndef K5_CH
#define K5_CH 64
#endif
#ifndef K5_TILE
#define K5_TILE 16
#endif
#ifndef K5_STAGES
#define K5_STAGES 2
#endif
#ifndef K5_OCC
#define K5_OCC 768
#endif
#ifndef K5_IEEE_DECAY          // 1: the decay as IEEE expf(dt * A)
#define K5_IEEE_DECAY 0
#endif
#ifndef K5_IEEE_GATE           // 1: the gate's sigmoid by IEEE expf and /
#define K5_IEEE_GATE 0
#endif
#ifndef K5_PROBE               // probes, whose output is not the scan: 1 no
#define K5_PROBE 0             // math, 2 no reloads, 3 an FFMA for the MUFU,
#endif                         // 4 the lookahead tile copied whole

constexpr int LANES = K5_LANES;        // lanes of one channel
constexpr int CH = K5_CH;              // channels per block
constexpr int THREADS = CH * LANES;    // 128
constexpr int TILE = K5_TILE;          // steps per ring stage
constexpr int STAGES = K5_STAGES;      // ring stages (STAGES - 1 in flight)
constexpr int OCC = K5_OCC;            // threads an SM: <= 80 registers
constexpr int N_MAX = 16;
constexpr int STATE_EVERY = 16;        // K5b's TILE, kernel.py's STATE_EVERY
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert((LANES & (LANES - 1)) == 0 && LANES <= 32 &&
              TILE % LANES == 0, "LANES a power of two dividing TILE");

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

// exp(dt * A) from dt and A_SCALE * A
constexpr float A_SCALE = K5_IEEE_DECAY ? 1.f : LOG2E;

__device__ __forceinline__ float decay_of(float dtv, float a2) {
  if (K5_PROBE == 3) return fmaf(dtv, a2, 1.f);
  if (K5_IEEE_DECAY) return expf(dtv * a2);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dtv * a2));
  return r;
}

// The ring: per stage, dt, x (and z) for TILE steps x CH channels, and
// B_t, C_t for TILE steps, each row padded to NP = LANES * P states.
template <int N, bool GATED>
struct alignas(16) Ring {
  static constexpr int P = (N + LANES - 1) / LANES;
  static constexpr int NP = P * LANES;
  static constexpr int ROWS = GATED ? 3 : 2;
  float seq[STAGES][ROWS][TILE][CH];
  float bc[STAGES][2][TILE][NP];
};

template <int P>
__device__ __forceinline__ void load_states(float (&v)[P], const float* s) {
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
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = s[p];
  }
}

// Queue the copies of rows [row, row + steps) (steps <= TILE) into
// ``stage``: dt, x (and z) for channels [c0, c0 + CH) and B_t, C_t.
template <int N, bool GATED>
__device__ __forceinline__ void load_tile(
    Ring<N, GATED>& r, int stage, const float* const (&seq)[3],
    const float* bmat, const float* cmat, size_t row, int steps, int c0,
    int d, bool vec) {
  constexpr int ROWS = Ring<N, GATED>::ROWS;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      for (int i = tid; i < steps * (CH / 4); i += THREADS) {
        const int s = i / (CH / 4), q = 4 * (i % (CH / 4));
        if (c0 + q < d)
          cp_async16(&r.seq[stage][k][s][q],
                     seq[k] + (row + s) * d + c0 + q);
      }
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int s = i / CH, q = i % CH;
        if (c0 + q < d)
          cp_async4(&r.seq[stage][k][s][q], seq[k] + (row + s) * d + c0 + q);
      }
  }
  for (int i = tid; i < steps * N; i += THREADS) {
    const int s = i / N, n = i - s * N;
    cp_async4(&r.bc[stage][0][s][n], bmat + row * N + i);
    cp_async4(&r.bc[stage][1][s][n], cmat + row * N + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// LANES steps from ring row j0 (the first nv of them real): the states
// advance, and lane g ends with the full y of step j0 + g, which it gates
// and stores at ``out`` + g * d.
template <int N, bool GATED>
__device__ __forceinline__ void step_group(
    const Ring<N, GATED>& r, int stage, int j0, int nv, int ch, int g,
    float (&h)[Ring<N, GATED>::P], const float (&a2)[Ring<N, GATED>::P],
    float dskip, bool live, float* out, int d) {
  constexpr int P = Ring<N, GATED>::P;
  float part[LANES];
#pragma unroll
  for (int u = 0; u < LANES; ++u) {
    part[u] = 0.f;
    if (K5_PROBE != 1 && u < nv) {
      const int j = j0 + u;
      const float dtv = r.seq[stage][0][j][ch];
      const float dx = dtv * r.seq[stage][1][j][ch];
      float bv[P], cv[P];
      load_states<P>(bv, &r.bc[stage][0][j][g * P]);
      load_states<P>(cv, &r.bc[stage][1][j][g * P]);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float decay = decay_of(dtv, a2[p]);
        h[p] = fmaf(decay, h[p], dx * bv[p]);
        acc = fmaf(h[p], cv[p], acc);
      }
      part[u] = acc;
    }
  }
  // transposed reduction: at lane distance m, a lane keeps the half of its
  // w steps that bit m of g picks and adds its partner's sums of them, so
  // lane g ends with step j0 + g
#pragma unroll
  for (int m = LANES / 2, w = LANES; m >= 1; m /= 2, w /= 2) {
    const bool hi = g & m;
#pragma unroll
    for (int i = 0; i < w / 2; ++i) {
      const float keep = hi ? part[i + w / 2] : part[i];
      const float send = hi ? part[i] : part[i + w / 2];
      part[i] = keep + __shfl_xor_sync(FULL, send, m);
    }
  }
  float yv = part[0];
  if (live && g < nv) {
    if constexpr (GATED) {
      const float xv = r.seq[stage][1][j0 + g][ch];
      const float zv = r.seq[stage][2][j0 + g][ch];
      yv = __fadd_rn(yv, __fmul_rn(dskip, xv));
      yv = __fmul_rn(yv, K5_IEEE_GATE ? zv / (1.f + expf(-zv))
                                      : __fdividef(zv, 1.f + __expf(-zv)));
    }
    out[static_cast<size_t>(g) * d] = yv;
  }
}

template <int N, bool GATED>
__global__ void __launch_bounds__(THREADS, OCC / THREADS)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bmat,
                      const float* __restrict__ cmat,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      const float* __restrict__ dskip,
                      const float* __restrict__ z,
                      float* __restrict__ y, float* __restrict__ h_last,
                      float* __restrict__ hs, int seqlen, int d, int vec) {
  using R = Ring<N, GATED>;
  constexpr int P = R::P, NP = R::NP;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  R& ring = *reinterpret_cast<R*>(ring_bytes);
  const int tid = threadIdx.x;
  const int g = tid & (LANES - 1);
  const int ch = tid / LANES;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + ch;
  const int b = blockIdx.y;
  const bool live = c < d;
  const size_t row0 = static_cast<size_t>(b) * seqlen;   // row of (b, 0)
  const float* const seq[3] = {dt, x, z};

  for (int k = 0; k < STAGES - 1; ++k)
    load_tile<N, GATED>(ring, k, seq, bmat, cmat, row0 + k * TILE,
                        max(0, min(TILE, seqlen - k * TILE)), c0, d,
                        vec != 0);
  if constexpr (NP > N) {      // padded states read B = C = 0
    for (int i = tid; i < STAGES * 2 * TILE * (NP - N); i += THREADS) {
      const int col = N + i % (NP - N), rest = i / (NP - N);
      (&ring.bc[0][0][0][0])[rest * NP + col] = 0.f;
    }
  }
  float a2[P], h[P];
  const size_t state = (static_cast<size_t>(b) * d + c) * N;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g * P + p;
    const bool on = live && n < N;
    a2[p] = on ? __ldg(a + static_cast<size_t>(c) * N + n) * A_SCALE : 0.f;
    h[p] = on ? __ldg(h0 + state + n) : 0.f;
  }
  const float dd = (GATED && live) ? __ldg(dskip + c) : 0.f;

  for (int t0 = 0, stage = 0; t0 < seqlen;
       t0 += TILE, stage = stage + 1 == STAGES ? 0 : stage + 1) {
    // tile t0 is in (the STAGES - 2 later groups may still be pending) and,
    // after the barrier, every lane is done with the stage refilled below
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    const int ahead = t0 + (STAGES - 1) * TILE;
    load_tile<N, GATED>(ring, stage == 0 ? STAGES - 1 : stage - 1, seq, bmat,
                        cmat, row0 + ahead,
                        K5_PROBE == 2   ? 0
                        : K5_PROBE == 4 ? TILE
                                        : max(0, min(TILE, seqlen - ahead)),
                        c0, d, vec != 0);
    if (hs != nullptr) {       // the state before step t0, for K5b
      float* to = hs + ((static_cast<size_t>(b) * ((seqlen + TILE - 1) / TILE)
                         + t0 / TILE) * d + c) * N;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (live && g * P + p < N) to[g * P + p] = h[p];
    }
    const int steps = min(TILE, seqlen - t0);
    float* out = y + (row0 + t0) * d + c;
    if (steps == TILE) {
#pragma unroll
      for (int j0 = 0; j0 < TILE; j0 += LANES)
        step_group<N, GATED>(ring, stage, j0, LANES, ch, g, h, a2, dd, live,
                             out + static_cast<size_t>(j0) * d, d);
    } else {
      for (int j0 = 0; j0 < steps; j0 += LANES)
        step_group<N, GATED>(ring, stage, j0, min(LANES, steps - j0), ch, g,
                             h, a2, dd, live,
                             out + static_cast<size_t>(j0) * d, d);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (live && g * P + p < N) h_last[state + g * P + p] = h[p];
}

using KernelPtr = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, float*,
                           float*, int, int, int);

template <bool GATED, int... I>
KernelPtr instance(int n, std::integer_sequence<int, I...>) {
  KernelPtr k = nullptr;
  ((k = (n == I + 1) ? &selective_scan_kernel<I + 1, GATED> : k), ...);
  return k;
}

template <bool GATED, int... I>
size_t ring_bytes(int n, std::integer_sequence<int, I...>) {
  size_t bytes = 0;
  ((bytes = (n == I + 1) ? sizeof(Ring<I + 1, GATED>) : bytes), ...);
  return bytes;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dt, x: (batch, seqlen, d); bmat, cmat: (batch, seqlen, n); a: (d, n);
// h0: (batch, d, n); dskip: (d,) and z: (batch, seqlen, d), both given or
// both null -- all contiguous fp32 -- into y (batch, seqlen, d) and h_last
// (batch, d, n), also contiguous fp32.  With dskip and z, y is the gated
// output.  hs, null when serving, takes the state at the start of every
// 16-step tile, (batch, ceil(seqlen / 16), d, n) fp32: what K5b needs (a
// build with another K5_TILE refuses it).  1 <= n <= 16.  Returns the
// launch's cudaError_t.
extern "C" int selective_scan(const void* dt, const void* x,
                              const void* bmat, const void* cmat,
                              const void* a, const void* h0,
                              const void* dskip, const void* z, void* y,
                              void* h_last, void* hs, int batch, int seqlen,
                              int d, int n, void* stream) {
  const bool gated = dskip != nullptr;
  if (batch < 1 || batch > 65535 || seqlen < 1 || d < 1 || n < 1 ||
      n > N_MAX || gated != (z != nullptr) ||
      (hs != nullptr && TILE != STATE_EVERY))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto seq = std::make_integer_sequence<int, N_MAX>();
  const KernelPtr k = gated ? instance<true>(n, seq)
                            : instance<false>(n, seq);
  const int vec = d % 4 == 0 && aligned16(dt) && aligned16(x) &&
                  (!gated || aligned16(z));
  const int smem = static_cast<int>(
      gated ? ring_bytes<true>(n, seq) : ring_bytes<false>(n, seq));
  if (smem > 48 * 1024) {     // only at a larger K5_TILE or K5_STAGES
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((d + CH - 1) / CH, batch);
  k<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<const float*>(dskip), static_cast<const float*>(z),
      static_cast<float*>(y), static_cast<float*>(h_last),
      static_cast<float*>(hs), seqlen, d, vec);
  return static_cast<int>(cudaGetLastError());
}
