// K5 `selective_scan`: Mamba1's selective-scan recurrence over a whole
// sequence, per (batch b, channel c) and state index n < N,
//   h_t[n] = exp(dt_t * A[c, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n C_t[n] * h_t[n]
// from h0, in fp32 throughout; it returns y and the last state.  It does
// not fold in D * x or the silu(z) gate: its contract is exactly that of
// the plain version it is held to (kernels/selective_scan/ref.py).
//
// Port-only: the JAX package has no Pallas kernel here.  It replaces the
// plain jnp _ssm_scan_chunked of src/repro/models/mamba.py:82, which runs
// a lax.associative_scan inside a lax.scan over chunks of 128 steps
// because the TPU has no recurrent kernel: log-depth passes over
// (B, 128, d, N) decay and drive tensors, ~50 of them a chunk.  On a GPU
// the recurrence is one pass with the state in registers.
//
// What bounds it on an H100: at falcon-mamba-7b's prefill (B 8, S 1024,
// d 8192, N 16) it must read dt and x and write y, 12 bytes per (b, t, c),
// 805 MB in all (0.24 ms at 3.35 TB/s), and take 1.07e9 exps, one per
// (b, t, c, n), on the special-function units, 16 per SM a clock (~0.26
// ms); the FMAs beside them are fewer than the exps' own instructions.
// So it sits where bytes and the exps meet, and only a design that keeps
// every thread issuing reaches either.
//
// Design (simple first): one thread per (b, c) keeps its N states and
// its N values of A in registers and walks the sequence once, in order;
// a block is 128 channels of one batch row.  All channels share B_t and
// C_t, so a block stages them in shared memory 64 steps at a time (8 KB
// at N = 16, read as broadcasts).  Loads of dt and x and stores of y are
// coalesced along the channels; the step loop is unrolled by 4 so that
// the loads of four steps are in flight together, and the N chains of a
// step are independent.  N is a template parameter (1..16) so that the
// state stays in registers.  expf (IEEE-accurate, not __expf): the
// reference's exp of dt*A.  The order of operations per step is the plain
// version's (decay, then decay * h + dx * b, then the sum over n in
// order); nvcc may contract a product and a sum into one FMA, which the
// plain version's separate kernels do not, so the two agree to rounding.
// At B * d = 65,536 threads the card holds ~16 warps an SM; splitting N
// over lanes is the first lever if the kernel falls well short of its
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TILE = 64;       // steps of B_t / C_t staged at a time
constexpr int N_MAX = 16;

template <int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bmat,
                      const float* __restrict__ cmat,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last,
                      int seqlen, int d) {
  __shared__ float sb[TILE * N];
  __shared__ float sc[TILE * N];
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = c < d;
  const size_t state = (static_cast<size_t>(b) * d + c) * N;
  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? __ldg(a + static_cast<size_t>(c) * N + n) : 0.f;
    h[n] = live ? __ldg(h0 + state + n) : 0.f;
  }
  const size_t row0 = static_cast<size_t>(b) * seqlen;   // row of (b, 0)
  const float* bb = bmat + row0 * N;
  const float* cb = cmat + row0 * N;
  for (int t0 = 0; t0 < seqlen; t0 += TILE) {
    const int steps = min(TILE, seqlen - t0);
    __syncthreads();             // every thread is done with the last tile
    for (int i = threadIdx.x; i < steps * N; i += THREADS) {
      sb[i] = __ldg(bb + static_cast<size_t>(t0) * N + i);
      sc[i] = __ldg(cb + static_cast<size_t>(t0) * N + i);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const size_t off = (row0 + t0 + s) * d + c;
      const float dtv = __ldg(dt + off);
      const float dx = dtv * __ldg(x + off);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float decay = expf(dtv * av[n]);
        h[n] = decay * h[n] + dx * sb[s * N + n];
        acc += h[n] * sc[s * N + n];
      }
      y[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

using KernelPtr = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*, float*,
                           float*, int, int);

template <int... I>
KernelPtr instance(int n, std::integer_sequence<int, I...>) {
  KernelPtr k = nullptr;
  ((k = (n == I + 1) ? &selective_scan_kernel<I + 1> : k), ...);
  return k;
}

}  // namespace

// dt, x: (batch, seqlen, d); bmat, cmat: (batch, seqlen, n); a: (d, n);
// h0: (batch, d, n) -- all contiguous fp32 -- into y (batch, seqlen, d)
// and h_last (batch, d, n), also contiguous fp32.  1 <= n <= 16.  Returns
// the launch's cudaError_t.
extern "C" int selective_scan(const void* dt, const void* x,
                              const void* bmat, const void* cmat,
                              const void* a, const void* h0, void* y,
                              void* h_last, int batch, int seqlen, int d,
                              int n, void* stream) {
  if (batch < 1 || batch > 65535 || seqlen < 1 || d < 1 || n < 1 ||
      n > N_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelPtr k = instance(n, std::make_integer_sequence<int, N_MAX>());
  const dim3 grid((d + THREADS - 1) / THREADS, batch);
  k<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bmat), static_cast<const float*>(cmat),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), seqlen, d);
  return static_cast<int>(cudaGetLastError());
}
