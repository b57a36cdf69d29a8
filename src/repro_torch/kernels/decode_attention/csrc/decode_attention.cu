// K6 `decode_attention`: one query position against a KV cache, for
//   q (B, Hq, D) fp32, k / v (B, Hkv, S, D) fp32, bf16 or float8_e4m3fn,
// GQA with g = Hq / Hkv query heads a KV head, output (B, Hq, D) fp32.
//
// Replaces no Pallas kernel.  The JAX package decodes through plain jnp:
// _masked_attention (src/repro/models/layers.py:79, called at :221) over
// the cache upcast to fp32, with kv_valid[i] = pos - ((pos - i) mod S) (the
// absolute position slot i holds: the latest <= pos) and the mask
// 0 <= kv_valid <= pos and, for a local layer, pos - kv_valid < window.
// This kernel computes that function: scale 1/sqrt(D) on the fp32 dot,
// softmax in fp32 over the valid slots, P V in fp32.  With r = (pos - i)
// mod S, slot i is valid iff r <= pos and (no window or r < window), so
// pos and window are arguments and no mask or position tensor exists.
//
// Why it exists: the plain path widens the whole cache to fp32 in device
// memory at every layer of every decode step (an fp8 element is read as 1
// byte, written as 4 and read again as 4), so an fp8 cache would move more
// bytes than the fp32 one it replaces.  Here K and V are read once, in
// their stored type, and widened in registers: bf16 by a shift, fp8 e4m3
// by the hardware's exact conversion to fp16 (cuda_fp8.h; every e4m3 value
// is an fp16 value, 0x7f / 0xff are NaN), then to fp32.
//
// What bounds it on an H100: bytes.  Each cached element is read once and
// takes 2 g FLOP of dot and P V: pixtral-12b's decode (B 8, Hkv 8, g 4,
// D 128, S 8192) reads 134 MB of fp32 K/V, 0.040 ms at 3.35 TB/s in fp8,
// 0.16 ms in fp32, against 0.008 ms of fp32 FLOP at 67 TFLOP/s.  So the
// instructions a slot must stay few, or the narrow caches (1/2 and 1/4 of
// the bytes) are bound by issue and latency instead.
//
// Design (a warp a tile of 32 slots; cp.async and TMA are later work):
//   * Grid (splits, B * Hkv).  Block (split, b * Hkv + h) walks the slots
//     [split * chunk, min(S, (split + 1) * chunk)) with 4 warps, warp w
//     the 32-slot tiles w, w + 4, ...  The host picks the chunk (a
//     multiple of 32) so that about sixteen blocks an SM are in flight
//     (B * Hkv alone is 64 blocks at pixtral's decode, half the card).
//     The block's g query rows sit in shared memory.
//   * Scores: lane t takes slot t of the tile and reads its K row itself,
//     16 bytes a load (the tile's 32 rows are one contiguous span), and
//     forms its g dots against q read as shared-memory broadcasts: no
//     shuffles a slot.  Invalid slots (unwritten, out of the window) are
//     not read.
//   * Softmax per tile: one warp max a row, the running max m (uniform),
//     p = exp(s - m) by each lane for its own slot, a per-lane running sum
//     l (summed over the warp at the end, in a fixed order).
//   * P V: the accumulator is split over lanes by column (lane l holds
//     columns l, l + 32, ...: EPL = ceil(D / 32) a row); for each live slot
//     of the tile in order, p is broadcast by a shuffle and the V row is
//     read 32 consecutive elements a load, 8 rows' loads (4 at D > 128)
//     issued before the first is used.
//   * The warps' states are merged in shared memory in warp order; with
//     one split the block writes the normalised output, else its (m, l,
//     acc) partial, and a second small kernel merges the splits in split
//     order.  No atomics: two calls give the same bits.
// Instances: dtype {fp32, bf16, fp8} x EPL {1, 2, 4, 8} (any D <= 256; the
// configs' D are 64, 112, 128 and 256) x g {1, 2, 4, 5} (the configs'
// n_heads / n_kv_heads).  K rows take 16-byte loads when D x the element
// size is a multiple of 16 and the cache is 16-byte aligned, else element
// loads.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int D_MAX = 256;
constexpr int G_MAX = 5;

struct Params {
  const float* q;          // (B, Hkv * g, D)
  const void* k;           // (B, Hkv, S, D)
  const void* v;
  float* out;              // (B, Hkv * g, D)
  float* part_ml;          // (splits, B * Hkv, g, 2): m, l
  float* part_acc;         // (splits, B * Hkv, g, D)
  int n_bh, g, d, s, pos, window, chunk, splits;   // n_bh = B * Hkv
  float scale;
};

struct Fp8 {};             // tag: float8_e4m3fn bytes

template <typename T> struct Bytes { static constexpr int n = sizeof(T); };
template <> struct Bytes<Fp8> { static constexpr int n = 1; };

// An element's raw bits (zero-extended), then its fp32 value, so that a
// batch of loads is issued before any is widened.
__device__ __forceinline__ unsigned int load_bits(const float* p,
                                                  long long i) {
  return __ldg(reinterpret_cast<const unsigned int*>(p) + i);
}
__device__ __forceinline__ unsigned int load_bits(const __nv_bfloat16* p,
                                                  long long i) {
  return __ldg(reinterpret_cast<const unsigned short*>(p) + i);
}
__device__ __forceinline__ unsigned int load_bits(const Fp8* p, long long i) {
  return __ldg(reinterpret_cast<const unsigned char*>(p) + i);
}

template <typename T> __device__ __forceinline__ float widen(unsigned int b);
template <> __device__ __forceinline__ float widen<float>(unsigned int b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(
    unsigned int b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float widen<Fp8>(unsigned int b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(b), __NV_E4M3)));
}

// The 16 / sizeof elements of a 16-byte load, widened to fp32.
template <typename T> __device__ __forceinline__ void widen16(const uint4& r,
                                                              float* out);
template <> __device__ __forceinline__ void widen16<float>(const uint4& r,
                                                           float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void widen16<__nv_bfloat16>(
    const uint4& r, float* out) {
  const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void widen16<Fp8>(const uint4& r,
                                                         float* out) {
  const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3)));
      out[4 * i + 2 * h] = f.x;
      out[4 * i + 2 * h + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The factor that brings a state of running max m to the common max top:
// 0 for a state that saw no slot.
__device__ __forceinline__ float rescale(float m, float top) {
  return m == -INFINITY ? 0.0f : expf(m - top);
}

template <typename T, int EPL, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(Params p) {
  constexpr int NB = Bytes<T>::n;
  constexpr int VE = 16 / NB;                  // elements a 16-byte load
  constexpr int VR = EPL <= 4 ? 8 : 4;         // V rows loaded at once
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int split = blockIdx.x;
  const int lo = split * p.chunk;
  const int hi = min(p.s, lo + p.chunk);
  const int d = p.d;

  __shared__ __align__(16) float sq[G][EPL * 32];
  for (int t = threadIdx.x; t < G * d; t += THREADS)
    sq[t / d][t % d] = p.q[static_cast<long long>(bh) * G * d + t];
  __syncthreads();

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.0f;
  }

  const T* kb = static_cast<const T*>(p.k);
  const T* vb = static_cast<const T*>(p.v);
  const long long base = static_cast<long long>(bh) * p.s * d;
  const bool vec = (d * NB) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.k) & 15) == 0;
  const int pm = p.pos % p.s;                  // the slot pos writes
  for (int t0 = lo + 32 * warp; t0 < hi; t0 += 32 * WARPS) {
    // scores: lane t for slot t0 + t
    const int i = t0 + lane;
    const int r = i <= pm ? pm - i : pm - i + p.s;   // steps back from pos
    const bool live = i < hi && r <= p.pos && (p.window <= 0 || r < p.window);
    const unsigned int alive = __ballot_sync(full, live);
    if (alive == 0u) continue;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.0f;
    if (live) {
      const long long row = base + static_cast<long long>(i) * d;
      if (vec) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + row);
#pragma unroll 4
        for (int c = 0; c < d / VE; ++c) {
          float kf[VE];
          widen16<T>(__ldg(kr + c), kf);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < VE; e += 4) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(&sq[g][c * VE + e]);
              sc[g] = fmaf(qq.x, kf[e], sc[g]);
              sc[g] = fmaf(qq.y, kf[e + 1], sc[g]);
              sc[g] = fmaf(qq.z, kf[e + 2], sc[g]);
              sc[g] = fmaf(qq.w, kf[e + 3], sc[g]);
            }
        }
      } else {
        for (int e = 0; e < d; ++e) {
          const float kf = widen<T>(load_bits(kb, row + e));
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] = fmaf(sq[g][e], kf, sc[g]);
        }
      }
    }
    // the tile's softmax: a warp max a row, p by each lane for its slot
    float pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = live ? sc[g] * p.scale : -INFINITY;
      const float top = fmaxf(m[g], warp_max(s));
      const float alpha = rescale(m[g], top);
      pr[g] = live ? expf(s - top) : 0.0f;
      l[g] = fmaf(l[g], alpha, pr[g]);
      m[g] = top;
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[g][j] *= alpha;
    }
    // P V over the tile's live slots in order, VR rows' loads at a time
    for (int u0 = 0; u0 < 32; u0 += VR) {
      if (((alive >> u0) & ((1u << VR) - 1u)) == 0u) continue;
      unsigned int vr[VR][EPL];
#pragma unroll
      for (int u = 0; u < VR; ++u) {
        const bool on = (alive >> (u0 + u)) & 1u;
        const long long row = base + static_cast<long long>(t0 + u0 + u) * d;
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          const int e = lane + 32 * j;
          vr[u][j] = on && e < d ? load_bits(vb, row + e) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < VR; ++u) {
        if (!((alive >> (u0 + u)) & 1u)) continue;   // warp-uniform
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pu = __shfl_sync(full, pr[g], u0 + u);
#pragma unroll
          for (int j = 0; j < EPL; ++j)
            acc[g][j] = fmaf(pu, widen<T>(vr[u][j]), acc[g][j]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = warp_sum(l[g]);

  // merge the warps' states in warp order
  __shared__ float sm_ml[WARPS][G][2];
  __shared__ float sm_acc[WARPS][G][EPL * 32];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_ml[warp][g][0] = m[g];
      sm_ml[warp][g][1] = l[g];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) sm_acc[warp][g][lane + 32 * j] = acc[g][j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * d; t += THREADS) {
    const int g = t / d, e = t % d;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) top = fmaxf(top, sm_ml[w][g][0]);
    float sum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = rescale(sm_ml[w][g][0], top);
      sum = fmaf(sm_ml[w][g][1], c, sum);
      a = fmaf(sm_acc[w][g][e], c, a);
    }
    const long long row = static_cast<long long>(bh) * G + g;
    if (p.splits == 1) {
      p.out[row * d + e] = sum == 0.0f ? 0.0f : a / sum;
    } else {
      const long long prow = static_cast<long long>(split) * p.n_bh * G + row;
      p.part_acc[prow * d + e] = a;
      if (e == 0) {
        p.part_ml[prow * 2] = top;
        p.part_ml[prow * 2 + 1] = sum;
      }
    }
  }
}

// Merge the splits' partials of one (b, KV head) in split order.
__global__ void __launch_bounds__(THREADS) decode_attention_merge(Params p) {
  const int bh = blockIdx.x;
  for (int t = threadIdx.x; t < p.g * p.d; t += THREADS) {
    const int g = t / p.d, e = t % p.d;
    const long long row = static_cast<long long>(bh) * p.g + g;
    const long long stride = static_cast<long long>(p.n_bh) * p.g;
    float top = -INFINITY;
    for (int sp = 0; sp < p.splits; ++sp)
      top = fmaxf(top, p.part_ml[(sp * stride + row) * 2]);
    float sum = 0.0f, a = 0.0f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const long long prow = sp * stride + row;
      const float c = rescale(p.part_ml[prow * 2], top);
      sum = fmaf(p.part_ml[prow * 2 + 1], c, sum);
      a = fmaf(p.part_acc[prow * p.d + e], c, a);
    }
    p.out[row * p.d + e] = sum == 0.0f ? 0.0f : a / sum;
  }
}

template <typename T, int EPL, int G>
cudaError_t run(const Params& p, cudaStream_t stream) {
  decode_attention_kernel<T, EPL, G>
      <<<dim3(p.splits, p.n_bh), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  decode_attention_merge<<<p.n_bh, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int EPL>
cudaError_t by_group(const Params& p, cudaStream_t stream) {
  switch (p.g) {
    case 1: return run<T, EPL, 1>(p, stream);
    case 2: return run<T, EPL, 2>(p, stream);
    case 4: return run<T, EPL, 4>(p, stream);
    case 5: return run<T, EPL, 5>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_width(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return by_group<T, 1>(p, stream);
  if (p.d <= 64) return by_group<T, 2>(p, stream);
  if (p.d <= 128) return by_group<T, 4>(p, stream);
  return by_group<T, 8>(p, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 float8_e4m3fn (the cache's; q and out are
// fp32).  window <= 0: a global layer.  part_ml / part_acc: the wrapper's
// scratch for splits > 1 (unused, may be null, for one split).
extern "C" int decode_attention(
    int dtype, const float* q, const void* k, const void* v, float* out,
    float* part_ml, float* part_acc, int batch, int hkv, int g, int d,
    int s, int pos, int window, int chunk, int splits, float scale,
    void* stream) {
  if (batch < 1 || hkv < 1 || g < 1 || g > G_MAX || d < 1 || d > D_MAX ||
      s < 1 || pos < 0 || chunk < 1 || splits < 1 ||
      static_cast<long long>(chunk) * splits < s ||
      static_cast<long long>(chunk) * (splits - 1) >= s ||
      batch * hkv > 65535 ||
      (splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, part_ml, part_acc, batch * hkv, g, d, s, pos,
           window, chunk, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(by_width<float>(p, st));
  if (dtype == 1) return static_cast<int>(by_width<__nv_bfloat16>(p, st));
  if (dtype == 2) return static_cast<int>(by_width<Fp8>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
