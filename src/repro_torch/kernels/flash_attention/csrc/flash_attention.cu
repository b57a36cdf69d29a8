// K4 `flash_attention`: online-softmax attention, fp32 math, for
//   q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), D <= 256, fp32 or bf16,
// with a causal mask (kpos <= qpos), a sliding window (qpos - kpos < window),
// the mask of keys at or past the true Tk, and GQA (query head h reads KV
// head h * Hkv / Hq in place: KV is never repeated in memory).
//
// Replaces flash_attention_pallas (_flash_kernel) of
// src/repro/kernels/flash_attention/kernel.py, and the same body relaunched
// by ops._call_kernel (ops.py) with the true KV length.  It computes what
// ops.flash_attention computes: masked scores are -1e30, p is zeroed where
// masked, l is clamped to 1e-30 (a fully masked row gives 0), and the scale
// is taken by the caller from the true D.
//
// What bounds it on an H100: operations.  At the served shape of gemma3-1b
// (B 8, Hq 4, Hkv 1, T 1024, D 256, fp32) a causal layer does 17.2 GFLOP
// of fp32 FMA on 84 MB of q, k, v and out: 0.26 ms at 67 TFLOP/s against
// 0.025 ms at 3.35 TB/s.  This version keeps the Pallas kernel's fp32
// arithmetic (the served dtype, and preferred_element_type=float32 there)
// and so runs on the CUDA cores; tensor cores (TF32, or bf16 wgmma) are for
// a later version.
//
// Design: one thread block per (query tile of BQ = 64 rows, query head,
// batch), the heaviest (last) query tiles first.  The TPU kernel walked the
// KV panels as its sequential 4th grid axis with m, l and acc in VMEM
// scratch; here a loop inside the block walks the live KV tiles of BK = 64
// keys: tiles wholly above the causal frontier or left of the window are
// never visited.  Per tile:
//   1. K and V (BK x D) are staged into shared memory by fully unrolled
//      4-wide loads (16 in flight per thread at D = 256), so the tile costs
//      about one L2 round trip, not one per element;
//   2. 256 threads compute the 64 x 64 scores as 4 x 4 register micro-tiles
//      by fp32 FMA over D, reading Q and K four floats at a time (row
//      stride DMAX + 4 floats: eight rows fill the 32 banks, so a warp's
//      16 distinct K rows cost two wavefronts);
//   3. the scaled, masked scores go to shared memory; four threads per row
//      update the running max m and sum l and turn scores into p;
//   4. each thread rescales and accumulates its 4 rows x 16 columns of acc
//      in registers against P V, reading P and V four floats at a time.
// Shared memory holds Q, K, V and P in fp32: 217,856 B at DMAX = 256, above
// the 48 KB default, hence cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
// Ragged Tq, Tk and D are masked in the kernel (zeros are staged past Tk and
// D, rows past Tq are not written), so the caller pads nothing; when D or a
// stride is not a multiple of 4, or a pointer is not aligned to 4 elements,
// the staging loads element by element instead.  bf16 is widened to fp32 on
// load and the output is rounded to bf16 on store.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 4;            // row stride of the score tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, tq, tk, d;
  long long sq_b, sq_h, sq_t;          // element strides (last dim is 1)
  long long sk_b, sk_h, sk_t;
  long long sv_b, sv_h, sv_t;
  long long so_b, so_h, so_t;
  float scale;
  int causal;
  int window;                          // <= 0: no window
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements as fp32; p is aligned to four elements.
__device__ __forceinline__ float4 load4_aligned(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_aligned(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

template <int DMAX>
constexpr int smem_floats() {
  return (BQ + 2 * BK) * (DMAX + 4) + BQ * LDP + 3 * BQ;
}

// Stage rows [lo, lo + ROWS) of a (T, D) head into shared memory with row
// stride DMAX + 4, zeros past t and past d: a thread starts all its loads
// before its first store.
template <typename T, int DMAX, int ROWS, bool VEC>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int lo, int t, int d) {
  constexpr int ld = DMAX + 4;
  constexpr int C4 = DMAX / 4;                 // 4-wide groups per row
  constexpr int PER = ROWS * C4 / THREADS;     // groups per thread
  float4 buf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / C4, c = (i - r * C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lo + r < t) {
      const T* row = src + (lo + r) * st;
      if (VEC) {
        if (c < d) x = load4_aligned(row + c);
      } else {
        if (c < d) x.x = load_f(row + c);
        if (c + 1 < d) x.y = load_f(row + c + 1);
        if (c + 2 < d) x.z = load_f(row + c + 2);
        if (c + 3 < d) x.w = load_f(row + c + 3);
      }
    }
    buf[u] = x;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / C4, c = (i - r * C4) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) = buf[u];
  }
}

template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const Params p) {
  constexpr int ld = DMAX + 4;
  constexpr int NJ = DMAX / 64;        // 4-wide column groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;                    // BQ x ld
  float* sK = sQ + BQ * ld;            // BK x ld
  float* sV = sK + BK * ld;            // BK x ld
  float* sP = sV + BK * ld;            // BQ x LDP (scores, then p)
  float* sM = sP + BQ * LDP;           // running max per row
  float* sL = sM + BQ;                 // running sum per row
  float* sA = sL + BQ;                 // this tile's rescale per row

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = static_cast<int>(static_cast<long long>(h) * p.hkv / p.hq);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  T* o = static_cast<T*>(p.o) + b * p.so_b + h * p.so_h;

  stage<T, DMAX, BQ, VEC>(sQ, q, p.sq_t, q_lo, p.tq, p.d);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  // acc[i][j][e]: row ty + 16 i, column 4 tx + 64 j + e
  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the live KV tiles of this query tile (the Pallas kernel's panel skip)
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, q_lo + BQ);
  if (p.window > 0) kv_lo = max(0, q_lo - (p.window - 1));
  kv_lo = (kv_lo / BK) * BK;
  const int nc4 = (p.d + 3) / 4;

  for (int k_lo = kv_lo; k_lo < kv_hi; k_lo += BK) {
    __syncthreads();                   // the last tile's K, V, P are read
    stage<T, DMAX, BK, VEC>(sK, k, p.sk_t, k_lo, p.tk, p.d);
    stage<T, DMAX, BK, VEC>(sV, v, p.sv_t, k_lo, p.tk, p.d);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j, D four at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < nc4; ++c4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * ld +
                                                 4 * c4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * ld +
                                                 4 * c4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sP[r * LDP + c] =
            live(p, q_lo + r, k_lo + c) ? s[i][j] * p.scale : NEG_INF;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = sP + r * LDP + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = live(p, q_lo + r, k_lo + part * 16 + c)
                            ? expf(row[c] - m_new) : 0.f;
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= a;
    }
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * LDP + c);
        pa[i][0] = t.x;
        pa[i][1] = t.y;
        pa[i][2] = t.z;
        pa[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vb = *reinterpret_cast<const float4*>(
              sV + (c + cc) * ld + 4 * tx + 64 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j][0] = fmaf(pa[i][cc], vb.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pa[i][cc], vb.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pa[i][cc], vb.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pa[i][cc], vb.w, acc[i][j][3]);
          }
        }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q_lo + r >= p.tq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + (q_lo + r) * p.so_t;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * tx + 64 * j + e;
        if (c < p.d) store_f(orow + c, acc[i][j][e] / l);
      }
  }
}

template <typename T, int DMAX, bool VEC>
int launch(const Params& p, int batch, cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DMAX, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((p.tq + BQ - 1) / BQ, p.hq, batch);
  flash_attention_kernel<T, DMAX, VEC><<<grid, THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int by_width(const Params& p, int batch, cudaStream_t s) {
  if (p.d <= 64) return launch<T, 64, VEC>(p, batch, s);
  if (p.d <= 128) return launch<T, 128, VEC>(p, batch, s);
  return launch<T, 256, VEC>(p, batch, s);
}

// 4-wide loads need D, every row stride and every base pointer (with its
// batch and head offsets) to be multiples of four elements.
template <typename T>
bool vector_ok(const Params& p) {
  const long long strides[] = {p.sq_b, p.sq_h, p.sq_t, p.sk_b, p.sk_h,
                               p.sk_t, p.sv_b, p.sv_h, p.sv_t};
  if (p.d % 4 != 0) return false;
  for (long long st : strides)
    if (st % 4 != 0) return false;
  const uintptr_t align = 4 * sizeof(T);
  return reinterpret_cast<uintptr_t>(p.q) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.k) % align == 0 &&
         reinterpret_cast<uintptr_t>(p.v) % align == 0;
}

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t s) {
  if (vector_ok<T>(p)) return by_width<T, true>(p, batch, s);
  return by_width<T, false>(p, batch, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  Strides are in
// elements; each tensor's last dimension is contiguous.  window <= 0 means
// no window.  Returns the launch's cudaError_t.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int batch, int hq, int hkv, int tq, int tk, int d,
    long long sq_b, long long sq_h, long long sq_t,
    long long sk_b, long long sk_h, long long sk_t,
    long long sv_b, long long sv_h, long long sv_t,
    long long so_b, long long so_h, long long so_t,
    float scale, int causal, int window, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 1 ||
      d < 1 || d > 256 || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, hq, hkv, tq, tk, d,
           sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t,
           so_b, so_h, so_t, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, batch, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
