// Block-wide helpers shared by the fused paged decode kernels
// (paged_attention.cu: SOCKET and hard LSH; paged_quest.cu: Quest;
// paged_ring.cu: the sliding-window ring).  Every kernel runs blocks of
// kThreads threads: the ring one per (request, KV head), the other two a
// thread-block cluster of them (paged_cluster.cuh).  The block-wide
// helpers below are called by every thread of the block (they
// synchronize); the online softmax over compacted rows (Softmax,
// fold_rows) is the ring's.
//
// K/V pool pages come in four element types (the wrappers' kv_type codes,
// KvType): f32, bf16 (stored as its 16 bits), int8, and fp8 e4m3fn
// (__nv_fp8_e4m3: the finite-only encoding of torch.float8_e4m3fn).  With
// the f32 per-row scale pools k_scale / v_scale (NB, KVH, bs) a K/V value
// is read as float(q) * scale[row], one rounding, the plain version's
// q.float() * s; without them (null pointers) the scale is 1, and
// float(q) * 1 is float(q) exactly.

#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// Order-preserving f32 -> uint32 map (the TPU kernels' _sort_key).
__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u ^ 0x80000000u);
}

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Element types of the K/V pool pages, as the wrappers code them.
enum KvType { kKvF32 = 0, kKvBf16 = 1, kKvInt8 = 2, kKvFp8 = 3 };

// One stored K/V element as f32 (exact for every storage type).
__device__ __forceinline__ float kv_to_float(float x) { return x; }
__device__ __forceinline__ float kv_to_float(uint16_t h) {
  return bf16_to_float(h);
}
__device__ __forceinline__ float kv_to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float kv_to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Calls f(static_cast<T*>(nullptr)) with T the element type of kv_type
// and returns its result; an unknown code gives cudaErrorInvalidValue.
template <typename F>
int with_kv_type(int kv_type, F&& f) {
  switch (kv_type) {
    case kKvF32: return f(static_cast<float*>(nullptr));
    case kKvBf16: return f(static_cast<uint16_t*>(nullptr));
    case kKvInt8: return f(static_cast<int8_t*>(nullptr));
    case kKvFp8: return f(static_cast<__nv_fp8_e4m3*>(nullptr));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Block-wide sum; every thread gets the result.  red: kWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                        // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

// Block-wide exclusive prefix sum in thread order; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int before = 0, sum = 0;
  for (int i = 0; i < kWarps; ++i) {
    const int r = red[i];
    if (i < warp) before += r;
    sum += r;
  }
  *total = sum;
  return before + inc - v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Online-softmax state of one block in shared memory: the G query heads
// sq (G, hd), the accumulator sacc (G, hd), tile scores ss (G, kThreads),
// the V scales of the tile's rows svs (kThreads) and the running max sm,
// sum sl and rescale factor salpha (G each).
struct Softmax {
  const float* sq;
  float* sacc;
  float* ss;
  float* svs;
  float* sm;
  float* sl;
  float* salpha;
};

// Fold the cnt compacted rows srow[0, cnt) (pool row indices) of one tile
// into the online softmax: scores one warp per row with coalesced K
// loads (one element per lane: 4 bytes of f32, 1 of int8 or fp8), the
// statistics one warp per query head, acc = acc * alpha + P V with
// threads over (g, d).  Only these rows of K and V, and of the scale
// pools when given (k_scale / v_scale, null for unscaled pages), are
// read; each value is dequantized in-register as kv_to_float(q) * scale.
// A softcap > 0 caps each scaled logit s to softcap * tanh(s / softcap)
// (Gemma-style); 0 leaves it as it is.
template <typename T>
__device__ __forceinline__ void fold_rows(const Softmax& s, int cnt,
                                          const int* srow,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          const float* __restrict__ k_scale,
                                          const float* __restrict__ v_scale,
                                          int g, int hd, float scale,
                                          float softcap) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < cnt; r += kWarps) {
    const int row = srow[r];
    const T* kr = k_pages + static_cast<size_t>(row) * hd;
    const float ks = k_scale != nullptr ? k_scale[row] : 1.f;
    if (lane == 0) s.svs[r] = v_scale != nullptr ? v_scale[row] : 1.f;
    for (int gg = 0; gg < g; ++gg) {
      float d = 0.f;
      for (int i = lane; i < hd; i += 32) {
        const float k = kv_to_float(kr[i]) * ks;
        d += s.sq[gg * hd + i] * k;
      }
      d = warp_sum(d) * scale;
      if (softcap > 0.f) d = softcap * tanhf(d / softcap);
      if (lane == 0) s.ss[gg * kThreads + r] = d;
    }
  }
  __syncthreads();
  for (int gg = warp; gg < g; gg += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < cnt; r += 32)
      mx = fmaxf(mx, s.ss[gg * kThreads + r]);
    mx = warp_max(mx);
    const float m_prev = s.sm[gg];
    const float m_new = fmaxf(m_prev, mx);
    float ps = 0.f;
    for (int r = lane; r < cnt; r += 32) {
      const float pr = expf(s.ss[gg * kThreads + r] - m_new);
      s.ss[gg * kThreads + r] = pr;
      ps += pr;
    }
    ps = warp_sum(ps);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      s.salpha[gg] = alpha;
      s.sl[gg] = s.sl[gg] * alpha + ps;
      s.sm[gg] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gg = i / hd, d = i - gg * hd;
    float a = s.sacc[i] * s.salpha[gg];
    for (int r = 0; r < cnt; ++r) {
      const float v =
          kv_to_float(v_pages[static_cast<size_t>(srow[r]) * hd + d]) *
          s.svs[r];
      a += s.ss[gg * kThreads + r] * v;
    }
    s.sacc[i] = a;
  }
}

// Set the G running maxima and sums to their initial values, q into sq
// and the accumulator to 0.
__device__ __forceinline__ void softmax_init(const Softmax& s,
                                             const float* __restrict__ qb,
                                             int g, int hd) {
  float* sq = const_cast<float*>(s.sq);
  for (int i = threadIdx.x; i < g * hd; i += kThreads) {
    sq[i] = qb[i];
    s.sacc[i] = 0.f;
  }
  if (threadIdx.x < g) {
    s.sm[threadIdx.x] = kNegInf;
    s.sl[threadIdx.x] = 0.f;
  }
}

// out (G, hd) = acc / max(l, 1e-30).
__device__ __forceinline__ void softmax_store(const Softmax& s, float* ob,
                                              int g, int hd) {
  for (int i = threadIdx.x; i < g * hd; i += kThreads)
    ob[i] = s.sacc[i] / fmaxf(s.sl[i / hd], 1e-30f);
}

// Shared-memory bytes of the Softmax state plus srow (kThreads ints) and
// red (kWarps ints), laid out by carve_softmax.
__host__ __device__ constexpr size_t softmax_smem_bytes(int g, int hd) {
  return static_cast<size_t>(2 * g * hd + (g + 1) * kThreads + 3 * g) *
             sizeof(float) +
         static_cast<size_t>(kThreads + kWarps) * sizeof(int);
}

// Lay out the Softmax state, srow and red from base; returns the first
// byte after them (4-byte aligned).
__device__ __forceinline__ unsigned char* carve_softmax(unsigned char* base,
                                                        int g, int hd,
                                                        Softmax* s,
                                                        int** srow,
                                                        int** red) {
  float* f = reinterpret_cast<float*>(base);
  s->sq = f;
  s->sacc = f + g * hd;
  s->ss = s->sacc + g * hd;
  s->svs = s->ss + g * kThreads;
  s->sm = s->svs + kThreads;
  s->sl = s->sm + g;
  s->salpha = s->sl + g;
  *srow = reinterpret_cast<int*>(s->salpha + g);
  *red = *srow + kThreads;
  return reinterpret_cast<unsigned char*>(*red + kWarps);
}

}  // namespace paged
