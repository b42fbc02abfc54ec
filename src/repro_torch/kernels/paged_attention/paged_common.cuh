// Block-wide helpers shared by the fused paged decode kernels
// (paged_attention.cu: SOCKET and hard LSH; paged_quest.cu: Quest;
// paged_ring.cu: the sliding-window ring).  Every kernel runs a
// thread-block cluster of blocks of kThreads threads per (request, KV
// head) (paged_cluster.cuh).  The block-wide helpers below are called by
// every thread of the block (they synchronize).
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

}  // namespace paged
