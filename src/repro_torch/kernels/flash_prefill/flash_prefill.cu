// Causal (optionally sliding-window) flash-attention prefill for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill/
// flash_prefill.py (_prefill_kernel, launched by flash_prefill_pallas):
// the FlashAttention-2 forward over a whole prompt,
//
//   out[bh, i] = sum_j p_ij v[kv, j] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = (q[bh, i] . k[kv, j]) * scale,
//
// over the keys kept by row i: j <= i and, when window > 0, i - j < window.
// With softcap > 0 the scores are capped first, s_ij = softcap *
// tanh(s_ij / softcap) (the model's attn_logit_softcap; the TPU kernel has
// no cap term and is the softcap = 0 case).
// q is (BH, S, hd) and k, v are (BKV, S, hd), f32 or bf16, read as f32;
// the output is f32 (BH, S, hd).  The running max m, sum l and the
// accumulator are f32, and the output is acc / max(l, 1e-30), as on the
// TPU.  Two differences from the TPU kernel, both with the same output
// where the TPU kernel is defined:
//   * any S: the last query and key tiles may be ragged (rows at or past S
//     are loaded as zeros and never stored; the causal mask already keeps
//     every key of a stored row below S);
//   * GQA without copies: with G = BH / BKV, row bh reads K/V row bh / G.
//     In the model's head order (bh = b*H + kv*G + g) that is b*KVH + kv;
//     with G = 1 it is the TPU kernel.
// The TPU kernel masks key tiles above the diagonal or outside the window;
// this one never visits them.  Masked scores are the finite -1e30 of the
// TPU kernel, so a tile that masks a whole row gives alpha = exp(0) = 1
// and p = 0, never exp(-inf + inf).
//
// What bounds it on this card: operations.  The function needs
// 4 * hd flops per (query, kept key) pair per head: q.k and p.v.  At
// llama31-8b's prefill (BH 64, BKV 16, S 8192, hd 128) that is 1.10e12
// flops, 16.4 ms at the 67 TFLOP/s of f32 outside the tensor cores
// (0.55 ms on the bf16 tensor cores at 989 TFLOP/s, 2.2 ms in TF32), while
// its bytes (q and out at BH, k and v at BKV) are 0.67 GB, 0.20 ms.
//
// What the design does about it (simple and right first; the tensor-core
// version is later work):
//   * one block of 256 threads per (bh, tile of 64 queries); the grid
//     puts the longest rows (the last query tiles) first, so the causal
//     triangle's long blocks do not run last;
//   * the TPU's sequential K grid axis is a loop inside the block over
//     tiles of 64 keys, from the window's first tile to the diagonal one;
//   * Q, K and V tiles are staged in shared memory as f32 (dynamic shared
//     memory: 98 KB at hd 128, two blocks an SM; 194 KB at hd 256); P is
//     written over the K tile once S = Q K^T is done;
//   * register tiles: each thread holds 4 query rows (ty + 16 i) by 4 keys
//     (tx + 16 j) of S and 4 rows by hd / 16 columns (tx + 16 j) of the
//     output; Q and K rows are read as float4 with a row stride of hd + 4
//     floats, which keeps the eight rows a quarter warp reads in distinct
//     banks; the row max and sum reduce over the 16 lanes of a half warp;
//   * f32 FMA throughout, no tensor cores.
//
// Head dims: 16, 32, 64, 128, 160, 256 (any multiple of 16 up to 256 would
// do; these are the ones instantiated).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;            // (ty, tx) in 16 x 16
constexpr int kRows = kBlockQ / 16;      // query rows a thread holds
constexpr int kCols = kBlockK / 16;      // keys a thread holds in S
constexpr int kPStride = kBlockK + 4;    // row stride of P in floats
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [row0, row0 + 64) of a (S, HD) matrix into shared memory as f32,
// row stride `stride` floats; rows at or past s are zeros.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int s) {
  constexpr int kVec = HD / 4;
  for (int e = threadIdx.x; e < kBlockK * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) val = load4(src + static_cast<size_t>(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * stride + c) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_floats() {
  constexpr int kQK = HD + 4;
  constexpr int k_region = kBlockK * kQK > kBlockQ * kPStride
                               ? kBlockK * kQK : kBlockQ * kPStride;
  return static_cast<size_t>(kBlockQ) * kQK + k_region +
         static_cast<size_t>(kBlockK) * HD;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     int s, int group, float scale, int window,
                     float softcap) {
  constexpr int kQK = HD + 4;            // Q and K row stride in floats
  constexpr int kNJ = HD / 16;           // output columns a thread holds
  constexpr int k_region = kBlockK * kQK > kBlockQ * kPStride
                               ? kBlockK * kQK : kBlockQ * kPStride;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // (64, HD + 4)
  float* sk = sq + kBlockQ * kQK;        // (64, HD + 4); P (64, 68) after S
  float* sv = sk + k_region;             // (64, HD)
  float* sp = sk;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t kv_row = static_cast<size_t>(bh / group) * s * HD;
  const T* kb = k + kv_row;
  const T* vb = v + kv_row;

  load_tile<HD>(sq, kQK, q + static_cast<size_t>(bh) * s * HD, q0, s);

  float m[kRows], l[kRows], acc[kRows][kNJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, s) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_first / kBlockK) * kBlockK; k0 <= q_last; k0 += kBlockK) {
    __syncthreads();                     // the last tile's P and V reads
    load_tile<HD>(sk, kQK, kb, k0, s);
    load_tile<HD>(sv, HD, vb, k0, s);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = load4(sq + (ty + 16 * i) * kQK + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = load4(sk + (tx + 16 * j) * kQK + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[i][j] = fmaf(a[i].x, b[j].x, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, b[j].y, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, b[j].z, sc[i][j]);
          sc[i][j] = fmaf(a[i].w, b[j].w, sc[i][j]);
        }
    }
    __syncthreads();                     // every K read done: P overwrites K

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool keep[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        keep[j] = kp <= qp && (window <= 0 || qp - kp < window);
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[i][j] = keep[j] ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = keep[j] ? expf(sc[i][j] - m_new) : 0.f;
        sp[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                     // P complete

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = load4(sp + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float* vc = sv + kk * HD + tx + 16 * j;
        const float v0 = vc[0], v1 = vc[HD], v2 = vc[2 * HD], v3 = vc[3 * HD];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][j] = fmaf(p[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(p[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(p[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(p[i].w, v3, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<size_t>(bh) * s + qp) * HD + tx;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) o[16 * j] = acc[i][j] / denom;
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, float* out, int bh,
           int group, int s, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_prefill_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, s, group, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                float* out, int bh, int group, int s, float scale, int window,
                float softcap, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    case 32: return launch<32, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    case 64: return launch<64, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    case 128: return launch<128, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    case 160: return launch<160, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    case 256: return launch<256, T>(q, k, v, out, bh, group, s, scale, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (BH, S, hd), k / v: (BKV, S, hd), all contiguous, of the element type
// dtype names (0 float, 1 bf16), 16-byte aligned (8 for bf16); out: f32
// (BH, S, hd).  BH is a multiple of BKV, BH <= 2^31 - 1, ceil(S / 64) <=
// 65535.  window <= 0 is plain causal attention; softcap <= 0 caps no
// score.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an unknown dtype or head dim).
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         float* out, int dtype, int bh, int bkv, int s,
                         int hd, float scale, int window, float softcap,
                         void* stream) {
  if (bkv <= 0 || bh % bkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, bh, group, s, scale, window,
                              softcap, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, bh, group, s, scale,
                                      window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
