// SOCKET soft-collision scoring for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/socket_score/socket_score.py
// (_score_kernel, launched by socket_score_pallas): for every cached key n
// of every (batch, kv-head) row bh
//
//     score[bh, n] = vnorm[bh, n] * sum_g sum_l exp(<S_nl, u_gl> / tau - logZ_gl)
//
// where S_nl are the key's P stored signs of table l (±1) and u the query
// soft-hash of the G query heads of the group.  This is the paper's own
// CUDA scoring kernel in its factorized form (no 2^P bucket table).
//
// What bounds it on this card: the function is bound by bytes.  At the
// main path's shapes (BH=16, N=8224, W=20 words, G=4, L=60, P=10) a key
// costs 80 bytes of packed bits, ~3.3 us for all keys at 3.35 TB/s; with
// P split into two halves looked up in per-(g, l) tables of exp(.), each
// (key, g, l) term is one FMA (~0.9 us at 67 TFLOP/s).  This kernel's
// simpler algorithm spends G*L*P = 2400 sign-adds plus G*L = 240
// exponentials per key, ~11 us of fp32 issue, so it is bound by its own
// operations, not by memory as on the TPU.
//
// What the design does about it:
//   * one thread block per (bh, tile of keys), one thread per key;
//   * u (G,L,P) and logZ (G,L) are staged in shared memory once per block
//     (9.6 KB + 0.96 KB at the main path) and read as broadcasts, so the
//     inner loop is shared-memory reads and adds only;
//   * logZ is computed in the block from the staged u (240 values), which
//     saves the separate launches the plain version spends on it;
//   * the tile's bit rows are copied to shared memory with coalesced
//     32-bit loads, then each thread extracts its table's P-bit field with
//     one 64-bit shift (a table's P bits may straddle two words: P=10);
//   * only the L real tables are looped, which is the same function as the
//     TPU kernel's padding tables killed by logZ = 1e30;
//   * the key tail (N not a multiple of the tile) is masked in the kernel.
// A faster version would split P into two 5-bit halves and look both up in
// 32-entry tables per (g, l) in shared memory; that is later work.
//
// Bit layout (repro.core.hashing.pack_signs): flat bit f = l*P + p is bit
// f % 32 of word f / 32.  The port stores the words as int32 with the same
// bit pattern; they are read here as uint32.  The int8 format stores the
// L*P signs as ±1 bytes per key (bits_storage="int8").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool INT8>
__global__ void socket_score_kernel(const void* __restrict__ bits,
                                    const float* __restrict__ u,
                                    const float* __restrict__ vnorm,
                                    float* __restrict__ out,
                                    int n, int w, int g, int l, int p,
                                    float tau) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* su = reinterpret_cast<float*>(smem);       // (G, L, P)
  float* slogz = su + g * l * p;                    // (G, L)
  unsigned char* srows = reinterpret_cast<unsigned char*>(slogz + g * l);

  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * blockDim.x;
  const int glp = g * l * p;
  const int lp = l * p;
  const int rows = min((int)blockDim.x, n - n0);

  const float* ub = u + (size_t)bh * glp;
  for (int i = threadIdx.x; i < glp; i += blockDim.x) su[i] = ub[i];
  if (INT8) {
    const signed char* src =
        static_cast<const signed char*>(bits) + ((size_t)bh * n + n0) * lp;
    signed char* dst = reinterpret_cast<signed char*>(srows);
    for (int i = threadIdx.x; i < rows * lp; i += blockDim.x) dst[i] = src[i];
  } else {
    const uint32_t* src =
        static_cast<const uint32_t*>(bits) + ((size_t)bh * n + n0) * w;
    uint32_t* dst = reinterpret_cast<uint32_t*>(srows);
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  // logZ_gl = sum_p log(2 cosh(u/tau)) = sum_p |x| + log1p(exp(-2|x|))
  for (int i = threadIdx.x; i < g * l; i += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < p; ++j) {
      const float ax = fabsf(su[i * p + j] / tau);
      s += ax + log1pf(expf(-2.f * ax));
    }
    slogz[i] = s;
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= rows) return;
  float score = 0.f;
  for (int t = 0; t < l; ++t) {
    if (INT8) {
      const signed char* sg =
          reinterpret_cast<const signed char*>(srows) + (size_t)r * lp + t * p;
      for (int gg = 0; gg < g; ++gg) {
        const float* ut = su + (gg * l + t) * p;
        float dot = 0.f;
        for (int j = 0; j < p; ++j) dot += (float)sg[j] * ut[j];
        score += expf(dot / tau - slogz[gg * l + t]);
      }
    } else {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(srows) + r * w;
      const int f0 = t * p;
      const int w0 = f0 >> 5;
      const int b0 = f0 & 31;
      uint64_t two = row[w0];
      if (b0 + p > 32) two |= (uint64_t)row[w0 + 1] << 32;
      const uint32_t field = (uint32_t)(two >> b0);   // bit j = plane j
      for (int gg = 0; gg < g; ++gg) {
        const float* ut = su + (gg * l + t) * p;
        float dot = 0.f;
        for (int j = 0; j < p; ++j) {
          const float uj = ut[j];
          dot += ((field >> j) & 1u) ? uj : -uj;
        }
        score += expf(dot / tau - slogz[gg * l + t]);
      }
    }
  }
  const size_t o = (size_t)bh * n + n0 + r;
  if (vnorm != nullptr) score *= vnorm[o];
  out[o] = score;
}

template <bool INT8>
int launch(const void* bits, const float* u, const float* vnorm, float* out,
           int bh, int n, int w, int g, int l, int p, float tau,
           cudaStream_t stream) {
  const int block_n = INT8 ? 64 : 128;
  const size_t row_bytes = INT8 ? (size_t)l * p : (size_t)w * 4;
  const size_t smem = (size_t)(g * l * p + g * l) * sizeof(float) +
                      block_n * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        socket_score_kernel<INT8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + block_n - 1) / block_n, bh);
  socket_score_kernel<INT8><<<grid, block_n, smem, stream>>>(
      bits, u, vnorm, out, n, w, g, l, p, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bits: uint32 (BH, N, W) words, or int8 (BH, N, L*P) when bits_int8 != 0;
// u: f32 (BH, G, L, P); vnorm: f32 (BH, N) or NULL; out: f32 (BH, N).
// All contiguous on the device.  Returns the launch's cudaError_t.
int socket_score_launch(const void* bits, int bits_int8, const float* u,
                        const float* vnorm, float* out, int bh, int n, int w,
                        int g, int l, int p, float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits_int8)
    return launch<true>(bits, u, vnorm, out, bh, n, w, g, l, p, tau, s);
  return launch<false>(bits, u, vnorm, out, bh, n, w, g, l, p, tau, s);
}

const char* socket_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
