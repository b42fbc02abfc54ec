// Fused sliding-window (ring) paged decode attention for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/
// paged_ring.py (_ring_kernel, launched by paged_ring_pallas).  A hybrid
// model's local layers keep only the last `window` tokens, in a circular
// page list: the first ring_blocks entries of a request's block table,
// with flat ring slot s = t % cap (cap = ring_blocks * bs) holding the
// newest token t of that residue.  For one decode step, per (request b,
// KV head h), the kernel
//
//   1. rebuilds each slot's absolute position
//        ring_pos = pos - ((pos - s) mod cap)
//      with a non-negative modulo (CUDA's % truncates toward zero, so it
//      is ((pos - s) % cap + cap) % cap), and keeps the slot iff
//      ring_pos >= 0 (written) and pos - ring_pos < window (in the
//      window; with window < cap a page holds rows that aged out);
//   2. folds the kept rows, and only those, into an fp32 online softmax
//      (m, l, acc) for the G query heads, each logit s = q.k * scale
//      capped to softcap * tanh(s / softcap) when softcap > 0; dead slots
//      are skipped, never multiplied by 0: a recycled page or the trash
//      page may hold anything, NaN included;
//   3. writes acc / max(l, 1e-30).
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _ring_kernel's
// `quantized` branch, paged_ring.py:69-72): with the per-row scale pools
// k_scale / v_scale each live row is dequantized in-register as
// float(q) * scale[row] by paged_common.cuh's fold_rows.  A dead slot's
// scale and fp8 payload may hold NaN too: they are skipped like its f32
// rows, never read.
//
// What bounds it on this card: bytes.  The function must read the K and V
// rows of the live slots (2 * hd * 4 bytes each: 1 KB at hd = 128 in f32;
// 2 * (hd + 4) bytes, 264 B, as int8 or fp8 with their scales), the
// ring slice of the block table, q and the output; its operations
// (4 * hd per live row and query head) take far less at fp32 rates.
//
// What the design does about it (a simple, right first version):
//   * grid = (KVH, B), one block of 512 threads per (request, head), like
//     paged_quest.cu: the TPU's sequential ring-block grid axis becomes a
//     loop over tiles of 512 slots inside the block;
//   * each tile compacts its live slots to pool row indices (a block-wide
//     scan) and folds them with paged_common.cuh's fold_rows: one warp
//     per row with coalesced K loads, threads over (g, d) for P V.
// Faster versions (several blocks per request at small batch, K/V tiles
// staged through shared memory) are later work.
//
// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; bt int32 (B, ring_blocks), the ring slice of the
// table; pos int32 (B,), the decode token's position (already written to
// its slot).  The pool holds fewer than 2^31 rows (NB * KVH * bs; the
// wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"

namespace {

using paged::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_ring_kernel(const float* __restrict__ q,
                  const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ bt, const int* __restrict__ poss,
                  float* __restrict__ out, int kvh, int g, int hd, int bs,
                  int rb, float scale, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::Softmax sm_state;
  int *srow, *red;
  paged::carve_softmax(smem, g, hd, &sm_state, &srow, &red);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cap = rb * bs;
  const int pos = poss[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * rb;

  paged::softmax_init(sm_state, q + bh * g * hd, g, hd);
  __syncthreads();                        // q staged for the first fold

  for (int n0 = 0; n0 < cap; n0 += kThreads) {
    const int s = n0 + tid;
    int live = 0;
    if (s < cap) {
      const int back = ((pos - s) % cap + cap) % cap;   // floor mod
      const int ring_pos = pos - back;
      live = ring_pos >= 0 && back < window;
    }
    int cnt;
    const int slot = paged::block_exclusive_scan(live, red, &cnt);
    if (live) srow[slot] = (btb[s / bs] * kvh + h) * bs + s % bs;
    __syncthreads();
    if (cnt == 0) continue;               // uniform across the block
    paged::fold_rows(sm_state, cnt, srow, k_pages, v_pages, k_scale, v_scale,
                     g, hd, scale, softcap);
    __syncthreads();                      // srow and ss reused next tile
  }
  __syncthreads();
  paged::softmax_store(sm_state, out + bh * g * hd, g, hd);
}

template <typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale, const int* bt,
           const int* pos, float* out, int b, int kvh, int g, int hd, int bs,
           int rb, float scale, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = paged::softmax_smem_bytes(g, hd);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(kvh, b);
  paged_ring_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, bt, pos, out, kvh, g, hd, bs,
      rb, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unknown kv_type).
int paged_ring_attend_launch(const float* q, const void* k_pages,
                             const void* v_pages, const float* k_scale,
                             const float* v_scale, const int* bt,
                             const int* pos, float* out, int kv_type, int b,
                             int kvh, int g, int hd, int bs, int rb,
                             float scale, int window, float softcap,
                             void* stream) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T>(q, static_cast<const T*>(k_pages),
                     static_cast<const T*>(v_pages), k_scale, v_scale, bt,
                     pos, out, b, kvh, g, hd, bs, rb, scale, window, softcap,
                     static_cast<cudaStream_t>(stream));
  });
}

const char* paged_ring_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
