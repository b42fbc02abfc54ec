// Fused Quest paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/
// paged_quest.py (_quest_kernel, launched by paged_quest_pallas).  For one
// decode step of the continuous engine it runs, per (request b, KV head
// h), Quest's page-granular selection over the request's pages, reached
// through its block table (page p of the request is stat row p % ppb of
// block bt[b, p / ppb], ppb = bs / ps pages a block):
//
//   1. score:  every live page (page_start = p * ps < length[b]) gets its
//              upper bound  sum_g sum_d max(q_gd * kmin_pd, q_gd * kmax_pd),
//              the f32 products accumulated in float64 and rounded to f32
//              once (repro_torch.baselines.quest does the same, so the
//              two round to the same f32 in any summation order, unless a
//              sum lies within its own f64 rounding error of an f32
//              rounding boundary); sink pages (page_start < sink) and
//              window pages (page_start >= length - window - ps: one page
//              wider than the token window) are FLT_MAX instead.  Pages
//              past length are -1e30 and are not read: their stats may be
//              the pool's +-inf fill;
//   2. select: a 32-step MSB-first radix descent over the order-preserving
//              uint32 keys finds the budget-th largest page key thr, and
//              ties_needed = budget - count(key > thr).  Pages past length
//              stay selectable, as jax.lax.top_k takes budget pages
//              regardless: they all share one key, are counted and not
//              read, and come after every live page in the tie order;
//   3. attend: live pages are marked selected iff key > thr, or key ==
//              thr and fewer than ties_needed equal keys precede them in
//              flat page order; then the tokens t < length of selected
//              pages fold into an fp32 online softmax (m, l, acc) for the
//              G query heads, and the output is acc / max(l, 1e-30).
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _quest_kernel's
// `quantized` branch, paged_quest.py:142-149): with the per-row scale pools
// k_scale / v_scale each attended row is dequantized in-register as
// float(q) * scale[row] by paged_common.cuh's fold_rows.  The page stats
// stay f32; under quantized pages the engine computes them from the
// quantization round trip of the keys (quest.stats_from_quantized), so
// the bounds cover the values attended.
//
// Selection is exactly repro_torch.baselines.quest.select_tokens's; the page
// scores (and then the selected flags) go to an f32 scratch (B, KVH,
// nb * ppb) in device memory, which the wrapper allocates.
//
// What bounds it on this card: bytes.  The function must read the kmin and
// kmax rows of every live page that is not forced (2 * hd * 4 bytes per
// page and head: 1 KB at hd = 128) and the K/V rows of the selected pages'
// live tokens (2 * hd * 4 bytes each in f32, 2 * (hd + 4) as int8 or fp8
// with their scales), plus q and the output.  Its
// operations (4 per (page, g, d) and 4 * hd per selected row and g) take
// far less than the bytes at fp32 rates.
//
// What the design does about it (a simple, right first version):
//   * grid = (KVH, B), one block of 512 threads per (request, head), like
//     paged_attention.cu: the TPU's sequential page axis becomes loops
//     inside the block;
//   * the score pass gives each page to one warp: lanes read kmin/kmax
//     coalesced along hd and keep a float64 sum over (d, g); a warp
//     shuffle reduces it;
//   * q is staged in shared memory and read as broadcasts;
//   * the attend pass walks the tokens in tiles of 512, compacts the
//     selected ones (block-wide scans) to pool row indices and folds them
//     with paged_common.cuh's fold_rows, so only selected K/V rows are
//     read.
// Faster versions (more blocks per request, page stats kept on chip) are
// later work.
//
// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; kmin/kmax pages f32 (NB, KVH, ppb, hd); bt int32
// (B, nb); length, budget int32 (B,) (budget in pages).  The pool holds
// fewer than 2^31 rows (NB * KVH * bs; the wrapper checks).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"

namespace {

using paged::kNegInf;
using paged::kThreads;
using paged::kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_quest_kernel(const float* __restrict__ q,
                   const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const float* __restrict__ kmin_pages,
                   const float* __restrict__ kmax_pages,
                   const int* __restrict__ bt,
                   const int* __restrict__ lengths,
                   const int* __restrict__ budgets,
                   float* __restrict__ out, int* __restrict__ sel_out,
                   float* __restrict__ eff_scr, int kvh, int g, int hd,
                   int bs, int ps, int nb, float scale, int sink,
                   int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::Softmax sm_state;
  int *srow, *red;
  paged::carve_softmax(smem, g, hd, &sm_state, &srow, &red);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ppb = bs / ps;
  const int n_total = nb * bs, n_pages = nb * ppb;
  const int length = max(0, min(lengths[b], n_total));
  const int n_live = (length + ps - 1) / ps;     // pages with start < length
  const int budget = budgets[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * nb;
  float* eff = eff_scr + bh * n_pages;

  paged::softmax_init(sm_state, q + bh * g * hd, g, hd);
  __syncthreads();                        // q staged for the score pass

  // ---- 1. page upper bounds of the live pages ------------------------------
  for (int pg = warp; pg < n_live; pg += kWarps) {
    const int start = pg * ps;
    float e;
    if (start < sink || start >= length - window - ps) {
      e = FLT_MAX;
    } else {
      const size_t row =
          (static_cast<size_t>(btb[pg / ppb]) * kvh + h) * ppb + pg % ppb;
      const float* lo = kmin_pages + row * hd;
      const float* hi = kmax_pages + row * hd;
      double acc = 0.0;
      for (int d = lane; d < hd; d += 32) {
        const float lo_d = lo[d], hi_d = hi[d];
        for (int gg = 0; gg < g; ++gg) {
          const float qd = sm_state.sq[gg * hd + d];
          acc += static_cast<double>(
              fmaxf(__fmul_rn(qd, lo_d), __fmul_rn(qd, hi_d)));
        }
      }
      e = __double2float_rn(paged::warp_sum(acc));
    }
    if (lane == 0) eff[pg] = e;
  }
  __syncthreads();                        // eff visible to the whole block

  // ---- 2. radix-select the budget-th largest page key ----------------------
  // pages past length all hold -1e30: one key, n_inv of them
  const uint32_t k_inv = paged::sort_key(kNegInf);
  const int n_inv = n_pages - n_live;
  uint32_t prefix = 0;
  for (int s = 31; s >= 0; --s) {
    const uint32_t cand = prefix | (1u << s);
    int c = 0;
    for (int pg = tid; pg < n_live; pg += kThreads)
      c += paged::sort_key(eff[pg]) >= cand;
    c = paged::block_sum(c, red) + (k_inv >= cand ? n_inv : 0);
    if (c >= budget) prefix = cand;
  }
  const uint32_t thr = prefix;
  int gt = 0;
  for (int pg = tid; pg < n_live; pg += kThreads)
    gt += paged::sort_key(eff[pg]) > thr;
  const int ties_needed =
      budget - (paged::block_sum(gt, red) + (k_inv > thr ? n_inv : 0));

  // ---- 3a. mark the selected live pages (flat page order breaks ties) ------
  int ties_seen = 0;
  for (int p0 = 0; p0 < n_live; p0 += kThreads) {
    const int pg = p0 + tid;
    uint32_t key = 0;
    int is_eq = 0;
    if (pg < n_live) {
      key = paged::sort_key(eff[pg]);
      is_eq = key == thr;
    }
    int eq_total;
    const int rank =
        ties_seen + paged::block_exclusive_scan(is_eq, red, &eq_total);
    ties_seen += eq_total;
    if (pg < n_live)
      eff[pg] = (key > thr || (is_eq && rank < ties_needed)) ? 1.f : 0.f;
  }
  __syncthreads();                        // flags visible to the whole block

  // ---- 3b. attend over the live rows of the selected pages -----------------
  for (int n0 = 0; n0 < length; n0 += kThreads) {
    const int t = n0 + tid;
    const int is_sel = t < length && eff[t / ps] != 0.f;
    if (sel_out != nullptr && t < length) sel_out[bh * n_total + t] = is_sel;
    int cnt;
    const int slot = paged::block_exclusive_scan(is_sel, red, &cnt);
    if (is_sel) srow[slot] = (btb[t / bs] * kvh + h) * bs + t % bs;
    __syncthreads();
    if (cnt == 0) continue;               // uniform across the block
    paged::fold_rows(sm_state, cnt, srow, k_pages, v_pages, k_scale, v_scale,
                     g, hd, scale, 0.f);
  }
  __syncthreads();
  paged::softmax_store(sm_state, out + bh * g * hd, g, hd);
  if (sel_out != nullptr)
    for (int t = length + tid; t < n_total; t += kThreads)
      sel_out[bh * n_total + t] = 0;
}

template <typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale,
           const float* kmin_pages, const float* kmax_pages, const int* bt,
           const int* lengths, const int* budgets, float* out, int* sel,
           float* eff, int b, int kvh, int g, int hd, int bs, int ps, int nb,
           float scale, int sink, int window, cudaStream_t stream) {
  const size_t smem = paged::softmax_smem_bytes(g, hd);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_quest_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(kvh, b);
  paged_quest_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, kmin_pages, kmax_pages, bt,
      lengths, budgets, out, sel, eff, kvh, g, hd, bs, ps, nb, scale, sink,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages; sel is int32
// (B, KVH, nb, bs) or NULL; eff is f32 (B, KVH, nb * bs / ps) scratch.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an unknown
// kv_type).
int paged_quest_attend_launch(const float* q, const void* k_pages,
                              const void* v_pages, const float* k_scale,
                              const float* v_scale, const float* kmin_pages,
                              const float* kmax_pages, const int* bt,
                              const int* lengths, const int* budgets,
                              float* out, int* sel, float* eff, int kv_type,
                              int b, int kvh, int g, int hd, int bs, int ps,
                              int nb, float scale, int sink, int window,
                              void* stream) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T>(q, static_cast<const T*>(k_pages),
                     static_cast<const T*>(v_pages), k_scale, v_scale,
                     kmin_pages, kmax_pages, bt, lengths, budgets, out, sel,
                     eff, b, kvh, g, hd, bs, ps, nb, scale, sink, window,
                     static_cast<cudaStream_t>(stream));
  });
}

const char* paged_quest_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
