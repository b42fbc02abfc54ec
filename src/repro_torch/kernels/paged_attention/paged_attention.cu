// Fused SOCKET and hard-LSH paged decode attention for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/
// paged_attention.py (_fused_kernel with mode="socket", launched by
// _fused_call from paged_attention_pallas) and, as Mode::kHardLsh, the
// same kernel's mode="hard_lsh" reached from paged_hard_lsh.py
// (paged_hard_lsh_pallas).  For one decode step of the
// continuous engine it runs, per (request b, KV head h), the whole SOCKET
// decode pipeline over the request's pages, reached through its block table:
//
//   1. score:  for every logical token t < length[b], follow
//              bt[b, t / bs], unpack the token's packed sign words, form
//                eff[t] = vnorm[t] * sum_g sum_l exp(<S_tl, u_gl> / tau - logZ_gl)
//              and overlay the forced sink/window rows with FLT_MAX (rows at
//              or past length are -1e30 and are not scored);
//   2. select: a 32-step MSB-first radix descent over the order-preserving
//              uint32 keys of eff finds the budget-th largest key thr, and
//              ties_needed = budget - count(key > thr);
//   3. attend: walk the tokens in logical order; token t is selected iff
//              key > thr, or key == thr and fewer than ties_needed equal keys
//              precede it (jax.lax.top_k's lowest-index-first order), and
//              eff > -5e29.  Selected K/V rows fold into an fp32 online
//              softmax (m, l, acc) for the G query heads of the group; the
//              output is acc / max(l, 1e-30).
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _fused_kernel's
// `quantized` branch, paged_attention.py:176-180): with the per-row scale
// pools k_scale / v_scale each selected row is dequantized in-register as
// float(q) * scale[row] (paged_common.cuh's fold_rows, a template on the
// element type).  Scoring reads only bits and vnorm, so the selection on
// quantized pages is bit for bit the selection on f32 pages.
//
// Hard LSH (Mode::kHardLsh) differs in the score term only: a table
// collides when the key's P-bit field equals the query's sign pattern
// (bit j set where the query's plane-j sign u_signs[g, l, j] is +1, packed
// per (g, l) while the block stages it in shared memory), and
//   eff[t] = vnorm[t] * sum_g sum_{l < L} 1[field_tl == pattern_gl],
// one integer compare per (token, g, l) over the L real tables only (a
// compare against a zero pattern would count the padded tables, whose
// key bits are 0).  The counts are small integers, exact in f32, so the
// scores and the selection equal the plain version's bit for bit.  The
// hard-LSH pass moves the same bytes as the SOCKET one and is bound by
// them.
//
// Selection is exactly repro.core.socket.value_aware_topk's; nothing but the
// output (and, for tests, the selection mask) leaves the kernel except the
// eff scratch (B, KVH, nb*bs) f32 in device memory, which the wrapper
// allocates: shared memory would cap the context near 56K tokens.
//
// What bounds it on this card: bytes.  The function must read, per request
// and head, the bits and vnorm of every scored token (W*4 + 2 bytes: 82 B at
// P=10, L=60; the sink and window rows are selected by position and need
// neither, nor does any row of a request whose budget is no more than its
// sink and window rows) and only the selected K/V rows, forced ones
// included (2*hd*4 bytes each: 1 KB at hd=128 in fp32; 2*(hd+4) bytes, 264 B,
// as int8 or fp8 with their scales).  At the continuous
// path (8 requests of 1-4K tokens, 8 KV heads, 256-410 rows selected per
// request and head; the 1K and 2K requests select only their 256 forced
// rows) that is 8.7 MB of bits/vnorm plus 20.2 MB of K/V rows: ~9 us at
// 3.35 TB/s.  The kernel itself also reads the forced rows' bits (it
// loads whole tiles) and scores every request.  The scoring needs one FMA per (scored token, g, l)
// with P split into table lookups; this simple kernel spends G*l_pad*P
// sign-adds and G*l_pad exponentials per token, like socket_score.cu, so
// its score pass is bound by its own operations.
//
// What the design does about it (a simple, right first version):
//   * grid = (KVH, B), one block of 512 threads per (request, head): the
//     TPU's sequential page axis becomes loops inside the block, and 16
//     warps per block hide the latency of the score pass's chains;
//   * u and logZ (padded tables: u = 0, logZ = 1e30, computed by the
//     wrapper), or hard LSH's sign patterns, and q are staged in shared
//     memory and read as broadcasts;
//   * bit rows are copied tile by tile into shared memory with coalesced
//     32-bit loads through the block table (a page's rows are contiguous);
//   * rows at or past length are never read: their key is a constant, so
//     the radix counts add n_total - length where it applies;
//   * the attend pass compacts each tile's selected tokens (block-wide
//     scans) with their pool row indices, scores them one warp per row
//     with coalesced K loads, and accumulates P.V with threads over
//     (g, d), so only selected K/V rows are read.
// Faster versions (split-P table lookups, more blocks per request, keys kept
// on chip) are later work.
//
// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; bits uint32 (NB, KVH, bs, W) (the port stores int32
// with the same bit pattern; flat bit f = l*P + p is bit f%32 of word f/32);
// vnorm bf16 (NB, KVH, bs); u_pad f32 (B, KVH, GS, l_pad, P) with GS = G
// (kvhead) or 1 (pooled); logz_pad f32 (B, KVH, GS, l_pad); hard LSH
// takes u_signs f32 +-1 (B, KVH, GS, L, P) in u_pad's place and no logZ;
// bt int32 (B, nb); length, budget int32 (B,).  The pool holds fewer than 2^31 rows
// (NB * KVH * bs; the wrapper checks), so a row index is an int.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"

namespace {

using paged::kNegInf;
using paged::kThreads;
using paged::kWarps;

// Scoring mode of the fused pass.
enum class Mode { kSocket, kHardLsh };

template <Mode M, typename T>
__global__ void __launch_bounds__(kThreads)
paged_socket_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const uint32_t* __restrict__ bits_pages,
                    const uint16_t* __restrict__ vnorm_pages,
                    const float* __restrict__ qhash,
                    const float* __restrict__ logz_pad,
                    const int* __restrict__ bt,
                    const int* __restrict__ lengths,
                    const int* __restrict__ budgets,
                    float* __restrict__ out, int* __restrict__ sel_out,
                    float* __restrict__ eff_scr, int kvh, int g, int gs,
                    int hd, int bs, int w, int nb, int nl, int p,
                    float tau, float scale, int sink, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::Softmax sm_state;
  int *srow, *red;
  unsigned char* rest =
      paged::carve_softmax(smem, g, hd, &sm_state, &srow, &red);
  // query hash over the nl tables scored (SOCKET: l_pad, hard LSH: L):
  // u (GS, nl, P) and logZ (GS, nl), or the sign patterns (GS, nl)
  const int u_words = M == Mode::kSocket ? gs * nl * p : gs * nl;
  const int z_words = M == Mode::kSocket ? gs * nl : 0;
  float* su = reinterpret_cast<float*>(rest);
  uint32_t* spat = reinterpret_cast<uint32_t*>(rest);
  float* slogz = su + u_words;
  uint32_t* swords = reinterpret_cast<uint32_t*>(slogz + z_words);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n_total = nb * bs;
  const int length = max(0, min(lengths[b], n_total));
  const int budget = budgets[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * nb;
  float* eff = eff_scr + bh * n_total;

  const float* ub = qhash + bh * gs * nl * p;
  if (M == Mode::kSocket) {
    for (int i = tid; i < u_words; i += kThreads) su[i] = ub[i];
    const float* lb = logz_pad + bh * z_words;
    for (int i = tid; i < z_words; i += kThreads) slogz[i] = lb[i];
  } else {
    for (int i = tid; i < u_words; i += kThreads) {
      uint32_t pat = 0;
      for (int j = 0; j < p; ++j) pat |= (ub[i * p + j] > 0.f ? 1u : 0u) << j;
      spat[i] = pat;
    }
  }
  paged::softmax_init(sm_state, q + bh * g * hd, g, hd);
  const uint32_t pmask = p < 32 ? (1u << p) - 1u : 0xffffffffu;

  // ---- 1. score every valid token into eff --------------------------------
  for (int n0 = 0; n0 < length; n0 += kThreads) {
    const int rows = min(kThreads, length - n0);
    __syncthreads();                      // previous tile's words consumed
    for (int i = tid; i < rows * w; i += kThreads) {
      const int r = i / w, word = i - r * w, t = n0 + r;
      const size_t row = (static_cast<size_t>(btb[t / bs]) * kvh + h) * bs +
                         t % bs;
      swords[i] = bits_pages[row * w + word];
    }
    __syncthreads();
    if (tid < rows) {
      const int t = n0 + tid;
      float e;
      if (t < sink || t >= length - window) {
        e = FLT_MAX;
      } else {
        const uint32_t* row = swords + tid * w;
        float score = 0.f;
        int hits = 0;
        for (int gg = 0; gg < gs; ++gg) {
          float sg = 0.f;
          for (int tb = 0; tb < nl; ++tb) {
            const int f0 = tb * p, w0 = f0 >> 5, b0 = f0 & 31;
            uint64_t two = row[w0];
            if (b0 + p > 32) two |= static_cast<uint64_t>(row[w0 + 1]) << 32;
            const uint32_t field = static_cast<uint32_t>(two >> b0);
            if (M == Mode::kSocket) {
              const float* ut = su + (gg * nl + tb) * p;
              float dot = 0.f;
              for (int j = 0; j < p; ++j)
                dot += ((field >> j) & 1u) ? ut[j] : -ut[j];
              sg += expf(dot / tau - slogz[gg * nl + tb]);
            } else {
              hits += (field & pmask) == spat[gg * nl + tb];
            }
          }
          score += sg;
        }
        const size_t vrow = (static_cast<size_t>(btb[t / bs]) * kvh + h) *
                                bs + t % bs;
        const float vn = paged::bf16_to_float(vnorm_pages[vrow]);
        e = M == Mode::kSocket ? score * vn : static_cast<float>(hits) * vn;
      }
      eff[t] = e;
    }
  }
  __syncthreads();                        // eff visible to the whole block

  // ---- 2. radix-select the budget-th largest key --------------------------
  // rows at or past length all hold eff = -1e30: one key, n_inv of them
  const uint32_t k_inv = paged::sort_key(kNegInf);
  const int n_inv = n_total - length;
  uint32_t prefix = 0;
  for (int s = 31; s >= 0; --s) {
    const uint32_t cand = prefix | (1u << s);
    int c = 0;
    for (int t = tid; t < length; t += kThreads)
      c += paged::sort_key(eff[t]) >= cand;
    c = paged::block_sum(c, red) + (k_inv >= cand ? n_inv : 0);
    if (c >= budget) prefix = cand;
  }
  const uint32_t thr = prefix;
  int gt = 0;
  for (int t = tid; t < length; t += kThreads)
    gt += paged::sort_key(eff[t]) > thr;
  const int ties_needed =
      budget - (paged::block_sum(gt, red) + (k_inv > thr ? n_inv : 0));

  // ---- 3. attend over the selected rows, in logical order -----------------
  int ties_seen = 0;
  for (int n0 = 0; n0 < length; n0 += kThreads) {
    const int t = n0 + tid;
    float e = kNegInf;
    uint32_t key = 0;
    int is_eq = 0;
    if (t < length) {
      e = eff[t];
      key = paged::sort_key(e);
      is_eq = key == thr;
    }
    int eq_total;
    const int rank =
        ties_seen + paged::block_exclusive_scan(is_eq, red, &eq_total);
    ties_seen += eq_total;
    const int is_sel = t < length &&
                       (key > thr || (is_eq && rank < ties_needed)) &&
                       e > -5e29f;
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

template <Mode M, typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale,
           const uint32_t* bits_pages, const uint16_t* vnorm_pages,
           const float* qhash, const float* logz_pad, const int* bt,
           const int* lengths, const int* budgets, float* out, int* sel,
           float* eff, int b, int kvh, int g, int gs, int hd, int bs, int w,
           int nb, int nl, int p, float tau, float scale, int sink,
           int window, cudaStream_t stream) {
  const int u_words = M == Mode::kSocket ? gs * nl * p : gs * nl;
  const int z_words = M == Mode::kSocket ? gs * nl : 0;
  const size_t smem =
      paged::softmax_smem_bytes(g, hd) +
      static_cast<size_t>(u_words + z_words + kThreads * w) * 4;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_socket_kernel<M, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(kvh, b);
  paged_socket_kernel<M, T><<<grid, kThreads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, bits_pages, vnorm_pages, qhash,
      logz_pad, bt,
      lengths, budgets, out, sel, eff, kvh, g, gs, hd, bs, w, nb, nl, p, tau,
      scale, sink, window);
  return static_cast<int>(cudaGetLastError());
}

// launch<M, T> with T the element type of kv_type.
template <Mode M>
int launch_kv(int kv_type, const float* q, const void* k_pages,
              const void* v_pages, const float* k_scale,
              const float* v_scale, const void* bits_pages,
              const void* vnorm_pages, const float* qhash,
              const float* logz_pad, const int* bt, const int* lengths,
              const int* budgets, float* out, int* sel, float* eff, int b,
              int kvh, int g, int gs, int hd, int bs, int w, int nb, int nl,
              int p, float tau, float scale, int sink, int window,
              void* stream) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<M, T>(
        q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        k_scale, v_scale, static_cast<const uint32_t*>(bits_pages),
        static_cast<const uint16_t*>(vnorm_pages), qhash, logz_pad, bt,
        lengths, budgets, out, sel, eff, b, kvh, g, gs, hd, bs, w, nb, nl, p,
        tau, scale, sink, window, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages; sel is int32
// (B, KVH, nb, bs) or NULL; eff is f32 (B, KVH, nb*bs) scratch.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for an unknown kv_type).
int paged_socket_attend_launch(const float* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const void* bits_pages,
                               const void* vnorm_pages, const float* u_pad,
                               const float* logz_pad, const int* bt,
                               const int* lengths, const int* budgets,
                               float* out, int* sel, float* eff, int kv_type,
                               int b, int kvh, int g, int gs, int hd, int bs,
                               int w, int nb, int l_pad, int p, float tau,
                               float scale, int sink, int window,
                               void* stream) {
  return launch_kv<Mode::kSocket>(
      kv_type, q, k_pages, v_pages, k_scale, v_scale, bits_pages,
      vnorm_pages, u_pad, logz_pad, bt, lengths, budgets, out, sel, eff, b,
      kvh, g, gs, hd, bs, w, nb, l_pad, p, tau, scale, sink, window, stream);
}

// As paged_socket_attend_launch, with u_signs f32 +-1 (B, KVH, GS, l, P)
// (the query's plane signs; only the l real tables, so padded tables are
// never scored) in place of u and logZ.
int paged_hard_lsh_attend_launch(const float* q, const void* k_pages,
                                 const void* v_pages, const float* k_scale,
                                 const float* v_scale, const void* bits_pages,
                                 const void* vnorm_pages,
                                 const float* u_signs, const int* bt,
                                 const int* lengths, const int* budgets,
                                 float* out, int* sel, float* eff,
                                 int kv_type, int b, int kvh, int g, int gs,
                                 int hd, int bs, int w, int nb, int l, int p,
                                 float scale, int sink, int window,
                                 void* stream) {
  return launch_kv<Mode::kHardLsh>(
      kv_type, q, k_pages, v_pages, k_scale, v_scale, bits_pages,
      vnorm_pages, u_signs, nullptr, bt, lengths, budgets, out, sel, eff, b,
      kvh, g, gs, hd, bs, w, nb, l, p, 1.f, scale, sink, window, stream);
}

const char* paged_socket_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
