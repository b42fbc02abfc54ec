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
//   2. select: the budget-th largest order-preserving uint32 page key
//              thr, and ties_needed = budget - count(key > thr).  Pages
//              past length stay selectable, as jax.lax.top_k takes budget
//              pages regardless: they all share one key, are counted and
//              not read, and come after every live page in the tie order;
//   3. attend: live pages are selected iff key > thr, or key == thr and
//              fewer than ties_needed equal keys precede them in flat page
//              order; then the tokens t < length of selected pages fold
//              into an fp32 online softmax (m, l, acc) for the G query
//              heads, and the output is acc / max(l, 1e-30).
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _quest_kernel's
// `quantized` branch, paged_quest.py:142-149): with the per-row scale pools
// k_scale / v_scale each attended row is dequantized in-register as
// float(q) * scale[row].  The page stats stay f32; under quantized pages
// the engine computes them from the quantization round trip of the keys
// (quest.stats_from_quantized), so the bounds cover the values attended.
//
// Selection is exactly repro_torch.baselines.quest.select_tokens's.  The
// page scores go to an f32 scratch (B, KVH, nb * ppb) in device memory,
// which the wrapper allocates and which stays in L2: it serves every
// context the engine admits with one code path, where shared memory would
// cap it.
//
// What bounds it on this card: bytes.  The function must read the kmin and
// kmax rows of every live page that is not forced (2 * hd * 4 bytes per
// page and head: 1 KB at hd = 128) and the K/V rows of the selected pages'
// live tokens (2 * hd * 4 bytes each in f32, 2 * (hd + 4) as int8 or fp8
// with their scales), plus q and the output: at the continuous path (8
// requests of 1-4K tokens, 8 KV heads, a page budget of 26) 8.4 MB of
// bounds and 27 MB of K/V rows, ~11 us at 3.35 TB/s.  Its operations (4
// per (page, g, d) and 4 * hd per selected row and g) take far less.
//
// What the design does about it:
//   * cluster split: grid (C, KVH, B), one thread-block cluster of C CTAs
//     per (request, head), launched with cudaLaunchKernelEx; C is
//     paged_cluster.cuh's plan_cluster choice (the largest C <= 8, and at
//     most one rank per kPagesPerRank pages of the table, whose B * KVH
//     clusters the card holds at once; if no cluster fits, the launch
//     fails).  Rank r owns the pages of the r-th contiguous run of the
//     request's live blocks; a rank past length only takes part in the
//     barriers;
//   * staged page bounds: the pages a rank scores (neither sink nor window:
//     one contiguous run) have their kmin and kmax rows copied into shared
//     memory by 16-byte cp.async copies in a ring of chunk stages of
//     kStatPages pages, the first ones issued before q is staged; a warp
//     scores a page from shared memory (lanes over d, q broadcast from
//     shared memory, a float64 sum reduced by shuffles);
//   * select: paged_cluster.cuh's four rounds of 8-bit radix digits over
//     the cluster, the n_pages - n_live pages past length counted once;
//     rank r starts its tie count at the keys equal to thr in ranks < r;
//   * attend: each rank writes the first pool row of each of its selected
//     pages, in page order, over the consumed head of its score range, and
//     counts their live rows; every rank then folds an even share of the
//     cluster's rows (row k is row k % ps of its list's page k / ps: only
//     the last live page can be short, and it comes last) through
//     paged_cluster.cuh's ring of K/V chunk stages, q.k and p.v from
//     shared memory; the C partial (m, l, acc) states merge over
//     distributed shared memory.
// Barriers a launch: four cluster barriers for the select, one for the
// lists, two around the merge.
//
// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; kmin/kmax pages f32 (NB, KVH, ppb, hd);
// bt int32 (B, nb); length, budget int32 (B,) (budget in pages).  The pool
// holds fewer than 2^31 rows (NB * KVH * bs; the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "paged_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using paged::FastDiv;
using paged::align16;
using paged::cp_async;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::kThreads;
using paged::kWarps;
using paged::sort_key;

constexpr int kMinBlocks = 2;        // CTAs an SM must fit (registers)
// table pages a CTA, choosing C: at the continuous path's 264 pages C 2
// (0.0586 ms) ran ahead of C 3 (0.0601), the largest C of one wave
constexpr int kPagesPerRank = 256;
constexpr int kStatPages = 16;       // pages a chunk of bounds holds
constexpr int kRingBytes = 64 * 1024;    // the bounds' or the K/V ring

// Byte offsets of the shared-memory arrays (all 16-byte aligned): those
// every cluster kernel has (paged_cluster.cuh), then one region that holds
// the score pass's ring of bounds and then the attend pass's ring of K/V
// chunk stages.
struct Layout {
  paged::ClusterSmem head;
  size_t ring, stat_buf, kv_buf, total;
  int stat_stages, stages;
};

__host__ __device__ inline Layout layout(int g, int hd, int rows,
                                         int tsize) {
  Layout s;
  size_t o = 0;
  s.head = paged::cluster_smem(g, hd, rows, &o);
  s.ring = o;
  // a chunk: the kmin rows of kStatPages pages, then their kmax rows
  s.stat_buf = align16(static_cast<size_t>(2) * kStatPages * hd * 4);
  const size_t fit = kRingBytes / s.stat_buf;
  s.stat_stages = fit < 2 ? 2 : fit > paged::kMaxStages
                                    ? paged::kMaxStages
                                    : static_cast<int>(fit);
  s.kv_buf = align16(static_cast<size_t>(rows) * hd * tsize);
  s.stages = paged::ring_stages(kRingBytes, s.kv_buf);
  const size_t stats = s.stat_buf * s.stat_stages;
  const size_t kv = 2 * s.kv_buf * s.stages;
  s.total = o + (stats > kv ? stats : kv);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
                   int window, int rows, int vec, int stat_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const Layout lay = layout(g, hd, rows, sizeof(T));
  const paged::Fold fold = paged::carve_fold(smem, lay.head, g, lay.ring,
                                             lay.kv_buf, rows, lay.stages);
  int* red = reinterpret_cast<int*>(smem + lay.head.red);
  int* shist = reinterpret_cast<int*>(smem + lay.head.hist);
  int* smisc = reinterpret_cast<int*>(smem + lay.head.misc);
  float* sstat = reinterpret_cast<float*>(smem + lay.ring);

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ppb = bs / ps;
  const int n_total = nb * bs, n_pages = nb * ppb;
  const int length = max(0, min(lengths[b], n_total));
  const int n_live = (length + ps - 1) / ps;     // pages with start < length
  const int budget = budgets[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * nb;
  float* eff = eff_scr + bh * n_pages;
  // this rank's run of the request's live blocks, as pages [p0, p1)
  const int used = (length + bs - 1) / bs;
  const int per = (used + nranks - 1) / nranks;
  const int p0 = min(n_live, rank * per * ppb);
  const int p1 = min(n_live, (rank + 1) * per * ppb);
  // its pages scored by their bounds, [f0, f1): page_start >= sink and
  // page_start < length - window - ps
  const int lim = length - window - ps;
  const int f0 = max(p0, sink > 0 ? (sink + ps - 1) / ps : 0);
  const int f1 = max(f0, min(p1, lim > 0 ? (lim + ps - 1) / ps : 0));

  // ---- 0. the first chunks of bounds; q --------------------------------
  const int stat_stages = lay.stat_stages;
  const int pieces = hd * 4 / stat_vec;
  const FastDiv div_pieces(pieces);
  const int chunks = (f1 - f0 + kStatPages - 1) / kStatPages;
  // the kmin and kmax rows of chunk c's pages into stage st
  auto issue = [&](int c, int st) {
    const int pa = f0 + c * kStatPages, n = min(kStatPages, f1 - pa);
    const int per_kind = n * pieces;
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(sstat) + st * lay.stat_buf;
    for (int i = tid; i < 2 * per_kind; i += kThreads) {
      const int which = i >= per_kind, j = i - which * per_kind;
      const int r = div_pieces(j), piece = j - r * pieces;
      const int pg = pa + r;
      const size_t row =
          (static_cast<size_t>(btb[pg / ppb]) * kvh + h) * ppb + pg % ppb;
      cp_async(dst + ((which * kStatPages + r) * hd) * 4 + piece * stat_vec,
               reinterpret_cast<const unsigned char*>(
                   (which ? kmax_pages : kmin_pages) + row * hd) +
                   piece * stat_vec,
               stat_vec);
    }
    cp_async_commit();
  };
  for (int c = 0; c < min(stat_stages - 1, chunks); ++c) issue(c, c);
  paged::init_fold(fold, q + bh * g * hd, g, hd);
  // sink and window pages: selected by position, not read
  for (int pg = p0 + tid; pg < p1; pg += kThreads)
    if (pg < f0 || pg >= f1) eff[pg] = FLT_MAX;

  // ---- 1. page upper bounds from shared memory -------------------------
  for (int c = 0; c < chunks; ++c) {
    const int ahead = c + stat_stages - 1;
    if (ahead < chunks) issue(ahead, ahead % stat_stages);
    cp_async_wait(min(chunks, c + stat_stages) - c - 1);
    __syncthreads();                      // chunk c's bounds (and q) in
    const int pa = f0 + c * kStatPages, n = min(kStatPages, f1 - pa);
    const float* lo = sstat + (c % stat_stages) * (lay.stat_buf / 4);
    const float* hi = lo + kStatPages * hd;
    for (int r = warp; r < n; r += kWarps) {
      double acc = 0.0;
      for (int d = lane; d < hd; d += 32) {
        const float lo_d = lo[r * hd + d], hi_d = hi[r * hd + d];
        for (int gg = 0; gg < g; ++gg) {
          const float qd = fold.sq[gg * hd + d];
          acc += static_cast<double>(
              fmaxf(__fmul_rn(qd, lo_d), __fmul_rn(qd, hi_d)));
        }
      }
      acc = paged::warp_sum(acc);
      if (lane == 0) eff[pa + r] = __double2float_rn(acc);
    }
    __syncthreads();                      // stage free again
  }

  // ---- 2. select: 8-bit radix digits over the cluster ----------------------
  // pages past length all hold -1e30: one key, counted once
  const paged::Threshold sel = paged::cluster_select(
      cluster, rank, nranks, p0, p1,
      [&](int pg) { return sort_key(eff[pg]); }, n_pages - n_live, budget,
      shist, smisc);

  // ---- 3. attend over the live rows of the selected pages ------------------
  // 3a. this rank's selected pages, in page order: sel_out, their first
  // pool rows written over the consumed head of the rank's eff range
  // (position p0 + k holds the k-th; k never passes the page being read),
  // and their live rows counted
  int* list = reinterpret_cast<int*>(eff);
  int ties_seen = sel.eq_before, found = 0, live_rows = 0;
  for (int n0 = p0; n0 < p1; n0 += kThreads) {
    const int pg = n0 + tid;
    uint32_t key = 0;
    int is_eq = 0;
    if (pg < p1) {
      key = sort_key(eff[pg]);
      is_eq = key == sel.thr;
    }
    int eq_total;
    const int rank_eq =
        ties_seen + paged::block_exclusive_scan(is_eq, red, &eq_total);
    ties_seen += eq_total;
    const int is_sel = pg < p1 && (key > sel.thr ||
                                   (is_eq && rank_eq < sel.ties_needed));
    const int start = pg * ps, live = min(ps, length - start);
    if (sel_out != nullptr && pg < p1)
      for (int i = 0; i < live; ++i)
        sel_out[bh * n_total + start + i] = is_sel;
    int cnt;
    const int slot = paged::block_exclusive_scan(is_sel, red, &cnt);
    if (is_sel) {
      list[p0 + found + slot] = (btb[pg / ppb] * kvh + h) * bs + start % bs;
      live_rows += live;
    }
    found += cnt;
  }
  live_rows = paged::block_sum(live_rows, red);
  if (tid == 0) smisc[3] = live_rows;
  cluster.sync();                         // every rank's list written

  // 3b. an even share of the cluster's rows, whichever rank found them
  int* sbase = smisc + 4;                 // each rank's live rows
  int k_lo, k_hi;
  paged::share_rows(cluster, rank, nranks, smisc, sbase, &k_lo, &k_hi);
  // the pool row of the cluster's k-th selected row: row k % ps of the
  // list's page k / ps, read from L2 (ranks' ranges are whole blocks, not
  // whole 128-byte lines, so this SM's L1 may hold a stale copy of a line
  // where another rank wrote its list)
  auto row_at = [&](int k) {
    int rr = 0;
    while (rr + 1 < nranks && k >= sbase[rr]) k -= sbase[rr++];
    const int j = k / ps;
    return __ldcg(list + min(n_live, rr * per * ppb) + j) + (k - j * ps);
  };
  paged::fold_list(fold, k_lo, k_hi, row_at, k_pages, v_pages, k_scale,
                   v_scale, g, hd, scale, vec);
  if (sel_out != nullptr)
    for (int t = length + rank * kThreads + tid; t < n_total;
         t += nranks * kThreads)
      sel_out[bh * n_total + t] = 0;

  // ---- 4. merge the ranks' (m, l, acc) and write the output ---------------
  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd);
}

// The largest cluster size worth taking for a table of n_pages pages:
// about kPagesPerRank pages a CTA, at most kMaxCluster.
inline int cluster_cap(int n_pages) {
  return std::max(1, std::min(paged::kMaxCluster,
                              (n_pages + kPagesPerRank - 1) / kPagesPerRank));
}

// How a launch is shaped: its configuration (grid, cluster, shared
// memory) and clusters at once, the chunk rows, copy widths and layout.
struct Plan {
  paged::ClusterLaunch launch;
  Layout lay;
  int rows, vec, stat_vec;
};

template <typename T>
int make_plan(Plan* pl, const T* k_pages, const T* v_pages,
              const float* kmin_pages, const float* kmax_pages, int b,
              int kvh, int g, int hd, int bs, int ps, int nb,
              cudaStream_t stream) {
  const int tsize = static_cast<int>(sizeof(T));
  // chunks of up to 64 rows: two stages of them fit the ring on bf16,
  // int8 and fp8 pages at hd 128, with half the chunk barriers of 32
  pl->rows = std::min(2 * paged::kChunkRows,
                      std::max(1, paged::kChunkBytes / (4 * hd * tsize)));
  pl->vec = paged::copy_width(k_pages, v_pages, hd * tsize);
  pl->stat_vec = paged::copy_width(kmin_pages, kmax_pages, hd * 4);
  pl->lay = layout(g, hd, pl->rows, tsize);
  const int n_pages = nb * (bs / ps);
  return paged::plan_cluster(
      &pl->launch, reinterpret_cast<const void*>(&paged_quest_kernel<T>),
      pl->lay.total, b, kvh, cluster_cap(n_pages), n_pages, stream);
}

template <typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale,
           const float* kmin_pages, const float* kmax_pages, const int* bt,
           const int* lengths, const int* budgets, float* out, int* sel,
           float* eff, int b, int kvh, int g, int hd, int bs, int ps, int nb,
           float scale, int sink, int window, cudaStream_t stream) {
  Plan pl;
  const int e = make_plan<T>(&pl, k_pages, v_pages, kmin_pages, kmax_pages,
                             b, kvh, g, hd, bs, ps, nb, stream);
  if (e != 0) return e;
  const cudaError_t err = cudaLaunchKernelEx(
      &pl.launch.cfg, paged_quest_kernel<T>, q, k_pages, v_pages, k_scale,
      v_scale, kmin_pages, kmax_pages, bt, lengths, budgets, out, sel, eff,
      kvh, g, hd, bs, ps, nb, scale, sink, window, pl.rows, pl.vec,
      pl.stat_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages; sel is int32
// (B, KVH, nb, bs) or NULL; eff is f32 (B, KVH, nb * bs / ps) scratch.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an unknown
// kv_type), or a negative code that paged_quest_attend_error_string
// explains.
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

// The shape of a launch with these arguments (pool pointers null: the
// widest copies): info[0] the cluster size C, info[1] the dynamic shared
// memory of a CTA in bytes, info[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), info[3] the K/V chunk stages.
// Returns 0 or an error code as the launch does.
int paged_quest_attend_plan(int kv_type, int b, int kvh, int g, int hd,
                            int bs, int ps, int nb, int* info) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Plan pl;
    const int e = make_plan<T>(&pl, nullptr, nullptr, nullptr, nullptr, b,
                               kvh, g, hd, bs, ps, nb, nullptr);
    if (e != 0) return e;
    info[0] = static_cast<int>(pl.launch.cfg.gridDim.x);
    info[1] = static_cast<int>(pl.lay.total);
    info[2] = pl.launch.fit;
    info[3] = pl.lay.stages;
    return 0;
  });
}

const char* paged_quest_attend_error_string(int code) {
  if (code == paged::kErrClusterFit)
    return "the kernel's thread-block cluster does not fit on the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (code == paged::kErrSmem)
    return "the bounds' and K/V chunk rings need more shared memory than a "
           "block may have (head dim too large)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
