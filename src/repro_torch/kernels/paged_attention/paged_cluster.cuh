// What the fused paged decode kernels that split each (request, KV head)
// over a thread-block cluster share (paged_attention.cu: SOCKET and hard
// LSH; paged_quest.cu: Quest; paged_ring.cu, the sliding-window ring,
// takes cp_async, merge_ranks and plan_cluster).  A cluster is C CTAs of
// kThreads threads (grid (C, KVH, B)); rank r owns the r-th contiguous
// run of the request's live blocks (the ring: of its live rows), and the
// ranks meet through distributed shared memory.
//
//   * cp_async / cp_async_commit / cp_async_wait: 16-, 8- or 4-byte
//     asynchronous copies into shared memory (2 and 1 bytes are copied by
//     the thread);
//   * cluster_select: the budget-th largest order-preserving uint32 key
//     of the cluster's entries, by four rounds of 8-bit radix digits;
//   * fold_list: an even share of the cluster's selected rows through a
//     ring of K/V chunk stages into an online softmax;
//   * merge_ranks: the C partial softmax states into the output;
//   * plan_cluster: the host's choice of C and the launch configuration.
//
// Every device function here is called by every thread of the CTA (they
// synchronize the CTA, and the cluster where they say so).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "paged_common.cuh"

namespace paged {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kGroups = 4;           // query heads a pass over a K row
constexpr int kChunkRows = 32;       // K/V rows a chunk holds, at most
constexpr int kChunkBytes = 64 * 1024;   // two stages of K/V chunks, at most
constexpr int kMaxStages = 8;        // chunks in flight, at most
constexpr int kBins = 256;           // 8-bit radix digits
constexpr unsigned kFull = 0xffffffffu;
// errors of a launch besides cudaError_t values
constexpr int kErrClusterFit = -1;
constexpr int kErrSmem = -2;

// n / d for n, d < 2^16 as one multiply-high (exact in that range).
struct FastDiv {
  uint32_t d, m;
  __host__ __device__ explicit FastDiv(uint32_t d_)
      : d(d_), m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), m))
                 : n;
  }
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The offset of a new array of `bytes` at *at; *at moves past it (16-byte
// aligned).
__host__ __device__ inline size_t take(size_t* at, size_t bytes) {
  const size_t o = *at;
  *at = align16(o + bytes);
  return o;
}

// Byte offsets of the shared-memory arrays every cluster kernel has, from
// offset 0: q (G, hd), the accumulator (G, hd), a chunk's scores (G,
// rows), the K and V scales of the stages (2 * kMaxStages * rows), the
// running max, sum and rescale factor (G each), the staged pool rows
// (kThreads), the scan scratch (kWarps + 1), two radix histograms, and
// the select's results and the ranks' counts (misc).
struct ClusterSmem {
  size_t q, acc, ss, scales, stats, srow, red, hist, misc;
};

__host__ __device__ inline ClusterSmem cluster_smem(int g, int hd, int rows,
                                                    size_t* at) {
  ClusterSmem s;
  s.q = take(at, static_cast<size_t>(g) * hd * 4);
  s.acc = take(at, static_cast<size_t>(g) * hd * 4);
  s.ss = take(at, static_cast<size_t>(g) * rows * 4);
  s.scales = take(at, static_cast<size_t>(2 * kMaxStages) * rows * 4);
  s.stats = take(at, static_cast<size_t>(3) * g * 4);
  s.srow = take(at, kThreads * 4);
  s.red = take(at, (kWarps + 1) * 4);
  s.hist = take(at, 2 * kBins * 4);
  s.misc = take(at, (4 + kMaxCluster) * 4);
  return s;
}

// K/V chunk stages of `buf` bytes each (a K and a V buffer a stage) that
// a ring region of `bytes` holds: between 2 and kMaxStages.
__host__ __device__ inline int ring_stages(size_t bytes, size_t buf) {
  const size_t fit = bytes / (2 * buf);
  return fit < 2 ? 2 : fit > kMaxStages ? kMaxStages : static_cast<int>(fit);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
      break;
    case 2:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
      break;
    default:
      *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::);
  }
}

// The CTA's online-softmax state and K/V ring in shared memory: q sq, the
// accumulator sacc, a chunk's scores ss (G, rows), the stages' scales
// sscale, the running max sm, sum sl and rescale factor salpha (G each),
// the staged pool rows srow (kThreads) and the ring skv of `stages`
// stages, each a K and a V buffer of kv_buf bytes (rows rows).
struct Fold {
  float *sq, *sacc, *ss, *sscale, *sm, *sl, *salpha;
  int* srow;
  unsigned char* skv;
  size_t kv_buf;
  int rows, stages;
};

__device__ __forceinline__ Fold carve_fold(unsigned char* smem,
                                           const ClusterSmem& s, int g,
                                           size_t kv, size_t kv_buf,
                                           int rows, int stages) {
  Fold f;
  f.sq = reinterpret_cast<float*>(smem + s.q);
  f.sacc = reinterpret_cast<float*>(smem + s.acc);
  f.ss = reinterpret_cast<float*>(smem + s.ss);
  f.sscale = reinterpret_cast<float*>(smem + s.scales);
  f.sm = reinterpret_cast<float*>(smem + s.stats);
  f.sl = f.sm + g;
  f.salpha = f.sl + g;
  f.srow = reinterpret_cast<int*>(smem + s.srow);
  f.skv = smem + kv;
  f.kv_buf = kv_buf;
  f.rows = rows;
  f.stages = stages;
  return f;
}

// q of the (request, head) into sq, the accumulator to 0, the G running
// maxima to -1e30 and sums to 0.
__device__ __forceinline__ void init_fold(const Fold& f,
                                          const float* __restrict__ qb,
                                          int g, int hd) {
  for (int i = threadIdx.x; i < g * hd; i += kThreads) {
    f.sq[i] = qb[i];
    f.sacc[i] = 0.f;
  }
  if (threadIdx.x < g) {
    f.sm[threadIdx.x] = kNegInf;
    f.sl[threadIdx.x] = 0.f;
  }
}

// The select's result: thr, the budget-th largest key; ties_needed =
// budget - count(key > thr); eq_before, the keys equal to thr in ranks
// before this one.
struct Threshold {
  uint32_t thr;
  int ties_needed, eq_before;
};

// Select over the cluster's entries: this rank holds entries [i0, i1)
// (key_at(i) their keys, written before the call), and n_inv entries past
// length hold one key, sort_key(-1e30), counted once.  Four rounds of
// 8-bit radix digits: each CTA histograms the digit of its keys that
// match the prefix so far (warp-aggregated shared atomics), the cluster
// sums the C histograms over distributed shared memory, and every CTA
// picks the same digit, the largest where the count from the top reaches
// budget.  The result is the one-bit MSB-first descent's.  shist: 2 *
// kBins ints; smisc: 3 ints.  Four cluster barriers.
template <typename KeyAt>
__device__ __forceinline__ Threshold cluster_select(
    cg::cluster_group& cluster, int rank, int nranks, int i0, int i1,
    KeyAt key_at, int n_inv, int budget, int* shist, int* smisc) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t k_inv = sort_key(kNegInf);
  uint32_t prefix = 0;
  int above = 0;            // keys of the cluster above the prefix's bucket
  int eq_before = 0;        // keys equal to thr in ranks < rank
  for (int round = 3; round >= 0; --round) {
    const int shift = 8 * round;
    const uint32_t hi_mask = round == 3 ? 0u : kFull << (shift + 8);
    int* hist = shist + (round & 1) * kBins;
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();                      // keys written; hist cleared
    for (int t0 = i0; t0 < i1; t0 += kThreads) {
      const int t = t0 + tid;
      bool in = false;
      uint32_t digit = 0;
      if (t < i1) {
        const uint32_t key = key_at(t);
        in = ((key ^ prefix) & hi_mask) == 0;
        digit = (key >> shift) & 0xffu;
      }
      const unsigned active = __ballot_sync(kFull, in);
      if (in) {
        const unsigned same = __match_any_sync(active, digit);
        if ((same & ((1u << lane) - 1u)) == 0)
          atomicAdd(&hist[digit], __popc(same));
      }
    }
    cluster.sync();                       // every rank's histogram done
    if (warp == 0) {
      // bins 8*lane .. 8*lane+7, summed over the ranks
      int c[8] = {};
#pragma unroll
      for (int rr = 0; rr < kMaxCluster; ++rr) {
        if (rr < nranks) {
          const int4* hr = reinterpret_cast<const int4*>(
                               cluster.map_shared_rank(hist, rr)) + 2 * lane;
          const int4 x = hr[0], y = hr[1];
          c[0] += x.x; c[1] += x.y; c[2] += x.z; c[3] += x.w;
          c[4] += y.x; c[5] += y.y; c[6] += y.z; c[7] += y.w;
        }
      }
      const uint32_t inv_digit = (k_inv >> shift) & 0xffu;
      if (((k_inv ^ prefix) & hi_mask) == 0 &&
          static_cast<int>(inv_digit >> 3) == lane)
        c[inv_digit & 7] += n_inv;
      int lane_sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) lane_sum += c[j];
      int suffix = lane_sum;              // bins of lanes >= lane
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_down_sync(kFull, suffix, o);
        if (lane + o < 32) suffix += x;
      }
      // the largest digit whose count from the top reaches budget, and
      // the count above it; none (fewer keys than budget): digit 0
      int run = above + suffix - lane_sum, found = -1, gt = 0, gt0 = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (found < 0 && run + c[j] >= budget) {
          found = j;
          gt = run;
        }
        if (j == 0) gt0 = run;
        run += c[j];
      }
      const unsigned any = __ballot_sync(kFull, found >= 0);
      const int src = any ? 31 - __clz(any) : 0;
      const int dj = __shfl_sync(kFull, any ? found : 0, src);
      const int dgt = __shfl_sync(kFull, any ? gt : gt0, src);
      const uint32_t digit = static_cast<uint32_t>(src * 8 + dj);
      int eb = 0;
      if (round == 0 && lane < rank)
        eb = cluster.map_shared_rank(hist, lane)[digit];
      for (int o = 16; o > 0; o >>= 1) eb += __shfl_xor_sync(kFull, eb, o);
      if (lane == 0) {
        smisc[0] = static_cast<int>(prefix | (digit << shift));
        smisc[1] = dgt;
        smisc[2] = eb;
      }
    }
    __syncthreads();
    prefix = static_cast<uint32_t>(smisc[0]);
    above = smisc[1];
    eq_before = smisc[2];
  }
  return Threshold{prefix, budget - above, eq_before};
}

// After each rank has written its count of selected rows into smisc[3]
// and the cluster has synchronized: the C counts into sbase[0, C), and
// this rank's even share [*k_lo, *k_hi) of the cluster's rows.
__device__ __forceinline__ void share_rows(cg::cluster_group& cluster,
                                           int rank, int nranks, int* smisc,
                                           int* sbase, int* k_lo,
                                           int* k_hi) {
  if (threadIdx.x < nranks)
    sbase[threadIdx.x] = cluster.map_shared_rank(smisc, threadIdx.x)[3];
  __syncthreads();
  int total = 0;
  for (int rr = 0; rr < nranks; ++rr) total += sbase[rr];
  *k_lo = static_cast<int>(static_cast<long long>(total) * rank / nranks);
  *k_hi =
      static_cast<int>(static_cast<long long>(total) * (rank + 1) / nranks);
}

// Fold the cluster's selected rows [k_lo, k_hi) into the CTA's online
// softmax; row_at(k) is the pool row of the cluster's k-th selected row.
// Rows are staged kThreads at a time in srow; their K/V rows (and scales)
// go to shared memory by cp.async in a ring of `stages` chunk stages of
// `rows` rows (vec-byte copies), stages - 1 chunks in flight; q.k one warp
// a row, kGroups heads at once; p.v with threads over (g, d), both from
// shared memory.
template <typename T, typename RowAt>
__device__ __forceinline__ void fold_list(const Fold& f, int k_lo, int k_hi,
                                          RowAt row_at,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          const float* __restrict__ k_scale,
                                          const float* __restrict__ v_scale,
                                          int g, int hd, float scale,
                                          int vec) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = f.rows, stages = f.stages;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int pieces = row_bytes / vec;
  const FastDiv div_pieces(pieces);
  const bool scaled = k_scale != nullptr;
  // K/V rows (and scales) of srow[c0, c0 + rows) into stage st
  auto issue = [&](int c0, int cnt, int st) {
    const int n = min(rows, cnt - c0), per_kv = n * pieces;
    unsigned char* kb = f.skv + st * 2 * f.kv_buf;
    for (int i = tid; i < 2 * per_kv; i += kThreads) {
      const int which = i >= per_kv, j = i - which * per_kv;
      const int r = div_pieces(j), piece = j - r * pieces;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(which ? v_pages : k_pages) +
          static_cast<size_t>(f.srow[c0 + r]) * row_bytes + piece * vec;
      cp_async(kb + which * f.kv_buf + r * row_bytes + piece * vec, src,
               vec);
    }
    if (scaled)
      for (int i = tid; i < 2 * n; i += kThreads) {
        const int which = i >= n, r = i - which * n;
        cp_async(f.sscale + (st * 2 + which) * rows + r,
                 (which ? v_scale : k_scale) + f.srow[c0 + r], 4);
      }
    cp_async_commit();
  };
  for (int k0 = k_lo; k0 < k_hi; k0 += kThreads) {
    const int cnt = min(kThreads, k_hi - k0);
    __syncthreads();                      // the previous batch's rows read
    if (tid < cnt) f.srow[tid] = row_at(k0 + tid);
    __syncthreads();
    const int chunks = (cnt + rows - 1) / rows;
    for (int k = 0; k < min(stages - 1, chunks); ++k)
      issue(k * rows, cnt, k);
    for (int c = 0; c < chunks; ++c) {
      const int ahead = c + stages - 1;
      if (ahead < chunks) issue(ahead * rows, cnt, ahead % stages);
      cp_async_wait(min(chunks, c + stages) - c - 1);
      __syncthreads();                    // chunk c's rows in
      const int st = c % stages, n = min(rows, cnt - c * rows);
      const T* kc = reinterpret_cast<const T*>(f.skv + st * 2 * f.kv_buf);
      const T* vc =
          reinterpret_cast<const T*>(f.skv + (st * 2 + 1) * f.kv_buf);
      const float* ksc = f.sscale + st * 2 * rows;
      const float* vsc = ksc + rows;
      // q.k: one warp a row, kGroups heads' sums at once
      for (int r = warp; r < n; r += kWarps) {
        const T* kr = kc + r * hd;
        const float ks = scaled ? ksc[r] : 1.f;
        for (int g0 = 0; g0 < g; g0 += kGroups) {
          float d[kGroups] = {};
          for (int i = lane; i < hd; i += 32) {
            const float kv = kv_to_float(kr[i]) * ks;
#pragma unroll
            for (int j = 0; j < kGroups; ++j)
              if (g0 + j < g) d[j] += f.sq[(g0 + j) * hd + i] * kv;
          }
#pragma unroll
          for (int j = 0; j < kGroups; ++j) d[j] = warp_sum(d[j]);
          if (lane == 0)
#pragma unroll
            for (int j = 0; j < kGroups; ++j)
              if (g0 + j < g) f.ss[(g0 + j) * rows + r] = d[j] * scale;
        }
      }
      __syncthreads();
      for (int gg = warp; gg < g; gg += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < n; r += 32) mx = fmaxf(mx, f.ss[gg * rows + r]);
        mx = warp_max(mx);
        const float m_prev = f.sm[gg];
        const float m_new = fmaxf(m_prev, mx);
        float ps = 0.f;
        for (int r = lane; r < n; r += 32) {
          const float pr = expf(f.ss[gg * rows + r] - m_new);
          f.ss[gg * rows + r] = pr;
          ps += pr;
        }
        ps = warp_sum(ps);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          f.salpha[gg] = alpha;
          f.sl[gg] = f.sl[gg] * alpha + ps;
          f.sm[gg] = m_new;
        }
      }
      __syncthreads();
      for (int i = tid; i < g * hd; i += kThreads) {
        const int gg = i / hd, d = i - gg * hd;
        float a = f.sacc[i] * f.salpha[gg];
        for (int r = 0; r < n; ++r)
          a += f.ss[gg * rows + r] *
               (kv_to_float(vc[r * hd + d]) * (scaled ? vsc[r] : 1.f));
        f.sacc[i] = a;
      }
      __syncthreads();                    // stage st and ss free again
    }
  }
}

// Merge the C ranks' (m, l, acc) over distributed shared memory; each rank
// writes its share of the output ob (G, hd) = acc / max(l, 1e-30), and
// where ml is not null the merged row max and normalizer of each head,
// ml (G, 2), from the rank that writes the head's first element.  Two
// cluster barriers: every rank's state final, and no rank leaving while
// another reads it.
__device__ __forceinline__ void merge_ranks(cg::cluster_group& cluster,
                                            int rank, int nranks,
                                            const Fold& f, int g, int hd,
                                            float* __restrict__ ob,
                                            float* __restrict__ ml = nullptr) {
  __syncthreads();
  cluster.sync();                         // every rank's state final
  const int ne = g * hd, share = (ne + nranks - 1) / nranks;
  const int e1 = min(ne, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < e1; i += kThreads) {
    const int gg = i / hd;
    float m = kNegInf;
    for (int rr = 0; rr < nranks; ++rr)
      m = fmaxf(m, cluster.map_shared_rank(f.sm, rr)[gg]);
    float l = 0.f, a = 0.f;
    for (int rr = 0; rr < nranks; ++rr) {
      const float* st = cluster.map_shared_rank(f.sm, rr);
      const float e = expf(st[gg] - m);
      l += st[g + gg] * e;
      a += cluster.map_shared_rank(f.sacc, rr)[i] * e;
    }
    ob[i] = a / fmaxf(l, 1e-30f);
    if (ml != nullptr && i == gg * hd) {
      ml[2 * gg] = m;
      ml[2 * gg + 1] = l;
    }
  }
  cluster.sync();                         // no rank leaves while read
}

// ---- host: the launch's shape ----------------------------------------------

// K/V rows a chunk stage holds at head dim hd and tsize-byte elements.
inline int chunk_rows(int hd, int tsize) {
  return std::min(kChunkRows, std::max(1, kChunkBytes / (4 * hd * tsize)));
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that rows of row_bytes and
// the alignment of both pools allow (null pools: the row alone decides).
inline int copy_width(const void* a, const void* b, int row_bytes) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          static_cast<uintptr_t>(row_bytes);
  int vec = 16;
  while (vec > 1 && align % vec) vec >>= 1;
  return vec;
}

// A launch's configuration (grid, cluster, shared memory) and how many of
// its clusters the card holds at once.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit;
};

// Clusters of c CTAs of `kernel` with smem bytes each that the card holds
// at once (cudaOccupancyMaxActiveClusters), asked once per (kernel, c,
// smem) and then remembered, so a launch inside a CUDA-graph capture asks
// nothing.
inline int clusters_at_once(const void* kernel, int c, size_t smem,
                            int* fit) {
  struct Asked {
    const void* kernel;
    int c;
    size_t smem;
    int fit;
  };
  static Asked asked[256];
  static int n_asked = 0;
  for (int i = 0; i < n_asked; ++i)
    if (asked[i].kernel == kernel && asked[i].c == c &&
        asked[i].smem == smem) {
      *fit = asked[i].fit;
      return 0;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_asked < 256) asked[n_asked++] = Asked{kernel, c, smem, *fit};
  return 0;
}

// Shape a launch of `kernel` over B * KVH clusters with smem bytes a CTA:
// the dynamic shared memory allowed (once per kernel and size), then C,
// the largest in [1, cap] whose B * KVH clusters the card holds at once
// (one wave); if none, the fewest waves times work / C (work: the entries
// a request's ranks split).  Both are known without a device sync.
// Returns 0, kErrSmem, kErrClusterFit or a cudaError_t.
inline int plan_cluster(ClusterLaunch* pl, const void* kernel, size_t smem,
                        int b, int kvh, int cap, long long work,
                        cudaStream_t stream) {
  static int optin = 0;                  // queried once, outside any capture
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem > static_cast<size_t>(optin)) return kErrSmem;
  struct Set {
    const void* kernel;
    size_t smem;
  };
  static Set set[64];
  static int n_set = 0;
  int k = 0;
  while (k < n_set && set[k].kernel != kernel) ++k;
  if (k == n_set || smem > set[k].smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (k < n_set)
      set[k].smem = smem;
    else if (n_set < 64)
      set[n_set++] = Set{kernel, smem};
  }
  const int clusters = b * kvh;
  int c = 0;
  long long best = 0;
  for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap)); ++cc) {
    int fit = 0;
    const int e = clusters_at_once(kernel, cc, smem, &fit);
    if (e != 0) return e;
    if (fit < 1) continue;
    const long long waves = (clusters + fit - 1) / fit;
    const long long cost = waves == 1 ? -cc : waves * ((work + cc - 1) / cc);
    if (c == 0 || cost < best) {
      c = cc;
      best = cost;
      pl->fit = fit;
    }
  }
  if (c == 0) return kErrClusterFit;
  pl->cfg = cudaLaunchConfig_t{};
  pl->cfg.gridDim = dim3(c, kvh, b);
  pl->cfg.blockDim = dim3(kThreads);
  pl->cfg.dynamicSmemBytes = smem;
  pl->cfg.stream = stream;
  pl->attr[0].id = cudaLaunchAttributeClusterDimension;
  pl->attr[0].val.clusterDim.x = c;
  pl->attr[0].val.clusterDim.y = 1;
  pl->attr[0].val.clusterDim.z = 1;
  pl->cfg.attrs = pl->attr;
  pl->cfg.numAttrs = 1;
  return 0;
}

}  // namespace paged
