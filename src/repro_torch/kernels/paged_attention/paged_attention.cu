// Fused SOCKET and hard-LSH paged decode attention for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/
// paged_attention.py (_fused_kernel with mode="socket", launched by
// _fused_call from paged_attention_pallas) and, as Mode::kHardLsh, the
// same kernel's mode="hard_lsh" reached from paged_hard_lsh.py
// (paged_hard_lsh_pallas).  For one decode step of the continuous engine
// it runs, per (request b, KV head h), the whole SOCKET decode pipeline
// over the request's pages, reached through its block table:
//
//   1. score:  for every logical token t < length[b], follow
//              bt[b, t / bs], unpack the token's packed sign words, form
//                eff[t] = vnorm[t] * sum_g sum_l exp(<S_tl, u_gl> / tau - logZ_gl)
//              over the L real tables, and overlay the forced sink/window
//              rows with FLT_MAX (rows at or past length are -1e30 and are
//              not scored);
//   2. select: the budget-th largest order-preserving uint32 key thr of
//              eff, and ties_needed = budget - count(key > thr);
//   3. attend: token t is selected iff key > thr, or key == thr and fewer
//              than ties_needed equal keys precede it (jax.lax.top_k's
//              lowest-index-first order), and eff > -5e29.  Selected K/V
//              rows fold into an fp32 online softmax (m, l, acc) for the G
//              query heads of the group; the output is acc / max(l, 1e-30).
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _fused_kernel's
// `quantized` branch, paged_attention.py:176-180): with the per-row scale
// pools k_scale / v_scale each selected row is dequantized as
// float(q) * scale[row].  Scoring reads only bits and vnorm, so the
// selection on quantized pages is bit for bit the selection on f32 pages.
//
// Hard LSH (Mode::kHardLsh) differs in the score term only: a table
// collides when the key's P-bit field equals the query's sign pattern
// (bit j set where the query's plane-j sign u_signs[g, l, j] is +1, packed
// per (g, l) while the block stages it in shared memory), and
//   eff[t] = vnorm[t] * sum_g sum_{l < L} 1[field_tl == pattern_gl],
// one integer compare per (token, g, l).  The counts are small integers,
// exact in f32, so the scores and the selection equal the plain version's
// bit for bit.
//
// Selection is exactly repro.core.socket.value_aware_topk's; nothing but the
// output (and, for tests, the selection mask) leaves the kernel except the
// eff scratch (B, KVH, nb*bs) f32 in device memory, which the wrapper
// allocates and which stays in L2: it serves every context the engine
// admits, where shared memory would cap it.
//
// What bounds it on this card: bytes.  The function must read, per request
// and head, the bits and vnorm of every scored token (W*4 + 2 bytes: 82 B at
// P=10, L=60; the sink and window rows are selected by position and need
// neither) and only the selected K/V rows (2*hd*4 bytes each in fp32;
// 2*(hd+4) as int8 or fp8 with their scales): at the continuous path (8
// requests of 1-4K tokens, 8 KV heads) 8.7 MB of bits/vnorm plus 20.2 MB
// of K/V rows, ~9 us at 3.35 TB/s.  The scoring needs one FMA per (scored
// token, g, l) once P is split into table lookups, which this kernel does.
//
// What the design does about it:
//   * cluster split: grid (C, KVH, B), one thread-block cluster of C CTAs
//     per (request, head), launched with cudaLaunchKernelEx.  The host
//     takes the largest C <= 8, and at most one rank per kPositions table
//     positions, whose B * KVH clusters the card holds at once
//     (cudaOccupancyMaxActiveClusters, asked once per size; both known
//     without a device sync); where none does, the C with the fewest
//     waves times positions a CTA; if no cluster fits, the launch fails.
//     Rank r owns the r-th contiguous run of the request's live blocks; a
//     rank past length only takes part in the barriers.  The ranks meet
//     through distributed shared memory (cluster.sync, map_shared_rank);
//   * split-table scoring (SOCKET): for each (g, l), two f32 tables over
//     the low ceil(P/2) and the high floor(P/2) planes,
//       T_lo[c] = exp(sum_j +-u_j / tau - logZ),  T_hi[c] = exp(sum_j +-u_j / tau),
//     so a term is T_lo[lo] * T_hi[hi]: two shared-memory lookups and one
//     FMA, no exponential and no sign-adds.  Each rank builds 1/C of the
//     tables (a warp a table, the query hash loaded ahead of the bits) and
//     copies the rest from the other ranks.  Lanes read one table with
//     arbitrary codes; 32 consecutive words span the 32 banks, so no bank
//     conflicts.  The tables of (l, g .. g + kG - 1) are adjacent and the
//     group chunk kG is a template, so a lookup needs no guard and one
//     add.  exp(a) * exp(b) differs from exp(a + b) by a few ulps: the
//     scores stay within the kernel check's score tolerance;
//   * bits: each tile's rows are copied into shared memory with cp.async
//     (16-byte copies where W % 4 == 0, the forced rows skipped), the
//     tile's block ids staged once, and a token's fields are shifted out
//     of a two-word window;
//   * select: four rounds of 8-bit radix digits.  Each CTA histograms the
//     digit of its keys that match the prefix so far (warp-aggregated
//     shared atomics), the cluster sums the C histograms over distributed
//     shared memory, and every CTA picks the same digit where the count
//     from the top reaches budget (the n_total - length rows past length
//     hold one key, sort_key(-1e30), and are counted there).  The result
//     is the one-bit descent's thr and ties_needed; rank r starts its tie
//     count at the keys equal to thr in ranks < r (the last round's bins);
//   * attend: each rank compacts its selected rows in logical order and
//     writes their pool rows over the consumed head of its eff range; then
//     every rank folds an even share of the cluster's list, so the sink
//     and window rows do not pile on ranks 0 and C-1.  K/V rows (and
//     scales) go to shared memory by cp.async in a ring of chunk stages
//     (16-byte copies where the row and the pools allow, 8, 4, 2 or 1
//     otherwise); q.k one warp a row, p.v with threads over (g, d), both
//     from shared memory; then the C partial (m, l, acc) states merge over
//     distributed shared memory, each rank writing its share of the output.
// Barriers a launch: one cluster barrier for the tables (SOCKET), four
// for the select, one for the lists, two around the merge.  The select,
// the list fold, the merge and the choice of C are paged_cluster.cuh's,
// shared with paged_quest.cu.

// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; bits uint32 (NB, KVH, bs, W) (the port stores int32
// with the same bit pattern; flat bit f = l*P + p is bit f%32 of word f/32);
// vnorm bf16 (NB, KVH, bs); u f32 (B, KVH, GS, L, P) with GS = G (kvhead)
// or 1 (pooled); logz f32 (B, KVH, GS, L); hard LSH takes u_signs f32 +-1
// (B, KVH, GS, L, P) in u's place and no logZ; bt int32 (B, nb); length,
// budget int32 (B,).  The pool holds fewer than 2^31 rows (NB * KVH * bs;
// the wrapper checks), so a row index is an int.

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
using paged::kFull;
using paged::kNegInf;
using paged::kThreads;
using paged::kWarps;
using paged::sort_key;
using paged::take;

constexpr int kMinBlocks = 2;        // CTAs an SM must fit (registers)
constexpr int kPositions = 512;      // table positions a CTA, choosing C
constexpr int kTableBatch = 8;      // tables a warp loads at once

// Scoring mode of the fused pass.
enum class Mode { kSocket, kHardLsh };

// Byte offsets of the shared-memory arrays (all 16-byte aligned): those
// every cluster kernel has (paged_cluster.cuh), then the tile's block ids.
// The score pass's tables and bits tile and the attend pass's ring of K/V
// chunk stages share one region.
struct Layout {
  paged::ClusterSmem head;
  size_t blk, tables, bits, kv, kv_buf, total;
  int stages;
};

// Floats one (g, l) table set takes: 2^ceil(P/2) + 2^floor(P/2) entries
// rounded up to whole 16-byte words (SOCKET); one sign pattern (hard LSH).
template <Mode M>
__host__ __device__ inline int table_stride(int p) {
  return M == Mode::kSocket
             ? (((1 << ((p + 1) / 2)) + (1 << (p / 2)) + 3) & ~3)
             : 1;
}

template <Mode M>
__host__ __device__ inline Layout layout(int g, int gs, int hd, int bs,
                                         int w, int nl, int p, int rows,
                                         int tsize) {
  Layout s;
  size_t o = 0;
  s.head = paged::cluster_smem(g, hd, rows, &o);
  s.blk = take(&o, static_cast<size_t>(2) * (kThreads / bs + 2) * 4);
  size_t score = o;
  s.tables = take(&score, static_cast<size_t>(gs) * nl * table_stride<M>(p) *
                              4);
  s.bits = take(&score, static_cast<size_t>(kThreads) * w * 4);
  s.kv = o;
  s.kv_buf = align16(static_cast<size_t>(rows) * hd * tsize);
  s.stages = paged::ring_stages(score - o, s.kv_buf);
  const size_t ring = o + 2 * s.kv_buf * s.stages;
  s.total = score > ring ? score : ring;
  return s;
}

// A row of packed words in shared memory, read in order: as 16-byte words
// where the stride allows (w % 4 == 0), else one word at a time.
struct RowWords {
  const uint32_t* row;
  bool quad;
  uint4 cur;
  __device__ __forceinline__ uint32_t at(int i) {
    if (!quad) return row[i];
    if ((i & 3) == 0) cur = reinterpret_cast<const uint4*>(row)[i >> 2];
    const int k = i & 3;
    return k == 0 ? cur.x : k == 1 ? cur.y : k == 2 ? cur.z : cur.w;
  }
};

// kG: query-hash groups scored a pass over a token's bits (1, 2 or 4,
// dividing GS; the host picks the largest)
template <Mode M, typename T, int kG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_socket_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const uint32_t* __restrict__ bits_pages,
                    const uint16_t* __restrict__ vnorm_pages,
                    const float* __restrict__ qhash,
                    const float* __restrict__ logz,
                    const int* __restrict__ bt,
                    const int* __restrict__ lengths,
                    const int* __restrict__ budgets,
                    float* __restrict__ out, int* __restrict__ sel_out,
                    float* __restrict__ eff_scr, int kvh, int g, int gs,
                    int hd, int bs, int w, int nb, int nl, int p,
                    float tau, float scale, int sink, int window, int rows,
                    int vec, int bits_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const Layout lay = layout<M>(g, gs, hd, bs, w, nl, p, rows, sizeof(T));
  const paged::Fold fold = paged::carve_fold(
      smem, lay.head, g, lay.kv, lay.kv_buf, rows, lay.stages);
  int* red = reinterpret_cast<int*>(smem + lay.head.red);
  int* shist = reinterpret_cast<int*>(smem + lay.head.hist);
  int* smisc = reinterpret_cast<int*>(smem + lay.head.misc);
  float* stab = reinterpret_cast<float*>(smem + lay.tables);
  uint32_t* spat = reinterpret_cast<uint32_t*>(smem + lay.tables);
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem + lay.bits);

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_total = nb * bs;
  const int length = max(0, min(lengths[b], n_total));
  const int budget = budgets[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * nb;
  float* eff = eff_scr + bh * n_total;
  // this rank's run of the request's live blocks, as token positions
  const int used = (length + bs - 1) / bs;
  const int per = (used + nranks - 1) / nranks;
  const int r0 = min(length, rank * per * bs);
  const int r1 = min(length, (rank + 1) * per * bs);
  const FastDiv div_bs(bs);
  // the pool row of token t of the tile starting at n0
  auto pool_row = [&](int n0, int t) {
    const int o = (n0 % bs) + (t - n0), ob = div_bs(o);
    return (btb[n0 / bs + ob] * kvh + h) * bs + (o - ob * bs);
  };
  auto forced = [&](int t) { return t < sink || t >= length - window; };
  // the block ids of a tile in shared memory (two buffers: the tile being
  // scored and the next), so its copies wait on no table load
  int* sblk = reinterpret_cast<int*>(smem + lay.blk);
  const int blk_n = kThreads / bs + 2;
  auto load_blocks = [&](int n0, int* dst) {
    const int first = n0 / bs;
    const int last = (min(r1, n0 + kThreads) - 1) / bs + 1;
    for (int i = tid; i < last - first; i += kThreads) dst[i] = btb[first + i];
  };
  auto tile_row = [&](const int* blk, int n0, int t) {
    const int o = (n0 % bs) + (t - n0), ob = div_bs(o);
    return (blk[ob] * kvh + h) * bs + (o - ob * bs);
  };

  // ---- 0. the query hash's first loads; q; the first tile's bits; this
  // rank's share of the tables
  const int lo_bits = (p + 1) / 2, n_lo = 1 << lo_bits;
  const uint32_t lo_mask = n_lo - 1u;
  const int stride = table_stride<M>(p), tables = gs * nl;
  const float* ub = qhash + bh * tables * p;
  // one warp a (g, l), kTableBatch of them at once: rank r builds tables
  // r + C * warp + C * kWarps * k; their u and logZ loads go out first,
  // ahead of the bits
  const int step = nranks * kWarps;
  int gl0 = rank + nranks * warp;
  float uj[kTableBatch], z[kTableBatch];
  if constexpr (M == Mode::kSocket) {
#pragma unroll
    for (int k = 0; k < kTableBatch; ++k) {
      const int gl = gl0 + k * step, at = (gl % gs) * nl + gl / gs;
      uj[k] = gl < tables && lane < p ? ub[at * p + lane] : 0.f;
      z[k] = gl < tables ? logz[bh * tables + at] : 0.f;
    }
  }
  if (r0 < r1) load_blocks(r0, sblk);
  paged::init_fold(fold, q + bh * g * hd, g, hd);
  __syncthreads();                        // the first tile's block ids in
  // the tile's rows at stride w, in bits_vec-word copies (4 where w and the
  // pool allow); a copy never crosses a row
  const int units = w / bits_vec;
  const FastDiv div_units(units);
  const bool fast_units = kThreads * units <= 65536;
  auto stage_bits = [&](int n0, const int* blk) {
    const int n = min(kThreads, r1 - n0);
    for (int i = tid; i < n * units; i += kThreads) {
      const int r = fast_units ? div_units(i) : i / units, t = n0 + r;
      if (forced(t)) continue;
      const int word = (i - r * units) * bits_vec;
      cp_async(sbits + r * w + word,
               bits_pages + static_cast<size_t>(tile_row(blk, n0, t)) * w +
                   word,
               4 * bits_vec);
    }
    cp_async_commit();
  };
  if (r0 < r1) stage_bits(r0, sblk);

  if constexpr (M == Mode::kSocket) {
    // entry c of the low table sums the signs of c's bits over planes
    // 0 .. lo_bits-1 (lane j holds u_j), of the high table over planes
    // lo_bits .. p-1
    const int entries = n_lo + (1 << (p - lo_bits));
    while (gl0 < tables) {
#pragma unroll
      for (int k = 0; k < kTableBatch; ++k) {
        const int gl = gl0 + k * step;
        if (gl >= tables) break;          // uniform across the warp
        for (int c0 = 0; c0 < entries; c0 += 32) {
          const int c = c0 + lane;
          const bool low = c < n_lo;
          const int code = low ? c : c - n_lo, j0 = low ? 0 : lo_bits;
          const int nj = low ? lo_bits : p - lo_bits;
          float s = 0.f;
          for (int j = 0; j < lo_bits; ++j) {
            const float x = __shfl_sync(kFull, uj[k], (j0 + j) & 31);
            if (j < nj) s += ((code >> j) & 1) ? x : -x;
          }
          if (c < entries)
            stab[gl * stride + c] =
                low ? expf(s / tau - z[k]) : expf(s / tau);
        }
      }
      gl0 += kTableBatch * step;
#pragma unroll
      for (int k = 0; k < kTableBatch; ++k) {
        const int gl = gl0 + k * step, at = (gl % gs) * nl + gl / gs;
        uj[k] = gl < tables && lane < p ? ub[at * p + lane] : 0.f;
        z[k] = gl < tables ? logz[bh * tables + at] : 0.f;
      }
    }
  } else {
    for (int i = tid; i < tables; i += kThreads) {
      const float* ut = ub + ((i % gs) * nl + i / gs) * p;
      uint32_t pat = 0;
      for (int j = 0; j < p; ++j) pat |= (ut[j] > 0.f ? 1u : 0u) << j;
      spat[i] = pat;
    }
  }
  if constexpr (M == Mode::kSocket) {
    // every rank's share built: copy the other ranks' tables in
    cluster.sync();
    const int quads = stride / 4;
    const FastDiv div_quads(quads);
    float4* own = reinterpret_cast<float4*>(stab);
    for (int i = tid; i < tables * quads; i += kThreads) {
      const int gl = div_quads(i), owner = gl % nranks;
      if (owner != rank)
        own[i] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(stab, owner))[i];
    }
  }
  const uint32_t pmask = p < 32 ? (1u << p) - 1u : kFull;

  // ---- 1. score this rank's tokens into eff --------------------------------
  for (int n0 = r0, cur = 0; n0 < r1; n0 += kThreads, cur ^= 1) {
    const int* blk = sblk + cur * blk_n;
    int* next_blk = sblk + (cur ^ 1) * blk_n;
    if (n0 + kThreads < r1) load_blocks(n0 + kThreads, next_blk);
    cp_async_wait(0);
    __syncthreads();                      // the tile's bits (and tables) in
    const int t = n0 + tid;
    if (t < r1) {
      float e;
      if (forced(t)) {
        e = FLT_MAX;
      } else {
        RowWords row{sbits + tid * w, bits_vec == 4, {}};
        float score = 0.f;
        int hits = 0;
        for (int g0 = 0; g0 < gs; g0 += kG) {
          float sg[kG] = {};
          uint32_t lo = row.at(0), hi = w > 1 ? row.at(1) : 0u;
          int bit = 0, wi = 1;
          // the tables of (l, g0 .. g0 + kG - 1) are adjacent
          const float* tl = stab + g0 * stride;
          const uint32_t* pl = spat + g0;
          for (int l = 0; l < nl; ++l, tl += gs * stride, pl += gs) {
            const uint32_t f = __funnelshift_r(lo, hi, bit) & pmask;
            bit += p;
            if (bit >= 32) {
              bit -= 32;
              lo = hi;
              ++wi;
              hi = wi < w ? row.at(wi) : 0u;
            }
            if constexpr (M == Mode::kSocket) {
              const float* a = tl + (f & lo_mask);
              const float* c = tl + n_lo + (f >> lo_bits);
#pragma unroll
              for (int j = 0; j < kG; ++j)
                sg[j] = fmaf(a[j * stride], c[j * stride], sg[j]);
            } else {
#pragma unroll
              for (int j = 0; j < kG; ++j) hits += f == pl[j];
            }
          }
#pragma unroll
          for (int j = 0; j < kG; ++j) score += sg[j];
        }
        const float vn =
            paged::bf16_to_float(vnorm_pages[tile_row(blk, n0, t)]);
        e = M == Mode::kSocket ? score * vn : static_cast<float>(hits) * vn;
      }
      eff[t] = e;
    }
    __syncthreads();                      // bits consumed, next ids in
    if (n0 + kThreads < r1) stage_bits(n0 + kThreads, next_blk);
  }

  // ---- 2. select: 8-bit radix digits over the cluster ----------------------
  // rows at or past length all hold eff = -1e30: one key, counted once
  const paged::Threshold sel = paged::cluster_select(
      cluster, rank, nranks, r0, r1,
      [&](int t) { return sort_key(eff[t]); }, n_total - length, budget,
      shist, smisc);
  const uint32_t thr = sel.thr;
  const int ties_needed = sel.ties_needed;

  // ---- 3. attend over the selected rows, in logical order ------------------
  // 3a. this rank's selected rows, in logical order: sel_out, and their
  // pool rows written over the consumed head of the rank's eff range
  // (position r0 + k holds the k-th; k never passes the token being read)
  int* list = reinterpret_cast<int*>(eff);
  int ties_seen = sel.eq_before, found = 0;
  for (int n0 = r0; n0 < r1; n0 += kThreads) {
    const int t = n0 + tid;
    float e = kNegInf;
    uint32_t key = 0;
    int is_eq = 0;
    if (t < r1) {
      e = eff[t];
      key = sort_key(e);
      is_eq = key == thr;
    }
    int eq_total;
    const int rank_eq =
        ties_seen + paged::block_exclusive_scan(is_eq, red, &eq_total);
    ties_seen += eq_total;
    const int is_sel = t < r1 &&
                       (key > thr || (is_eq && rank_eq < ties_needed)) &&
                       e > -5e29f;
    if (sel_out != nullptr && t < r1) sel_out[bh * n_total + t] = is_sel;
    int cnt;
    const int slot = paged::block_exclusive_scan(is_sel, red, &cnt);
    if (is_sel) list[r0 + found + slot] = pool_row(n0, t);
    found += cnt;
  }
  if (tid == 0) smisc[3] = found;
  cluster.sync();                         // every rank's list written

  // 3b. an even share of the cluster's list: rank r folds list entries
  // [r * S / C, (r + 1) * S / C) of the S selected rows, whichever rank
  // found them, so the sink and window rows do not pile on two ranks
  int* sbase = smisc + 4;                 // each rank's count
  int k_lo, k_hi;
  paged::share_rows(cluster, rank, nranks, smisc, sbase, &k_lo, &k_hi);
  // the pool row of the cluster's k-th selected row, read from L2: ranks'
  // ranges are whole blocks, not whole 128-byte lines, so this SM's L1 may
  // hold a stale copy of a line where another rank wrote its list
  auto list_row = [&](int k) {
    int rr = 0;
    while (rr + 1 < nranks && k >= sbase[rr]) k -= sbase[rr++];
    return __ldcg(list + min(length, rr * per * bs) + k);
  };
  paged::fold_list(fold, k_lo, k_hi, list_row, k_pages, v_pages, k_scale,
                   v_scale, g, hd, scale, vec);
  if (sel_out != nullptr)
    for (int t = length + rank * kThreads + tid; t < n_total;
         t += nranks * kThreads)
      sel_out[bh * n_total + t] = 0;

  // ---- 4. merge the ranks' (m, l, acc) and write the output ---------------
  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd);
}

// The largest cluster size worth taking for a table of n_total
// positions: about kPositions positions a CTA, at most kMaxCluster.
inline int cluster_cap(int n_total) {
  return std::max(1, std::min(paged::kMaxCluster,
                              (n_total + kPositions - 1) / kPositions));
}

// How a launch is shaped: its configuration (grid, cluster, shared
// memory) and clusters at once, the chunk rows, copy widths and layout.
struct Plan {
  paged::ClusterLaunch launch;
  Layout lay;
  int rows, vec, bits_vec;
};

template <Mode M, typename T, int kG>
int make_plan(Plan* pl, const T* k_pages, const T* v_pages,
              const uint32_t* bits_pages, int b, int kvh, int g, int gs,
              int hd, int bs, int w, int nb, int nl, int p,
              cudaStream_t stream) {
  const int tsize = static_cast<int>(sizeof(T));
  pl->rows = paged::chunk_rows(hd, tsize);
  pl->vec = paged::copy_width(k_pages, v_pages, hd * tsize);
  pl->bits_vec =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(bits_pages) % 16 == 0 ? 4 : 1;
  pl->lay = layout<M>(g, gs, hd, bs, w, nl, p, pl->rows, tsize);
  const int n_total = nb * bs;
  return paged::plan_cluster(
      &pl->launch,
      reinterpret_cast<const void*>(&paged_socket_kernel<M, T, kG>),
      pl->lay.total, b, kvh, cluster_cap(n_total), n_total, stream);
}

template <Mode M, typename T, int kG>
int launch_g(const float* q, const T* k_pages, const T* v_pages,
             const float* k_scale, const float* v_scale,
             const uint32_t* bits_pages, const uint16_t* vnorm_pages,
             const float* qhash, const float* logz, const int* bt,
             const int* lengths, const int* budgets, float* out, int* sel,
             float* eff, int b, int kvh, int g, int gs, int hd, int bs, int w,
             int nb, int nl, int p, float tau, float scale, int sink,
             int window, cudaStream_t stream) {
  Plan pl;
  const int e = make_plan<M, T, kG>(&pl, k_pages, v_pages, bits_pages, b,
                                    kvh, g, gs, hd, bs, w, nb, nl, p, stream);
  if (e != 0) return e;
  const cudaError_t err = cudaLaunchKernelEx(
      &pl.launch.cfg, paged_socket_kernel<M, T, kG>, q, k_pages, v_pages,
      k_scale, v_scale, bits_pages, vnorm_pages, qhash, logz, bt, lengths,
      budgets, out, sel, eff, kvh, g, gs, hd, bs, w, nb, nl, p, tau, scale,
      sink, window, pl.rows, pl.vec, pl.bits_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(std::integral_constant<int, kG>{}) with kG the largest of 4, 2, 1
// dividing gs.
template <typename F>
int with_groups(int gs, F&& f) {
  if (gs % 4 == 0) return f(std::integral_constant<int, 4>{});
  if (gs % 2 == 0) return f(std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{});
}

template <Mode M, typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale,
           const uint32_t* bits_pages, const uint16_t* vnorm_pages,
           const float* qhash, const float* logz, const int* bt,
           const int* lengths, const int* budgets, float* out, int* sel,
           float* eff, int b, int kvh, int g, int gs, int hd, int bs, int w,
           int nb, int nl, int p, float tau, float scale, int sink,
           int window, cudaStream_t stream) {
  return with_groups(gs, [&](auto kg) {
    return launch_g<M, T, decltype(kg)::value>(
        q, k_pages, v_pages, k_scale, v_scale, bits_pages, vnorm_pages, qhash,
        logz, bt, lengths, budgets, out, sel, eff, b, kvh, g, gs, hd, bs, w,
        nb, nl, p, tau, scale, sink, window, stream);
  });
}

// launch<M, T> with T the element type of kv_type.
template <Mode M>
int launch_kv(int kv_type, const float* q, const void* k_pages,
              const void* v_pages, const float* k_scale,
              const float* v_scale, const void* bits_pages,
              const void* vnorm_pages, const float* qhash, const float* logz,
              const int* bt, const int* lengths, const int* budgets,
              float* out, int* sel, float* eff, int b, int kvh, int g,
              int gs, int hd, int bs, int w, int nb, int nl, int p,
              float tau, float scale, int sink, int window, void* stream) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<M, T>(
        q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        k_scale, v_scale, static_cast<const uint32_t*>(bits_pages),
        static_cast<const uint16_t*>(vnorm_pages), qhash, logz, bt, lengths,
        budgets, out, sel, eff, b, kvh, g, gs, hd, bs, w, nb, nl, p, tau,
        scale, sink, window, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages; u (B, KVH, GS,
// l, P) and logz (B, KVH, GS, l) over the l real tables; sel is int32
// (B, KVH, nb, bs) or NULL; eff is f32 (B, KVH, nb*bs) scratch.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for an unknown kv_type),
// or a negative code that paged_socket_attend_error_string explains.
int paged_socket_attend_launch(const float* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const void* bits_pages,
                               const void* vnorm_pages, const float* u,
                               const float* logz, const int* bt,
                               const int* lengths, const int* budgets,
                               float* out, int* sel, float* eff, int kv_type,
                               int b, int kvh, int g, int gs, int hd, int bs,
                               int w, int nb, int l, int p, float tau,
                               float scale, int sink, int window,
                               void* stream) {
  return launch_kv<Mode::kSocket>(
      kv_type, q, k_pages, v_pages, k_scale, v_scale, bits_pages,
      vnorm_pages, u, logz, bt, lengths, budgets, out, sel, eff, b, kvh, g,
      gs, hd, bs, w, nb, l, p, tau, scale, sink, window, stream);
}

// As paged_socket_attend_launch, with u_signs f32 +-1 (B, KVH, GS, l, P)
// (the query's plane signs) in place of u and logZ.
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

// The shape of a launch with these arguments (pool pointers null: the
// widest copies): info[0] the cluster size C, info[1] the dynamic shared
// memory of a CTA in bytes, info[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), info[3] the K/V chunk stages.
// Returns 0 or an error code as the launches do.
int paged_socket_attend_plan(int hard, int kv_type, int b, int kvh, int g,
                             int gs, int hd, int bs, int w, int nb, int l,
                             int p, int* info) {
  auto run = [&](auto mode) {
    return paged::with_kv_type(kv_type, [&](auto* tag) {
      using T = std::remove_pointer_t<decltype(tag)>;
      constexpr Mode M = decltype(mode)::value;
      return with_groups(gs, [&](auto kg) {
        Plan pl;
        const int e = make_plan<M, T, decltype(kg)::value>(
            &pl, nullptr, nullptr, nullptr, b, kvh, g, gs, hd, bs, w, nb, l,
            p, nullptr);
        if (e != 0) return e;
        info[0] = static_cast<int>(pl.launch.cfg.gridDim.x);
        info[1] = static_cast<int>(pl.lay.total);
        info[2] = pl.launch.fit;
        info[3] = pl.lay.stages;
        return 0;
      });
    });
  };
  return hard ? run(std::integral_constant<Mode, Mode::kHardLsh>{})
              : run(std::integral_constant<Mode, Mode::kSocket>{});
}

const char* paged_socket_attend_error_string(int code) {
  if (code == paged::kErrClusterFit)
    return "the kernel's thread-block cluster does not fit on the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (code == paged::kErrSmem)
    return "the split score tables, bits tile and K/V chunks need more "
           "shared memory than a block may have (GS * L * 2^(P/2) too "
           "large)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
