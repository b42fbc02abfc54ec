// SOCKET soft-collision scoring for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/socket_score/socket_score.py
// (_score_kernel, launched by socket_score_pallas): for every cached key n
// of every (batch, kv-head) row bh
//
//     score[bh, n] = vnorm[bh, n] * sum_g sum_l exp(<S_nl, u_gl> / tau - logZ_gl)
//
// where S_nl are the key's P stored signs of table l (±1) and u the query
// soft-hash of the G query heads of the group (G = 1 under pooled
// selection).  This is the paper's own CUDA scoring kernel.
//
// What bounds it on this card: bytes.  At the main path's shapes (BH 16,
// N 8224, W 20 words, G 4, L 60, P 10) a key costs 80 bytes of packed
// bits, 10.5 MB in all, ~3.3 us at 3.35 TB/s; with P split into two halves
// looked up in per-(g, l) tables of exp(.), a (key, g, l) term is one FMA
// (~0.9 us at 67 TFLOP/s).  What limits this kernel in practice is the
// shared-memory port: two 4-byte lookups a term, 131,584 keys x 240 terms,
// 253 MB of table reads, ~8.5 us at 128 bytes a clock an SM.  The design
// it replaces (one 128-thread block per (bh, 128-key tile), a thread a
// key, P sign-adds and one expf per (key, g, l), u and logZ restaged in
// every block) spent 2400 sign-adds and 240 exponentials a key: it was
// bound by its own instruction issue, 57x the bytes bound.
//
// What the design does about it:
//   * split-table scoring, the definition paged_attention.cu scores with:
//     for each (g, l) two f32 tables over the low ceil(P/2) and the high
//     floor(P/2) planes,
//       T_lo[c] = exp(sum_j +-u_j / tau - logZ),  T_hi[c] = exp(sum_j +-u_j / tau),
//     so a term is T_lo[lo] * T_hi[hi]: two shared-memory lookups and one
//     FMA, no exponential in the key loop (exp(a) * exp(b) differs from
//     exp(a + b) by a few ulps, inside the kernel check's score
//     tolerance).  The tables of (l, g .. g + kG - 1) are adjacent and the
//     group chunk kG (4, 2 or 1, dividing G) is a template, so a lookup
//     needs no guard; a key's P-bit field is shifted out of a two-word
//     window with __funnelshift_r.  Lanes read one half-table with
//     arbitrary codes: at P <= 10 a half-table is at most 32 consecutive
//     words, so no bank conflicts;
//   * one fixed order a key: tables in order within a group chunk, then
//     the groups (ref.split_table_scores), so keys with equal bits score
//     bit-equal wherever they land (value_aware_topk's tie order relies on
//     it);
//   * the tables are built once per bh, not per tile: grid (C, BH), one
//     thread-block cluster of C CTAs a bh (cudaLaunchKernelEx; C from
//     paged_cluster.cuh's plan_cluster: the largest C <= 8, at most one
//     rank per kThreads keys, whose BH clusters the card holds at once,
//     else the fewest waves times keys a rank).  Each rank builds 1/C of
//     the tables (a warp a table, u loaded kTableBatch tables ahead,
//     logZ summed in plane order) and copies the rest from the other
//     ranks over distributed shared memory; a split cluster barrier
//     (arrive after the copy, wait before leaving) keeps every rank's
//     tables alive while they are read;
//   * rank r scores the r-th contiguous run of ceil(N / C) keys in tiles
//     of at most kThreads keys, a thread a key, the tile rows spread
//     evenly over the run in whole warps (key_run; ops.key_runs is the
//     host's copy);
//   * bits: a tile's rows go to shared memory by cp.async (16-byte copies
//     where W % 4 == 0 and the pointer allows, else 4), double-buffered
//     behind the score loop, and are read back as 16-byte words; a row's
//     stride there is an odd multiple of 4 words, so 8 lanes' 16-byte
//     reads hit distinct banks.  int8 planes (±1 bytes, L*P a key): each
//     staged word is formed from the sign bits of 32 bytes, 4 at a time
//     by one multiply, and scored with the same lookups;
//   * where the G*L table sets do not fit shared memory beside the bits,
//     each tile loops over chunks of tables (one group chunk, a run of
//     tables), the CTA building each chunk, a key's partial sums carried
//     in registers in the same order;
//   * P > 16 (a table set would pass 2 * 256 entries): the second
//     instance (kSplit false), chosen on the host, keeps u and logZ per
//     (g, l) in shared memory and sums P sign-adds and one expf a (key,
//     g, l), in the same order.
//
// Diagnostic build (-DSOCKET_SCORE_DUMP_TABLES, never the shipped one;
// ops.table_dump): where all tables are resident, each CTA writes its
// table sets, as it holds them once built and shared, to the buffer that
// socket_score_set_table_dump names, at ((bh * C + rank) * G * L + k) *
// stride for set k = l * G + g, before it scores.
//
// Bit layout (repro.core.hashing.pack_signs): flat bit f = l*P + p is bit
// f % 32 of word f / 32.  The port stores the words as int32 with the same
// bit pattern; they are read here as uint32.  The int8 format stores the
// L*P signs as ±1 bytes per key (bits_storage="int8"); a byte >= 0 reads
// as +1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "../paged_attention/paged_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using paged::FastDiv;
using paged::cp_async;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::kFull;
using paged::kThreads;
using paged::kWarps;

constexpr int kTableBatch = 8;       // tables a warp loads u for at once
constexpr int kMaxSplitPlanes = 16;  // the largest P the split tables take

#ifdef SOCKET_SCORE_DUMP_TABLES
__device__ float* g_table_dump;      // (BH, C, G * L, stride) floats
#endif

// Floats one (g, l) table set takes, rounded up to whole 16-byte words:
// the split tables' 2^ceil(P/2) + 2^floor(P/2) entries, or (sign-add) u's
// P planes and logZ.
template <bool kSplit>
__host__ __device__ inline int table_stride(int p) {
  return kSplit ? (((1 << ((p + 1) / 2)) + (1 << (p / 2)) + 3) & ~3)
                : ((p + 1 + 3) & ~3);
}

// Words a staged bit row takes in shared memory: w rounded up to an odd
// multiple of 4.
__host__ __device__ inline int row_stride(int w) {
  return ((w + 3) & ~3) | 4;
}

// The run [r0, r1) of rank `rank` of n keys split over c ranks, and the
// rows a tile: at most `tile`, whole warps, spread evenly over the run.
struct KeyRun {
  int r0, r1, rows;
};

__host__ __device__ inline KeyRun key_run(int n, int c, int tile, int rank) {
  const int per = (n + c - 1) / c;
  int tiles = (per + tile - 1) / tile;
  tiles = tiles < 1 ? 1 : tiles;
  int rows = ((per + tiles - 1) / tiles + 31) / 32 * 32;
  rows = rows < tile ? rows : tile;
  const int r0 = rank * per, r1 = (rank + 1) * per;
  return {r0 < n ? r0 : n, r1 < n ? r1 : n, rows};
}

// A staged row of words, read in order as 16-byte words.
struct RowWords {
  const uint4* row;
  uint4 cur;
  __device__ __forceinline__ uint32_t at(int i, bool fresh = false) {
    if (fresh || (i & 3) == 0) cur = row[i >> 2];
    const int k = i & 3;
    return k == 0 ? cur.x : k == 1 ? cur.y : k == 2 ? cur.z : cur.w;
  }
};

// Bit b (of 4) set where byte b of x is >= 0: the packed bit of a ±1 byte.
__device__ __forceinline__ uint32_t sign_bits4(uint32_t x) {
  return ((~x & 0x80808080u) * 0x00204081u) >> 28;
}

// The split cluster barrier: arrive once this rank reads no other rank's
// shared memory, wait before leaving until no rank reads this one's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One (g, l) table set at t, by a whole warp; lane j < p holds x = u_j.
template <bool kSplit>
__device__ __forceinline__ void build_table(float* t, float x, int p,
                                            float tau, int lane) {
  // logZ = sum_j |u_j / tau| + log1p(exp(-2 |u_j / tau|)), in plane order
  const float ax = fabsf(x / tau);
  const float term = ax + log1pf(expf(-2.f * ax));
  float z = 0.f;
  for (int j = 0; j < p; ++j) z += __shfl_sync(kFull, term, j);
  if constexpr (kSplit) {
    // entry c of the low table sums the signs of c's bits over planes
    // 0 .. lo_bits-1, of the high table over planes lo_bits .. p-1
    const int lo_bits = (p + 1) / 2, n_lo = 1 << lo_bits;
    const int entries = n_lo + (1 << (p - lo_bits));
    for (int c0 = 0; c0 < entries; c0 += 32) {
      const int c = c0 + lane;
      const bool low = c < n_lo;
      const int code = low ? c : c - n_lo, j0 = low ? 0 : lo_bits;
      const int nj = low ? lo_bits : p - lo_bits;
      float s = 0.f;
      for (int j = 0; j < lo_bits; ++j) {
        const float xj = __shfl_sync(kFull, x, (j0 + j) & 31);
        if (j < nj) s += ((code >> j) & 1) ? xj : -xj;
      }
      if (c < entries) t[c] = low ? expf(s / tau - z) : expf(s / tau);
    }
  } else {
    if (lane < p) t[lane] = x;
    if (lane == 0) t[p] = z;
  }
}

// The table sets k = first, first + step, ... < count at stab + k *
// stride, set k being (g, l) = (ga + k % gc, l0 + k / gc) of u (G, nl, P)
// at ub: a warp a set, u loaded kTableBatch sets ahead.
template <bool kSplit>
__device__ __forceinline__ void build_tables(float* stab, const float* ub,
                                             int ga, int gc, int l0,
                                             int count, int nl, int p,
                                             float tau, int first, int step) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = table_stride<kSplit>(p), hop = kWarps * step;
  for (int k0 = first + warp * step; k0 < count; k0 += kTableBatch * hop) {
    float x[kTableBatch];
#pragma unroll
    for (int b = 0; b < kTableBatch; ++b) {
      const int k = k0 + b * hop;
      x[b] = k < count && lane < p
                 ? ub[((ga + k % gc) * nl + l0 + k / gc) * p + lane]
                 : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kTableBatch; ++b) {
      const int k = k0 + b * hop;
      if (k < count)                      // uniform across the warp
        build_table<kSplit>(stab + k * stride, x[b], p, tau, lane);
    }
  }
}

// Adds tables l0 .. l1-1 of one group chunk to a key's sums sg: table l of
// group g0 + j at tl + (l - l0) * lstep + j * stride; the key's staged row
// holds w words.
template <bool kSplit, int kG>
__device__ __forceinline__ void score_tables(float (&sg)[kG], RowWords& row,
                                             const float* tl, int lstep,
                                             int stride, int l0, int l1,
                                             int p, int w, float tau) {
  const uint32_t pmask = p < 32 ? (1u << p) - 1u : kFull;
  const int lo_bits = (p + 1) / 2, n_lo = 1 << lo_bits;
  const uint32_t lo_mask = n_lo - 1u;
  int wi = (l0 * p) >> 5, bit = (l0 * p) & 31;
  uint32_t lo = row.at(wi, true), hi = wi + 1 < w ? row.at(wi + 1) : 0u;
  ++wi;
  for (int l = l0; l < l1; ++l, tl += lstep) {
    const uint32_t f = __funnelshift_r(lo, hi, bit) & pmask;
    bit += p;
    if (bit >= 32) {
      bit -= 32;
      lo = hi;
      ++wi;
      hi = wi < w ? row.at(wi) : 0u;
    }
    if constexpr (kSplit) {
      const float* a = tl + (f & lo_mask);
      const float* c = tl + n_lo + (f >> lo_bits);
#pragma unroll
      for (int j = 0; j < kG; ++j)
        sg[j] = fmaf(a[j * stride], c[j * stride], sg[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const float* ut = tl + j * stride;
        float dot = 0.f;
        for (int jj = 0; jj < p; ++jj)
          dot += ((f >> jj) & 1u) ? ut[jj] : -ut[jj];
        sg[j] += expf(dot / tau - ut[p]);
      }
    }
  }
}

// bits: uint32 (BH, n, w) words, or (kInt8) int8 (BH, n, w = nl*p) ±1
// bytes.  Shared memory: the table sets (all G*nl when resident, else
// kG*lc of one chunk), then two buffers of `tile` staged rows.  vec: the
// copy width, in words (packed: 4 or 1) or bytes (int8: 16, 8, 4 or 1).
template <bool kInt8, bool kSplit, int kG>
__global__ void __launch_bounds__(kThreads, 1)
socket_score_kernel(const void* __restrict__ bits,
                    const float* __restrict__ u,
                    const float* __restrict__ vnorm,
                    float* __restrict__ out, int n, int w, int g, int nl,
                    int p, float tau, int tile, int lc, int resident,
                    int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int bh = blockIdx.y, tid = threadIdx.x;
  const int stride = table_stride<kSplit>(p);
  const int wp = kInt8 ? (nl * p + 31) / 32 : w;   // words a key's row holds
  const int ws = row_stride(wp);
  float* stab = reinterpret_cast<float*>(smem);
  uint32_t* sbits =
      reinterpret_cast<uint32_t*>(stab + (resident ? g * nl : kG * lc) *
                                             stride);
  const KeyRun run = key_run(n, nranks, tile, rank);
  const float* ub = u + static_cast<size_t>(bh) * g * nl * p;

  // a tile's rows into dst at stride ws: copies of vec words (packed), or
  // words formed from the sign bits of the int8 planes
  const int units = kInt8 ? wp : w / vec;
  const FastDiv div_units(units);
  const bool fast_units = tile * units <= 65536;
  auto stage = [&](int n0, uint32_t* dst) {
    const int items = min(run.rows, run.r1 - n0) * units;
    const size_t row0 = static_cast<size_t>(bh) * n + n0;
    for (int i = tid; i < items; i += kThreads) {
      const int r = fast_units ? div_units(i) : i / units;
      const int k = i - r * units;
      if constexpr (kInt8) {
        const unsigned char* src = static_cast<const unsigned char*>(bits) +
                                   (row0 + r) * w + k * 32;
        const int nb = min(32, w - k * 32);
        uint32_t word = 0;
        for (int o = 0; o < nb; o += vec) {
          if (vec == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src + o);
            word |= sign_bits4(v.x) << o | sign_bits4(v.y) << (o + 4) |
                    sign_bits4(v.z) << (o + 8) | sign_bits4(v.w) << (o + 12);
          } else if (vec == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(src + o);
            word |= sign_bits4(v.x) << o | sign_bits4(v.y) << (o + 4);
          } else if (vec == 4) {
            word |= sign_bits4(*reinterpret_cast<const uint32_t*>(src + o))
                    << o;
          } else {
            word |= (static_cast<signed char>(src[o]) >= 0 ? 1u : 0u) << o;
          }
        }
        dst[r * ws + k] = word;
      } else {
        cp_async(dst + r * ws + k * vec,
                 static_cast<const uint32_t*>(bits) + (row0 + r) * w +
                     k * vec,
                 4 * vec);
      }
    }
    if constexpr (!kInt8) cp_async_commit();
  };

  // ---- 0. the first tile's bits in flight; the tables ---------------------
  if (run.r0 < run.r1) stage(run.r0, sbits);
  const bool share = resident && nranks > 1;
  if (resident) {
    // rank r builds sets r, r + C, ...; set k is (l, g) = (k / G, k % G)
    build_tables<kSplit>(stab, ub, 0, g, 0, g * nl, nl, p, tau, rank,
                         nranks);
    if (share) {
      cluster.sync();                     // every rank's share built
      const int quads = stride / 4;
      const FastDiv div_quads(quads);
      float4* own = reinterpret_cast<float4*>(stab);
      for (int i = tid; i < g * nl * quads; i += kThreads) {
        const int owner = div_quads(i) % nranks;
        if (owner != rank)
          own[i] = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(stab, owner))[i];
      }
      cluster_arrive();                   // done reading the other ranks
    }
#ifdef SOCKET_SCORE_DUMP_TABLES
    __syncthreads();                      // every thread's copies written
    const int floats = g * nl * stride;
    float* dump = g_table_dump +
                  (static_cast<size_t>(bh) * nranks + rank) * floats;
    for (int i = tid; i < floats; i += kThreads) dump[i] = stab[i];
#endif
  }

  // ---- 1. score the run, tile by tile -------------------------------------
  const int gc = resident ? g : kG;       // group sets a table row holds
  int buf = 0;
  for (int n0 = run.r0; n0 < run.r1; n0 += run.rows, buf ^= 1) {
    const bool next = n0 + run.rows < run.r1;
    if (next) stage(n0 + run.rows, sbits + (buf ^ 1) * tile * ws);
    if constexpr (!kInt8) cp_async_wait(next ? 1 : 0);
    __syncthreads();                      // the tile's rows (and tables) in
    const int t = n0 + tid;
    const bool active = tid < run.rows && t < run.r1;
    RowWords row{reinterpret_cast<const uint4*>(sbits + buf * tile * ws +
                                                tid * ws), {}};
    float score = 0.f;
    for (int g0 = 0; g0 < g; g0 += kG) {
      float sg[kG] = {};
      for (int l0 = 0; l0 < nl; l0 += lc) {
        const int l1 = min(nl, l0 + lc);
        if (!resident) {
          __syncthreads();                // the last chunk's tables read
          build_tables<kSplit>(stab, ub, g0, kG, l0, kG * (l1 - l0), nl, p,
                               tau, 0, 1);
          __syncthreads();
        }
        if (active)
          score_tables<kSplit, kG>(sg, row,
                                   stab + (resident ? g0 * stride : 0),
                                   gc * stride, stride, l0, l1, p, wp, tau);
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) score += sg[j];
    }
    if (active) {
      const size_t o = static_cast<size_t>(bh) * n + t;
      if (vnorm != nullptr) score *= vnorm[o];
      out[o] = score;
    }
    __syncthreads();                      // the buffer read before restaged
  }
  if (share) cluster_wait();              // no rank's tables read any more
}

// How a launch is shaped: its configuration (grid, cluster, shared
// memory) and clusters at once, the tile rows, the tables a chunk.
struct Plan {
  paged::ClusterLaunch launch;
  size_t smem;
  int tile, lc, resident, vec;
};

inline int smem_optin(int* optin) {
  static int v = 0;                       // queried once, outside any capture
  if (v == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *optin = v;
  return 0;
}

// The largest cluster size worth taking for n keys: a rank per kThreads
// keys, at most kMaxCluster.
inline int cluster_cap(int n) {
  return std::max(1, std::min(paged::kMaxCluster,
                              (n + kThreads - 1) / kThreads));
}

// All tables resident with the largest tile (kThreads down to 32 rows)
// that leaves room for them; else the largest tile with room for a chunk
// of one group chunk's tables, as many tables a chunk as fit.
template <bool kInt8, bool kSplit, int kG>
int make_plan(Plan* pl, const void* bits, int bh, int n, int w, int g,
              int nl, int p, cudaStream_t stream) {
  int optin = 0;
  int e = smem_optin(&optin);
  if (e != 0) return e;
  const int wp = kInt8 ? (nl * p + 31) / 32 : w;
  const size_t row = static_cast<size_t>(row_stride(wp)) * 4;
  const size_t set = static_cast<size_t>(table_stride<kSplit>(p)) * 4;
  const size_t all = static_cast<size_t>(g) * nl * set;
  const size_t cap = static_cast<size_t>(optin);
  pl->resident = 0;
  for (int t = kThreads; t >= 32 && !pl->resident; t /= 2)
    if (all + 2 * t * row <= cap) {
      pl->resident = 1;
      pl->tile = t;
      pl->lc = nl;
      pl->smem = all + 2 * t * row;
    }
  if (!pl->resident) {
    int t = kThreads;
    while (t >= 32 && 2 * t * row + kG * set > cap) t /= 2;
    if (t < 32) return paged::kErrSmem;
    pl->tile = t;
    pl->lc = static_cast<int>(std::min<size_t>(
        nl, (cap - 2 * t * row) / (kG * set)));
    pl->smem = kG * pl->lc * set + 2 * t * row;
  }
  const uintptr_t at = reinterpret_cast<uintptr_t>(bits);
  if (kInt8) {
    pl->vec = 16;
    while (pl->vec > 1 && ((nl * p) % pl->vec || at % pl->vec)) pl->vec >>= 1;
  } else {
    pl->vec = w % 4 == 0 && at % 16 == 0 ? 4 : 1;
  }
  return paged::plan_cluster(
      &pl->launch,
      reinterpret_cast<const void*>(&socket_score_kernel<kInt8, kSplit, kG>),
      pl->smem, 1, bh, cluster_cap(n), n, stream);
}

// Calls f(std::integral_constant<int, kG>{}) with kG the largest of 4, 2, 1
// dividing g.
template <typename F>
int with_groups(int g, F&& f) {
  if (g % 4 == 0) return f(std::integral_constant<int, 4>{});
  if (g % 2 == 0) return f(std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{});
}

// Calls f(int8, split, kG) with the instance's template arguments as
// integral constants: split tables for P <= kMaxSplitPlanes, the sign-add
// instance above.
template <typename F>
int with_instance(int bits_int8, int g, int p, F&& f) {
  auto by_split = [&](auto int8) {
    if (p <= kMaxSplitPlanes)
      return with_groups(g, [&](auto kg) {
        return f(int8, std::true_type{}, kg);
      });
    return with_groups(g, [&](auto kg) {
      return f(int8, std::false_type{}, kg);
    });
  };
  return bits_int8 ? by_split(std::true_type{}) : by_split(std::false_type{});
}

}  // namespace

extern "C" {

// bits: uint32 (BH, N, W) words, or int8 (BH, N, L*P) when bits_int8 != 0
// (w is then L*P); u: f32 (BH, G, L, P); vnorm: f32 (BH, N) or NULL; out:
// f32 (BH, N).  All contiguous on the device; BH <= 65535, 0 < P <= 32.
// Returns the launch's cudaError_t, or a negative code that
// socket_score_error_string explains.
int socket_score_launch(const void* bits, int bits_int8, const float* u,
                        const float* vnorm, float* out, int bh, int n, int w,
                        int g, int l, int p, float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(bits_int8, g, p, [&](auto int8, auto split, auto kg) {
    constexpr bool kInt8 = decltype(int8)::value;
    constexpr bool kSplit = decltype(split)::value;
    constexpr int kG = decltype(kg)::value;
    Plan pl;
    const int e = make_plan<kInt8, kSplit, kG>(&pl, bits, bh, n, w, g, l, p,
                                                s);
    if (e != 0) return e;
    const cudaError_t err = cudaLaunchKernelEx(
        &pl.launch.cfg, socket_score_kernel<kInt8, kSplit, kG>, bits, u,
        vnorm, out, n, w, g, l, p, tau, pl.tile, pl.lc, pl.resident, pl.vec);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}

// The shape of a launch with these arguments (an aligned bits pointer):
// info[0] the cluster size C, info[1] the dynamic shared memory of a CTA
// in bytes, info[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), info[3] 1 for the split-table
// instance, 0 for the sign-add one, info[4] the most rows a tile, info[5]
// 1 where all tables stay resident, info[6] the tables (l) a chunk.
// Returns 0 or an error code as the launch does.
int socket_score_plan(int bits_int8, int bh, int n, int w, int g, int l,
                      int p, int* info) {
  return with_instance(bits_int8, g, p, [&](auto int8, auto split, auto kg) {
    constexpr bool kInt8 = decltype(int8)::value;
    constexpr bool kSplit = decltype(split)::value;
    Plan pl;
    const int e = make_plan<kInt8, kSplit, decltype(kg)::value>(
        &pl, nullptr, bh, n, w, g, l, p, nullptr);
    if (e != 0) return e;
    info[0] = static_cast<int>(pl.launch.cfg.gridDim.x);
    info[1] = static_cast<int>(pl.smem);
    info[2] = pl.launch.fit;
    info[3] = kSplit ? 1 : 0;
    info[4] = pl.tile;
    info[5] = pl.resident;
    info[6] = pl.lc;
    return 0;
  });
}

#ifdef SOCKET_SCORE_DUMP_TABLES
// Names the buffer the next launches dump their tables to.
int socket_score_set_table_dump(float* dump) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_table_dump, &dump, sizeof(dump)));
}

// Floats one (g, l) table set takes in the dump (as in shared memory).
int socket_score_table_stride(int p) {
  return p <= kMaxSplitPlanes ? table_stride<true>(p) : table_stride<false>(p);
}
#endif

const char* socket_score_error_string(int code) {
  if (code == paged::kErrClusterFit)
    return "the kernel's thread-block cluster does not fit on the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (code == paged::kErrSmem)
    return "one group chunk's table set and two 32-row bit tiles need more "
           "shared memory than a block may have (L*P too large)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
