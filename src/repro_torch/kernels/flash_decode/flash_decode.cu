// Flash decode over the gathered selection for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode/flash_decode.py
// (_decode_kernel, launched by flash_decode_pallas), the paper's "Flash
// Decode" backend: one decode step of GQA attention for the G query heads
// of one (batch, KV head) row bh against the K rows gathered for it (the
// top-k, sink and window selection), with a validity mask.  Per row
// s = q.k * scale, a masked row's logit -1e30 and its p 0, an fp32 online
// softmax (m, l, acc), and the output acc / max(l, 1e-30): a row whose
// mask is all false returns 0.  Where the caller asks for them, the same
// epilogue also writes each query head's softmax partials, the row max m
// and the normalizer l (a row with no kept entry: m -1e30, l 0), which a
// context-parallel rank merges with the other ranks' partials.
//
// What bounds it on this card: bytes.  The function must read each kept K
// and V row once (2 * hd * 4 bytes in f32), q, the mask and the output: at
// the static path's shape (BH 16, K 823, G 4, hd 128, f32, ~90 % kept)
// 12.2 MB, 3.6 us at 3.35 TB/s.  Its operations, 4 * hd a kept row and
// query head (q.k and p.v), about 2 a byte, take ~0.4 us at the f32 rate.
// Tensor cores do not fit: G is 1-6 query rows against mma's 16, the
// arithmetic is far below the ridge, and full fp32 would need 3xTF32.
// CUDA-core FMAs cover the fold in about 1 us of issue time a CTA; the
// fold has to overlap the copies, not be wide.
//
// What the design does about it:
//   * one launch, a thread-block cluster a row: grid (C, BH), launched
//     with cudaLaunchKernelEx; C is paged_cluster.cuh's plan_cluster
//     choice (the largest C <= 8 whose BH clusters the card holds at once,
//     else the fewest waves times K / C).  Rank r folds the r-th even share
//     [K r / C, K (r + 1) / C) of the row's K entries; a rank whose share
//     is empty (K < C) merges as m = -1e30, l = 0.  The ranks merge over
//     distributed shared memory (merge_ranks), which writes the output;
//     at C 1 the CTA writes it itself.  Nothing but the output is
//     allocated, and no partial state goes through device memory;
//   * staged rows: a share is one contiguous byte range of K and one of V,
//     so no table or index is read.  Its rows go to shared memory in a
//     ring of kStages stages of `rows` rows, kStages - 1 in flight, by
//     16-byte cp.async copies of the flat range (a thread on every
//     kThreads-th 16-byte piece); each stage also takes its rows' mask
//     bytes, as the aligned 4-byte words that hold them.  Rows of a size
//     or address that 16-byte copies do not fit are copied a piece at a
//     time, into rows padded to 16 bytes.  Masked rows are copied too:
//     the static path keeps nearly all;
//   * the ring's dense fold, from shared memory (paged_ring.cu's, its own
//     copy here): a unit of lpr lanes holds 32 B of a row each, 8 f32 or
//     16 bf16 / f16 elements (lpr the least power of two that holds hd;
//     lanes past the row hold zeros in registers), q of GT query heads and
//     their sums in registers; the units of a head group take the stage's
//     rows in turn, kRowsAUnit at once (their raw rows loaded first, their
//     dot products reduced together), each an online softmax of its own
//     (scale, mask, max, exp, the TPU kernel's order; the sums rescaled
//     only when the max grows), and merge once at the end, in shared
//     memory.
// Barriers a launch: one a stage, three for the CTA's merge, two around
// the ranks' merge.  The host asks the device nothing a launch: the plan
// is cached by shape, and plan_cluster remembers its occupancy queries.
//
// Layouts (all contiguous): q (BH, G, hd) f32, bf16 or f16 (q_type); k, v
// (BH, K, hd) of one type, f32, bf16 or f16 (kv_type); mask (BH, K) bytes,
// nonzero where the row is kept; out f32 (BH, G, hd); ml f32 (BH, G, 2),
// (m, l) a head, or null.  hd <= 256, G <= 32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "../paged_attention/paged_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using paged::FastDiv;
using paged::align16;
using paged::cp_async;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::kNegInf;
using paged::kThreads;
using paged::kWarps;

// element types of q, k and v, as the wrapper codes them
enum DType { kF32 = 0, kBf16 = 1, kF16 = 2 };

// elements of a row a lane holds: 8 f32 or 16 of the 2-byte types, 32 B
template <typename T>
__host__ __device__ constexpr int lane_elems() {
  return sizeof(T) == 4 ? 8 : 16;
}
constexpr int kRowsAUnit = 2;        // rows a unit folds at once
constexpr int kMaxLanes = 32;        // lanes a row, at most (hd <= 256)
constexpr int kMaxHeads = 32;        // query heads a row, at most
constexpr int kStageBytes = 32 * 1024;   // K and V rows of a stage, about
constexpr int kStages = 4;           // stages in the ring, one being folded
constexpr int kErrShape = -3;

inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// The launch's shape, computed on the host: lanes a row (lpr), head groups
// (hg) of GT heads and the units each has (uh), the row in registers
// (hd_pad elements) and in shared memory (stride bytes), the stage's rows
// and count, the copy width and whether a stage is one flat copy; the
// stage's parts (K rows, V rows, mask words; 128-byte aligned) and the
// ring's offset.
struct Geom {
  int lpr, hg, uh, hd_pad, stride, rows, stages, vec, flat;
  int kv_bytes, stage_bytes, ring;
};

// 16 B of a row as floats: 4 f32, 8 bf16 or 8 f16.
__device__ __forceinline__ void to_float(uint4 w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void to_float(uint4 w, float* x, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_float(uint4 w, float* x, __half) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2 h;
    *reinterpret_cast<uint32_t*>(&h) = u[i];
    const float2 f = __half22float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// element i of q as a float
__device__ __forceinline__ float q_at(const void* q, int q_type, size_t i) {
  if (q_type == kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  if (q_type == kF16) return __half2float(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}

// A lane's bytes of a staged row, as loaded: 32 B in chunks of 16, chunk c
// at chunk index c * lpr + lane_u of the row (a unit's lanes read
// neighbouring chunks); chunks past the row (nchunk of 16 B) are zero.
template <typename T>
struct Raw {
  static constexpr int kChunks = lane_elems<T>() * sizeof(T) / 16;
  static constexpr int kPer = 16 / sizeof(T);      // elements a chunk
  uint4 c[kChunks];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const unsigned char* row, int lpr,
                                           int lane_u, int nchunk) {
  Raw<T> r;
#pragma unroll
  for (int c = 0; c < Raw<T>::kChunks; ++c) {
    const int at = c * lpr + lane_u;
    r.c[c] = at < nchunk ? *reinterpret_cast<const uint4*>(row + at * 16)
                         : make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void convert(const Raw<T>& r, float* x) {
#pragma unroll
  for (int c = 0; c < Raw<T>::kChunks; ++c)
    to_float(r.c[c], x + c * Raw<T>::kPer, T());
}

// The column of the lane's element e (element e % kPer of chunk e / kPer).
template <typename T>
__device__ __forceinline__ int column(int e, int lpr, int lane_u) {
  constexpr int kPer = Raw<T>::kPer;
  return ((e / kPer) * lpr + lane_u) * kPer + e % kPer;
}

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const void* __restrict__ q, int q_type,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ out, float* __restrict__ ml,
                    int nbh, int kk, int g, int hd,
                    float scale, Geom geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the grid's rows of clusters: bh = blockIdx.z * gridDim.y + blockIdx.y
  // (the last row may run past BH; its clusters leave whole)
  const int row_id = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (row_id >= nbh) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = static_cast<size_t>(row_id);
  paged::Fold fold = {};
  fold.sacc = reinterpret_cast<float*>(smem);
  fold.sm = reinterpret_cast<float*>(
      smem + align16(static_cast<size_t>(g) * hd * 4));
  fold.sl = fold.sm + g;
  unsigned char* ring = smem + geo.ring;

  // ---- 0. this rank's share of the row's K entries -----------------------
  const int k_lo =
      static_cast<int>(static_cast<long long>(kk) * rank / nranks);
  const int k_hi =
      static_cast<int>(static_cast<long long>(kk) * (rank + 1) / nranks);
  const int rows = geo.rows, stages = geo.stages;
  const int nst = (k_hi - k_lo + rows - 1) / rows;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const size_t first = (bh * kk + k_lo) * row_bytes;
  const auto* kbytes = reinterpret_cast<const unsigned char*>(k) + first;
  const auto* vbytes = reinterpret_cast<const unsigned char*>(v) + first;
  const unsigned char* mrow = mask + bh * kk + k_lo;
  if (geo.stride != row_bytes) {          // padded rows: zeros past hd
    for (int i = tid; i < stages * geo.stage_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // ---- 1. q and the online softmax in registers ---------------------------
  constexpr int kE = lane_elems<T>();
  const int lpr = geo.lpr, lane_u = tid & (lpr - 1), unit = tid / lpr;
  const int hgi = unit / geo.uh, slot = unit - hgi * geo.uh;
  const bool active = hgi < geo.hg;
  const int nchunk = geo.stride / 16;
  float qr[GT][kE], acc[GT][kE], m[GT], l[GT];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    const int gg = hgi * GT + j;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = column<T>(e, lpr, lane_u);
      qr[j][e] = active && gg < g && d < hd
                     ? q_at(q, q_type, (bh * g + gg) * hd + d)
                     : 0.f;
      acc[j][e] = 0.f;
    }
    m[j] = kNegInf;
    l[j] = 0.f;
  }

  // ---- 2. the stages' copies --------------------------------------------
  const int pieces = row_bytes / geo.vec;
  const FastDiv div_pieces(pieces);
  // stage c's K and V rows and mask words into ring stage c % stages; a
  // group is committed whether or not c is a stage
  auto issue = [&](int c) {
    if (c < nst) {
      const int r0 = c * rows, n = min(rows, k_hi - k_lo - r0);
      unsigned char* st = ring + (c % stages) * geo.stage_bytes;
      const unsigned char* ks = kbytes + static_cast<size_t>(r0) * row_bytes;
      const unsigned char* vs = vbytes + static_cast<size_t>(r0) * row_bytes;
      if (geo.flat) {                     // one run of 16-byte pieces
        const int n16 = n * row_bytes / 16;
        for (int i = tid; i < n16; i += kThreads) {
          cp_async(st + i * 16, ks + i * 16, 16);
          cp_async(st + geo.kv_bytes + i * 16, vs + i * 16, 16);
        }
      } else {
        const int per_kv = n * pieces;
        for (int i = tid; i < 2 * per_kv; i += kThreads) {
          const int which = i >= per_kv, j = i - which * per_kv;
          const int r = div_pieces(j), piece = j - r * pieces;
          cp_async(st + which * geo.kv_bytes + r * geo.stride +
                       piece * geo.vec,
                   (which ? vs : ks) + r * row_bytes + piece * geo.vec,
                   geo.vec);
        }
      }
      // the mask bytes of rows r0 .. r0 + n, as the aligned words holding
      // them (a word never crosses an allocation's end)
      const uintptr_t m0 = reinterpret_cast<uintptr_t>(mrow + r0);
      const auto* mw =
          reinterpret_cast<const unsigned char*>(m0 & ~uintptr_t{3});
      const int words = (static_cast<int>(m0 & 3) + n + 3) >> 2;
      for (int i = tid; i < words; i += kThreads)
        cp_async(st + 2 * geo.kv_bytes + 4 * i, mw + 4 * i, 4);
    }
    cp_async_commit();
  };
  for (int c = 0; c < stages - 1; ++c) issue(c);

  // ---- 3. fold the stages ----------------------------------------------
  for (int c = 0; c < nst; ++c) {
    cp_async_wait(stages - 2);
    __syncthreads();                      // stage c in; stage c - 1 read
    issue(c + stages - 1);
    const int r0s = c * rows, n = min(rows, k_hi - k_lo - r0s);
    const unsigned char* kst = ring + (c % stages) * geo.stage_bytes;
    const unsigned char* vst = kst + geo.kv_bytes;
    const unsigned char* mst =
        vst + geo.kv_bytes +
        (reinterpret_cast<uintptr_t>(mrow + r0s) & 3);
    // a unit's rows r0 + slot + i * uh, i < kRowsAUnit, at once: their
    // raw K and V rows loaded first, their dot products reduced together
    for (int r0 = 0; r0 < n; r0 += geo.uh * kRowsAUnit) {
      int r[kRowsAUnit];
      bool ok[kRowsAUnit];
      Raw<T> kr[kRowsAUnit], vr[kRowsAUnit];
#pragma unroll
      for (int i = 0; i < kRowsAUnit; ++i) {
        r[i] = r0 + slot + i * geo.uh;
        ok[i] = active && r[i] < n && mst[r[i]] != 0;
        if (ok[i]) {
          kr[i] = load_raw<T>(kst + r[i] * geo.stride, lpr, lane_u, nchunk);
          vr[i] = load_raw<T>(vst + r[i] * geo.stride, lpr, lane_u, nchunk);
        } else {
#pragma unroll
          for (int c = 0; c < Raw<T>::kChunks; ++c)
            kr[i].c[c] = make_uint4(0, 0, 0, 0);
        }
      }
      float dot[kRowsAUnit][GT];
#pragma unroll
      for (int i = 0; i < kRowsAUnit; ++i) {
        float x[kE];
        convert(kr[i], x);
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          float s0 = 0.f, s1 = 0.f;       // two chains of FMAs
#pragma unroll
          for (int e = 0; e < kE; e += 2) {
            s0 = fmaf(qr[j][e], x[e], s0);
            s1 = fmaf(qr[j][e + 1], x[e + 1], s1);
          }
          dot[i][j] = s0 + s1;
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRowsAUnit; ++i)
#pragma unroll
          for (int j = 0; j < GT; ++j)
            dot[i][j] += __shfl_xor_sync(paged::kFull, dot[i][j], o);
#pragma unroll
      for (int i = 0; i < kRowsAUnit; ++i) {
        if (!ok[i]) continue;             // masked: p 0, the max unmoved
        float x[kE];
        convert(vr[i], x);
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          const float s = dot[i][j] * scale;
          if (s > m[j]) {                 // a new max: rescale the sums
            const float alpha = expf(m[j] - s);
            l[j] *= alpha;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[j][e] *= alpha;
            m[j] = s;
          }
          const float p = expf(s - m[j]);
          l[j] += p;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[j][e] = fmaf(p, x[e], acc[j][e]);
        }
      }
    }
  }

  // ---- 4. merge the CTA's units, then the cluster's ranks ----------------
  cp_async_wait(0);
  __syncthreads();                        // the ring free for the units
  const int units = kThreads / lpr;
  float* sx = reinterpret_cast<float*>(ring);         // (units, GT, hd_pad)
  float* sml = sx + static_cast<size_t>(units) * GT * geo.hd_pad;
  if (active) {
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      float* a = sx + (unit * GT + j) * geo.hd_pad;
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        *reinterpret_cast<float4*>(a + column<T>(e, lpr, lane_u)) =
            make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2],
                        acc[j][e + 3]);
      if (lane_u == 0) {
        sml[(unit * GT + j) * 2] = m[j];
        sml[(unit * GT + j) * 2 + 1] = l[j];
      }
    }
  }
  __syncthreads();
  // per query head: the units' max, their weights in place of their maxima
  // and the weighted sum of their l
  for (int gg = warp; gg < g; gg += kWarps) {
    const int hq = gg / GT, j = gg - hq * GT;
    float mx = kNegInf;
    for (int s = lane; s < geo.uh; s += 32)
      mx = fmaxf(mx, sml[((hq * geo.uh + s) * GT + j) * 2]);
    mx = paged::warp_max(mx);
    float ls = 0.f;
    for (int s = lane; s < geo.uh; s += 32) {
      float* st = sml + ((hq * geo.uh + s) * GT + j) * 2;
      const float w = expf(st[0] - mx);
      ls += st[1] * w;
      st[0] = w;
    }
    ls = paged::warp_sum(ls);
    if (lane == 0) {
      fold.sm[gg] = mx;
      fold.sl[gg] = ls;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gg = i / hd, d = i - gg * hd, hq = gg / GT, j = gg - hq * GT;
    const int u0 = hq * geo.uh * GT + j, step = GT * geo.hd_pad;
    const float* xs = sx + u0 * geo.hd_pad + d;
    const float* ws = sml + u0 * 2;
    float a[4] = {};                      // four chains over the units
    int s = 0;
    for (; s + 4 <= geo.uh; s += 4)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        a[t] = fmaf(xs[(s + t) * step], ws[(s + t) * GT * 2], a[t]);
    for (; s < geo.uh; ++s) a[0] = fmaf(xs[s * step], ws[s * GT * 2], a[0]);
    fold.sacc[i] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  if (nranks == 1) {                      // the CTA's state is the output
    __syncthreads();
    for (int i = tid; i < g * hd; i += kThreads)
      out[bh * g * hd + i] = fold.sacc[i] / fmaxf(fold.sl[i / hd], 1e-30f);
    if (ml != nullptr)
      for (int gg = tid; gg < g; gg += kThreads) {
        ml[(bh * g + gg) * 2] = fold.sm[gg];
        ml[(bh * g + gg) * 2 + 1] = fold.sl[gg];
      }
    return;
  }
  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd,
                     ml == nullptr ? nullptr : ml + bh * g * 2);
}

// Query heads a unit holds: 2 where there are two or more (each staged
// row then read once for two heads), else 1.
inline int heads_a_unit(int g) { return g >= 2 ? 2 : 1; }

// The instantiation a plan launches: GT = heads_a_unit(g).
template <typename T>
const void* kernel_of(int gt) {
  return gt == 2
             ? reinterpret_cast<const void*>(&flash_decode_kernel<T, 2>)
             : reinterpret_cast<const void*>(&flash_decode_kernel<T, 1>);
}

// Calls f(static_cast<T*>(nullptr)) with T the element type of kv_type
// and returns its result; an unknown code gives cudaErrorInvalidValue.
template <typename F>
int with_type(int kv_type, F&& f) {
  switch (kv_type) {
    case kF32: return f(static_cast<float*>(nullptr));
    case kBf16: return f(static_cast<__nv_bfloat16*>(nullptr));
    case kF16: return f(static_cast<__half*>(nullptr));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How a launch is shaped: its configuration (grid, cluster, shared
// memory), clusters at once, and the fold's geometry.
struct Plan {
  paged::ClusterLaunch launch;
  Geom geo;
  size_t smem;
};

template <typename T>
int make_plan(Plan* pl, int vec, int nbh, int kk, int g, int hd) {
  const int tsize = static_cast<int>(sizeof(T)), gt = heads_a_unit(g);
  Geom& geo = pl->geo;
  constexpr int kE = lane_elems<T>();
  if (g < 1 || g > kMaxHeads || hd < 1 || nbh < 1 || kk < 0)
    return kErrShape;
  geo.lpr = 1;
  while (geo.lpr * kE < hd) geo.lpr <<= 1;
  if (geo.lpr > kMaxLanes) return kErrShape;
  const int units = kThreads / geo.lpr;
  geo.hg = (g + gt - 1) / gt;
  geo.uh = units / geo.hg;
  geo.hd_pad = kE * geo.lpr;
  const int row_bytes = hd * tsize;
  geo.stride = static_cast<int>(align16(row_bytes));
  geo.vec = vec;
  geo.flat = vec == 16 && geo.stride == row_bytes;
  // stage rows: a multiple of the rows the units of a head group fold at
  // once, about kStageBytes of K and V
  const int at_once = geo.uh * kRowsAUnit;
  geo.rows =
      at_once * std::max(1, kStageBytes / (2 * at_once * geo.stride));
  geo.kv_bytes = static_cast<int>(
      align128(static_cast<size_t>(geo.rows) * geo.stride));
  // K rows, V rows, and the mask words (one more word than the rows span)
  geo.stage_bytes = 2 * geo.kv_bytes +
                    static_cast<int>(align128(geo.rows + 8));
  size_t at = 0;
  paged::take(&at, static_cast<size_t>(g) * hd * 4);  // the accumulator
  paged::take(&at, static_cast<size_t>(2) * g * 4);   // m, l
  at = align128(at);
  geo.ring = static_cast<int>(at);
  // kStages stages, or as many as the block's shared memory holds (2 at
  // least; plan_cluster refuses what does not fit)
  static int optin = 0;                  // queried once, outside any capture
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t room = static_cast<size_t>(optin) > at
                          ? (static_cast<size_t>(optin) - at) / geo.stage_bytes
                          : 0;
  geo.stages = static_cast<int>(
      std::max<size_t>(2, std::min<size_t>(kStages, room)));
  const size_t units_state =
      static_cast<size_t>(units) * gt * (geo.hd_pad + 2) * 4;
  pl->smem = at + std::max(static_cast<size_t>(geo.stages) * geo.stage_bytes,
                           units_state);
  // BH clusters as rows of the grid's y (at most 65535) and z
  const int ny = std::min(nbh, 65535), nz = (nbh + ny - 1) / ny;
  return paged::plan_cluster(&pl->launch, kernel_of<T>(gt), pl->smem, nz,
                             ny, paged::kMaxCluster, kk, nullptr);
}

// make_plan's result for a shape, remembered (the last kCached shapes).
int cached_plan(Plan* pl, int kv_type, int vec, int nbh, int kk, int g,
                int hd) {
  constexpr int kCached = 64;
  struct Entry {
    int key[6];
    Plan plan;
  };
  static Entry cache[kCached];
  static int n_cached = 0, next = 0;
  const int key[6] = {kv_type, vec, nbh, kk, g, hd};
  for (int i = 0; i < n_cached; ++i)
    if (std::equal(key, key + 6, cache[i].key)) {
      *pl = cache[i].plan;
      pl->launch.cfg.attrs = pl->launch.attr;   // the copy's own attribute
      return 0;
    }
  const int e = with_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return make_plan<T>(pl, vec, nbh, kk, g, hd);
  });
  if (e != 0) return e;
  Entry& slot = cache[next];
  std::copy(key, key + 6, slot.key);
  slot.plan = *pl;
  next = (next + 1) % kCached;
  n_cached = std::max(n_cached, next == 0 ? kCached : next);
  pl->launch.cfg.attrs = pl->launch.attr;
  return 0;
}

inline int elem_size(int type) { return type == kF32 ? 4 : 2; }

}  // namespace

extern "C" {

// Pointers as in the layouts above (ml may be null); q of the type q_type
// names, k and v of the type kv_type names (0 f32, 1 bf16, 2 f16).
// Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an unknown type), or a negative
// code that flash_decode_error_string explains.
int flash_decode_launch(const void* q, int q_type, const void* k,
                        const void* v, const unsigned char* mask, float* out,
                        float* ml, int kv_type, int nbh, int kk, int g, int hd,
                        float scale, void* stream) {
  if (nbh == 0) return 0;
  if (q_type < kF32 || q_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = paged::copy_width(k, v, hd * elem_size(kv_type));
  Plan pl;
  const int e = cached_plan(&pl, kv_type, vec, nbh, kk, g, hd);
  if (e != 0) return e;
  pl.launch.cfg.stream = static_cast<cudaStream_t>(stream);
  // the instantiation the plan was made for, launched with its arguments
  const void* kernel = nullptr;
  with_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    kernel = kernel_of<T>(heads_a_unit(g));
    return 0;
  });
  void* args[] = {&q, &q_type, &k, &v, &mask, &out, &ml, &nbh, &kk, &g,
                  &hd, &scale, &pl.geo};
  const cudaError_t err = cudaLaunchKernelExC(&pl.launch.cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The shape of a launch with these arguments (16-byte copies): info[0]
// the cluster size C, info[1] the dynamic shared memory of a CTA in
// bytes, info[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), info[3] the K/V stages, info[4] the
// rows a stage, info[5] the lanes a row, info[6] the query heads a unit,
// info[7] the units a head group, info[8] the bytes a staged row takes
// (hd's padded to 16).  Returns 0 or an error code as the launch does.
int flash_decode_plan(int kv_type, int nbh, int kk, int g, int hd,
                      int* info) {
  Plan pl;
  const int e = cached_plan(&pl, kv_type, 16, std::max(nbh, 1), kk, g, hd);
  if (e != 0) return e;
  info[0] = static_cast<int>(pl.launch.cfg.gridDim.x);
  info[1] = static_cast<int>(pl.smem);
  info[2] = pl.launch.fit;
  info[3] = pl.geo.stages;
  info[4] = pl.geo.rows;
  info[5] = pl.geo.lpr;
  info[6] = heads_a_unit(g);
  info[7] = pl.geo.uh;
  info[8] = pl.geo.stride;
  return 0;
}

const char* flash_decode_error_string(int code) {
  if (code == paged::kErrClusterFit)
    return "the kernel's thread-block cluster does not fit on the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (code == paged::kErrSmem)
    return "the K/V stages need more shared memory than a block may have";
  if (code == kErrShape)
    return "head dim above 256 or below 1, or query heads outside 1..32";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
