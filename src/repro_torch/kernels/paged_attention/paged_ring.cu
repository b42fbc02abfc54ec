// Fused sliding-window (ring) paged decode attention for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/
// paged_ring.py (_ring_kernel, launched by paged_ring_pallas).  A hybrid
// model's local layers keep only the last `window` tokens, in a circular
// page list: the first ring_blocks entries of a request's block table,
// with flat ring slot s = t % cap (cap = ring_blocks * bs) holding the
// newest token t of that residue.  For one decode step, per (request b,
// KV head h), the kernel folds the live rows, and only those, into an
// fp32 online softmax (m, l, acc) for the G query heads, each logit
// s = q.k * scale capped to softcap * tanh(s / softcap) when softcap > 0,
// and writes acc / max(l, 1e-30).  Dead slots are never read: a recycled
// page or the trash page may hold anything, NaN included, in its rows,
// scales and fp8 payloads.
//
// The live rows in closed form: the positions max(0, pos - window + 1) ..
// pos that the ring still holds, n_live = min(pos + 1, window, cap) of
// them from p0 = pos - n_live + 1; the k-th sits in slot
// s = (p0 + k) mod cap (p0 >= 0, so C++'s % is the floor modulo), pool
// row (bt[b, s / bs] * KVH + h) * bs + s % bs.  This is the set the TPU
// kernel keeps, ring_pos = pos - ((pos - s) mod cap) >= 0 and
// pos - ring_pos < window, with no slot tested.
//
// K/V pages are f32, bf16, int8 or fp8 e4m3fn (the _ring_kernel's
// `quantized` branch, paged_ring.py:69-72): with the per-row scale pools
// k_scale / v_scale a row's dot product q . k is multiplied by its K
// scale, and its V scale folds into its p, once a row each.
//
// What bounds it on this card: bytes.  The function must read the K and V
// rows of the live slots once (2 * hd * 4 bytes each in f32: 1 MB a
// (request, head) at the gemma3 continuous path's 1024-token window, hd
// 128; 2 * (hd + 4) as int8 or fp8 with their scales), plus q, the ring
// slice of the table and the output: 128 MB, 0.040 ms at 3.35 TB/s, at
// that path's 8 requests and 16 KV heads.  Its operations (4 * hd a live
// row and query head) take far less.
//
// What the design does about it:
//   * cluster split: grid (C, KVH, B), one thread-block cluster of C CTAs
//     per (request, head), launched with cudaLaunchKernelEx; C is
//     paged_cluster.cuh's plan_cluster choice (the largest C <= 8, and at
//     most one rank a kRowsPerRank live rows of the window, whose B * KVH
//     clusters the card holds at once).  Rank r folds the r-th even share
//     [n_live * r / C, n_live * (r + 1) / C) of the request's live rows;
//     a rank whose share is empty merges as m = -1e30, l = 0;
//   * staged K/V pages: a rank's share is a run of ring slots, so each
//     page it touches holds one contiguous run of its rows.  The pool row
//     of each page is read once into shared memory, and the rows are
//     copied page by page into a ring of kStages stages of `rows` rows
//     (the share's slots counted from the start of its first page, so a
//     stage's rows of one page are contiguous in both memories), two
//     stages in flight, by 16-byte cp.async copies (a thread on the same
//     piece of every few rows), scales by 4-byte ones; the ring's parts
//     128-byte aligned.  The first and last pages of a share copy only
//     their live rows;
//   * a fold written for a dense run, from shared memory: a unit of lpr
//     lanes holds 32 B of a row each, 8 f32 or 16 narrower elements (lpr
//     the least power of two that holds hd), q of GT query heads and
//     their accumulators in registers; the units of a head group take the
//     stage's rows in turn, kRowsAUnit at once (their raw rows loaded
//     first, their dot products reduced together), each an online softmax
//     of its own (scale, cap, max, exp, in the order of the TPU kernel,
//     the sums rescaled only when the max grows), and merge once at the
//     end, in shared memory; the C ranks' states then merge over
//     distributed shared memory (paged_cluster.cuh's merge_ranks).
// Barriers a launch: one a stage, three for the CTA's merge, two around
// the ranks' merge.
//
// Layouts (all contiguous): q f32 (B, KVH, G, hd); k/v pages T
// (NB, KVH, bs, hd) with T per kv_type (paged_common.cuh's KvType); k/v
// scales f32 (NB, KVH, bs) or null; bt int32 (B, ring_blocks), the ring
// slice of the table; pos int32 (B,), the decode token's position
// (already written to its slot).  The pool holds fewer than 2^31 rows
// (NB * KVH * bs; the wrapper checks); hd is at most 256 on f32 pages,
// 512 on the others.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
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
using paged::kNegInf;
using paged::kThreads;
using paged::kWarps;

// elements of a row a lane holds: 8 f32 or 16 of the narrower types, 32 B
// either way (two 16 B loads; one for int8 and fp8)
template <typename T>
__host__ __device__ constexpr int lane_elems() {
  return sizeof(T) == 4 ? 8 : 16;
}
constexpr int kRowsAUnit = 2;        // rows a unit folds at once
constexpr int kMaxLanes = 32;        // lanes a row, at most (hd <= 32 * elems)
constexpr int kRowsPerRank = 128;    // live rows of the window a rank, C's cap
constexpr int kStageBytes = 32 * 1024;   // K and V rows of a stage, about
// stages in the ring: two in flight while one is folded (more in flight
// delay the first stage's arrival, which the fold waits for)
constexpr int kStages = 3;
constexpr int kErrShape = -3;

inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// The launch's shape, computed on the host: lanes a row (lpr), head
// groups (hg) of GT heads and the units each has (uh), the padded row
// (hd_pad elements), the stage's rows and count, the copy width; byte
// offsets of the page table and the ring (128-byte aligned, as are a
// stage's parts).
struct Geom {
  int lpr, hg, uh, hd_pad, rows, stages, vec;
  int pages, ring, kv_bytes, scale_bytes, stage_bytes;
};

// 16 B of a row as floats: 4 f32, 8 bf16, 16 int8 or 16 fp8 e4m3fn.
__device__ __forceinline__ void to_float(uint4 w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void to_float(uint4 w, float* x, uint16_t) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// int8: byte b + 128 as the low bits of 2^23, then 2^23 + 128 taken off
// (exact; an int-to-float conversion issues at a quarter of the rate)
__device__ __forceinline__ void to_float(uint4 w, float* x, int8_t) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[4 * i] = __uint_as_float(__byte_perm(u[i], 0x4b000000u, 0x7440)) -
               8388736.f;
    x[4 * i + 1] =
        __uint_as_float(__byte_perm(u[i], 0x4b000000u, 0x7441)) - 8388736.f;
    x[4 * i + 2] =
        __uint_as_float(__byte_perm(u[i], 0x4b000000u, 0x7442)) - 8388736.f;
    x[4 * i + 3] =
        __uint_as_float(__byte_perm(u[i], 0x4b000000u, 0x7443)) - 8388736.f;
  }
}

// fp8 e4m3fn: two at a time to half2 (exact), then to float
__device__ __forceinline__ void to_float(uint4 w, float* x, __nv_fp8_e4m3) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(u[i >> 1] >> (16 * (i & 1))),
        __NV_E4M3);
    const float2 f = __half22float2(__half2(hr));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// A lane's bytes of a staged row, as loaded: lane_elems<T>() elements in
// chunks of 16 B, chunk c at chunk index c * lpr + lane_u of the row (a
// unit's lanes read neighbouring chunks).
template <typename T>
struct Raw {
  static constexpr int kChunks = lane_elems<T>() * sizeof(T) / 16;
  static constexpr int kPer = 16 / sizeof(T);      // elements a chunk
  uint4 c[kChunks];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const unsigned char* row, int lpr,
                                           int lane_u) {
  Raw<T> r;
#pragma unroll
  for (int c = 0; c < Raw<T>::kChunks; ++c)
    r.c[c] = *reinterpret_cast<const uint4*>(row + (c * lpr + lane_u) * 16);
  return r;
}

template <typename T>
__device__ __forceinline__ void convert(const Raw<T>& r, float* x) {
#pragma unroll
  for (int c = 0; c < Raw<T>::kChunks; ++c)
    to_float(r.c[c], x + c * Raw<T>::kPer, T());
}

// The column of the lane's element e (element e % kPer of chunk
// e / kPer).
template <typename T>
__device__ __forceinline__ int column(int e, int lpr, int lane_u) {
  constexpr int kPer = Raw<T>::kPer;
  return ((e / kPer) * lpr + lane_u) * kPer + e % kPer;
}

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads, 1)
paged_ring_kernel(const float* __restrict__ q,
                  const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ bt, const int* __restrict__ poss,
                  float* __restrict__ out, int kvh, int g, int hd, int bs,
                  int rb, float scale, int window, float softcap, Geom geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cap = rb * bs;
  const int pos = poss[b];
  const size_t bh = static_cast<size_t>(b) * kvh + h;
  const int* btb = bt + static_cast<size_t>(b) * rb;
  const bool scaled = k_scale != nullptr;
  paged::Fold fold = {};
  fold.sacc = reinterpret_cast<float*>(smem);
  fold.sm = reinterpret_cast<float*>(
      smem + align16(static_cast<size_t>(g) * hd * 4));
  fold.sl = fold.sm + g;
  int* spg = reinterpret_cast<int*>(smem + geo.pages);
  unsigned char* ring = smem + geo.ring;

  // ---- 0. this rank's share of the live rows, and its pages --------------
  const int n_live = max(0, min(min(pos + 1, window), cap));
  const int k_lo =
      static_cast<int>(static_cast<long long>(n_live) * rank / nranks);
  const int k_hi =
      static_cast<int>(static_cast<long long>(n_live) * (rank + 1) / nranks);
  // slots counted from the start of the share's first page: t in
  // [off0, t_end) holds the share, page t / bs of the share
  int off0 = 0, pg0 = 0;
  if (k_hi > k_lo) {
    const int sf = static_cast<int>(
        (static_cast<long long>(pos - n_live + 1) + k_lo) % cap);
    pg0 = sf / bs;
    off0 = sf - pg0 * bs;
  }
  const int t_end = off0 + (k_hi - k_lo);
  const int npg = (t_end + bs - 1) / bs;            // <= rb + 1
  for (int j = tid; j < npg; j += kThreads) {
    const int blk = pg0 + j < rb ? pg0 + j : pg0 + j - rb;
    spg[j] = (btb[blk] * kvh + h) * bs;
  }
  if (geo.hd_pad != hd)                   // padded columns read as 0
    for (int i = tid; i < geo.stages * geo.stage_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();                        // page table (and padding) in

  // ---- 1. q and the online softmax in registers ---------------------------
  constexpr int kE = lane_elems<T>();
  const int lpr = geo.lpr, lane_u = tid & (lpr - 1), unit = tid / lpr;
  const int hgi = unit / geo.uh, slot = unit - hgi * geo.uh;
  const bool active = hgi < geo.hg;
  float qr[GT][kE], acc[GT][kE], m[GT], l[GT];
#pragma unroll
  for (int j = 0; j < GT; ++j) {
    const int gg = hgi * GT + j;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = column<T>(e, lpr, lane_u);
      qr[j][e] = active && gg < g && d < hd ? q[(bh * g + gg) * hd + d] : 0.f;
      acc[j][e] = 0.f;
    }
    m[j] = kNegInf;
    l[j] = 0.f;
  }

  // ---- 2. the stages' copies --------------------------------------------
  const int rows = geo.rows, stages = geo.stages;
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int stride = geo.hd_pad * static_cast<int>(sizeof(T));
  const int pieces = row_bytes / geo.vec;
  const FastDiv div_pieces(pieces), div_bs(bs);
  const auto* kbytes = reinterpret_cast<const unsigned char*>(k_pages);
  const auto* vbytes = reinterpret_cast<const unsigned char*>(v_pages);
  const int q0 = off0 / rows;
  const int nst = k_hi > k_lo ? (t_end + rows - 1) / rows - q0 : 0;
  // the live rows [r_lo, r_hi) of stage c (slots t = (q0 + c) * rows + r)
  auto stage_rows = [&](int c, int* r_lo, int* r_hi) {
    const int t0 = (q0 + c) * rows;
    *r_lo = max(off0 - t0, 0);
    *r_hi = min(t_end - t0, rows);
  };
  // stage c's rows (and scales) into ring stage c % stages; a group is
  // committed whether or not c is a stage
  auto issue = [&](int c) {
    if (c < nst) {
      int r_lo, r_hi;
      stage_rows(c, &r_lo, &r_hi);
      // slot t0 + r is row (o0 + r) % bs of the share's page
      // pb + (o0 + r) / bs (o0 + r < 2^16: FastDiv is exact)
      const int t0 = (q0 + c) * rows, pb = t0 / bs, o0 = t0 - pb * bs;
      auto pool_row = [&](int r) {
        const int u = o0 + r, j = div_bs(u);
        return static_cast<size_t>(spg[pb + j]) + (u - j * bs);
      };
      unsigned char* st = ring + (c % stages) * geo.stage_bytes;
      if (geo.vec == 16 && kThreads % pieces == 0) {
        // a thread copies the same 16 B piece of every rstep-th row
        const int piece = tid % pieces, rstep = kThreads / pieces;
        for (int r = r_lo + tid / pieces; r < r_hi; r += rstep) {
          const size_t src = pool_row(r) * row_bytes + piece * 16;
          unsigned char* dst = st + r * stride + piece * 16;
          cp_async(dst, kbytes + src, 16);
          cp_async(dst + geo.kv_bytes, vbytes + src, 16);
        }
      } else {
        const int per_kv = (r_hi - r_lo) * pieces;
        for (int i = tid; i < 2 * per_kv; i += kThreads) {
          const int which = i >= per_kv, j = i - which * per_kv;
          const int rr = div_pieces(j), piece = j - rr * pieces;
          const int r = r_lo + rr;
          cp_async(st + which * geo.kv_bytes + r * stride + piece * geo.vec,
                   (which ? vbytes : kbytes) + pool_row(r) * row_bytes +
                       piece * geo.vec,
                   geo.vec);
        }
      }
      if (scaled) {
        float* ss = reinterpret_cast<float*>(st + 2 * geo.kv_bytes);
        const int n = r_hi - r_lo;
        for (int i = tid; i < 2 * n; i += kThreads) {
          const int which = i >= n, r = r_lo + i - which * n;
          cp_async(ss + which * (geo.scale_bytes / 4) + r,
                   (which ? v_scale : k_scale) + pool_row(r), 4);
        }
      }
    }
    cp_async_commit();
  };
  for (int c = 0; c < stages - 1; ++c) issue(c);

  // ---- 3. fold the stages ----------------------------------------------
  for (int c = 0; c < nst; ++c) {
    cp_async_wait(stages - 2);
    __syncthreads();                      // stage c in; stage c - 1 read
    issue(c + stages - 1);
    int r_lo, r_hi;
    stage_rows(c, &r_lo, &r_hi);
    const unsigned char* kst = ring + (c % stages) * geo.stage_bytes;
    const unsigned char* vst = kst + geo.kv_bytes;
    const float* kss = reinterpret_cast<const float*>(kst + 2 * geo.kv_bytes);
    const float* vss = kss + geo.scale_bytes / 4;
    // a unit's rows r0 + slot + i * uh, i < kRowsAUnit, at once: their
    // raw K and V rows loaded first, their dot products reduced together
    for (int r0 = r_lo; r0 < r_hi; r0 += geo.uh * kRowsAUnit) {
      int r[kRowsAUnit];
      bool ok[kRowsAUnit];
      Raw<T> kr[kRowsAUnit], vr[kRowsAUnit];
#pragma unroll
      for (int i = 0; i < kRowsAUnit; ++i) {
        r[i] = r0 + slot + i * geo.uh;
        ok[i] = active && r[i] < r_hi;
        if (ok[i]) {
          kr[i] = load_raw<T>(kst + r[i] * stride, lpr, lane_u);
          vr[i] = load_raw<T>(vst + r[i] * stride, lpr, lane_u);
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
        if (!ok[i]) continue;
        const float ks = scaled ? kss[r[i]] : 1.f;
        const float vs = scaled ? vss[r[i]] : 1.f;
        float x[kE];
        convert(vr[i], x);
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          float s = dot[i][j] * ks * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          if (s > m[j]) {                 // a new max: rescale the sums
            const float alpha = expf(m[j] - s);
            l[j] *= alpha;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[j][e] *= alpha;
            m[j] = s;
          }
          const float p = expf(s - m[j]), pv = p * vs;
          l[j] += p;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[j][e] = fmaf(pv, x[e], acc[j][e]);
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
      for (int k = 0; k < 4; ++k)
        a[k] = fmaf(xs[(s + k) * step], ws[(s + k) * GT * 2], a[k]);
    for (; s < geo.uh; ++s) a[0] = fmaf(xs[s * step], ws[s * GT * 2], a[0]);
    fold.sacc[i] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  if (nranks == 1) {                      // the CTA's state is the output
    __syncthreads();
    for (int i = tid; i < g * hd; i += kThreads)
      out[bh * g * hd + i] = fold.sacc[i] / fmaxf(fold.sl[i / hd], 1e-30f);
    return;
  }
  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd);
}

// Query heads a unit holds: 2 where there are two or more (each staged
// row then read once for two heads), else 1.
inline int heads_a_unit(int g) { return g >= 2 ? 2 : 1; }

// The instantiation a plan launches: GT = heads_a_unit(g).
template <typename T>
const void* kernel_of(int gt) {
  return gt == 2 ? reinterpret_cast<const void*>(&paged_ring_kernel<T, 2>)
                 : reinterpret_cast<const void*>(&paged_ring_kernel<T, 1>);
}

// How a launch is shaped: its configuration (grid, cluster, shared
// memory), clusters at once, and the fold's geometry.
struct Plan {
  paged::ClusterLaunch launch;
  Geom geo;
  size_t smem;
};

template <typename T>
int make_plan(Plan* pl, const T* k_pages, const T* v_pages, int b, int kvh,
              int g, int hd, int bs, int rb, int window,
              cudaStream_t stream) {
  const int tsize = static_cast<int>(sizeof(T)), gt = heads_a_unit(g);
  Geom& geo = pl->geo;
  constexpr int kE = lane_elems<T>();
  geo.lpr = 1;
  while (geo.lpr * kE < hd) geo.lpr <<= 1;
  if (geo.lpr > kMaxLanes || g < 1) return kErrShape;
  const int units = kThreads / geo.lpr;
  geo.hg = (g + gt - 1) / gt;
  geo.uh = units / geo.hg;
  if (geo.uh < 1) return kErrShape;
  geo.hd_pad = kE * geo.lpr;
  const int stride = geo.hd_pad * tsize;
  // stage rows: a multiple of the rows the units of a head group fold at
  // once, about kStageBytes of K and V
  const int at_once = geo.uh * kRowsAUnit;
  geo.rows = at_once * std::max(1, kStageBytes / (2 * at_once * stride));
  geo.kv_bytes = static_cast<int>(align128(static_cast<size_t>(geo.rows) *
                                           stride));
  geo.scale_bytes = static_cast<int>(align128(geo.rows * 4));
  geo.stage_bytes = 2 * geo.kv_bytes + 2 * geo.scale_bytes;
  geo.vec = paged::copy_width(k_pages, v_pages, hd * tsize);
  size_t at = 0;
  paged::take(&at, static_cast<size_t>(g) * hd * 4);  // the accumulator
  paged::take(&at, static_cast<size_t>(3) * g * 4);   // m, l
  geo.pages = static_cast<int>(paged::take(&at, (rb + 1) * 4));
  at = align128(at);
  geo.ring = static_cast<int>(at);
  // kStages stages, or 2 where they do not fit the block's shared memory
  static int optin = 0;                  // queried once, outside any capture
  if (optin == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  geo.stages = at + static_cast<size_t>(kStages) * geo.stage_bytes <=
                       static_cast<size_t>(optin)
                   ? kStages
                   : 2;
  const size_t units_state =
      static_cast<size_t>(units) * gt * (geo.hd_pad + 2) * 4;
  pl->smem = at + std::max(static_cast<size_t>(geo.stages) * geo.stage_bytes,
                           units_state);
  const long long work = std::min(window, rb * bs);
  const int c_cap = static_cast<int>(std::max(
      1LL, std::min<long long>(paged::kMaxCluster,
                               (work + kRowsPerRank - 1) / kRowsPerRank)));
  return paged::plan_cluster(
      &pl->launch, kernel_of<T>(gt), pl->smem, b, kvh, c_cap, work, stream);
}

template <typename T>
int launch(const float* q, const T* k_pages, const T* v_pages,
           const float* k_scale, const float* v_scale, const int* bt,
           const int* pos, float* out, int b, int kvh, int g, int hd, int bs,
           int rb, float scale, int window, float softcap,
           cudaStream_t stream) {
  Plan pl;
  const int e = make_plan<T>(&pl, k_pages, v_pages, b, kvh, g, hd, bs, rb,
                             window, stream);
  if (e != 0) return e;
  // the instantiation the plan was made for, launched with its arguments
  void* args[] = {&q, &k_pages, &v_pages, &k_scale, &v_scale, &bt, &pos,
                  &out, &kvh, &g, &hd, &bs, &rb, &scale, &window, &softcap,
                  &pl.geo};
  const cudaError_t err = cudaLaunchKernelExC(
      &pl.launch.cfg, kernel_of<T>(heads_a_unit(g)), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pointers as in the layouts above; k_pages / v_pages of the element type
// kv_type names, k_scale / v_scale NULL for unscaled pages.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unknown kv_type), or
// a negative code that paged_ring_attend_error_string explains.
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

// The shape of a launch with these arguments (pool pointers null: the
// widest copies): info[0] the cluster size C, info[1] the dynamic shared
// memory of a CTA in bytes, info[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), info[3] the K/V stages, info[4] the
// rows a stage, info[5] the lanes a row, info[6] the query heads a unit,
// info[7] the elements a K/V row takes in shared memory (hd padded to the
// lanes' width).
// Returns 0 or an error code as the launch does.
int paged_ring_attend_plan(int kv_type, int b, int kvh, int g, int hd,
                           int bs, int rb, int window, int* info) {
  return paged::with_kv_type(kv_type, [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Plan pl;
    const int e = make_plan<T>(&pl, nullptr, nullptr, b, kvh, g, hd, bs, rb,
                               window, nullptr);
    if (e != 0) return e;
    info[0] = static_cast<int>(pl.launch.cfg.gridDim.x);
    info[1] = static_cast<int>(pl.smem);
    info[2] = pl.launch.fit;
    info[3] = pl.geo.stages;
    info[4] = pl.geo.rows;
    info[5] = pl.geo.lpr;
    info[6] = heads_a_unit(g);
    info[7] = pl.geo.hd_pad;
    return 0;
  });
}

const char* paged_ring_attend_error_string(int code) {
  if (code == paged::kErrClusterFit)
    return "the kernel's thread-block cluster does not fit on the device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (code == paged::kErrSmem)
    return "the K/V stages need more shared memory than a block may have "
           "(ring too long or head dim too large)";
  if (code == kErrShape)
    return "head dim above 256 (f32 pages) or 512, or more query heads "
           "than the fold's units";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
