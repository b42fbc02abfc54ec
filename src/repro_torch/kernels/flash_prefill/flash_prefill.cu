// Causal (optionally sliding-window) flash-attention prefill for Hopper
// (sm_90a), CUDA C++, on the tensor cores at f32 accuracy.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill/
// flash_prefill.py (_prefill_kernel, launched by flash_prefill_pallas):
// the FlashAttention-2 forward over a whole prompt,
//
//   out[bh, i] = sum_j p_ij v[kv, j] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = (q[bh, i] . k[kv, j]) * scale,
//
// over the keys kept by row i: j <= i and, when window > 0, i - j < window.
// With softcap > 0 the scores are capped first, s_ij = softcap *
// tanh(s_ij / softcap) (the model's attn_logit_softcap; the TPU kernel has
// no cap term and is the softcap = 0 case).
// q is (BH, S, hd) and k, v are (BKV, S, hd), f32 or bf16; the output is
// f32 (BH, S, hd).  The running max m, sum l and the accumulator are f32,
// and the output is acc / max(l, 1e-30), as on the TPU.  Two differences
// from the TPU kernel, both with the same output where the TPU kernel is
// defined:
//   * any S: the last query and key tiles may be ragged (rows at or past S
//     are copied in as zeros and never stored; the causal mask already
//     keeps every key of a stored row below S);
//   * GQA without copies: with G = BH / BKV, row bh reads K/V row bh / G.
//     In the model's head order (bh = b*H + kv*G + g) that is b*KVH + kv;
//     with G = 1 it is the TPU kernel.
// The TPU kernel masks key tiles above the diagonal or outside the window;
// this one never visits them (nor does a warp whose 16 rows keep none of
// a tile's keys).  Masked scores are the finite -1e30 of the TPU kernel,
// so a tile that masks a whole row gives alpha = exp(0) = 1 and p = 0,
// never exp(-inf + inf).
//
// What bounds it on this card: operations.  The function needs 4 * hd
// flops per (query, kept key) pair per head: q.k and p.v.  At llama31-8b's
// prefill (BH 64, BKV 16, S 8192, hd 128) that is 1.10e12 flops: 16.41 ms
// at the 67 TFLOP/s of f32 outside the tensor cores, 2.22 ms at TF32's
// 495 TFLOP/s, and 3 x 2.22 = 6.66 ms for the three TF32 products of each
// f32 product below (the floor of this design), while its bytes (q and
// out at BH, k and v at BKV) are 0.67 GB, 0.20 ms.  mma.sync reaches 318
// TFLOP/s of TF32 on an H100 (experiments/flash_prefill_variants.py), so
// its 3xTF32 floor is 10.4 ms; wgmma, the way to the full rate, is later
// work.
//
// What the design does about it:
//   * 3xTF32: both products, S = Q K^T and O += P V, run as
//     mma.sync.m16n8k8 TF32 with f32 accumulation.  Each f32 operand x is
//     split into big = rna_tf32(x) and small = rna_tf32(x - big), so
//     x = big + small to 2^-22 |x|, and a product is a_small b_big +
//     a_big b_small + a_big b_big, small terms first (1xTF32 keeps ~3
//     decimal digits and fails the f32 gates).  rna_tf32 is the value
//     cvt.rna.tf32.f32 gives (to nearest, ties away from zero), made with
//     integer adds: (bits + 0x1000) & ~0x1fff for big; for small, bits +
//     0x1000 alone, as the tensor cores ignore an operand's 13 low bits.
//     bf16 values are exact in TF32 (8 mantissa bits of TF32's 10): with
//     bf16 inputs Q K^T is the big product alone and P V two (P split,
//     V exact).  The tensor cores do not round their f32 sums to nearest
//     (longer mma chains read farther from the plain version), so they
//     sum at most kChunk k-steps of S (32 of hd's products) and one key
//     tile of P V before an f32 add outside them takes over.
//   * a warp owns 16 query rows: its S tile stays in registers in the
//     mma accumulator layout (thread (g, c) = (lane / 4, lane % 4) holds
//     rows g, g + 8 and keys 2c, 2c + 1 of each 8), the row max and sum
//     reduce over the row's 4 lanes, and P goes from S's registers
//     straight into the A operand of P V.  The accumulator's columns
//     (2c, 2c + 1) are not the A fragment's (c, c + 4), so each 8-key
//     step of P V takes its keys in the order 0 2 4 6 1 3 5 7: V's B
//     fragment reads key rows 2c and 2c + 1.  Q K^T's reduction over hd
//     takes the same order, so A and B fragments read two adjacent
//     elements (one 8-byte load) instead of columns c and c + 4; the
//     output's columns pair up the same way (a thread stores 4 adjacent
//     ones), so V's B fragments of two output tiles are one 8-byte load.
//     Tiles where a warp's mask keeps every key run a softmax without it.
//   * K/V tiles are copied by cp.async.cg (16 B, the zero-filling form
//     with src-size 0 for rows at or past S) into a landing buffer: tile
//     j + 1 lands while tile j is multiplied.  Between tiles the block
//     splits the landed tile once into TF32 operand planes (big, small;
//     big alone for bf16), which every warp then reads: one split per
//     element instead of one per warp (measured at hd 128 against
//     splitting at each fragment load: see PERF.md section 6).  TMA would
//     free the copying threads' issue slots too, but its tensor maps are
//     made on the host per (pointer, S), which the plain C interface and
//     the CUDA-graph captures of its callers would have to carry;
//     cp.async keeps the launch a plain call.
//   * shared memory, row strides padded so that every fragment load is
//     free of bank conflicts: Q rows and K planes hd + 8 elements (an A
//     or B load reads rows g at columns 2c, 2c + 1), V planes hd + 4
//     words (a B load reads rows 2c, 2c + 1 at columns 2g, 2g + 1).  Q
//     stays as loaded and is split at each fragment load: its planes
//     would not fit beside K's and V's.
//   * tiles (query rows = 16 x warps, keys, threads; f32 shared memory):
//       hd <= 64: 128 x 64, 256 threads (hd 64: 141,312 B);
//       hd 128:   128 x 48, 256 threads (221,696 B: one block an SM);
//       hd 160:   128 x 32, 256 threads (211,968 B);
//       hd 256:    64 x 16, 128 threads (167,424 B);
//     bf16 inputs take less (their planes hold big alone).  The grid puts
//     the longest rows (the last query tiles) first, so the causal
//     triangle's long blocks do not run last.
//   * the softmax: expf (no fast math), the cap's tanhf, the finite
//     sentinel, acc / max(l, 1e-30).
//
// ptxas -v (sm_90a, CUDA 12.8), registers a thread for f32 / bf16 inputs,
// as chip_smoke.py logs them: hd 16: 125 / 110; hd 32: 136 / 124; hd 64:
// 190 / 176; hd 128: 232 / 231; hd 160: 242 / 242; hd 256: 255 / 255,
// spilling 24 / 16 bytes (no other spills).  Shared memory is dynamic
// (the tiles above).
//
// Head dims: 16, 32, 64, 128, 160, 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 4;          // k-steps of Q K^T summed in one mma chain

// Query rows (16 a warp) and keys of a block's tile, by head dim.
template <int HD>
struct Tiles {
  static constexpr int kWarps = 8;
  static constexpr int kBK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int kWarps = 8;
  static constexpr int kBK = 48;
};
template <>
struct Tiles<160> {
  static constexpr int kWarps = 8;
  static constexpr int kBK = 32;
};
template <>
struct Tiles<256> {
  static constexpr int kWarps = 4;
  static constexpr int kBK = 16;
};

// Shared memory: Q as loaded (kBQ rows, stride kQK elements of T); the
// next K and V tiles as loaded (kBK rows of HD each, the cp.async
// target); the current K and V tiles as TF32 operand planes, 32-bit
// words: big, and small unless the inputs are exact in TF32 (strides kQK
// for K, kV for V).
template <int HD, typename T>
struct Layout {
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kWarps = Tiles<HD>::kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = Tiles<HD>::kBK;
  static constexpr int kQK = HD + 8;       // Q row stride, K planes' too
  static constexpr int kV = HD + 4;        // V planes' row stride
  static constexpr int kQElems = kBQ * kQK;
  static constexpr int kRawElems = kBK * HD;
  static constexpr int kKWords = kBK * kQK;
  static constexpr int kVWords = kBK * kV;
  static constexpr int kPlanes = kExact ? 1 : 2;
  static constexpr int kSmemBytes =
      (kQElems + 2 * kRawElems) * int(sizeof(T)) +
      kPlanes * (kKWords + kVWords) * 4;
};

// The TF32 operands of x: big = rna_tf32(x), and small = rna_tf32(x - big)
// as the tensor cores read it (its 13 low bits ignored), unless x is exact
// in TF32 (bf16 inputs), when small is never read.
template <bool kExact>
__device__ __forceinline__ void operands(float x, uint32_t& big,
                                         uint32_t& small) {
  if (kExact) {
    big = __float_as_uint(x);
  } else {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
  }
}

// d += a b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (S, HD) matrix into shared memory, row
// stride STRIDE elements, as 16-byte cp.async copies; rows at or past s
// are zero-filled (their source address is row 0's, never read).
template <int HD, int ROWS, int STRIDE, int THREADS, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int row0,
                                          int s) {
  constexpr int kVec = 16 / int(sizeof(T));
  constexpr int kPerRow = HD / kVec;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * kPerRow; e += THREADS) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kVec;
    const bool valid = row0 + r < s;
    cp_async16(dst + r * STRIDE + c,
               src + static_cast<size_t>(valid ? row0 + r : 0) * HD + c,
               valid);
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The loaded K and V tiles (ROWS, HD) of T into their TF32 operand
// planes, row strides KS and VS words: big, and small unless exact.  All
// loads are issued before any split or store.
template <int HD, int ROWS, int KS, int VS, int THREADS, bool kExact,
          typename T>
__device__ __forceinline__ void split_tiles(uint32_t* kbig, uint32_t* ksmall,
                                            uint32_t* vbig, uint32_t* vsmall,
                                            const T* rk, const T* rv) {
  constexpr int kPerRow = HD / 4;
  constexpr int kIters = ROWS * kPerRow / THREADS;
  static_assert(ROWS * kPerRow % THREADS == 0, "uneven split pass");
  float4 x[2][kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * 4;
    x[0][i] = load4(rk + r * HD + c);
    x[1][i] = load4(rv + r * HD + c);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / kPerRow;
      const int at = r * (m ? VS : KS) + (e - r * kPerRow) * 4;
      uint4 b, sm;
      operands<kExact>(x[m][i].x, b.x, sm.x);
      operands<kExact>(x[m][i].y, b.y, sm.y);
      operands<kExact>(x[m][i].z, b.z, sm.z);
      operands<kExact>(x[m][i].w, b.w, sm.w);
      *reinterpret_cast<uint4*>((m ? vbig : kbig) + at) = b;
      if (!kExact) *reinterpret_cast<uint4*>((m ? vsmall : ksmall) + at) = sm;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of a warp's S tile (keys kp0 + 8j + e of its
// accumulator registers j, e and 2 + e, rows r0 and r1): scales and caps
// the scores, masks them when kMask (k <= q and q - k < window), moves
// the running maxima m0, m1 and the lane-partial sums l0, l1 on, and
// leaves p = exp(s - m) in sc.  Returns both rows' alpha = exp(m_old -
// m_new).
template <bool kMask, int kNT>
__device__ __forceinline__ float2 softmax_tile(float (&sc)[kNT][4], int kp0,
                                               int r0, int r1, float scale,
                                               int window, float softcap,
                                               float& m0, float& m1,
                                               float& l0, float& l1) {
  auto keep = [&](int kp, int qp) {
    return !kMask || (kp <= qp && (window <= 0 || qp - kp < window));
  };
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kp = kp0 + 8 * j + e;
      float x0 = sc[j][e] * scale, x1 = sc[j][2 + e] * scale;
      if (softcap > 0.f) {
        x0 = softcap * tanhf(x0 / softcap);
        x1 = softcap * tanhf(x1 / softcap);
      }
      sc[j][e] = keep(kp, r0) ? x0 : kNegInf;
      sc[j][2 + e] = keep(kp, r1) ? x1 : kNegInf;
      mx0 = fmaxf(mx0, sc[j][e]);
      mx1 = fmaxf(mx1, sc[j][2 + e]);
    }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float2 alpha = make_float2(expf(m0 - mx0), expf(m1 - mx1));
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kp = kp0 + 8 * j + e;
      sc[j][e] = keep(kp, r0) ? expf(sc[j][e] - m0) : 0.f;
      sc[j][2 + e] = keep(kp, r1) ? expf(sc[j][2 + e] - m1) : 0.f;
      sum0 += sc[j][e];
      sum1 += sc[j][2 + e];
    }
  l0 = l0 * alpha.x + sum0;
  l1 = l1 * alpha.y + sum1;
  return alpha;
}

template <int HD, typename T>
__global__ void __launch_bounds__(Layout<HD, T>::kThreads, 1)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out,
                     int s, int group, float scale, int window,
                     float softcap) {
  using L = Layout<HD, T>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kQK = L::kQK, kVS = L::kV;
  constexpr int kNT = kBK / 8;           // 8-key steps of a tile
  constexpr int kKS = HD / 8;            // 8-column steps of hd
  constexpr int kCh = kKS < kChunk ? kKS : kChunk;
  constexpr int kNG = kKS % 4 == 0 ? 4 : kKS;   // output tiles at a time
  constexpr bool kExact = L::kExact;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);        // (kBQ, kQK)
  T* rk = sq + L::kQElems;                       // (kBK, HD) as loaded
  T* rv = rk + L::kRawElems;
  uint32_t* kbig = reinterpret_cast<uint32_t*>(rv + L::kRawElems);
  uint32_t* vbig = kbig + L::kKWords;            // (kBK, kVS)
  uint32_t* ksmall = vbig + L::kVWords;          // f32 inputs only
  uint32_t* vsmall = ksmall + L::kKWords;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int c = threadIdx.x & 3;
  const int wq0 = q0 + 16 * warp;        // this warp's first query row
  const int r0 = wq0 + g, r1 = r0 + 8;   // this thread's two rows
  const size_t kv_off = static_cast<size_t>(bh / group) * s * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  const int q_last = min(q0 + kBQ, s) - 1;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK;
  const int n_tiles = q_last / kBK - t_first + 1;

  // K/V tile it + 1 lands in rk/rv while tile it, split into the
  // planes, is multiplied
  auto copy_kv = [&](int row0) {
    copy_tile<HD, kBK, HD, L::kThreads>(rk, kb, row0, s);
    copy_tile<HD, kBK, HD, L::kThreads>(rv, vb, row0, s);
    cp_async_commit();
  };
  auto split_kv = [&]() {
    split_tiles<HD, kBK, kQK, kVS, L::kThreads, kExact>(kbig, ksmall, vbig,
                                                        vsmall, rk, rv);
  };
  copy_tile<HD, kBQ, kQK, L::kThreads>(
      sq, q + static_cast<size_t>(bh) * s * HD, q0, s);
  copy_kv(t_first * kBK);
  cp_async_wait<0>();
  __syncthreads();
  split_kv();
  __syncthreads();
  if (n_tiles > 1) copy_kv((t_first + 1) * kBK);

  float o[kKS][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane partials
  // A fragments of Q: rows g (a0, a2) and g + 8 (a1, a3), columns 2c, 2c+1
  const T* qa = sq + (16 * warp + g) * kQK + 2 * c;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t_first + it) * kBK;
    const bool active = wq0 < s && k0 <= wq0 + 15 &&
                        (window <= 0 || k0 + kBK - 1 > wq0 - window);
    if (active) {
      // ---- S = Q K^T: B fragments read K rows g, columns 2c, 2c + 1
      const int kt = g * kQK + 2 * c;
      float sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[j][r] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < kKS; kc += kCh) {
        float t[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) t[j][r] = 0.f;
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int d = 8 * (kc + i);
          const float2 x0 = load2(qa + d), x1 = load2(qa + 8 * kQK + d);
          uint32_t ab[4], as[4];
          operands<kExact>(x0.x, ab[0], as[0]);
          operands<kExact>(x1.x, ab[1], as[1]);
          operands<kExact>(x0.y, ab[2], as[2]);
          operands<kExact>(x1.y, ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int at = kt + 8 * j * kQK + d;
            const uint2 yb = *reinterpret_cast<const uint2*>(kbig + at);
            const uint32_t bb[2] = {yb.x, yb.y};
            if (!kExact) {
              const uint2 ys = *reinterpret_cast<const uint2*>(ksmall + at);
              const uint32_t bs[2] = {ys.x, ys.y};
              mma(t[j], as, bb);
              mma(t[j], ab, bs);
            }
            mma(t[j], ab, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) sc[j][r] += t[j][r];
      }

      // ---- online softmax over the tile; sc becomes p
      const bool need_mask = k0 + kBK - 1 > wq0 ||
                             (window > 0 && k0 < wq0 + 16 - window);
      const float2 alpha =
          need_mask ? softmax_tile<true>(sc, k0 + 2 * c, r0, r1, scale,
                                         window, softcap, m0, m1, l0, l1)
                    : softmax_tile<false>(sc, k0 + 2 * c, r0, r1, scale,
                                          window, softcap, m0, m1, l0, l1);
      const float alpha0 = alpha.x, alpha1 = alpha.y;

      // ---- O = O alpha + P V.  P's A fragment of key step j is its
      // accumulator registers (keys 2c, 2c + 1 of rows g, g + 8) in the
      // order a0 = (g, 2c), a1 = (g + 8, 2c), a2 = (g, 2c+1), a3 =
      // (g + 8, 2c+1); V's B fragment follows: rows 2c, 2c + 1, column g.
      uint32_t pb[kNT][4], ps[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        operands<false>(sc[j][0], pb[j][0], ps[j][0]);
        operands<false>(sc[j][2], pb[j][1], ps[j][1]);
        operands<false>(sc[j][1], pb[j][2], ps[j][2]);
        operands<false>(sc[j][3], pb[j][3], ps[j][3]);
      }
      const int vt = 2 * c * kVS + 2 * g;
#pragma unroll
      for (int n0 = 0; n0 < kKS; n0 += kNG) {
        float t[kNG][4];
#pragma unroll
        for (int i = 0; i < kNG; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) t[i][r] = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int i = 0; i < kNG; i += 2) {
            const int at = vt + 8 * j * kVS + 8 * (n0 + i);
            const uint2 b0 = *reinterpret_cast<const uint2*>(vbig + at);
            const uint2 b1 = *reinterpret_cast<const uint2*>(vbig + at + kVS);
            const uint32_t bb[2][2] = {{b0.x, b1.x}, {b0.y, b1.y}};
            uint32_t bs[2][2] = {};
            if (!kExact) {
              const uint2 s0 = *reinterpret_cast<const uint2*>(vsmall + at);
              const uint2 s1 =
                  *reinterpret_cast<const uint2*>(vsmall + at + kVS);
              bs[0][0] = s0.x;
              bs[0][1] = s1.x;
              bs[1][0] = s0.y;
              bs[1][1] = s1.y;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma(t[i + h], ps[j], bb[h]);
              if (!kExact) mma(t[i + h], pb[j], bs[h]);
              mma(t[i + h], pb[j], bb[h]);
            }
          }
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          o[n0 + i][0] = fmaf(o[n0 + i][0], alpha0, t[i][0]);
          o[n0 + i][1] = fmaf(o[n0 + i][1], alpha0, t[i][1]);
          o[n0 + i][2] = fmaf(o[n0 + i][2], alpha1, t[i][2]);
          o[n0 + i][3] = fmaf(o[n0 + i][3], alpha1, t[i][3]);
        }
      }
    }
    if (it + 1 < n_tiles) {
      cp_async_wait<0>();
      __syncthreads();                   // tile it + 1 in, planes all read
      split_kv();
      __syncthreads();                   // its planes ready, rk/rv free
      if (it + 2 < n_tiles) copy_kv(k0 + 2 * kBK);
    }
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  // output tiles 2m and 2m + 1 hold columns 16m + 2q and 16m + 2q + 1
  // (q their column): this thread's are 16m + 4c .. 16m + 4c + 3
  float* ob = out + static_cast<size_t>(bh) * s * HD + 4 * c;
#pragma unroll
  for (int n = 0; n < kKS; n += 2) {
    if (r0 < s)
      *reinterpret_cast<float4*>(ob + static_cast<size_t>(r0) * HD + 8 * n) =
          make_float4(o[n][0] / d0, o[n + 1][0] / d0, o[n][1] / d0,
                      o[n + 1][1] / d0);
    if (r1 < s)
      *reinterpret_cast<float4*>(ob + static_cast<size_t>(r1) * HD + 8 * n) =
          make_float4(o[n][2] / d1, o[n + 1][2] / d1, o[n][3] / d1,
                      o[n + 1][3] / d1);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, float* out, int bh,
           int group, int s, float scale, int window, float softcap,
           cudaStream_t stream) {
  using L = Layout<HD, T>;
  static bool smem_set = false;
  if (!smem_set && L::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid(bh, (s + L::kBQ - 1) / L::kBQ);
  flash_prefill_kernel<HD, T><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, s, group, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

#define FLASH_PREFILL_HEAD_DIMS(CASE) \
  CASE(16) CASE(32) CASE(64) CASE(128) CASE(160) CASE(256)

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                float* out, int bh, int group, int s, float scale, int window,
                float softcap, cudaStream_t stream) {
  switch (hd) {
#define CASE(HD)                                                         \
    case HD:                                                             \
      return launch<HD, T>(q, k, v, out, bh, group, s, scale, window,    \
                           softcap, stream);
    FLASH_PREFILL_HEAD_DIMS(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (BH, S, hd), k / v: (BKV, S, hd), all contiguous, of the element type
// dtype names (0 float, 1 bf16), 16-byte aligned; out: f32 (BH, S, hd).
// BH is a multiple of BKV, BH <= 2^31 - 1, ceil(S / 64) <= 65535.
// window <= 0 is plain causal attention; softcap <= 0 caps no score.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an unknown
// dtype or head dim).
int flash_prefill_launch(const void* q, const void* k, const void* v,
                         float* out, int dtype, int bh, int bkv, int s,
                         int hd, float scale, int window, float softcap,
                         void* stream) {
  if (bkv <= 0 || bh % bkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = bh / bkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, bh, group, s, scale, window,
                              softcap, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, bh, group, s, scale,
                                      window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
