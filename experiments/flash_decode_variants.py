#!/usr/bin/env python3
"""Per-pass split and design alternatives of the port's flash-decode
kernel, timed on one card.

    python3 experiments/flash_decode_variants.py --save-old   # in a git checkout
    python3 experiments/flash_decode_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Each variant is a
copy of ``src/repro_torch/kernels/flash_decode/flash_decode.cu`` and the
cluster headers it includes (``paged_attention/paged_cluster.cuh``,
``paged_common.cuh``) with a few text substitutions (``VARIANTS``; a
substitution lands in whichever file holds its text), built with the
port's nvcc flags, checked against the plain version
(``flash_decode_ref`` within ``chip_smoke.ATTN_TOL``) and timed as
``chip_smoke.py`` times the kernel (CUDA-graph replay, inputs rotated
past the L2 cache) at the static path's shape (``cases.CARD_CASES``'
"main path": BH 16, K 823, G 4, hd 128, f32, ~90 % of rows kept) and at
batch 1 ("B 1": BH 8).

``old`` is the design before the redesign (the Triton split-K kernel and
its combine kernel, two launches and three scratch tensors a call), read
from commit ``OLD_COMMIT``: ``--save-old`` copies its sources into
``build/`` for a machine without git; the card machine needs Triton.
Variants named ``drop ...`` leave a pass out to show what it costs;
their outputs are wrong by design and only timed: ``drop copies``
copies no K/V row or mask word (the fold reads whatever the ring
holds), ``drop fold`` folds nothing (the copies still land), ``drop
copies and fold`` leaves the launch's fixed cost.  ``phase clock``
stamps ``%globaltimer`` in thread 0 of every CTA at entry, when the
first stage has landed, after the fold, after the units' merge and after
the ranks' merge.  ``C n`` forces the cluster size n in place of the
host's choice; ``cp.async.bulk`` copies a stage's K rows and its V rows
with one bulk copy each (thread 0, completing on the stage's
``mbarrier``) in place of the 16-byte ``cp.async`` copies;
``stages``/``stage`` variants change the ring's stage count and the
stage's byte budget.  ``host_us`` is the host's microseconds a call of
the shipped and old wrappers (``ops.launch_flash_decode``, 200 calls
without a synchronize).

Prints one line a measurement and writes a JSON object of them all to
``chiprun_out/flash_decode_variants.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "experiments"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from socket_score_variants import _nvcc, substitute  # noqa: E402

OUT = REPO / "build" / "flash_decode_variants"
OLD_COMMIT = "3d292cb28f500d0a967a53755dd97340f57b9170"
KERNELS = "src/repro_torch/kernels"
MAIN = "flash_decode/flash_decode.cu"
HEADERS = ("paged_attention/paged_cluster.cuh",
           "paged_attention/paged_common.cuh")
OLD_FILES = ("flash_decode/flash_decode.py", "flash_decode/ops.py")
SHAPES = ("main path", "B 1")            # labels of cases.CARD_CASES

# thread 0 of every CTA stamps %globaltimer: 0 entry, 1 first stage in,
# 2 stages folded, 3 units merged, 4 ranks merged (or the output written);
# and counts SM clocks: 5 waiting for its copies (cp.async.wait_group), 6
# in the stage barrier, 7 issuing copies, 8 the whole stage loop
_CLOCK = [
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_clk[1 << 16];\n"
     "#define CLK_AT(k) g_clk[((blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x) * 9 + (k)]\n"
     "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "CLK_AT(k) = t_; }\n\nnamespace {\n"),
    ("  if (row_id >= nbh) return;\n",
     "  if (row_id >= nbh) return;\n  CLK(0);\n"),
    ("  // ---- 3. fold the stages",
     "  long long wsum_ = 0, bsum_ = 0, isum_ = 0;\n"
     "  const long long loop0_ = clock64();\n"
     "  // ---- 3. fold the stages"),
    ("    cp_async_wait(stages - 2);\n"
     "    __syncthreads();                      // stage c in; stage c - 1 read\n"
     "    issue(c + stages - 1);\n",
     "    const long long w0_ = clock64();\n"
     "    cp_async_wait(stages - 2);\n"
     "    const long long b0_ = clock64();\n"
     "    __syncthreads();\n"
     "    const long long i0_ = clock64();\n"
     "    if (c == 0) CLK(1);\n"
     "    issue(c + stages - 1);\n"
     "    wsum_ += b0_ - w0_;\n    bsum_ += i0_ - b0_;\n"
     "    isum_ += clock64() - i0_;\n"),
    ("  // ---- 4. merge the CTA's units",
     "  if (threadIdx.x == 0) {\n    CLK_AT(5) = wsum_;\n"
     "    CLK_AT(6) = bsum_;\n    CLK_AT(7) = isum_;\n"
     "    CLK_AT(8) = clock64() - loop0_;\n  }\n"
     "  if (nst == 0) CLK(1);\n  CLK(2);\n"
     "  // ---- 4. merge the CTA's units"),
    ("  if (nranks == 1) {                      // the CTA's state is the output\n",
     "  CLK(3);\n"
     "  if (nranks == 1) {                      // the CTA's state is the output\n"),
    ("        ml[(bh * g + gg) * 2 + 1] = fold.sl[gg];\n      }\n"
     "    return;\n",
     "        ml[(bh * g + gg) * 2 + 1] = fold.sl[gg];\n      }\n"
     "    CLK(4);\n    return;\n"),
    ("                     ml == nullptr ? nullptr : ml + bh * g * 2);\n}",
     "                     ml == nullptr ? nullptr : ml + bh * g * 2);\n"
     "  CLK(4);\n}"),
    ("const char* flash_decode_error_string(int code) {",
     "int flash_decode_phase_clock(unsigned long long* host, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, n * 8));\n"
     "}\n\nconst char* flash_decode_error_string(int code) {")]
PHASES = ["first stage in", "fold", "unit merge", "rank merge"]

# a stage's K and V rows by cp.async.bulk: thread 0 issues one copy of
# each flat range, completing on the stage's mbarrier, which every thread
# waits on before the stage's barrier (the mask words stay on cp.async);
# the mbarriers take 128 bytes of static shared memory, so the dynamic
# window stays 128-byte aligned
_BULK = [
    ("  unsigned char* ring = smem + geo.ring;\n",
     "  unsigned char* ring = smem + geo.ring;\n"
     "  __shared__ __align__(128) unsigned long long bar_[16];\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < geo.stages; ++i)\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\" :: \"r\"("
     "static_cast<unsigned>(__cvta_generic_to_shared(bar_ + i))));\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "  }\n  __syncthreads();\n"),
    ("""        const int n16 = n * row_bytes / 16;
        for (int i = tid; i < n16; i += kThreads) {
          cp_async(st + i * 16, ks + i * 16, 16);
          cp_async(st + geo.kv_bytes + i * 16, vs + i * 16, 16);
        }""",
     """        if (tid == 0) {
          const unsigned bar = static_cast<unsigned>(
              __cvta_generic_to_shared(bar_ + c % stages));
          const unsigned bytes = n * row_bytes;
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                       :: "r"(bar), "r"(2 * bytes) : "memory");
          for (int which = 0; which < 2; ++which) {
            const unsigned dst = static_cast<unsigned>(
                __cvta_generic_to_shared(st + which * geo.kv_bytes));
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                         :: "r"(dst), "l"(which ? vs : ks), "r"(bytes), "r"(bar) : "memory");
          }
        }"""),
    ("    cp_async_wait(stages - 2);\n",
     "    cp_async_wait(stages - 2);\n"
     "    if (geo.flat) {\n"
     "      const unsigned bar = static_cast<unsigned>(\n"
     "          __cvta_generic_to_shared(bar_ + c % stages));\n"
     "      unsigned done = 0;\n"
     "      while (!done)\n"
     "        asm volatile(\"{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }\"\n"
     "                     : \"=r\"(done) : \"r\"(bar), \"r\"((c / stages) & 1) : \"memory\");\n"
     "    }\n")]
_DROP_COPIES = [("    if (c < nst) {\n      const int r0 = c * rows",
                 "    if (c < 0) {\n      const int r0 = c * rows")]
_DROP_FOLD = [("for (int r0 = 0; r0 < n; r0 += geo.uh * kRowsAUnit) {",
               "for (int r0 = 0; r0 < 0; r0 += geo.uh * kRowsAUnit) {")]


def _span(start: str, end: str) -> str:
    """The shipped source's text from ``start`` up to ``end``."""
    src = (REPO / KERNELS / MAIN).read_text()
    i = src.index(start)
    return src[i:src.index(end, i)]


# The fold in three passes a stage instead of units with a softmax each:
# scores (a warp a row, its lanes over 16-byte chunks of the row, q of
# all heads in registers, the heads' sums reduce-scattered over the warp),
# the stage's softmax (a warp a head, its lanes over the rows: the max,
# the rescale factor, p), and p.v (a warp's rows, its lanes over the
# columns, all heads' sums in registers, rescaled once a stage); the warps'
# sums, all against the CTA's one max, add up at the end.  Written for G
# <= 4 and stages of <= 256 rows (the main path and B 1 shapes).
_PHASED_Q = """  // ---- 1. q in registers: a lane's 16-byte chunks of the row, all heads
  constexpr int kPer = Raw<T>::kPer;
  constexpr int kC = sizeof(T) == 4 ? 2 : 1;     // chunks a lane (hd <= 256)
  constexpr int kG = 4;                          // heads (g <= 4)
  const int nchunk = geo.stride / 16;
  __shared__ __align__(128) float ps_[2 * kG * 256 + 32];
  float* ssc = ps_;                      // (g, 256) scores
  float* spp = ps_ + kG * 256;           // (g, 256) p
  float* sal = ps_ + 2 * kG * 256;       // (g) rescale factors
  float qr[kG][kC * kPer], acc[kG][kC * kPer];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int d = (c * 32 + lane) * kPer + e;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        qr[j][c * kPer + e] =
            j < g && d < hd ? q_at(q, q_type, (bh * g + j) * hd + d) : 0.f;
        acc[j][c * kPer + e] = 0.f;
      }
    }
  if (tid < g) {
    fold.sm[tid] = kNegInf;
    fold.sl[tid] = 0.f;
  }

"""
_PHASED_FOLD = """  // ---- 3. fold the stages: scores, the stage's softmax, p.v
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
    for (int r = warp; r < n; r += kWarps) {
      if (!mst[r]) continue;
      float d[kG] = {};
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int at = cc * 32 + lane;
        if (at < nchunk) {
          float x[kPer];
          to_float(*reinterpret_cast<const uint4*>(kst + r * geo.stride +
                                                   at * 16), x, T());
#pragma unroll
          for (int j = 0; j < kG; ++j)
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              d[j] = fmaf(qr[j][cc * kPer + e], x[e], d[j]);
        }
      }
      const bool h16 = lane & 16, h8 = lane & 8;
      float k0 = h16 ? d[2] : d[0], k1 = h16 ? d[3] : d[1];
      k0 += __shfl_xor_sync(paged::kFull, h16 ? d[0] : d[2], 16);
      k1 += __shfl_xor_sync(paged::kFull, h16 ? d[1] : d[3], 16);
      float kk = h8 ? k1 : k0;
      kk += __shfl_xor_sync(paged::kFull, h8 ? k0 : k1, 8);
      kk += __shfl_xor_sync(paged::kFull, kk, 4);
      kk += __shfl_xor_sync(paged::kFull, kk, 2);
      kk += __shfl_xor_sync(paged::kFull, kk, 1);
      const int j = (h16 ? 2 : 0) + (h8 ? 1 : 0);
      if ((lane & 7) == 0 && j < g) ssc[j * 256 + r] = kk * scale;
    }
    __syncthreads();
    for (int j = warp; j < g; j += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32)
        if (mst[r]) mx = fmaxf(mx, ssc[j * 256 + r]);
      mx = paged::warp_max(mx);
      const float m_old = fold.sm[j], m_new = fmaxf(m_old, mx);
      float ps = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = mst[r] ? expf(ssc[j * 256 + r] - m_new) : 0.f;
        spp[j * 256 + r] = p;
        ps += p;
      }
      ps = paged::warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sal[j] = alpha;
        fold.sl[j] = fold.sl[j] * alpha + ps;
        fold.sm[j] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const float a = j < g ? sal[j] : 1.f;
#pragma unroll
      for (int e = 0; e < kC * kPer; ++e) acc[j][e] *= a;
    }
    for (int r = warp; r < n; r += kWarps) {
      if (!mst[r]) continue;
      float p[kG];
#pragma unroll
      for (int j = 0; j < kG; ++j) p[j] = j < g ? spp[j * 256 + r] : 0.f;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int at = cc * 32 + lane;
        if (at < nchunk) {
          float x[kPer];
          to_float(*reinterpret_cast<const uint4*>(vst + r * geo.stride +
                                                   at * 16), x, T());
#pragma unroll
          for (int j = 0; j < kG; ++j)
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              acc[j][cc * kPer + e] =
                  fmaf(p[j], x[e], acc[j][cc * kPer + e]);
        }
      }
    }
  }

  // ---- 4. merge the CTA's units, then the cluster's ranks
  cp_async_wait(0);
  __syncthreads();
  float* sx = reinterpret_cast<float*>(ring);
  constexpr int kW = kC * kPer * 32;    // columns a warp's lanes hold
#pragma unroll
  for (int j = 0; j < kG; ++j)
    if (j < g)
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
#pragma unroll
        for (int e = 0; e < kPer; e += 4)
          *reinterpret_cast<float4*>(
              sx + (warp * kG + j) * kW + (cc * 32 + lane) * kPer + e) =
              make_float4(acc[j][cc * kPer + e], acc[j][cc * kPer + e + 1],
                          acc[j][cc * kPer + e + 2],
                          acc[j][cc * kPer + e + 3]);
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int j = i / hd, dd = i - j * hd;
    float a[4] = {};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a[w & 3] += sx[(w * kG + j) * kW + dd];
    fold.sacc[i] = (a[0] + a[1]) + (a[2] + a[3]);
  }
"""
_PHASED = [
    (_span("  // ---- 1. q and the online softmax in registers",
           "  // ---- 2. the stages' copies"), _PHASED_Q),
    (_span("  // ---- 3. fold the stages",
           "  if (nranks == 1) {"), _PHASED_FOLD)]


_Q_BLOCK = _span("  // ---- 1. q and the online softmax in registers",
                 "  // ---- 2. the stages' copies")
_ISSUE_FIRST = "  for (int c = 0; c < stages - 1; ++c) issue(c);\n"
# the first stages' copies issued before q is loaded
_COPIES_FIRST = [(_Q_BLOCK, ""), (_ISSUE_FIRST, _ISSUE_FIRST + "\n" + _Q_BLOCK)]
# the ranks' shares by 32-bit division where K * C fits
_SHARES_32 = [(
    """  const int k_lo =
      static_cast<int>(static_cast<long long>(kk) * rank / nranks);
  const int k_hi =
      static_cast<int>(static_cast<long long>(kk) * (rank + 1) / nranks);""",
    """  const bool small_ = kk < (1 << 27);
  const int k_lo = small_ ? kk * rank / nranks :
      static_cast<int>(static_cast<long long>(kk) * rank / nranks);
  const int k_hi = small_ ? kk * (rank + 1) / nranks :
      static_cast<int>(static_cast<long long>(kk) * (rank + 1) / nranks);""")]


def _cluster(c):
    # C forced to c in place of the host's choice
    return [("for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap));",
             f"for (int cc = {c}; cc <= {c};")]


VARIANTS = {
    "shipped": [],
    "phase clock": _CLOCK,
    "drop copies": _DROP_COPIES,
    "drop fold": _DROP_FOLD,
    "drop copies and fold": _DROP_COPIES + _DROP_FOLD,
    **{f"C {c}": _cluster(c) for c in range(1, 9)},
    "phase clock, C 8": _CLOCK + _cluster(8),
    "cp.async.bulk": _BULK,
    "shipped, again": [],                 # the spread within one call
    **{f"{n} stages": [("constexpr int kStages = 4;",
                        f"constexpr int kStages = {n};")] for n in (2, 3, 6)},
    **{f"stage {kb} KB": [("constexpr int kStageBytes = 32 * 1024;",
                           f"constexpr int kStageBytes = {kb} * 1024;")]
       for kb in (16, 64)},
    "one row a unit": [("constexpr int kRowsAUnit = 2;",
                        "constexpr int kRowsAUnit = 1;")],
    "one head a unit": [
        ("inline int heads_a_unit(int g) { return g >= 2 ? 2 : 1; }",
         "inline int heads_a_unit(int g) { return 1; }")],
    "copies before q": _COPIES_FIRST,
    "32-bit shares": _SHARES_32,
    "copies before q, 32-bit shares": _COPIES_FIRST + _SHARES_32,
    "phase clock, copies before q": _COPIES_FIRST + _CLOCK,
    "phased fold": _PHASED,
    "phase clock, phased fold": _PHASED + _CLOCK,
    "phase clock, drop copies": _CLOCK + _DROP_COPIES,
    "phase clock, drop fold": _CLOCK + _DROP_FOLD,
    # the fold's parts: no shuffle reduction of the dot products, no p.v
    # (one element; both wrong by design), exponentials by __expf
    "drop shuffles": [
        ("for (int o = lpr >> 1; o > 0; o >>= 1)",
         "for (int o = lpr >> 1; o > 64; o >>= 1)")],
    "drop p.v": [
        ("for (int e = 0; e < kE; ++e) acc[j][e] = fmaf(p, x[e], acc[j][e]);",
         "acc[j][0] = fmaf(p, x[0], acc[j][0]);")],
    "__expf": [("const float alpha = expf(m[j] - s);",
                "const float alpha = __expf(m[j] - s);"),
               ("const float p = expf(s - m[j]);",
                "const float p = __expf(s - m[j]);")],
}


def save_old() -> None:
    dst = OUT / OLD_COMMIT[:7]
    for name in OLD_FILES:
        text = subprocess.run(
            ["git", "show", f"{OLD_COMMIT}:{KERNELS}/{name}"], cwd=REPO,
            check=True, capture_output=True, text=True).stdout
        (dst / name).parent.mkdir(parents=True, exist_ok=True)
        (dst / name).write_text(text)
    print(f"saved {', '.join(OLD_FILES)} of {OLD_COMMIT[:7]} to {dst}")


def old_ops():
    """The old design's ops module (Triton), loaded from the saved
    sources under its own package path so its imports resolve."""
    src = OUT / OLD_COMMIT[:7]
    if not (src / OLD_FILES[1]).exists():
        raise SystemExit(f"{src / OLD_FILES[1]} missing: run with "
                         "--save-old in a git checkout first")
    mods = {}
    for name, mod in (("flash_decode/flash_decode.py",
                       "repro_torch.kernels.flash_decode.flash_decode"),
                      ("flash_decode/ops.py", "old_flash_decode_ops")):
        spec = importlib.util.spec_from_file_location(mod, src / name)
        mods[mod] = importlib.util.module_from_spec(spec)
        sys.modules[mod] = mods[mod]
        spec.loader.exec_module(mods[mod])
    return mods["old_flash_decode_ops"]


def build_all(only) -> list:
    """(name, library, ptxas summary) of every chosen variant, built in
    parallel, each in a directory of its own (the kernel directories'
    layout, so the source's relative include holds)."""
    design = {name: (REPO / KERNELS / name).read_text()
              for name in (MAIN, *HEADERS)}
    items = [(n, s) for n, s in VARIANTS.items() if not only or n in only]

    def one(k_item):
        k, (name, subs) = k_item
        files = substitute(name, design, subs)
        d = OUT / f"v{k}"
        for f, text in files.items():
            (d / f).parent.mkdir(parents=True, exist_ok=True)
            (d / f).write_text(text)
        return (name, *_nvcc(d / MAIN))

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, enumerate(items)))


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p, i, p, p, p, p, p] + [i] * 5 + \
        [ctypes.c_float, p]
    lib.flash_decode_plan.argtypes = [i] * 5 + [p]
    lib.flash_decode_error_string.argtypes = [i]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def runner(lib, scale: float):
    """fn(q, k, v, mask) -> out launching ``lib`` (f32 inputs)."""
    def run(q, k, v, mask):
        bh, g, hd = q.shape
        out = torch.empty((bh, g, hd), device=q.device)
        err = lib.flash_decode_launch(
            q.data_ptr(), 0, k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), None, 0, bh, k.shape[1], g, hd,
            ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.flash_decode_error_string(err).decode())
        return out
    return run


def plan_info(lib, q, k) -> list:
    """(C, shared bytes a CTA, clusters at once, stages, rows a stage,
    lanes a row, heads a unit, units a head group) of a launch."""
    info = (ctypes.c_int * 8)()
    bh, g, hd = q.shape
    err = lib.flash_decode_plan(0, bh, k.shape[1], g, hd, info)
    if err:
        raise RuntimeError(f"plan error {err}")
    return list(info)


def phase_clock(lib, run, inputs, c) -> dict:
    """Device microseconds a CTA from its clock stamps (``_CLOCK``): mean
    and max over CTAs of each phase, the CTAs' start spread and the
    launch's span."""
    import numpy as np
    run(*inputs)
    torch.cuda.synchronize()
    n = c * inputs[0].shape[0]
    buf = (ctypes.c_ulonglong * (n * 9))()
    lib.flash_decode_phase_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.flash_decode_phase_clock(buf, n * 9):
        raise RuntimeError("reading the phase clock failed")
    full = np.array(buf, dtype=np.float64).reshape(n, 9)
    t = (full[:, :5] - full[:, :1].min()) / 1e3
    d = np.diff(t, axis=1)
    loop = np.maximum(full[:, 8], 1)
    return dict(span_us=float(t[:, 4].max()),
                loop_clocks=float(full[:, 8].mean()),
                copy_wait_share=float((full[:, 5] / loop).mean()),
                barrier_share=float((full[:, 6] / loop).mean()),
                issue_share=float((full[:, 7] / loop).mean()),
                start_us=[float(np.quantile(t[:, 0], x))
                          for x in (0, .5, 1)],
                mean_us={k: float(d[:, i].mean())
                         for i, k in enumerate(PHASES)},
                max_us={k: float(d[:, i].max())
                        for i, k in enumerate(PHASES)})


def host_us(fn, sets, calls=200) -> float:
    """Host microseconds a call of ``fn`` (``calls`` calls, no
    synchronize between them)."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*sets[i % len(sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def measure(results: dict, built: list, with_old: bool) -> None:
    from chip_smoke import ATTN_TOL, check_close, device_time_ms, rotations
    from repro_torch.kernels.flash_decode import cases, ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(23)
    shapes = {}
    for label in SHAPES:
        kw = dict(cases.CARD_CASES)[label]
        nbytes = 2 * kw["bh"] * kw["k"] * kw["hd"] * 4
        shapes[label] = (kw, cases.card_case(gen, **kw),
                         [cases.card_case(gen, **kw)
                          for _ in range(rotations(nbytes))])
    impls = [(name, bind(lib), ptxas) for name, lib, ptxas in built]
    if with_old:
        impls.append(("old", old_ops(), "Triton"))
    for name, impl, ptxas in impls:
        for label, (kw, check, sets) in shapes.items():
            if label != "main path" and not (
                    name.startswith(("shipped", "C ", "phase clock")) or
                    name == "old"):
                continue
            scale = 1.0 / math.sqrt(kw["hd"])
            run = (lambda q, k, v, m, _o=impl: _o.launch_flash_decode(
                q, k, v, m, scale=scale)) if name == "old" else \
                runner(impl, scale)
            key = f"{name} [{label}]"
            err = float("nan")
            try:
                if "drop" not in name:
                    out = run(*check)
                    torch.cuda.synchronize()
                    err = check_close(key, out,
                                      flash_decode_ref(*check, scale=scale),
                                      ATTN_TOL)
                ms = device_time_ms(run, sets)
            except (RuntimeError, AssertionError) as e:    # refused, wrong
                results[key] = dict(error=str(e))
                print(f"{key}: {e}", flush=True)
                continue
            info = None if name == "old" else plan_info(impl, *check[:2])
            results[key] = dict(ms=ms, max_abs_err=err, ptxas=ptxas,
                                plan=info)
            if name in ("shipped", "old"):
                wrapper = ops.launch_flash_decode if name == "shipped" \
                    else impl.launch_flash_decode
                results[key]["host_us"] = host_us(
                    lambda q, k, v, m: wrapper(q, k, v, m, scale=scale), sets)
            print(f"{key}: {ms:.4f} ms, max|err| {err:.3e}; plan (C, smem, "
                  f"clusters at once, stages, rows, lanes, heads, units) "
                  f"{info}; {ptxas}"
                  + (f"; host {results[key]['host_us']:.1f} us a call"
                     if "host_us" in results[key] else ""), flush=True)
            if "phase clock" in name:
                clk = phase_clock(impl, run, sets[0], info[0])
                results[key]["phase_clock"] = clk
                print(f"  phase clock: {json.dumps(clk)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to build (default: all, and old)")
    ap.add_argument("--save-old", action="store_true",
                    help=f"copy the sources of {OLD_COMMIT[:7]} into "
                         "build/ (needs git) and exit")
    args = ap.parse_args()
    if args.save_old:
        save_old()
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    built = build_all(args.only)
    results = {}
    for name, lib_path, _ in built:
        if name == "shipped":             # the shipped SASS, for reading
            from repro_torch.kernels import build
            tool = Path(build.nvcc_path()).with_name("cuobjdump")
            sass = REPO / "chiprun_out" / "flash_decode_shipped.sass"
            sass.parent.mkdir(exist_ok=True)
            sass.write_text(subprocess.run(
                [str(tool), "-sass", str(lib_path)], capture_output=True,
                text=True).stdout)
    measure(results, built, not args.only or "old" in args.only)
    line = json.dumps(dict(card=card, results=results))
    dump = REPO / "chiprun_out" / "flash_decode_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line + "\n")
    print(f"results: {dump.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
