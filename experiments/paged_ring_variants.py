#!/usr/bin/env python3
"""Per-pass split and design alternatives of the port's sliding-window
(ring) paged decode kernel, timed on one card.

    python3 experiments/paged_ring_variants.py --save-old   # in a git checkout
    python3 experiments/paged_ring_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Each variant is the
source of ``src/repro_torch/kernels/paged_attention/paged_ring.cu`` (and
the headers beside it) with a few text substitutions (``VARIANTS``),
built with the port's nvcc flags, checked against the plain version
(``cases.check_ring``, NaN in the dead slots) and timed as
``chip_smoke.py`` times the kernel (CUDA-graph replay, inputs rotated
past the L2 cache) at the gemma3 continuous path's shape (8 requests,
KVH 16, G 2, hd 128, 16-token pages, 64 ring blocks, window 1024, every
ring wrapped: ``cases.RING_CASES[0]``) and at its B 2 case.

``old`` is the design before the redesign (one block of 512 threads per
(request, head) walking every ring slot in tiles of 512, a block-wide
scan compacting the live ones, ``paged_common.cuh``'s ``fold_rows``
reading K/V from device memory), read from commit ``OLD_COMMIT``:
``--save-old`` copies its sources into ``build/`` for a machine without
git.  Variants named ``drop ...`` leave a pass out to show what it
costs; their outputs are wrong by design and only timed: ``drop
staging`` copies no K/V row (the fold reads whatever the ring holds),
``drop fold`` folds nothing (the copies still land), ``drop merge``
merges neither the units nor the ranks.  ``phase clock`` stamps
``%globaltimer`` at the pass boundaries of every CTA and counts the
SM clocks its thread 0 spends waiting for stages and issuing copies.
``drop staging and fold`` drops both, leaving the launch's fixed cost.
``C n`` forces the cluster size n in place of the host's choice; ``cp.async.bulk`` copies each page's run of K and of V
rows with one bulk copy (issued by warp 0's lanes, completing on the
stage's ``mbarrier``) in place of the shipped 16-byte ``cp.async``
copies; ``stages``/``stage`` variants change the ring's stage count and
the stage's byte budget.

Prints one line a measurement and writes a JSON object of them all
to ``chiprun_out/paged_ring_variants.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "experiments"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import paged_socket_variants as psv  # noqa: E402

OUT = REPO / "build" / "paged_ring_variants"
OLD_COMMIT = "f5a062824da2d07f8745c13f6f4dd9d0f78f39e4"
SOURCES = ("paged_ring.cu", "paged_common.cuh")          # the old design's
SHAPES = ("main path", "B 2")                  # labels of cases.RING_CASES

# thread 0 of every CTA stamps %globaltimer: 0 entry, 1 first stages
# issued and q loaded, 2 stages folded, 3 units merged, 4 ranks merged;
# 5 the SM clocks spent in the stage waits, 6 (globaltimer) the first
# stage in, 7 the SM clocks of the fold loop, 8 those spent issuing
# copies in it
_CLOCK = [
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_clk[1 << 16];\n"
     "#define CLK_AT(k) g_clk[((blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x) * 10 + (k)]\n"
     "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "CLK_AT(k) = t_; }\n\nnamespace {\n"),
    ("  const int cap = rb * bs;\n  const int pos = poss[b];",
     "  CLK(0);\n  const int cap = rb * bs;\n  const int pos = poss[b];"),
    ("  // ---- 3. fold the stages",
     "  CLK(1);\n  long long wsum_ = 0, isum_ = 0;\n"
     "  const long long loop0_ = clock64();\n"
     "  // ---- 3. fold the stages"),
    ("    cp_async_wait(stages - 2);\n",
     "    const long long w0_ = clock64();\n    cp_async_wait(stages - 2);\n"),
    ("    __syncthreads();                      // stage c in; stage c - 1 read\n",
     "    __syncthreads();\n"
     "    wsum_ += clock64() - w0_;\n    if (c == 0) CLK(6);\n"),
    ("    issue(c + stages - 1);\n",
     "    const long long i0_ = clock64();\n    issue(c + stages - 1);\n"
     "    isum_ += clock64() - i0_;\n"),
    ("  // ---- 4. merge the CTA's units",
     "  if (threadIdx.x == 0) {\n    CLK_AT(5) = wsum_;\n"
     "    CLK_AT(7) = clock64() - loop0_;\n    CLK_AT(8) = isum_;\n  }\n"
     "  CLK(2);\n"
     "  // ---- 4. merge the CTA's units"),
    ("  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd);\n}",
     "  CLK(3);\n"
     "  paged::merge_ranks(cluster, rank, nranks, fold, g, hd, out + bh * g * hd);\n"
     "  CLK(4);\n}"),
    ("const char* paged_ring_attend_error_string(int code) {",
     "int paged_phase_clock(unsigned long long* host, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, n * 8));\n"
     "}\n\nconst char* paged_ring_attend_error_string(int code) {")]
PHASES = ["prologue", "stages", "unit merge", "rank merge"]


def _cluster(c):
    # C forced to c in place of the host's choice
    return [("for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap));",
             f"for (int cc = {c}; cc <= {c};")]


_LAZY = '''          if (s > m[j]) {                 // a new max: rescale the sums
            const float alpha = expf(m[j] - s);
            l[j] *= alpha;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[j][e] *= alpha;
            m[j] = s;
          }
          const float p = expf(s - m[j]), pv = p * vs;
          l[j] += p;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[j][e] = fmaf(pv, x[e], acc[j][e]);'''
_EAGER = '''          const float mn = fmaxf(m[j], s);
          const float alpha = expf(m[j] - mn), p = expf(s - mn);
          l[j] = l[j] * alpha + p;
          m[j] = mn;
          const float pv = p * vs;
#pragma unroll
          for (int e = 0; e < kE; ++e)
            acc[j][e] = fmaf(pv, x[e], acc[j][e] * alpha);'''

# K and V by cp.async.bulk: the lanes of warp 0 issue one copy of a
# page's run of K rows and one of V rows each (rows contiguous in both
# memories: hd_pad == hd), completing on the stage's mbarrier, which every
# thread waits on before the stage's barrier (scales stay on cp.async);
# the mbarriers take 128 bytes of static shared memory, so the dynamic
# window stays 128-byte aligned
_BULK = [
    ("  unsigned char* ring = smem + geo.ring;\n",
     "  unsigned char* ring = smem + geo.ring;\n"
     "  __shared__ __align__(128) unsigned long long bar_[16];\n"
     "  if (tid == 0) {\n"
     "    for (int i = 0; i < geo.stages; ++i)\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\" :: \"r\"("
     "static_cast<unsigned>(__cvta_generic_to_shared(bar_ + i))));\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "  }\n"),
    ("      if (geo.vec == 16 && kThreads % pieces == 0) {",
     "      if (tid < 32) {\n"
     "        const unsigned bar = static_cast<unsigned>(\n"
     "            __cvta_generic_to_shared(bar_ + c % stages));\n"
     "        if (tid == 0)\n"
     "          asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\"\n"
     "                       :: \"r\"(bar), \"r\"(2 * (r_hi - r_lo) * row_bytes) : \"memory\");\n"
     "        __syncwarp();\n"
     "        const int npg_st = div_bs(o0 + r_hi - 1) + 1;\n"
     "        for (int k = tid; k < npg_st; k += 32) {\n"
     "          const int ra = max(r_lo, k * bs - o0), rz = min(r_hi, (k + 1) * bs - o0);\n"
     "          if (ra >= rz) continue;\n"
     "          const size_t row = pool_row(ra);\n"
     "          for (int which = 0; which < 2; ++which) {\n"
     "            const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(\n"
     "                st + which * geo.kv_bytes + ra * stride));\n"
     "            const unsigned char* src = (which ? vbytes : kbytes) + row * row_bytes;\n"
     "            asm volatile(\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\"\n"
     "                         :: \"r\"(dst), \"l\"(src), \"r\"((rz - ra) * row_bytes), \"r\"(bar) : \"memory\");\n"
     "          }\n"
     "        }\n"
     "      }\n"
     "      if (false) {"),
    ("        for (int i = tid; i < 2 * per_kv; i += kThreads) {",
     "        for (int i = tid; i < 0; i += kThreads) {"),
    ("    cp_async_wait(stages - 2);\n",
     "    cp_async_wait(stages - 2);\n"
     "    {\n"
     "      const unsigned bar = static_cast<unsigned>(\n"
     "          __cvta_generic_to_shared(bar_ + c % stages));\n"
     "      unsigned done = 0;\n"
     "      while (!done)\n"
     "        asm volatile(\"{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }\"\n"
     "                     : \"=r\"(done) : \"r\"(bar), \"r\"((c / stages) & 1) : \"memory\");\n"
     "    }\n")]
_DROP_STAGING = [("    if (c < nst) {\n      int r_lo, r_hi;",
                  "    if (c < 0) {\n      int r_lo, r_hi;")]
_DROP_FOLD = [("for (int r0 = r_lo; r0 < r_hi; r0 += geo.uh * kRowsAUnit) {",
               "for (int r0 = r_lo; r0 < r_lo; r0 += geo.uh * kRowsAUnit) {")]

VARIANTS = {
    "shipped": [],
    "phase clock": _CLOCK,
    "drop staging": _DROP_STAGING,
    "drop fold": _DROP_FOLD,
    "drop staging and fold": _DROP_STAGING + _DROP_FOLD,
    "drop merge": [
        ("for (int gg = warp; gg < g; gg += kWarps) {",
         "for (int gg = warp; gg < 0; gg += kWarps) {"),
        ("for (int i = tid; i < g * hd; i += kThreads) {\n"
         "    const int gg = i / hd, d = i - gg * hd, hq",
         "for (int i = tid; i < 0; i += kThreads) {\n"
         "    const int gg = i / hd, d = i - gg * hd, hq"),
        ("for (int i = rank * share + threadIdx.x; i < e1;",
         "for (int i = rank * share + threadIdx.x; i < 0;")],
    **{f"C {c}": _cluster(c) for c in range(1, 9)},
    "phase clock, C 2": _CLOCK + _cluster(2),
    "cp.async.bulk": _BULK,
    "drop fold, cp.async.bulk": _BULK + _DROP_FOLD,
    "eager rescale": [(_LAZY, _EAGER)],
    "__expf": [("const float alpha = expf(m[j] - s);",
                "const float alpha = __expf(m[j] - s);"),
               ("const float p = expf(s - m[j]), pv = p * vs;",
                "const float p = __expf(s - m[j]), pv = p * vs;")],
    "one FMA chain": [("            s1 = fmaf(qr[j][e + 1], x[e + 1], s1);",
                       "            s0 = fmaf(qr[j][e + 1], x[e + 1], s0);")],
    "one row a unit": [("constexpr int kRowsAUnit = 2;",
                        "constexpr int kRowsAUnit = 1;")],
    "8 elements a lane": [
        ("  return sizeof(T) == 4 ? 8 : 16;", "  return sizeof(T) == 1 ? 16 : 8;")],
    "shipped, again": [],                 # the spread within one call
    "one head a unit": [("inline int heads_a_unit(int g) { return g >= 2 ? 2 : 1; }",
                         "inline int heads_a_unit(int g) { return 1; }")],
    **{f"{n} stages": [("constexpr int kStages = 3;",
                        f"constexpr int kStages = {n};")] for n in (2, 4, 6)},
    **{f"stage {kb} KB": [("constexpr int kStageBytes = 32 * 1024;",
                           f"constexpr int kStageBytes = {kb} * 1024;")]
       for kb in (16, 64)},
}

# the variants timed on int8 and fp8 pages too
ALL_DTYPES = ("shipped", "shipped, again", "old", "cp.async.bulk",
              "drop fold, cp.async.bulk", "drop staging and fold",
              "eager rescale",
              "__expf", "one head a unit", "stage 16 KB", "stage 64 KB",
              "2 stages", "4 stages", "6 stages", "drop staging",
              "drop fold", "phase clock", "one row a unit",
              "8 elements a lane")

OLD_VARIANTS = {"old": []}


def save_old() -> None:
    psv.save_sources(OLD_COMMIT, SOURCES, OUT / OLD_COMMIT[:7])


def build_all(only) -> list:
    """(name, old?, library, ptxas summary) of every chosen variant."""
    items = [(n, False, s) for n, s in VARIANTS.items()] + \
        [(n, True, s) for n, s in OLD_VARIANTS.items()]
    items = [it for it in items if not only or it[0] in only]
    designs = {False: psv.design(SOURCES[0])}
    if any(old for _, old, _ in items):
        designs[True] = psv.design(SOURCES[0], OUT / OLD_COMMIT[:7])
    return psv.build_variants(items, designs, OUT)


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_ring_attend_launch.argtypes = [P] * 8 + [I] * 7 + [F, I, F, P]
    lib.paged_ring_attend_error_string.restype = ctypes.c_char_p
    return lib


def runner(lib, kw: dict):
    """fn(q, kp, vp, ks, vs, bt, pos) -> out launching ``lib``;
    ``prepare(set, scales)`` builds its arguments."""
    from repro_torch.kernels.paged_attention.ops import KV_TYPES

    def prepare(case, scales):
        q, kp, vp, bt, pos = case
        return (q, kp, vp, scales.get("k_scale"), scales.get("v_scale"), bt,
                pos)

    def run(q, kp, vp, ks, vs, bt, pos):
        b, kvh, g, hd = q.shape
        out = torch.empty_like(q)
        ptrs = [t.data_ptr() if t is not None else None for t in
                (q, kp, vp, ks, vs, bt, pos, out)]
        err = lib.paged_ring_attend_launch(
            *ptrs, KV_TYPES[kp.dtype], b, kvh, g, hd, kp.shape[2],
            bt.shape[1], ctypes.c_float(kw["scale"]), kw["window"],
            ctypes.c_float(kw["softcap"]),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.paged_ring_attend_error_string(err)
                               .decode())
        return out

    return prepare, run


def plan_info(lib, case, kw) -> list:
    """(C, shared bytes a CTA, clusters the card holds at once, stages,
    rows a stage, lanes a row, heads a unit, elements a staged row) of a
    launch on ``case``."""
    from repro_torch.kernels.paged_attention.ops import KV_TYPES
    q, kp, bt = case[0], case[1], case[3]
    b, kvh, g, hd = q.shape
    info = (ctypes.c_int * 8)()
    lib.paged_ring_attend_plan.argtypes = [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    err = lib.paged_ring_attend_plan(KV_TYPES[kp.dtype], b, kvh, g, hd,
                                     kp.shape[2], bt.shape[1], kw["window"],
                                     info)
    if err:
        raise RuntimeError(f"plan error {err}")
    return list(info)


def phase_clock(lib, run, prepared, c, b, kvh) -> dict:
    """Per-phase device microseconds of one launch from its CTAs' clock
    stamps (``_CLOCK``): mean and max over CTAs; the first stage's arrival
    from entry; the shares of the fold loop's SM clocks spent waiting for
    stages and issuing copies."""
    import numpy as np
    run(*prepared)
    torch.cuda.synchronize()
    n = c * kvh * b
    buf = (ctypes.c_ulonglong * (n * 10))()
    lib.paged_phase_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.paged_phase_clock(buf, n * 10):
        raise RuntimeError("reading the phase clock failed")
    full = np.array(buf, dtype=np.float64).reshape(n, 10)
    t = full[:, :5] - full[:, :1].min()
    d = np.diff(t, axis=1) / 1e3
    return dict(
        span_us=float(t[:, 4].max() / 1e3),
        start_us=[float(np.quantile(t[:, 0], x) / 1e3)
                  for x in (0, .5, .9, 1)],
        mean_us={k: float(d[:, i].mean()) for i, k in enumerate(PHASES)},
        max_us={k: float(d[:, i].max()) for i, k in enumerate(PHASES)},
        first_stage_in_us=float(((full[:, 6] - full[:, 0]) / 1e3).mean()),
        wait_share=float((full[:, 5] / np.maximum(full[:, 7], 1)).mean()),
        issue_share=float((full[:, 8] / np.maximum(full[:, 7], 1)).mean()))


def measure(results: dict, built: list) -> None:
    from chip_smoke import (ATTN_TOL, device_time_ms, kv_row_bytes,
                            rotations)
    from repro_torch.kernels.paged_attention import cases
    dev = torch.device("cuda", 0)
    shapes = {}
    for label in SHAPES:
        kw = next(k for lab, k in cases.RING_CASES if lab.startswith(label))
        gen = torch.Generator(device=dev).manual_seed(17)
        (case,), akw = cases.ring_case(gen, **kw)
        per = {"f32": ((case, {}), None)}
        nbytes = kv_row_bytes(case, {}) * 1024 * case[0].shape[0] * \
            case[0].shape[1]
        sets, _ = cases.ring_case(gen, copies=rotations(nbytes), **kw)
        per["f32"] = ((case, {}), (sets, {}))
        for dt in ("int8", "fp8"):
            (c8,), s8 = cases.store_kv([case], dt)
            per[dt] = ((c8, s8), cases.store_kv(sets, dt))
        shapes[label] = (akw, per)
    for name, old, lib_path, ptxas in built:
        lib = bind(lib_path)
        for label, (akw, per) in shapes.items():
            prepare, run = runner(lib, akw)
            dts = ("f32", "int8", "fp8") if name in ALL_DTYPES else ("f32",)
            for dt in dts:
                (check, cscales), (tsets, tscales) = per[dt]
                err = float("nan")
                key = f"{name} [{label}, {dt}]"
                try:
                    if "drop" not in name:
                        out = run(*prepare(check, cscales))
                        torch.cuda.synchronize()
                        err = cases.check_ring(out, check, akw,
                                               attn_tol=ATTN_TOL,
                                               scales=cscales)
                    prepared = [prepare(st, tscales) for st in tsets]
                    ms = device_time_ms(run, prepared)
                except (RuntimeError, AssertionError) as e:   # refused, wrong
                    results[key] = dict(error=str(e))
                    print(f"{key}: {e}", flush=True)
                    continue
                info = plan_info(lib, tsets[0], akw) if not old else [1]
                results[key] = dict(ms=ms, max_abs_err=err, ptxas=ptxas,
                                    plan=info)
                print(f"{key}: {ms:.4f} ms, max|err| {err:.3e}; plan (C, "
                      f"smem, clusters at once, stages, rows, lanes, heads, row) "
                      f"{info}; {ptxas}", flush=True)
                if "phase clock" in name:
                    q = tsets[0][0]
                    clk = phase_clock(lib, run, prepared[0], info[0],
                                      *q.shape[:2])
                    results[key]["phase_clock"] = clk
                    print(f"  phase clock: {json.dumps(clk)}", flush=True)
                del prepared


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to build (default: all)")
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
    OUT.mkdir(parents=True, exist_ok=True)
    built = build_all(args.only)
    results = {}
    for name, old, lib_path, _ in built:
        if name in ("shipped", "old"):
            results[f"local memory (LDL, STL) of {name}"] = \
                psv.local_memory(lib_path)
        if name == "shipped":
            from repro_torch.kernels import build
            tool = Path(build.nvcc_path()).with_name("cuobjdump")
            sass = REPO / "chiprun_out" / "paged_ring_shipped.sass"
            sass.parent.mkdir(exist_ok=True)
            sass.write_text(subprocess.run(
                [str(tool), "-sass", str(lib_path)], capture_output=True,
                text=True).stdout)
            print(f"local memory (LDL, STL) of {name}:",
                  results[f"local memory (LDL, STL) of {name}"], flush=True)
    measure(results, built)
    line = json.dumps(dict(card=card, results=results))
    dump = REPO / "chiprun_out" / "paged_ring_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line + "\n")
    print(f"results: {dump.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
