#!/usr/bin/env python3
"""Per-pass split and design alternatives of the port's fused paged Quest
kernel, timed on one card.

    python3 experiments/paged_quest_variants.py --save-old   # in a git checkout
    python3 experiments/paged_quest_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Each variant is the
source of ``src/repro_torch/kernels/paged_attention/paged_quest.cu`` (and
the headers beside it) with a few text substitutions (``VARIANTS``),
built with the port's nvcc flags, checked against the plain version
(``cases.check_quest``: the selection bit for bit) and timed as
``chip_smoke.py`` times the kernel (CUDA-graph replay, inputs rotated past
the L2 cache) at the continuous path's shape: 8 requests of 1-4K tokens,
KVH 8, G 4, hd 128, 16-token pages, a 264-block table, a page budget of
26.

``old`` variants are the design before the redesign (one block of 512
threads per (request, head), a warp a page reading its bounds from
device memory, 32 one-bit radix passes, the attend pass's tiles of 512
tokens folded by ``paged_common.cuh``'s ``fold_rows``), read from commit
``OLD_COMMIT``: ``--save-old`` copies its sources into ``build/`` for a
machine without git.  Variants named ``drop ...`` leave a pass out to
show what it costs; their outputs are wrong by design and only timed.
``drop select`` selects the forced pages alone (17 or 18 of the 26 a
request, so its attend pass folds about two thirds of the rows); the
old design's ``drop score`` forces every live page (the select then
takes the first 26 in page order, as many rows as the real one).
``phase clock`` variants stamp ``%globaltimer`` at the pass boundaries of
every CTA.  ``C n`` forces the cluster size n in place of the host's
choice.

Prints one line a measurement and writes a JSON object of them all
to ``chiprun_out/paged_quest_variants.json``.
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

OUT = REPO / "build" / "paged_quest_variants"
OLD_COMMIT = "2dfd6cff3cef1fed0ff2b6b9902da72ecdae3fab"
SOURCES = ("paged_quest.cu", "paged_common.cuh")          # the old design's
MAIN = dict(lengths=psv.MAIN_LENS, nb=264)

# thread 0 of every CTA stamps %globaltimer: 0 entry, 1 bounds issued and q
# staged, 2 scored, 3 selected, 4 attended, 5 merged; from entry, 6 first
# bounds issued, 7 first chunk of bounds in, 8 q staged, 9 lists written
_CLOCK_MACRO = (
    "namespace cg = cooperative_groups;\n\nnamespace {\n",
    "namespace cg = cooperative_groups;\n"
    "__device__ unsigned long long g_clk[1 << 16];\n"
    "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
    "g_clk[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
    "blockIdx.x) * 10 + (k)] = t_; }\n\nnamespace {\n")
_CLOCK_READ = (
    "const char* paged_quest_attend_error_string(int code) {",
    "int paged_phase_clock(unsigned long long* host, int n) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, n * 8));\n"
    "}\n\nconst char* paged_quest_attend_error_string(int code) {")
_CLOCK = [
    _CLOCK_MACRO,
    ("  const int warp = tid >> 5, lane = tid & 31;\n  const int ppb",
     "  const int warp = tid >> 5, lane = tid & 31;\n  CLK(0);\n"
     "  const int ppb"),
    ("  paged::init_fold(fold, q", "  CLK(6);\n  paged::init_fold(fold, q"),
    ("  paged::init_fold(fold, q + bh * g * hd, g, hd);\n",
     "  paged::init_fold(fold, q + bh * g * hd, g, hd);\n  CLK(8);\n"),
    ("  // ---- 1. page upper bounds",
     "  __syncthreads();\n  CLK(1);\n  CLK(7);\n"
     "  // ---- 1. page upper bounds"),
    ("    __syncthreads();                      // chunk c's bounds (and q) in\n",
     "    __syncthreads();                      // chunk c's bounds (and q) in\n"
     "    if (c == 0) CLK(7);\n"),
    ("  // ---- 2. select", "  __syncthreads();\n  CLK(2);\n  // ---- 2. select"),
    ("  // ---- 3. attend", "  CLK(3);\n  // ---- 3. attend"),
    ("  int* sbase = smisc + 4;", "  CLK(9);\n  int* sbase = smisc + 4;"),
    ("  // ---- 4. merge", "  CLK(4);\n  // ---- 4. merge"),
    ("fold, g, hd, out + bh * g * hd);\n}",
     "fold, g, hd, out + bh * g * hd);\n  CLK(5);\n}"),
    _CLOCK_READ]
PHASES = ["issue+q", "score", "select", "list+attend", "merge"]
STEPS = ["bounds issued", "first bounds in", "q staged", "lists written"]

# the old design: 0 entry, 1 q staged, 2 scored, 3 selected, 4 attended, 5
# stored
_OLD_CLOCK = [
    ("#include \"paged_common.cuh\"\n\nnamespace {\n",
     "#include \"paged_common.cuh\"\n"
     "__device__ unsigned long long g_clk[1 << 16];\n"
     "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "g_clk[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
     "blockIdx.x) * 10 + (k)] = t_; }\n\nnamespace {\n"),
    ("  const int warp = tid >> 5, lane = tid & 31;\n  const int ppb",
     "  const int warp = tid >> 5, lane = tid & 31;\n  CLK(0);\n"
     "  const int ppb"),
    ("  // ---- 1. page upper bounds", "  CLK(1);\n  // ---- 1. page upper bounds"),
    ("  // ---- 2. radix-select", "  CLK(2);\n  // ---- 2. radix-select"),
    ("  // ---- 3a. mark", "  __syncthreads();\n  CLK(3);\n  // ---- 3a. mark"),
    ("  paged::softmax_store(sm_state", "  CLK(4);\n  paged::softmax_store(sm_state"),
    ("      sel_out[bh * n_total + t] = 0;\n}",
     "      sel_out[bh * n_total + t] = 0;\n  CLK(5);\n}"),
    _CLOCK_READ]
OLD_PHASES = ["q", "score", "select", "mark+attend", "store"]
OLD_STEPS = []


def _cluster(c):
    # C forced to c in place of the host's choice
    return [("for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap));",
             f"for (int cc = {c}; cc <= {c};")]


# free pages scored 1 without reading their bounds
_UNSCORED = [("    if (pg < f0 || pg >= f1) eff[pg] = FLT_MAX;",
              "    eff[pg] = pg < f0 || pg >= f1 ? FLT_MAX : 1.f;")]

VARIANTS = {
    "shipped": [],
    "phase clock": _CLOCK,
    "drop score": _UNSCORED + [
        ("const int chunks = (f1 - f0 + kStatPages - 1) / kStatPages;",
         "const int chunks = 0;")],
    "drop score arithmetic": _UNSCORED + [
        ("    for (int r = warp; r < n; r += kWarps) {\n      double acc",
         "    for (int r = warp; r < 0; r += kWarps) {\n      double acc")],
    "drop select": [
        ("for (int round = 3; round >= 0; --round) {",
         "for (int round = 3; round >= 4; --round) {"),
        ("  return Threshold{prefix, budget - above, eq_before};",
         "  return Threshold{sort_key(FLT_MAX), 1 << 30, 0};")],
    "drop attend": [("for (int k0 = k_lo; k0 < k_hi; k0 += kThreads) {",
                     "for (int k0 = k_lo; k0 < k_lo; k0 += kThreads) {")],
    "drop merge": [("for (int i = rank * share + threadIdx.x; i < e1;",
                    "for (int i = rank * share + threadIdx.x; i < 0;")],
    **{f"C {c}": _cluster(c) for c in (1, 2, 3, 4, 6, 8)},
    "phase clock, C 8": _CLOCK + _cluster(8),
    "32-row chunks": [
        ("  pl->rows = std::min(2 * paged::kChunkRows,",
         "  pl->rows = std::min(paged::kChunkRows,")],
    "8 pages a chunk of bounds": [("constexpr int kStatPages = 16;",
                                   "constexpr int kStatPages = 8;")],
    "32 pages a chunk of bounds": [("constexpr int kStatPages = 16;",
                                    "constexpr int kStatPages = 32;")],
}

# the variants timed on int8 and fp8 pages too
ALL_DTYPES = ("shipped", "old", "32-row chunks")

OLD_VARIANTS = {
    "old": [],
    "old, phase clock": _OLD_CLOCK,
    "old, drop score": [
        ("    if (start < sink || start >= length - window - ps) {",
         "    if (true) {")],
    "old, drop select": [
        ("for (int s = 31; s >= 0; --s) {", "for (int s = 31; s >= 32; --s) {"),
        ("const uint32_t thr = prefix;",
         "const uint32_t thr = paged::sort_key(FLT_MAX);"),
        ("""  const int ties_needed =
      budget - (paged::block_sum(gt, red) + (k_inv > thr ? n_inv : 0));""",
         "  const int ties_needed = 1 << 30;")],
    "old, drop attend": [("    if (cnt == 0) continue;", "    continue;")],
}


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
    lib.paged_quest_attend_launch.argtypes = \
        [P] * 13 + [I] * 8 + [F] + [I] * 2 + [P]
    lib.paged_quest_attend_error_string.restype = ctypes.c_char_p
    return lib


def runner(lib, kw: dict):
    """fn(q, kp, vp, ks, vs, kmin, kmax, bt, length, budget) -> (out, sel)
    launching ``lib``; ``prepare(set, scales)`` builds its arguments."""
    from repro_torch.kernels.paged_attention.ops import KV_TYPES
    ps = kw["page_size"]

    def prepare(case, scales):
        q, kp, vp, kmin, kmax, bt, length, budget = case
        return (q, kp, vp, scales.get("k_scale"), scales.get("v_scale"),
                kmin, kmax, bt, length.int(), budget.int())

    def run(q, kp, vp, ks, vs, kmin, kmax, bt, length, budget):
        b, kvh, g, hd = q.shape
        nb, bs = bt.shape[1], kp.shape[2]
        out = torch.empty_like(q)
        sel = torch.empty((b, kvh, nb, bs), dtype=torch.int32,
                          device=q.device)
        eff = torch.empty((b, kvh, nb * bs // ps), device=q.device)
        ptrs = [t.data_ptr() if t is not None else None for t in
                (q, kp, vp, ks, vs, kmin, kmax, bt, length, budget, out, sel,
                 eff)]
        err = lib.paged_quest_attend_launch(
            *ptrs, KV_TYPES[kp.dtype], b, kvh, g, hd, bs, ps, nb,
            ctypes.c_float(kw["scale"]), kw["sink_tokens"],
            kw["window_tokens"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.paged_quest_attend_error_string(err)
                               .decode())
        return out, sel

    return prepare, run


def plan_info(lib, case, kw) -> list:
    """(C, shared bytes a CTA, clusters the card holds at once, K/V
    stages) of a launch on ``case``."""
    from repro_torch.kernels.paged_attention.ops import KV_TYPES
    q, kp, bt = case[0], case[1], case[5]
    b, kvh, g, hd = q.shape
    info = (ctypes.c_int * 4)()
    lib.paged_quest_attend_plan.argtypes = [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    err = lib.paged_quest_attend_plan(KV_TYPES[kp.dtype], b, kvh, g, hd,
                                      kp.shape[2], kw["page_size"],
                                      bt.shape[1], info)
    if err:
        raise RuntimeError(f"plan error {err}")
    return list(info)


def measure(results: dict, built: list) -> None:
    from chip_smoke import (ATTN_TOL, device_time_ms, kv_row_bytes,
                            quest_cost, rotations)
    from repro_torch.kernels.paged_attention import cases
    from repro_torch.kernels.paged_attention.ref import paged_quest_attend_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    (case,), kw = cases.quest_case(gen, **MAIN)
    _, sel = paged_quest_attend_ref(*case[:6], length=case[6],
                                    page_budget=case[7], **kw)
    touched = quest_cost(case, kw, sel, kv_row_bytes(case, {}))[2]
    sets, _ = cases.quest_case(gen, copies=rotations(touched), **MAIN)
    for name, old, lib_path, ptxas in built:
        lib = bind(lib_path)
        prepare, run = runner(lib, kw)
        dts = ("f32", "int8", "fp8") if name in ALL_DTYPES else ("f32",)
        for dt in dts:
            check, scales, tsets = (case, {}), {}, sets
            if dt != "f32":
                (c8,), s8 = cases.store_kv([case], dt, quest=True)
                check = (c8, s8)
                tsets, scales = cases.store_kv(sets, dt, quest=True)
            err = float("nan")
            if "drop" not in name:
                out, sel = run(*prepare(*check))
                torch.cuda.synchronize()
                err = cases.check_quest(out, sel, check[0], kw,
                                        attn_tol=ATTN_TOL, scales=check[1])
            prepared = [prepare(st, scales) for st in tsets]
            ms = device_time_ms(run, prepared)
            info = plan_info(lib, tsets[0], kw) if not old else [1]
            key = f"{name} [{dt}]"
            results[key] = dict(ms=ms, max_abs_err=err, ptxas=ptxas,
                                plan=info)
            print(f"{key}: {ms:.4f} ms, max|err| {err:.3e}; plan (C, smem, "
                  f"clusters at once, stages) {info}; {ptxas}", flush=True)
            if "phase clock" in name:
                names, steps = (OLD_PHASES, OLD_STEPS) if old else \
                    (PHASES, STEPS)
                clk = psv.phase_clock(lib, run, prepared[0], info,
                                      *case[0].shape[:2], names=names,
                                      steps=steps)
                results[key]["phase_clock"] = clk
                print(f"  phase clock: {json.dumps(clk)}", flush=True)
            del prepared, tsets


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
            print(f"local memory (LDL, STL) of {name}:",
                  results[f"local memory (LDL, STL) of {name}"], flush=True)
    measure(results, built)
    line = json.dumps(dict(card=card, results=results))
    dump = REPO / "chiprun_out" / "paged_quest_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line + "\n")
    print(f"results: {dump.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
