#!/usr/bin/env python3
"""Design alternatives of the port's fused paged SOCKET kernel, timed on
one card.

    python3 experiments/paged_socket_variants.py --save-old   # in a git checkout
    python3 experiments/paged_socket_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Each variant is a
source of ``src/repro_torch/kernels/paged_attention/paged_attention.cu``
with a few text substitutions (``VARIANTS``), built with the port's nvcc
flags, checked against the plain version (``cases.check_paged``, or
``cases.check_hard_lsh`` in hard-LSH mode) and timed as ``chip_smoke.py``
times the kernel (CUDA-graph replay, inputs rotated past the L2 cache) at
the continuous path's shape (8 requests of 1-4K tokens, KVH 8, G 4, hd
128, a 264-block table) and gemma3's global layers (KVH 16, G 2, 2-6K
tokens).  Only the kernel is timed: the query hash's logZ is computed
beforehand.

``old`` variants are the design before the redesign (one block of 512
threads per (request, head), 32 one-bit radix passes, exponentials in
the score loop), read from commit ``OLD_COMMIT``: ``--save-old`` copies
its two sources into ``build/`` for a machine without git.  A variant's
substitutions apply to whichever of its design's files holds the text
(the kernel's source first, then the headers beside it, where the
select, the list fold and the merge live since they are shared with the
Quest kernel).  Variants
named ``drop ...`` leave a pass out to show what it costs; their outputs
are wrong by design and only timed.  ``drop select`` selects the forced
rows alone (the attend pass then folds 256 rows a request).

Prints one line a measurement and writes a JSON object of them all
to ``chiprun_out/paged_socket_variants.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

OUT = REPO / "build" / "paged_socket_variants"
OLD_COMMIT = "acc5ac004d5a1eff2158ea38b29226d9424eab75"
KERNEL_DIR = "src/repro_torch/kernels/paged_attention"
SOURCES = ("paged_attention.cu", "paged_common.cuh")       # the old design's
MAIN_LENS = [1024, 2048, 3072, 4096, 1024, 2048, 3072, 4096]
SHAPES = {
    "main path": dict(lengths=MAIN_LENS, nb=264),
    "gemma3 global": dict(lengths=[2080, 3104, 4128, 6176, 2079, 3103,
                                   4127, 6175], nb=392, kvh=16, g=2),
}

_DROP_LOOKUPS = [
    ("for (int g0 = 0; g0 < gs; g0 += kG) {",
     "for (int g0 = 0; g0 < 0; g0 += kG) {"),
    ("        float score = 0.f;\n        int hits = 0;",
     "        float score = 1.f;\n        int hits = 0;")]


_NO_TABLES = [
    ("    while (gl0 < tables) {", "    while (gl0 < 0) {"),
    ("for (int i = tid; i < tables * quads; i += kThreads) {",
     "for (int i = tid; i < 0; i += kThreads) {")]

# thread 0 of every CTA stamps %globaltimer at the phase boundaries:
# 0 entry, 1 tables and q in, 2 scored, 3 selected, 4 attended, 5 merged
_CLOCK = [
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_clk[1 << 16];\n"
     "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "g_clk[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
     "blockIdx.x) * 10 + (k)] = t_; }\n\nnamespace {\n"),
    ("  const int warp = tid >> 5, lane = tid & 31;\n  const int n_total",
     "  const int warp = tid >> 5, lane = tid & 31;\n  CLK(0);\n"
     "  const int n_total"),
    ("  paged::init_fold(fold, q", "  CLK(6);\n  paged::init_fold(fold, q"),
    ("    // every rank's share built: copy the other ranks' tables in\n"
     "    cluster.sync();\n",
     "    __syncthreads();\n    CLK(7);\n"
     "    // every rank's share built: copy the other ranks' tables in\n"
     "    cluster.sync();\n    CLK(8);\n"),
    ("  // ---- 1. score", "  __syncthreads();\n  CLK(1);\n  // ---- 1. score"),
    ("  // ---- 2. select", "  __syncthreads();\n  CLK(2);\n  // ---- 2. select"),
    ("  // ---- 3. attend", "  CLK(3);\n  // ---- 3. attend"),
    ("  // ---- 4. merge", "  CLK(4);\n  // ---- 4. merge"),
    ("  int* sbase = smisc + 4;", "  CLK(9);\n  int* sbase = smisc + 4;"),
    ("fold, g, hd, out + bh * g * hd);\n}",
     "fold, g, hd, out + bh * g * hd);\n  CLK(5);\n}"),
    ("const char* paged_socket_attend_error_string(int code) {",
     "int paged_phase_clock(unsigned long long* host, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, n * 8));\n"
     "}\n\nconst char* paged_socket_attend_error_string(int code) {")]


# the table build multiplying by 1 / tau in place of dividing
_INV_TAU = [("                low ? expf(s / tau - z[k]) : expf(s / tau);",
             "                low ? expf(s * (1.f / tau) - z[k]) "
             ": expf(s * (1.f / tau));")]


def _cluster(c):
    # C forced to c in place of the host's choice
    return [("for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap));",
             f"for (int cc = {c}; cc <= {c};")]


VARIANTS = {
    "shipped": [],
    "drop score lookups": _DROP_LOOKUPS,
    "drop score pass": _DROP_LOOKUPS + _NO_TABLES + [
        ("  if (r0 < r1) stage_bits(r0, sblk);\n", ""),
        ("    if (n0 + kThreads < r1) stage_bits(n0 + kThreads, next_blk);\n",
         "")],
    "drop tables": _NO_TABLES,
    "tables built by every rank": [
        ("int gl0 = rank + nranks * warp;", "int gl0 = warp;"),
        ("const int step = nranks * kWarps;", "const int step = kWarps;"),
        _NO_TABLES[1]],
    "drop select": [
        ("for (int round = 3; round >= 0; --round) {",
         "for (int round = 3; round >= 4; --round) {"),
        ("const uint32_t thr = sel.thr;",
         "const uint32_t thr = sort_key(FLT_MAX);"),
        ("const int ties_needed = sel.ties_needed;",
         "const int ties_needed = 1 << 30;")],
    "drop attend": [("for (int k0 = k_lo; k0 < k_hi; k0 += kThreads) {",
                     "for (int k0 = k_lo; k0 < k_lo; k0 += kThreads) {")],
    "drop merge": [("for (int i = rank * share + threadIdx.x; i < e1;",
                    "for (int i = rank * share + threadIdx.x; i < 0;")],
    "phase clock": _CLOCK,
    "phase clock, tables before bits": _CLOCK + [
        ("  if (r0 < r1) stage_bits(r0, sblk);\n", ""),
        ("  const uint32_t pmask = p < 32",
         "  if (r0 < r1) stage_bits(r0, sblk);\n"
         "  const uint32_t pmask = p < 32")],
    "drop u loads, phase clock": _CLOCK + [
        ("uj[k] = gl < tables && lane < p ? ub[at * p + lane] : 0.f;",
         "uj[k] = 0.01f * lane;"),
        ("z[k] = gl < tables ? logz[bh * tables + at] : 0.f;",
         "z[k] = 3.f;")],
    "phase clock, C 8": _CLOCK + _cluster(8),
    "1/tau": _INV_TAU,
    **{f"C {c}": _cluster(c) for c in (1, 2, 3, 4, 6, 8)},
    "bit words one at a time": [("w % 4 == 0 && reinterpret_cast",
                                 "false && reinterpret_cast")],
    "256 threads": [("constexpr int kThreads = 512;",
                     "constexpr int kThreads = 256;")],
}

OLD_VARIANTS = {
    "old": [],
    "old, drop score lookups": [
        ("for (int tb = 0; tb < nl; ++tb) {",
         "for (int tb = 0; tb < 0; ++tb) {"),
        ("        float score = 0.f;\n        int hits = 0;",
         "        float score = 1.f;\n        int hits = 0;")],
    "old, drop select": [
        ("for (int s = 31; s >= 0; --s) {", "for (int s = 31; s >= 32; --s) {"),
        ("const uint32_t thr = prefix;",
         "const uint32_t thr = paged::sort_key(FLT_MAX);"),
        ("""  const int ties_needed =
      budget - (paged::block_sum(gt, red) + (k_inv > thr ? n_inv : 0));""",
         "  const int ties_needed = 1 << 30;")],
    "old, drop attend": [("    if (cnt == 0) continue;", "    continue;")],
}


def save_sources(commit: str, names, dst: Path) -> None:
    """The files ``names`` of the kernel directory at ``commit`` (git) into
    ``dst``."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in names:
        text = subprocess.run(
            ["git", "show", f"{commit}:{KERNEL_DIR}/{name}"], cwd=REPO,
            check=True, capture_output=True, text=True).stdout
        (dst / name).write_text(text)
    print(f"saved {', '.join(names)} of {commit[:7]} to {dst}")


def save_old() -> None:
    save_sources(OLD_COMMIT, SOURCES, OUT / OLD_COMMIT[:7])


def design(main: str, saved=None) -> dict:
    """name -> text of a design's files, ``main`` (the kernel's source)
    first, then the headers beside it: the checkout's, or those saved in
    ``saved`` (raises where they are missing: run ``--save-old`` first)."""
    src = REPO / KERNEL_DIR if saved is None else saved
    if not (src / main).exists():
        raise SystemExit(f"{src / main} missing: run with --save-old in a "
                         "git checkout first")
    names = [main] + sorted(p.name for p in src.glob("*.cuh"))
    return {name: (src / name).read_text() for name in names}


def substitute(name: str, files: dict, subs) -> dict:
    """``files`` with each substitution of variant ``name`` made in the
    first file (in order) that holds its text; raises where none does."""
    files = dict(files)
    for a, b in subs:
        where = next((f for f, t in files.items() if a in t), None)
        if where is None:
            raise RuntimeError(f"variant {name!r}: {a[:60]!r} not in the "
                               "sources")
        files[where] = files[where].replace(a, b)
    return files


def build_variants(items, designs: dict, out: Path) -> list:
    """(name, old?, library, ptxas summary) of each (name, old?, subs) of
    ``items``, built in parallel; ``designs[old]`` is the design's files
    (:func:`design`), the first the source that nvcc compiles.  Each
    variant's files go into a directory of their own."""
    def one(k_item):
        k, (name, old, subs) = k_item
        files = substitute(name, designs[old], subs)
        d = out / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        return (name, old, *_nvcc(d / next(iter(files))))

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, enumerate(items)))


def _nvcc(src: Path) -> tuple:
    from repro_torch.kernels import build
    lib = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", proc.stderr)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         proc.stderr)]
    return lib, f"registers <= {max(regs)}, spill stores <= {max(spills)} B"


def local_memory(lib: Path) -> dict:
    """Local-memory loads and stores (LDL, STL) in the SASS of each kernel
    of ``lib``: spills that ptxas reports land in these."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)[-60:]
            out[name] = [0, 0]
        elif name and re.search(r"\bLDL\b", line):
            out[name][0] += 1
        elif name and re.search(r"\bSTL\b", line):
            out[name][1] += 1
    return out


def build_all(only) -> list:
    """(name, old?, library, ptxas summary) of every chosen variant."""
    items = [(n, False, s) for n, s in VARIANTS.items()] + \
        [(n, True, s) for n, s in OLD_VARIANTS.items()]
    items = [it for it in items if not only or it[0] in only]
    designs = {False: design(SOURCES[0])}
    if any(old for _, old, _ in items):
        designs[True] = design(SOURCES[0], OUT / OLD_COMMIT[:7])
    return build_variants(items, designs, OUT)


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_socket_attend_launch.argtypes = \
        [P] * 15 + [I] * 11 + [F] * 2 + [I] * 2 + [P]
    lib.paged_hard_lsh_attend_launch.argtypes = \
        [P] * 14 + [I] * 11 + [F] + [I] * 2 + [P]
    lib.paged_socket_attend_error_string.restype = ctypes.c_char_p
    return lib


def runner(lib, old: bool, hard: bool, kw: dict):
    """fn(prepared set) -> (out, sel) launching ``lib``; ``prepare(set,
    scales)`` builds what fn takes (the query hash as this design wants
    it: old ones padded to whole words of tables, logZ 1e30 there)."""
    from repro_torch.core import socket as sk
    from repro_torch.kernels.paged_attention.ops import KV_TYPES
    tau = kw.get("tau", 1.0)

    def prepare(case, scales):
        q, kp, vp, bits, vn, u, bt, length, budget = case
        gs, l, p = u.shape[2:]
        hashes = [u.contiguous()]
        if not hard:
            logz = sk.log_normalizer(u, tau)
            if old:
                pad = bits.shape[3] * 32 // p - l
                hashes = [torch.nn.functional.pad(u, (0, 0, 0, pad)),
                          torch.nn.functional.pad(logz, (0, pad),
                                                  value=1e30)]
                l += pad
            else:
                hashes.append(logz)
        hashes = [x.contiguous() for x in hashes]
        ks, vs = scales.get("k_scale"), scales.get("v_scale")
        return (q, kp, vp, ks, vs, bits, vn, hashes, bt, length.int(),
                budget.int(), l)

    fn = lib.paged_hard_lsh_attend_launch if hard else \
        lib.paged_socket_attend_launch

    def run(q, kp, vp, ks, vs, bits, vn, hashes, bt, length, budget, l):
        b, kvh, g, hd = q.shape
        nb, bs, w = bt.shape[1], bits.shape[2], bits.shape[3]
        p = kw["num_planes"]
        out = torch.empty_like(q)
        sel = torch.empty((b, kvh, nb, bs), dtype=torch.int32,
                          device=q.device)
        eff = torch.empty((b, kvh, nb * bs), device=q.device)
        ptrs = [t.data_ptr() if t is not None else None for t in
                (q, kp, vp, ks, vs, bits, vn, *hashes, bt, length, budget,
                 out, sel, eff)]
        scalars = [KV_TYPES[kp.dtype], b, kvh, g, u_gs(hashes), hd, bs, w,
                   nb, l, p]
        tail = [ctypes.c_float(kw["scale"]), kw["sink_tokens"],
                kw["window_tokens"],
                torch.cuda.current_stream().cuda_stream]
        if not hard:
            tail.insert(0, ctypes.c_float(tau))
        err = fn(*ptrs, *scalars, *tail)
        if err:
            raise RuntimeError(lib.paged_socket_attend_error_string(err)
                               .decode())
        return out, sel

    return prepare, run


def plan_info(lib, hard: bool, case, kw) -> list:
    """(C, shared bytes a CTA, clusters the card holds at once, K/V
    stages) of a launch on ``case``."""
    from repro_torch.kernels.paged_attention.ops import KV_TYPES
    q, kp, bits, u, bt = case[0], case[1], case[3], case[5], case[6]
    b, kvh, g, hd = q.shape
    info = (ctypes.c_int * 4)()
    lib.paged_socket_attend_plan.argtypes = [ctypes.c_int] * 12 + \
        [ctypes.c_void_p]
    err = lib.paged_socket_attend_plan(
        int(hard), KV_TYPES[kp.dtype], b, kvh, g, u.shape[2], hd,
        bits.shape[2], bits.shape[3], bt.shape[1], kw["num_tables"],
        kw["num_planes"], info)
    if err:
        raise RuntimeError(f"plan error {err}")
    return list(info)


PHASES = ["tables+q", "score", "select", "attend", "merge"]
STEPS = ["bits issued", "tables built", "cluster synced", "rows listed"]


def phase_clock(lib, run, prepared, info, b, kvh, names=PHASES,
                steps=STEPS) -> dict:
    """Per-phase device microseconds of one launch from its CTAs' clock
    stamps (see ``_CLOCK``: stamps 0-5 bound the five ``names`` phases,
    6-9 are the ``steps`` from entry): mean and max over CTAs, and by
    rank."""
    import numpy as np
    run(*prepared)
    torch.cuda.synchronize()
    c = info[0]
    n = c * kvh * b
    buf = (ctypes.c_ulonglong * (n * 10))()
    lib.paged_phase_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.paged_phase_clock(buf, n * 10):
        raise RuntimeError("reading the phase clock failed")
    full = np.array(buf, dtype=np.float64).reshape(n, 10)
    t = full[:, :6] - full[:, :1].min()
    sub = (full[:, 6:10] - full[:, :1]) / 1e3          # steps from entry
    d = np.diff(t, axis=1) / 1e3                       # microseconds
    by_rank = d.reshape(b * kvh, c, 5)
    return dict(
        span_us=float(t[:, 5].max() / 1e3),
        steps_us={k: float(sub[:, i].mean()) for i, k in enumerate(steps)},
        start_us=[float(np.quantile(t[:, 0], x) / 1e3)
                  for x in (0, .5, .9, 1)],
        mean_us={k: float(d[:, i].mean()) for i, k in enumerate(names)},
        max_us={k: float(d[:, i].max()) for i, k in enumerate(names)},
        rank_mean_us={k: [float(v) for v in by_rank[:, :, i].mean(0)]
                      for i, k in enumerate(names)})


def u_gs(hashes) -> int:
    return hashes[0].shape[2]


def plan(name: str, hard: bool, shape: str):
    """The page dtypes ``name`` is timed in for a mode and shape: the two
    designs everywhere, each alternative in SOCKET mode at the main path
    on f32 pages."""
    if name in ("shipped", "old"):
        return ("f32", "int8", "fp8") if shape == "main path" else ("f32",)
    return ("f32",) if not hard and shape == "main path" else ()


def measure(results: dict, built: list) -> None:
    from chip_smoke import (ATTN_TOL, SCORE_TOL, device_time_ms,
                            kv_row_bytes, lsh_cost, rotations)
    from repro_torch.kernels.paged_attention import cases
    dev = torch.device("cuda", 0)
    for shape, skw in SHAPES.items():
        for hard in (False, True):
            if hard and shape != "main path":
                continue
            mode = "hard LSH" if hard else "SOCKET"
            build = cases.hard_lsh_case if hard else cases.paged_case
            gen = torch.Generator(device=dev).manual_seed(7)
            (case,), kw = build(gen, **skw)
            touched = lsh_cost(case, kw, hard, kv_row_bytes(case, {}))[2]
            sets, _ = build(gen, copies=rotations(touched), **skw)
            for name, old, lib_path, ptxas in built:
                prepare, run = runner(bind(lib_path), old, hard, kw)
                for dt in plan(name, hard, shape):
                    check, scales = (case, {}), {}
                    tsets = sets
                    if dt != "f32":
                        (c8,), s8 = cases.store_kv([case], dt)
                        check = (c8, s8)
                        tsets, scales = cases.store_kv(sets, dt)
                    err = float("nan")
                    if "drop" not in name:
                        out, sel = run(*prepare(*check))
                        torch.cuda.synchronize()
                        if hard:
                            err = cases.check_hard_lsh(
                                out, sel, check[0], kw, attn_tol=ATTN_TOL,
                                scales=check[1])
                        else:
                            err, _ = cases.check_paged(
                                out, sel, check[0], kw, ties=False,
                                attn_tol=ATTN_TOL, score_tol=SCORE_TOL,
                                scales=check[1])
                    prepared = [prepare(st, scales) for st in tsets]
                    ms = device_time_ms(run, prepared)
                    key = f"{name} [{mode}, {shape}, {dt}]"
                    info = plan_info(bind(lib_path), hard, tsets[0], kw) \
                        if not old else None
                    results[key] = dict(ms=ms, max_abs_err=err, ptxas=ptxas,
                                        plan=info)
                    print(f"{key}: {ms:.4f} ms, max|err| {err:.3e}; plan "
                          f"(C, smem, clusters at once, stages) {info}; "
                          f"{ptxas}", flush=True)
                    if "phase clock" in name:
                        clk = phase_clock(bind(lib_path), run, prepared[0],
                                          info, *case[0].shape[:2])
                        results[key]["phase_clock"] = clk
                        print(f"  phase clock: {json.dumps(clk)}",
                              flush=True)
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
        if name == "shipped":
            results["local memory (LDL, STL) of shipped"] = \
                local_memory(lib_path)
            print("local memory (LDL, STL):",
                  results["local memory (LDL, STL) of shipped"], flush=True)
    measure(results, built)
    line = json.dumps(dict(card=card, results=results))
    dump = REPO / "chiprun_out" / "paged_socket_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line + "\n")
    print(f"results: {dump.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
