#!/usr/bin/env python3
"""Design alternatives of the port's ``socket_score`` kernel, timed on one
card.

    python3 experiments/socket_score_variants.py --save-old   # in a git checkout
    python3 experiments/socket_score_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Each variant is a
copy of ``src/repro_torch/kernels/socket_score/socket_score.cu`` and the
cluster headers it includes (``paged_attention/paged_cluster.cuh``,
``paged_common.cuh``) with a few text substitutions (``VARIANTS``),
built with the port's nvcc flags, checked against the plain version
(``socket_score_ref``, within ``chip_smoke.SCORE_TOL``) and timed as
``chip_smoke.py`` times the kernel (CUDA-graph replay, inputs rotated
past the L2 cache) at the static path's shape: BH 16, N 8224, G 4, L 60,
P 10, packed words, no vnorm (the shipped and old designs also with
vnorm and on int8 planes).

``old`` is the design before the redesign (one 128-thread block per
(bh, 128-key tile), P sign-adds and one expf per (key, g, l)), read from
commit ``OLD_COMMIT``: ``--save-old`` copies its source into ``build/``
for a machine without git.  A substitution lands in whichever of the
design's files holds its text.  Variants named ``drop ...`` leave a pass
out to show what it costs; their outputs are wrong by design and only
timed.  ``phase clock`` stamps ``%globaltimer`` in thread 0 of every CTA
at entry, once the tables are in (built, and copied from the other
ranks) and after the score loop.

Prints one line a measurement and writes a JSON object of them all to
``chiprun_out/socket_score_variants.json``.
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

OUT = REPO / "build" / "socket_score_variants"
OLD_COMMIT = "b8c7f1fc9a13aa679831677b78f34ecd2b6136a4"
KERNELS = "src/repro_torch/kernels"
MAIN = "socket_score/socket_score.cu"
HEADERS = ("paged_attention/paged_cluster.cuh",
           "paged_attention/paged_common.cuh")
SHAPE = dict(bh=16, n=8224, g=4, l=60, p=10)
TAU = 0.4

_NO_STAGING = [
    ("  if (run.r0 < run.r1) stage(run.r0, sbits);\n", ""),
    ("    if (next) stage(n0 + run.rows, sbits + (buf ^ 1) * tile * ws);\n",
     ""),
    ("    if constexpr (!kInt8) cp_async_wait(next ? 1 : 0);\n", "")]

# thread 0 of every CTA stamps %globaltimer: 0 entry, 1 tables in, 2 scored
_CLOCK = [
    ("namespace cg = cooperative_groups;\n\nnamespace {\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_clk[1 << 16];\n"
     "#define CLK(k) if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "g_clk[(blockIdx.y * gridDim.x + blockIdx.x) * 3 + (k)] = t_; }\n\n"
     "namespace {\n"),
    ("  const int bh = blockIdx.y, tid = threadIdx.x;\n",
     "  const int bh = blockIdx.y, tid = threadIdx.x;\n  CLK(0);\n"),
    ("  // ---- 1. score the run, tile by tile",
     "  __syncthreads();\n  CLK(1);\n  // ---- 1. score the run, tile by tile"),
    ("  if (share) cluster_wait();",
     "  CLK(2);\n  if (share) cluster_wait();"),
    ("const char* socket_score_error_string(int code) {",
     "int socket_phase_clock(unsigned long long* host, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, n * 8));\n"
     "}\n\nconst char* socket_score_error_string(int code) {")]

# the other ranks' tables copied with four 16-byte loads in flight a
# thread, all issued before any store
_BATCHED_COPY = (
    """      for (int i = tid; i < g * nl * quads; i += kThreads) {
        const int owner = div_quads(i) % nranks;
        if (owner != rank)
          own[i] = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(stab, owner))[i];
      }""",
    """      const int total = g * nl * quads;
      for (int i0 = tid; i0 < total; i0 += 4 * kThreads) {
        float4 v[4];
        int at[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + b * kThreads;
          const int owner = i < total ? div_quads(i) % nranks : rank;
          at[b] = owner != rank ? i : -1;
          if (at[b] >= 0)
            v[b] = reinterpret_cast<const float4*>(
                cluster.map_shared_rank(stab, owner))[i];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (at[b] >= 0) own[at[b]] = v[b];
      }""")

_NO_TABLES = [("  const bool share = resident && nranks > 1;\n  if (resident) {",
               "  const bool share = false;\n  if (false) {")]


# int8 planes: each thread forms kStageBatch words at once, their loads
# (through __ldg, whole words as 8- or 16-byte loads) all issued before
# any store
def _int8_batched(batch):
    return [(_SHIPPED_STAGE, _BATCHED_STAGE),
            ("// The split cluster barrier:",
             _PLANE_WORD + "// The split cluster barrier:"),
            ("constexpr int kMaxSplitPlanes = 16;",
             f"constexpr int kStageBatch = {batch};\n"
             "constexpr int kMaxSplitPlanes = 16;")]


_SHIPPED_STAGE = """  // a tile's rows into dst at stride ws: copies of vec words (packed), or
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

"""

_BATCHED_STAGE = """  // a tile's rows into dst at stride ws: copies of vec words (packed), or
  // words formed from the sign bits of the int8 planes, kStageBatch a
  // thread at once (their loads all issued before any store)
  const int units = kInt8 ? wp : w / vec;
  const FastDiv div_units(units);
  const bool fast_units = tile * units <= 65536;
  auto stage = [&](int n0, uint32_t* dst) {
    const int items = min(run.rows, run.r1 - n0) * units;
    const size_t row0 = static_cast<size_t>(bh) * n + n0;
    if constexpr (kInt8) {
      const unsigned char* src = static_cast<const unsigned char*>(bits);
      for (int i0 = tid; i0 < items; i0 += kStageBatch * kThreads) {
        uint32_t word[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int i = i0 + b * kThreads;
          const int r = fast_units ? div_units(i) : i / units;
          const int k = i - r * units;
          word[b] = i < items ? plane_word(src + (row0 + r) * w + k * 32,
                                           min(32, w - k * 32), vec)
                              : 0u;
        }
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int i = i0 + b * kThreads;
          const int r = fast_units ? div_units(i) : i / units;
          if (i < items) dst[r * ws + i - r * units] = word[b];
        }
      }
    } else {
      for (int i = tid; i < items; i += kThreads) {
        const int r = fast_units ? div_units(i) : i / units;
        const int k = i - r * units;
        cp_async(dst + r * ws + k * vec,
                 static_cast<const uint32_t*>(bits) + (row0 + r) * w +
                     k * vec,
                 4 * vec);
      }
      cp_async_commit();
    }
  };

"""

_PLANE_WORD = """// The packed word of nb (<= 32) ±1 plane bytes at src, read vec bytes at
// a time (whole words as two 16-byte or four 8-byte loads).
__device__ __forceinline__ uint32_t plane_word(const unsigned char* src,
                                               int nb, int vec) {
  if (nb == 32 && vec == 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    return sign_bits4(a.x) | sign_bits4(a.y) << 4 | sign_bits4(a.z) << 8 |
           sign_bits4(a.w) << 12 | sign_bits4(b.x) << 16 |
           sign_bits4(b.y) << 20 | sign_bits4(b.z) << 24 |
           sign_bits4(b.w) << 28;
  }
  if (nb == 32 && vec == 8) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + q);
      word |= (sign_bits4(v.x) | sign_bits4(v.y) << 4) << (8 * q);
    }
    return word;
  }
  uint32_t word = 0;
  for (int o = 0; o < nb; o += vec) {
    if (vec >= 4) {
      for (int q = 0; q < vec; q += 4)
        word |= sign_bits4(__ldg(reinterpret_cast<const uint32_t*>(src + o +
                                                                  q)))
                << (o + q);
    } else {
      word |= (static_cast<signed char>(src[o]) >= 0 ? 1u : 0u) << o;
    }
  }
  return word;
}

"""

def _cluster(c):
    # C forced to c in place of the host's choice
    return [("for (int cc = 1; cc <= std::max(1, std::min(kMaxCluster, cap));",
             f"for (int cc = {c}; cc <= {c};")]


VARIANTS = {
    "shipped": [],
    "(b) tables built by every rank": [
        ("tau, rank,\n                         nranks);",
         "tau, 0,\n                         1);"),
        ("const bool share = resident && nranks > 1;",
         "const bool share = false;")],
    "uint4 loads": _NO_STAGING + [
        ("RowWords row{reinterpret_cast<const uint4*>(sbits + buf * tile * ws +"
         "\n                                                tid * ws), {}};",
         "RowWords row{reinterpret_cast<const uint4*>(\n"
         "        static_cast<const uint32_t*>(bits) +\n"
         "        (static_cast<size_t>(bh) * n + (active ? t : n0)) * w), {}};")],
    "drop tables": _NO_TABLES,
    "drop bits load": _NO_STAGING,
    "drop score loop": [("        if (active)\n          score_tables",
                         "        if (false)\n          score_tables")],
    "drop tables and score loop": _NO_TABLES + [
        ("        if (active)\n          score_tables",
         "        if (false)\n          score_tables")],
    "phase clock": _CLOCK,
    "phase clock, (b)": _CLOCK + [
        ("tau, rank,\n                         nranks);",
         "tau, 0,\n                         1);"),
        ("const bool share = resident && nranks > 1;",
         "const bool share = false;")],
    **{f"C {c}": _cluster(c) for c in range(1, 9)},
    "tuning: DSMEM copy 4 loads in flight": [_BATCHED_COPY],
    "tuning: score loop unrolled by 4": [
        ("  for (int l = l0; l < l1; ++l, tl += lstep) {",
         "#pragma unroll 4\n  for (int l = l0; l < l1; ++l, tl += lstep) {")],
    "int8 words batched 4 through __ldg": _int8_batched(4),
    "int8 words batched 1 through __ldg": _int8_batched(1),
    "tuning: logZ by butterfly": [
        ("  for (int j = 0; j < p; ++j) z += __shfl_sync(kFull, term, j);",
         "  z = lane < p ? term : 0.f;\n"
         "  for (int o = 16; o > 0; o >>= 1) "
         "z += __shfl_xor_sync(kFull, z, o);")],
}

OLD_VARIANTS = {"old": []}

ALL_FORMATS = ("f32 words", "f32 words + vnorm", "int8 planes")


def formats(name: str) -> tuple:
    """The input formats variant ``name`` is checked and timed on: the
    shipped and old designs on all, the int8 staging variant on int8
    planes, the rest on packed words."""
    if name in ("shipped", "old"):
        return ALL_FORMATS
    return ("int8 planes",) if name.startswith("int8") else ("f32 words",)


def save_old() -> None:
    dst = OUT / OLD_COMMIT[:7] / MAIN
    dst.parent.mkdir(parents=True, exist_ok=True)
    text = subprocess.run(["git", "show", f"{OLD_COMMIT}:{KERNELS}/{MAIN}"],
                          cwd=REPO, check=True, capture_output=True,
                          text=True).stdout
    dst.write_text(text)
    print(f"saved {MAIN} of {OLD_COMMIT[:7]} to {dst}")


def design(old: bool) -> dict:
    """relative path -> text of a design's files, the source nvcc compiles
    first (raises where the old one is missing: run ``--save-old``)."""
    if old:
        src = OUT / OLD_COMMIT[:7] / MAIN
        if not src.exists():
            raise SystemExit(f"{src} missing: run with --save-old in a git "
                             "checkout first")
        return {MAIN: src.read_text()}
    return {name: (REPO / KERNELS / name).read_text()
            for name in (MAIN, *HEADERS)}


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


def build_all(only) -> list:
    """(name, old?, library, ptxas summary) of every chosen variant, built
    in parallel, each in a directory of its own (the kernel directories'
    layout, so the source's relative include holds)."""
    items = [(n, False, s) for n, s in VARIANTS.items()] + \
        [(n, True, s) for n, s in OLD_VARIANTS.items()]
    items = [it for it in items if not only or it[0] in only]
    designs = {old: design(old) for old in {it[1] for it in items}}

    def one(k_item):
        k, (name, old, subs) = k_item
        files = substitute(name, designs[old], subs)
        d = OUT / f"v{k}"
        for f, text in files.items():
            (d / f).parent.mkdir(parents=True, exist_ok=True)
            (d / f).write_text(text)
        return (name, old, *_nvcc(d / MAIN))

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, enumerate(items)))


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.socket_score_launch.argtypes = [P, I, P, P, P] + [I] * 6 + [F, P]
    lib.socket_score_launch.restype = I
    lib.socket_score_error_string.argtypes = [I]
    lib.socket_score_error_string.restype = ctypes.c_char_p
    return lib


def runner(lib):
    """fn(bits, u, vnorm) -> scores, launching ``lib``."""
    def run(bits, u, vnorm):
        bh, n, w = bits.shape
        g, l, p = u.shape[1:]
        out = torch.empty((bh, n), device=bits.device)
        err = lib.socket_score_launch(
            bits.data_ptr(), int(bits.dtype == torch.int8), u.data_ptr(),
            vnorm.data_ptr() if vnorm is not None else None, out.data_ptr(),
            bh, n, w, g, l, p, ctypes.c_float(TAU),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.socket_score_error_string(err).decode())
        return out
    return run


def plan_info(lib, bits, g) -> list:
    """(C, shared bytes a CTA, clusters at once, split?, tile rows,
    resident?, tables a chunk) of a launch on ``bits``."""
    info = (ctypes.c_int * 7)()
    lib.socket_score_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bh, n, w = bits.shape
    err = lib.socket_score_plan(int(bits.dtype == torch.int8), bh, n, w, g,
                                SHAPE["l"], SHAPE["p"], info)
    if err:
        raise RuntimeError(f"plan error {err}")
    return list(info)


def phase_clock(lib, run, inputs, c) -> dict:
    """Device microseconds a CTA from its clock stamps (``_CLOCK``): until
    the tables are in, the score loop; mean and max over CTAs, and the
    launch's span."""
    import numpy as np
    run(*inputs)
    torch.cuda.synchronize()
    n = c * SHAPE["bh"]
    buf = (ctypes.c_ulonglong * (n * 3))()
    lib.socket_phase_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.socket_phase_clock(buf, n * 3):
        raise RuntimeError("reading the phase clock failed")
    t = np.array(buf, dtype=np.float64).reshape(n, 3)
    t = (t - t[:, :1].min()) / 1e3
    d = np.diff(t, axis=1)
    return dict(span_us=float(t[:, 2].max()),
                start_us=[float(np.quantile(t[:, 0], x))
                          for x in (0, .5, 1)],
                tables_in_mean_us=float(d[:, 0].mean()),
                tables_in_max_us=float(d[:, 0].max()),
                score_mean_us=float(d[:, 1].mean()),
                score_max_us=float(d[:, 1].max()))


def measure(results: dict, built: list) -> None:
    from chip_smoke import (SCORE_TOL, check_close, device_time_ms,
                            rotations, socket_score_case)
    from repro_torch.kernels.socket_score.ref import socket_score_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = {}
    for fmt, int8, vnorm in (("f32 words", False, False),
                             ("f32 words + vnorm", False, True),
                             ("int8 planes", True, False)):
        kw = dict(SHAPE, int8=int8, vnorm=vnorm)
        check = socket_score_case(dev, gen, **kw)
        nbytes = sum(x.numel() * x.element_size() for x in check
                     if x is not None)
        sets = [socket_score_case(dev, gen, **kw)
                for _ in range(rotations(nbytes))]
        cases[fmt] = (check, sets)
    args = dict(num_tables=SHAPE["l"], num_planes=SHAPE["p"], tau=TAU)
    for name, old, lib_path, ptxas in built:
        lib = bind(lib_path)
        run = runner(lib)
        for fmt, (check, sets) in cases.items():
            if fmt not in formats(name):
                continue
            err = float("nan")
            if "drop" not in name:
                out = run(*check)
                torch.cuda.synchronize()
                err = check_close(f"{name} [{fmt}]", out,
                                  socket_score_ref(*check, **args),
                                  SCORE_TOL)
            ms = device_time_ms(run, sets)
            info = None if old else plan_info(lib, check[0], SHAPE["g"])
            key = f"{name} [{fmt}]"
            results[key] = dict(ms=ms, max_abs_err=err, ptxas=ptxas,
                                plan=info)
            print(f"{key}: {ms:.4f} ms, max|err| {err:.3e}; plan (C, smem, "
                  f"clusters at once, split, tile, resident, tables a "
                  f"chunk) {info}; {ptxas}", flush=True)
            if "phase clock" in name:
                clk = phase_clock(lib, run, sets[0], info[0])
                results[key]["phase_clock"] = clk
                print(f"  phase clock: {json.dumps(clk)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to build (default: all)")
    ap.add_argument("--save-old", action="store_true",
                    help=f"copy the source of {OLD_COMMIT[:7]} into build/ "
                         "(needs git) and exit")
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
    measure(results, built)
    line = json.dumps(dict(card=card, results=results))
    dump = REPO / "chiprun_out" / "socket_score_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line + "\n")
    print(f"results: {dump.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
