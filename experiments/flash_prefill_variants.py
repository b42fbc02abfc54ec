#!/usr/bin/env python3
"""Design alternatives of the port's flash_prefill CUDA kernel, timed on
one card.

    python3 experiments/flash_prefill_variants.py [--only NAME ...]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Two measurements:

* the card's ``mma.sync`` TF32 rate (m16n8k8; blocks of 4, 8 or 16
  warps, four blocks an SM; 1, 4 or 16 independent accumulators a warp):
  the ceiling of any kernel built on ``mma.sync``, and so of
  flash_prefill's 3xTF32 products;
* variants of ``src/repro_torch/kernels/flash_prefill/flash_prefill.cu``,
  each the shipped source with a few text substitutions (``VARIANTS``),
  instantiated for hd 128 alone and built with the port's nvcc flags,
  then checked against the plain version (atol 1e-5 on N(0, 1) inputs)
  and timed as ``chip_smoke.py`` times the kernel (CUDA-graph replay,
  inputs rotated past the L2 cache) at llama31-8b's prefill shape (BH 64,
  BKV 16, S 8192) and gemma3's local one (BH 32, BKV 16, S 4096, window
  1024).  Variants named ``drop ...`` leave work out to show what it
  costs; their outputs are wrong by design and only timed.

Prints one line a measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

OUT = REPO / "build" / "flash_prefill_variants"
HEAD_DIMS = "CASE(16) CASE(32) CASE(64) CASE(128) CASE(160) CASE(256)"
SHAPES = {"llama31-8b prefill": (64, 16, 8192, 0),
          "gemma3 local, window 1024": (32, 16, 4096, 1024)}

# splitting K and V at each fragment load (one split per warp) instead of
# once per tile into operand planes: the planes hold the loaded values,
# and there are no small planes
_AT_FRAGMENT = [
    ("static constexpr int kPlanes = kExact ? 1 : 2;",
     "static constexpr int kPlanes = 1;"),
    ("""      operands<kExact>(x[m][i].x, b.x, sm.x);
      operands<kExact>(x[m][i].y, b.y, sm.y);
      operands<kExact>(x[m][i].z, b.z, sm.z);
      operands<kExact>(x[m][i].w, b.w, sm.w);""",
     """      operands<true>(x[m][i].x, b.x, sm.x);
      operands<true>(x[m][i].y, b.y, sm.y);
      operands<true>(x[m][i].z, b.z, sm.z);
      operands<true>(x[m][i].w, b.w, sm.w);"""),
    ("      if (!kExact) *reinterpret_cast<uint4*>((m ? vsmall : ksmall) + at)"
     " = sm;\n", ""),
    ("""            const uint2 yb = *reinterpret_cast<const uint2*>(kbig + at);
            const uint32_t bb[2] = {yb.x, yb.y};
            if (!kExact) {
              const uint2 ys = *reinterpret_cast<const uint2*>(ksmall + at);
              const uint32_t bs[2] = {ys.x, ys.y};""",
     """            const uint2 yb = *reinterpret_cast<const uint2*>(kbig + at);
            uint32_t bb[2], bs[2];
            operands<kExact>(__uint_as_float(yb.x), bb[0], bs[0]);
            operands<kExact>(__uint_as_float(yb.y), bb[1], bs[1]);
            if (!kExact) {"""),
    ("""            const uint32_t bb[2][2] = {{b0.x, b1.x}, {b0.y, b1.y}};
            uint32_t bs[2][2] = {};
            if (!kExact) {
              const uint2 s0 = *reinterpret_cast<const uint2*>(vsmall + at);
              const uint2 s1 =
                  *reinterpret_cast<const uint2*>(vsmall + at + kVS);
              bs[0][0] = s0.x;
              bs[0][1] = s1.x;
              bs[1][0] = s0.y;
              bs[1][1] = s1.y;
            }""",
     """            uint32_t bb[2][2], bs[2][2];
            operands<kExact>(__uint_as_float(b0.x), bb[0][0], bs[0][0]);
            operands<kExact>(__uint_as_float(b1.x), bb[0][1], bs[0][1]);
            operands<kExact>(__uint_as_float(b0.y), bb[1][0], bs[1][0]);
            operands<kExact>(__uint_as_float(b1.y), bb[1][1], bs[1][1]);"""),
]


def _key_tile(keys):
    return [("struct Tiles<128> {\n  static constexpr int kWarps = 8;\n"
             "  static constexpr int kBK = 48;",
             "struct Tiles<128> {\n  static constexpr int kWarps = 8;\n"
             f"  static constexpr int kBK = {keys};")]


VARIANTS = {
    "shipped": [],
    "split at each fragment load": _AT_FRAGMENT,
    "split at each fragment load, 64-key tiles": _AT_FRAGMENT + _key_tile(64),
    "32-key tiles": _key_tile(32),
    "cvt.rna.tf32.f32 for the split": [(
        """    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;""",
        """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small)
        : "f"(x - __uint_as_float(big)));""")],
    "tensor-core chains of 8 k-steps": [("kChunk = 4;", "kChunk = 8;")],
    "one softmax, mask always on": [(
        "          need_mask ? softmax_tile<true>",
        "          true ? softmax_tile<true>")],
    "drop P V": [("for (int n0 = 0; n0 < kKS; n0 += kNG) {",
                  "for (int n0 = 0; n0 < 0; n0 += kNG) {")],
    "drop Q K^T": [("for (int kc = 0; kc < kKS; kc += kCh) {",
                    "for (int kc = 0; kc < 0; kc += kCh) {")],
    "drop Q K^T and P V": [
        ("for (int n0 = 0; n0 < kKS; n0 += kNG) {",
         "for (int n0 = 0; n0 < 0; n0 += kNG) {"),
        ("for (int kc = 0; kc < kKS; kc += kCh) {",
         "for (int kc = 0; kc < 0; kc += kCh) {")],
    "drop the split pass": [(
        "      split_kv();\n      __syncthreads();                   // its",
        "      __syncthreads();                   // its")],
    "drop exp": [("expf(sc[j][e] - m0)", "(sc[j][e] - m0)"),
                 ("expf(sc[j][2 + e] - m1)", "(sc[j][2 + e] - m1)")],
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int N>
__global__ void bench(float* out, int iters) {
  const uint32_t a[4] = {__float_as_uint(1.f), __float_as_uint(.5f),
                         __float_as_uint(.25f), __float_as_uint(2.f)};
  const uint32_t b[2] = {__float_as_uint(1e-3f), __float_as_uint(2e-3f)};
  float d[N][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]),
                     "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < N; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int n, int blocks, int threads, int iters) {
  switch (n) {
    case 1: bench<1><<<blocks, threads>>>(out, iters); break;
    case 4: bench<4><<<blocks, threads>>>(out, iters); break;
    case 16: bench<16><<<blocks, threads>>>(out, iters); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc(src: Path, lib: Path) -> str:
    from repro_torch.kernels import build
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return " ".join(line.split(":", 1)[-1].strip()
                    for line in proc.stderr.splitlines()
                    if "Used" in line or "spill stores" in line)


def mma_rate(results: dict) -> None:
    src = OUT / "mma_bench.cu"
    src.write_text(MMA_BENCH)
    _nvcc(src, src.with_suffix(".so"))
    lib = ctypes.CDLL(str(src.with_suffix(".so")))
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.run.restype = ctypes.c_int

    def run(chains, blocks, threads, iters):
        err = lib.run(out.data_ptr(), chains, blocks, threads, iters)
        if err:
            raise RuntimeError(f"mma bench launch error {err}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 512, device="cuda")
    for threads in (128, 256, 512):
        for chains in (1, 4, 16):
            blocks, iters = sms * 4, 4096
            run(chains, blocks, threads, 16)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(chains, blocks, threads, iters)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            flops = blocks * threads // 32 * iters * chains * 2048
            tflops = flops / ms / 1e9
            key = f"mma.sync tf32, {threads // 32} warps a block, " \
                  f"{chains} accumulators a warp"
            results[key] = dict(ms=ms, tflops=tflops)
            print(f"{key}: {tflops:.1f} TFLOP/s", flush=True)


def variants(results: dict, only) -> None:
    from chip_smoke import device_time_ms
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    base = fp.SOURCE.read_text().replace(HEAD_DIMS, "CASE(128)")
    chosen = {k: v for k, v in VARIANTS.items() if not only or k in only}

    def build(item):
        name, subs = item
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old[:60]!r} not in "
                                   "the source")
            text = text.replace(old, new)
        src = OUT / f"v{list(VARIANTS).index(name)}.cu"
        src.write_text(text)
        return name, src.with_suffix(".so"), _nvcc(src,
                                                   src.with_suffix(".so"))

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        built = list(ex.map(build, chosen.items()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    hd = 128
    for shape, (bh, bkv, s, window) in SHAPES.items():
        sets = [tuple(torch.randn((n, s, hd), generator=gen, device=dev)
                      for n in (bh, bkv, bkv)) for _ in range(2)]
        scale = 1 / math.sqrt(hd)
        want = flash_prefill_ref(*sets[0], scale=scale, window=window,
                                 q_chunk=512)
        for name, lib_path, ptxas in built:
            fn = ctypes.CDLL(str(lib_path)).flash_prefill_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
                [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                 ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(q, k, v):
                o = torch.empty((bh, s, hd), device=dev)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), 0, bh, bkv, s, hd, scale, window, 0.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
                return o

            err = (run(*sets[0]) - want).abs().max().item()
            if not name.startswith("drop") and not err <= 1e-5:
                raise AssertionError(f"{name} [{shape}]: max|err| {err:.3e}")
            ms = device_time_ms(run, sets, iters=4, replays=2)
            results[f"{name} [{shape}]"] = dict(ms=ms, max_abs_err=err,
                                                ptxas=ptxas)
            print(f"{name} [{shape}]: {ms:.3f} ms, max|err| {err:.3e}; "
                  f"{ptxas}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to build (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    results = {}
    mma_rate(results)
    variants(results, args.only)
    print(json.dumps(dict(card=card, results=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
