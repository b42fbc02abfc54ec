#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:

1. device   — a CUDA card must be present; prints its name and power
              limit as nvidia-smi reports them.
2. build    — builds the CUDA kernels from the sources in this checkout
              (nvcc, sm_90a, one process per source, all started together:
              socket_score.cu, flash_decode.cu, paged_attention.cu,
              paged_quest.cu, paged_ring.cu, flash_prefill.cu).
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at edge shapes, with the tolerance
              stated; times kernel, plain version and (where one exists) the
              one PyTorch call computing the same function on the device
              (CUDA-graph replay), beside the least time the card could
              take, and the kernel once more launched back to back from
              Python (the host's launch rate).  ``socket_score`` at the
              static path's shape (f32 words, with vnorm, int8 planes,
              pooled G 1; f32 words and int8 planes timed) and at its
              edges (G 3 / P 7, P 1, P 20 on the sign-add instance, BH
              256 on C 1 in several waves, tables in chunks at P 16 and
              at P 24 / L 600), every case logged with its launch plan
              (C, clusters at once, shared memory, instance) and failing
              where the plan does not exercise its label; keys given
              equal bits on every rank of the cluster must score
              bit-equal (f32 words and int8 planes).  ``flash_decode`` on
              every case of its ``cases.CARD_CASES`` (the static path's
              shape, B 1, stablelm hd 160, gemma-7b hd 256 / G 1, mixtral
              G 6, K < C, BH 256 / K 64, bf16 and f16 K/V, fully masked
              rows, which must return exactly 0), each logged with its
              launch plan (``ops.flash_decode_plan``: C, clusters at once,
              shared memory, stages) and failing where the plan does not
              exercise its label; timed at the main shape with the host's
              microseconds a call; its build's ptxas registers and spills
              are logged, and ``cuobjdump -sass`` of the library must show
              asynchronous copies (``LDGSTS`` or ``UTMALDG``).  The four fused paged
              kernels again on pools stored as bf16, int8 and fp8 (the main
              case and an edge: ties, or a ring whose dead rows hold NaN in
              scales and fp8 payloads), SOCKET's and hard LSH's selections
              also equal to their own on the f32 pages; int8 and fp8 are
              timed as entries ``name[int8]``, ``name[fp8]``.  SOCKET,
              hard LSH and Quest also run, on every pool, the cases of the
              cluster split (32K contexts, selected ties across ranks, idle
              ranks and, but for Quest, pooled selection), every case
              logged with the split it ran (C, clusters the card holds at
              once, shared memory a CTA, K/V stages); the tie case must
              put selected ties on two ranks or more (Quest's must also
              leave a tied page out), the idle case leave a rank idle, and
              Quest's main path run on two ranks or more.  The ring
              kernel runs every case of ``cases.RING_CASES`` on f32,
              bf16, int8 and fp8 pools, each logged with its launch plan
              (``ops.paged_ring_plan``: C, shared memory, stages, the
              fold's lanes) and failing where the plan does not exercise
              its label (a cluster split at B 1 and B 2, empty ranks,
              windows from inside a page, padded rows); it is timed at
              the main shape and at B 2 (``b2``), and its yardstick twice:
              SDPA over views gathered beforehand, and the gather, mask
              and SDPA as one callable (``library_with_gather_ms``).
              The prefill kernel ``flash_prefill`` at llama31-8b's
              prefill (BH 64, BKV
              16, S 8192, hd 128; timed with its plain version and
              ``scaled_dot_product_attention``, beside its bound, that of
              the 3xTF32 products it runs on the tensor cores, and the f32
              one outside them), gemma3's local layers
              (window 1024, S 4096; timed), hd 160 (G 4), hd 256 (G 1 and
              G 4), bf16 inputs (also with a window), ragged S of 4100 and
              9, a window off the key tiles and a score cap (softcap 2,
              window 512); its build's ptxas registers and spills are
              logged per head dim, and ``cuobjdump -sass`` of the
              library must show tensor-core mma (``HMMA``) and
              asynchronous copies (``LDGSTS`` or ``UTMALDG``).
4. main     — llama31-8b at full width and depth through
              ``repro_torch.launch.serve.run_serve``: batch 2, an 8192-token
              prompt drawn from --seed, 32 greedy decode steps, SOCKET with
              both contiguous-path kernels on.  The decode kernels' launch
              counts must equal layers x decode calls, ``flash_prefill``'s
              layers x 1 (the one whole-prompt prefill).  The same run on
              int8 plane bytes (``socket.bits_storage`` "int8"; the
              ``socket_score[int8]`` entry's launches) must give the same
              greedy tokens as packed words.  The prefill runs
              again through the kernel and once through its plain version
              (the same layout code, the op swapped for its plain version):
              last-token logits within LOGITS_ATOL, layer 0's K/V bit for
              bit, SOCKET bits equal outside |proj| ~ 0; the times and
              peak memory of both are logged.  Then layer by layer, each
              layer's kernel and plain op fed the kernel route's q/k/v:
              every layer's K/V within PREFILL_TOL (atol 1e-5); every
              layer's attention output, held to the plain version in
              float64, within ATTN_TOL of it or, where the plain op itself
              is farther, no farther than the plain op (both in ATTN_TOL
              units), and its largest |error| within F64_RATIO of the
              plain op's; the kernel's distance from the plain op is
              logged.  A wrong head order and a mask one key too wide,
              through the plain op, must fail that gate on every layer.
              Decode step 0 is run again
              on a clone of the prefilled cache through the plain versions;
              its logits must agree with the kernel path's, and the greedy
              tokens of the two paths are compared.  Where the plain
              route's SOCKET top-k differs from the kernel route's only at
              rows whose effective scores lie within SCORE_TOL of the
              threshold, it takes the kernel route's selection there
              (``static_ties_shared``; the split tables move scores a few
              ulps) and the swapped rows are logged; a difference outside
              the band fails.
5. continuous — llama31-8b at full width and depth, the same weights,
              through ``ContinuousBatchingEngine.warmup()`` and
              ``run(realtime=False)``, once with each fused backend
              (``socket_fused``, ``hard_lsh_fused``, ``quest_fused``): 8
              requests (prompts of 1024/2048/3072/4096 tokens from --seed,
              each twice), 32 greedy tokens each, chunked prefill of 512,
              a pool that never preempts.  Every request must finish with
              32 tokens; the backend's paged kernel must launch exactly
              layers x (engine iterations + the 2 warm-up steps) times,
              and no other kernel at all (``flash_prefill`` 0 times: chunks
              attend over the pool).  One decode iteration of the
              engine's state (the widest batch the run held, on a clone of
              the pool) is run again through the kernel and through the
              plain paged path; their logits must agree.  Where the
              plain path's SOCKET selection differs from the kernel's only
              at rows whose effective scores lie within SCORE_TOL of the
              top-k threshold (the kernel check's band: the two sum the
              same fp32 terms in another order), the plain path takes the
              kernel's selection there, and the swapped rows are logged;
              a difference outside the band fails.  Each run's pool
              and snapshot are freed before the next.  Each backend then
              runs again, the same weights and traffic, on int8 and on fp8
              K/V pages (``serving.kv_dtype``), with the same gates; the
              K/V bytes a block id holds and the greedy tokens' agreement
              with the f32 run are logged (a number, not a gate).
6. gemma3-continuous — after llama31-8b's weights are freed, gemma3-27b
              at full width (d_model 5376, 32/16 heads, d_ff 21504, vocab
              262144, window 1024) with its depth cut to 2 groups: 14 of
              its 62 layers, 12 local and 2 global (all 62 do not fit the
              card in fp32), through the same engine entry points with
              ``socket_fused`` and ``use_ring_kernel``: 8 requests (prompts
              of 2048/3072/4096/6144 tokens from --seed, each twice), 32
              greedy tokens each, a 2048-block pool that never preempts.
              ``paged_ring`` must launch exactly 12 x decode calls, the
              paged SOCKET kernel 2 x decode calls, no other kernel at all;
              one decode iteration runs again through the plain routes
              (ring and global), and the logits must agree.  Then again on
              int8 and on fp8 pages, both kernels in that mode.
7. legacy   — the continuous engine's legacy whole-prompt bucketed prefill
              (``prefill_chunk`` 0), f32 pages, ``socket_fused``: llama31-8b
              (after phase 5, the same weights and the 8 requests of its
              case) and gemma3-27b (after phase 6, 14 layers, the ring
              kernel), both in buckets of 2048, 4096 and max_context (4224,
              6272), so half the prompts run padded (llama31-8b's 1024 and
              3072, gemma3's 3072 and 6144) and are read at their last real
              token; each prefill's padded share is logged.
              ``engine.warmup(requests)`` prefills each bucket the prompts
              hit once.  ``flash_prefill``
              must launch layers x (prefills + warm-up buckets) times, the
              paged kernels layers x (engine iterations + the 1 warm-up
              decode step); the decode-iteration logits check of phase 5;
              wall, TTFT, tokens/s and the greedy tokens' agreement with the
              chunked run of the same case (a number, not a gate) logged.

The last line of output is ``{"ok": true, "device": {...}}``; the line before
it lists every kernel's numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside tensor cores
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)    # fp32, another summation order
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)     # fp32 online vs two-pass softmax
# End-to-end step-0 logits, kernel path vs plain path: fp32 through 32
# layers with other summation orders in the two kernels.  Measured 4.5e-6
# on an H100 (|logits| <= 9.3, seed 0); the limit leaves 20x headroom, well
# below the ~1e-2 that one dropped or swapped top-k row moves them.
LOGITS_ATOL = 1e-4
# The prefill kernel against its plain version on N(0, 1) cases: the
# harness's f32 tolerance, for bf16 inputs too (both sides read the same
# bf16 values and compute in f32).  The main phase holds every layer's
# K/V to it layer by layer, both routes fed the kernel route's input to
# the layer (free-running, the routes' float32 differences compound with
# depth: K/V up to 1.8e-5 apart in deep layers, logged, not gated).  The
# layer's attention output is held to the plain version computed in
# float64: the model's scores are far larger than N(0, 1) ones, and
# there the f32 plain op is itself 1.55 to 2.97 x ATTN_TOL from float64
# (llama31-8b, seed 0, an H100), so a kernel that sums its products in
# another order (on the tensor cores, say) cannot come within ATTN_TOL
# of it (3.3 x measured).  So the kernel must come within ATTN_TOL of
# the float64 version or, where the plain op is farther than that, no
# farther than the plain op (measured at most 0.64 of that limit); and
# its largest |error| from the float64 version within F64_RATIO of the
# plain op's (0.49 x).  A wrong head order or mask reads above 1e5 x
# the limit.
PREFILL_TOL = dict(rtol=0.0, atol=1e-5)
F64_RATIO = 2.0
# H100 SXM data sheet, dense tensor-core rates (the prefill kernel's
# 3xTF32 products run at TF32's)
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# the stored K/V page modes the paged kernels are checked in besides f32
# (serving.kv_dtype); int8 and fp8 also get timed entries and main-path
# runs
QUANT_KV_DTYPES = ("bf16", "int8", "fp8")
TIMED_ITERS = 50
GRAPH_REPLAYS = 4
L2_BYTES = 50 * 2 ** 20


def log(*parts) -> None:
    print(*parts, flush=True)


def device_time_ms(fn, input_sets, iters=TIMED_ITERS,
                   replays=GRAPH_REPLAYS) -> float:
    """Device milliseconds of one ``fn(*inputs)``.  ``iters`` calls,
    cycling through ``input_sets`` (sized together past the L2 cache, so
    every call reads its inputs from device memory), are captured in one
    CUDA graph; its ``replays`` are timed with CUDA events, which leaves
    the host's launch cost out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up before capture
        for inputs in input_sets[:3]:
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def back_to_back_ms(fn, input_sets, iters=TIMED_ITERS) -> float:
    """Milliseconds per call of ``iters`` calls launched one after the
    other from Python (CUDA events): the host's launch rate wherever it
    exceeds the device time."""
    for inputs in input_sets[:3]:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*input_sets[i % len(input_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotations(bytes_per_set: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, tol) -> float:
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out.double() - ref.double()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.double().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} exceeds atol "
            f"{tol['atol']} + rtol {tol['rtol']} * |ref|")
    return float(err.max().item())


# ------------------------------------------------------------ phase 2+3

def socket_score_case(dev, gen, *, bh, n, g, l, p, int8, vnorm):
    from repro_torch.core import hashing, socket as sk
    if int8:
        bits = (torch.randint(0, 2, (bh, n, l * p), generator=gen,
                              device=dev, dtype=torch.int8) * 2 - 1)
    else:
        w = hashing.num_words(l, p)
        bits = torch.randint(-2 ** 31, 2 ** 31, (bh, n, w), generator=gen,
                             device=dev, dtype=torch.int32)
    hd = 128
    planes = torch.randn((l, p, hd), generator=gen, device=dev)
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    u = sk.soft_hash_query(planes, q)                     # (BH, G, L, P)
    vn = (torch.rand((bh, n), generator=gen, device=dev) * 4
          if vnorm else None)
    return bits, u, vn


def score_plan_note(ss, label, bits, kw) -> str:
    """The launch plan of a socket_score case, as a log note; raises where
    the case does not exercise what its label names."""
    pl = ss.socket_score_plan(bits, kw["g"], num_tables=kw["l"],
                              num_planes=kw["p"])
    wants = {"main path": pl["C"] > 1 and pl["resident"],
             "BH=256 N=513": pl["C"] == 1 and
             kw["bh"] > pl["clusters_at_once"],
             "P=20 sign-add": pl["instance"] == "sign-add",
             "chunked tables P=16": pl["instance"] == "split" and
             not pl["resident"],
             "chunked sign-add P=24 L=600": pl["instance"] == "sign-add" and
             not pl["resident"]}
    if not wants.get(label, True):
        raise AssertionError(f"socket_score[{label}]: plan {pl} does not "
                             "exercise the case")
    return (f"C {pl['C']}, {pl['clusters_at_once']} clusters at once, "
            f"{pl['smem']} B a CTA, {pl['instance']} instance, tiles of "
            f"<= {pl['tile']} keys, " +
            ("tables resident" if pl["resident"] else
             f"tables in chunks of {pl['tables_a_chunk']}"))


def equal_rows_check(ss, bits, u, args) -> None:
    """Keys given equal bits on every rank of the cluster (and in two
    tiles of a rank) must score bit for bit the same."""
    g = u.shape[1]
    c = ss.socket_score_plan(bits, g, num_tables=args["num_tables"],
                             num_planes=args["num_planes"])["C"]
    rows, runs = ss.key_runs(bits.shape[1], c)
    at = [r0 + k for r0, r1 in runs for k in (0, rows + 3) if r0 + k < r1]
    bits = bits.clone()
    bits[:, at] = bits[:, at[:1]]
    out = ss.launch_socket_score(bits, u, None, **args)
    torch.cuda.synchronize()
    fmt = str(bits.dtype)[6:]
    if not torch.equal(out[:, at], out[:, at[:1]].expand(-1, len(at))):
        raise AssertionError(f"socket_score ({fmt}): keys with equal bits "
                             "on different ranks score differently")
    log(f"socket_score ({fmt}): equal bit rows at keys {at} (C {c}, tiles "
        f"of {rows}) score bit-equal")


def socket_score_row(ss, ref_fn, dev, gen, name, kw, args, bits, u, vn,
                     err) -> dict:
    """The timed entry of a socket_score case: kernel and plain version
    over inputs rotated past the L2 cache, beside the bound."""
    bh, n, g = kw["bh"], kw["n"], kw["g"]
    nbytes = bits.numel() * bits.element_size() + u.numel() * 4 + \
        bh * n * 4 * (2 if vn is not None else 1)
    # what the function needs, not what this kernel does: with P split
    # into two halves, each looked up in a per-(g, l) table of exp(.), a
    # (key, g, l) term is one FMA
    flops = bh * n * g * kw["l"] * 2
    sets = [socket_score_case(dev, gen, **kw)
            for _ in range(rotations(nbytes))]
    kernel = functools.partial(ss.launch_socket_score, **args)
    ms = device_time_ms(kernel, sets)
    plain_ms = device_time_ms(functools.partial(ref_fn, **args), sets)
    bms, by = bound(nbytes, flops)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/socket_score/socket_score.cu",
        replaces="src/repro/kernels/socket_score/socket_score.py:45",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        back_to_back_ms=back_to_back_ms(kernel, sets))


def host_us(fn, input_sets, calls=TIMED_ITERS) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls issued one after
    the other with no synchronize between them (the host's cost to issue
    one, allocations included)."""
    for inputs in input_sets[:3]:
        fn(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*input_sets[i % len(input_sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# the SASS opcodes of asynchronous global-to-shared copies (cp.async, or
# TMA's bulk copies)
ASYNC_COPY_SASS = ("LDGSTS", "UTMALDG")


def sass_counts(lib, opcodes, name) -> dict:
    """How often each of ``opcodes`` appears in ``cuobjdump -sass`` of the
    library ``lib`` (all its kernels), logged; raises if the tool is
    missing."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"{tool} not found: the {name} SASS cannot be "
                           "checked")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = re.findall(r"\b(" + "|".join(opcodes) + r")\b", sass)
    counts = {op: ops.count(op) for op in opcodes}
    log(f"  {name} SASS (cuobjdump -sass, all instantiations): " +
        ", ".join(f"{op} {n}" for op, n in counts.items()))
    return counts


def build_report(source, name):
    """A library's build: ptxas's registers and spills (its build log,
    logged), and its SASS, which must hold asynchronous copies
    (``ASYNC_COPY_SASS``)."""
    from repro_torch.kernels import build
    lib = build.build_library(source)
    log_text = lib.with_suffix(".log").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         log_text)]
    log(f"  {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
        f"spill stores <= {max(spills)} B")
    counts = sass_counts(lib, ASYNC_COPY_SASS, name)
    if not any(counts.values()):
        raise AssertionError(f"{name} SASS has no asynchronous copies: "
                             f"{counts}")
    return counts, dict(registers=max(regs), spill_stores=max(spills))


def flash_decode_rows(dev, gen):
    """``flash_decode`` against its plain version on every case of
    ``cases.CARD_CASES`` (within ATTN_TOL; a fully masked row must return
    exactly 0), each logged with its launch plan and failing where the
    plan does not exercise its label; the main case timed beside its
    bound, the plain version, SDPA with a bool mask and the host's
    microseconds a call."""
    from repro_torch.kernels.flash_decode import cases, ops as fd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    sass, ptxas = build_report(fd.SOURCE, "flash_decode.cu")
    rows = {}
    for label, kw in cases.CARD_CASES:
        q, kk, vv, mask = cases.card_case(gen, **kw)
        scale = 1.0 / math.sqrt(kw["hd"])
        out = fd.launch_flash_decode(q, kk, vv, mask, scale=scale)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, kk, vv, mask, scale=scale)
        err = check_close(f"flash_decode[{label}]", out, ref, ATTN_TOL)
        if kw.get("dead_row") is not None and \
                out[kw["dead_row"]].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode[{label}]: a fully masked "
                                 "row must return 0")
        note = cases.plan_note(fd.flash_decode_plan(q, kk), label, **kw)
        log(f"flash_decode [{label}] BH={kw['bh']} K={kw['k']} G={kw['g']} "
            f"hd={kw['hd']} {str(kw['dtype'])[6:]}: max|err| {err:.3e} "
            f"(rtol {ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}); {note}")
        if label == "main path":
            bh, k, g, hd = kw["bh"], kw["k"], kw["g"], kw["hd"]
            sets = [cases.card_case(gen, **kw)
                    for _ in range(rotations(2 * bh * k * hd * 4))]
            # only the rows the mask keeps need reading and multiplying
            valid = sum(int(s[3].sum().item()) for s in sets) / len(sets)
            nbytes = 2 * bh * g * hd * 4 + 2 * valid * hd * 4 + bh * k
            flops = valid * g * (4 * hd + 4)
            kernel = functools.partial(fd.launch_flash_decode, scale=scale)
            ms = device_time_ms(kernel, sets)
            plain_ms = device_time_ms(
                functools.partial(flash_decode_ref, scale=scale), sets)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = device_time_ms(
                lambda a, b, c, m: sdpa(a[:, None], b[:, None], c[:, None],
                                        attn_mask=m[:, None, None, :],
                                        scale=scale), sets)
            bms, by = bound(nbytes, flops)
            rows["flash_decode"] = dict(
                name="flash_decode", route="cuda",
                source="src/repro_torch/kernels/flash_decode/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode/flash_decode.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                library_call="scaled_dot_product_attention, bool mask",
                back_to_back_ms=back_to_back_ms(kernel, sets),
                host_us=host_us(kernel, sets), plan=note, sass=sass,
                ptxas=ptxas)
            log(f"flash_decode timed: kernel {ms:.4f} ms, bound {bms:.5f} "
                f"({by}), plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, host "
                f"{rows['flash_decode']['host_us']:.1f} us a call")
    return rows


def phase_kernels(dev, seed):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.kernels.socket_score.ref import socket_score_ref

    # -- build: one nvcc per CUDA source, all at once
    t0 = time.perf_counter()
    sources = (ss.SOURCE, fd.SOURCE, pa.SOURCE, pa.QUEST_SOURCE,
               pa.RING_SOURCE, fp.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(build.load_library, sources))
    log(f"build {' + '.join(s.name for s in sources)}: "
        f"{time.perf_counter() - t0:.2f} s")
    for stem, (secs, report) in build.BUILD_LOGS.items():
        log(f"  nvcc {stem}: {secs:.2f} s\n  " +
            report.replace("\n", "\n  "))
    gen = torch.Generator(device=dev).manual_seed(seed)

    rows = {}
    # -- socket_score: main-path shapes first, then the edges
    L, P, G = 60, 10, 4
    main = dict(bh=16, n=8224, g=G, l=L, p=P)
    score_cases = [
        ("main path", dict(main, int8=False, vnorm=False)),
        ("main path + vnorm", dict(main, int8=False, vnorm=True)),
        ("int8 planes", dict(main, int8=True, vnorm=True)),
        ("pooled G=1", dict(main, g=1, int8=False, vnorm=False)),
        ("ragged N, G=1", dict(bh=3, n=1001, g=1, l=L, p=P, int8=False,
                               vnorm=True)),
        ("smoke P=6 L=12", dict(bh=4, n=77, g=2, l=12, p=6, int8=False,
                                vnorm=False)),
        ("G=3 L=9 P=7", dict(bh=6, n=300, g=3, l=9, p=7, int8=False,
                             vnorm=True)),
        ("int8 G=3 L=9 P=7", dict(bh=6, n=300, g=3, l=9, p=7, int8=True,
                                  vnorm=False)),
        ("P=1", dict(bh=6, n=300, g=2, l=5, p=1, int8=False, vnorm=True)),
        ("P=20 sign-add", dict(bh=6, n=300, g=2, l=3, p=20, int8=False,
                               vnorm=True)),
        ("BH=256 N=513", dict(bh=256, n=513, g=G, l=L, p=P, int8=False,
                              vnorm=False)),
        ("chunked tables P=16", dict(bh=4, n=700, g=G, l=L, p=16,
                                     int8=False, vnorm=True)),
        ("chunked sign-add P=24 L=600", dict(bh=2, n=300, g=G, l=600, p=24,
                                             int8=False, vnorm=False)),
    ]
    for label, kw in score_cases:
        bits, u, vn = socket_score_case(dev, gen, **kw)
        args = dict(num_tables=kw["l"], num_planes=kw["p"], tau=0.4)
        out = ss.launch_socket_score(bits, u, vn, **args)
        torch.cuda.synchronize()
        ref = socket_score_ref(bits, u, vn, **args)
        err = check_close(f"socket_score[{label}]", out, ref, SCORE_TOL)
        log(f"socket_score [{label}] {tuple(bits.shape)} "
            f"{str(bits.dtype)[6:]} G={kw['g']}: max|err| {err:.3e} "
            f"(rtol {SCORE_TOL['rtol']}, atol {SCORE_TOL['atol']}); "
            f"{score_plan_note(ss, label, bits, kw)}")
        if label in ("main path", "int8 planes"):
            equal_rows_check(ss, bits, u, args)
            name = "socket_score" + ("[int8]" if kw["int8"] else "")
            rows[name] = socket_score_row(ss, socket_score_ref, dev, gen,
                                          name, kw, args, bits, u, vn, err)

    rows.update(flash_decode_rows(dev, gen))
    rows.update(flash_prefill_rows(dev, seed))
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES:
        rows.update(paged_rows(dev, seed, kv_dtype))
        rows.update(ring_rows(dev, seed, kv_dtype))
    return rows


# The prefill kernel's cases, (label, BH, BKV, S, hd, window, softcap,
# dtype): the main paths' shapes first (llama31-8b's static prefill of
# batch 2; one gemma3 local layer's prompt of 4096), then the edges.
PREFILL_CASES = [
    ("main path: llama31-8b prefill", 64, 16, 8192, 128, 0, 0.0,
     torch.float32),
    ("gemma3 local, window 1024", 32, 16, 4096, 128, 1024, 0.0,
     torch.float32),
    ("stablelm hd 160, G 4", 32, 8, 2048, 160, 0, 0.0, torch.float32),
    ("gemma-7b hd 256, G 1", 16, 16, 2048, 256, 0, 0.0, torch.float32),
    ("bf16 inputs", 64, 16, 2048, 128, 0, 0.0, torch.bfloat16),
    ("ragged S 4100", 32, 8, 4100, 128, 0, 0.0, torch.float32),
    ("softcap 2, window 512", 32, 16, 2048, 128, 512, 2.0, torch.float32),
    ("ragged S 9, G 4", 8, 2, 9, 128, 0, 0.0, torch.float32),
    ("window 1000 off the key tiles, S 2100", 16, 4, 2100, 128, 1000, 0.0,
     torch.float32),
    ("hd 256, G 4", 16, 4, 1100, 256, 0, 0.0, torch.float32),
    ("bf16, window 300", 32, 8, 1500, 128, 300, 0.0, torch.bfloat16),
]
PREFILL_PLAIN_CHUNK = 512        # the plain version's query chunk
# the SASS opcodes of the prefill kernel's design: tensor-core mma
# (HMMA) and asynchronous global-to-shared copies
PREFILL_SASS = ("HMMA",) + ASYNC_COPY_SASS


def prefill_build_report(fp):
    """The prefill library's build: ptxas's registers and spills per
    instantiation (its build log), and the SASS
    opcode counts that show the tensor cores and the asynchronous copies
    at work (``cuobjdump -sass``; raises if the tool is missing or an
    opcode family is absent)."""
    from repro_torch.kernels import build
    lib = build.build_library(fp.SOURCE)
    per_kernel, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"flash_prefill_kernelILi(\d+)E(f|13__nv_bfloat16)",
                      line)
        if "Compiling entry function" in line and m:
            name = (int(m.group(1)), "f32" if m.group(2) == "f" else "bf16")
            per_kernel[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            per_kernel[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            per_kernel[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    for (hd, dt), info in sorted(per_kernel.items()):
        log(f"  flash_prefill hd {hd} {dt}: {info.get('registers')} "
            f"registers, spill stores/loads {info.get('spill_stores')}/"
            f"{info.get('spill_loads')} B")
    if len(per_kernel) != 2 * len(fp.HEAD_DIMS):
        raise AssertionError(f"flash_prefill build log names "
                             f"{sorted(per_kernel)}, not every head dim")
    counts = sass_counts(lib, PREFILL_SASS, "flash_prefill")
    if not counts["HMMA"] or not (counts["LDGSTS"] or counts["UTMALDG"]):
        raise AssertionError(f"flash_prefill SASS lacks tensor-core mma or "
                             f"asynchronous copies: {counts}")
    return counts, {f"hd{hd}_{dt}": info
                    for (hd, dt), info in sorted(per_kernel.items())}


def prefill_cost(bh, bkv, s, hd, window, dtype):
    """Bytes (q and out at BH, k and v at BKV, each once) and operations
    (4 * hd a kept (query, key) pair: q.k and p.v) of the causal
    function."""
    keys = s * (s + 1) // 2 if not window else sum(
        min(i + 1, window) for i in range(s))
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = bh * s * hd * (esize + 4) + 2 * bkv * s * hd * esize
    return float(nbytes), float(4 * hd * bh * keys)


def prefill_bound(nbytes, flops, dtype):
    """The prefill kernel's bound on the compute unit it runs on: its
    products as TF32 tensor-core products at the data sheet's TF32 rate,
    three a product for f32 inputs (3xTF32), and for bf16 ones (exact in
    TF32) one for q.k and two for p.v."""
    products = 3.0 if dtype == torch.float32 else 1.5
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (products * flops / TF32_FLOP_PER_S * 1e3, "operations"))


def flash_prefill_rows(dev, seed):
    """The prefill kernel against its plain version on ``PREFILL_CASES``;
    the main case (and gemma3's local one, logged) timed beside its
    bound, the plain version and ``scaled_dot_product_attention`` (causal,
    or a bool window mask; GQA by ``enable_gqa``)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    sass, ptxas = prefill_build_report(fp)

    def inputs(bh, bkv, s, hd, dtype):
        return tuple(torch.randn((n, s, hd), generator=gen, device=dev)
                     .to(dtype) for n in (bh, bkv, bkv))

    rows = {}
    for label, bh, bkv, s, hd, window, cap, dtype in PREFILL_CASES:
        scale = 1.0 / math.sqrt(hd)
        kw = dict(scale=scale, window=window, softcap=cap)
        plain = functools.partial(flash_prefill_ref, q_chunk=PREFILL_PLAIN_CHUNK,
                                  **kw)
        case = inputs(bh, bkv, s, hd, dtype)
        out = fp.launch_flash_prefill(*case, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash_prefill[{label}]", out, plain(*case),
                          PREFILL_TOL)
        nbytes, flops = prefill_cost(bh, bkv, s, hd, window, dtype)
        bms, by = prefill_bound(nbytes, flops, dtype)
        log(f"flash_prefill [{label}] BH {bh} BKV {bkv} S {s} hd {hd} window "
            f"{window} softcap {cap} {str(dtype)[6:]}: max|err| {err:.3e} "
            f"(atol {PREFILL_TOL['atol']}); bound {bms:.3f} ms ({by})")
        del out
        if not label.startswith(("main path", "gemma3 local")):
            continue
        sets = [case] + [inputs(bh, bkv, s, hd, dtype)
                         for _ in range(rotations(nbytes) - 1)]
        kernel = functools.partial(fp.launch_flash_prefill, **kw)
        ms = device_time_ms(kernel, sets, iters=4, replays=2)
        plain_ms = device_time_ms(plain, sets, iters=2, replays=1)
        # the library call: SDPA in fp32 through the memory-efficient
        # backend (fp32 rules out flash; the math backend would build the
        # (BH, S, S) logits), GQA by enable_gqa, the window as a bool mask
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & \
                (i[:, None] - i[None, :] < window)

        def lib(q, k, v, gqa=True):
            return sdpa(q[None], k[None], v[None], attn_mask=mask,
                        is_causal=mask is None, scale=scale,
                        enable_gqa=gqa)[0]

        lib_sets, call = sets, "enable_gqa"
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # why each backend
                    want = lib(*case)                 # declined
            except RuntimeError as e:
                # this backend takes no GQA: K/V repeated to the query
                # heads beforehand (not timed)
                log(f"  SDPA with enable_gqa: {e}".splitlines()[0])
                g = bh // bkv
                lib_sets = [(q, k.repeat_interleave(g, 0),
                             v.repeat_interleave(g, 0)) for q, k, v in sets]
                lib = functools.partial(lib, gqa=False)
                call = "K/V repeated to the query heads beforehand"
                want = lib(*lib_sets[0])
            check_close(f"flash_prefill[{label}, SDPA yardstick]", want,
                        plain(*case), ATTN_TOL)
            del want
            lib_ms = device_time_ms(lib, lib_sets, iters=4, replays=2)
        del lib_sets
        b2b = back_to_back_ms(kernel, sets, iters=4)
        log(f"flash_prefill [{label}] kernel {ms:.3f} ms, plain {plain_ms:.3f}"
            f" ms, SDPA {lib_ms:.3f} ms, back to back {b2b:.3f} ms; bound "
            f"{bms:.3f} ms by {by} on the tensor cores, {ms / bms:.2f}x "
            f"(3xTF32 {3 * flops / TF32_FLOP_PER_S * 1e3:.3f}, TF32 "
            f"{flops / TF32_FLOP_PER_S * 1e3:.3f}, bf16 "
            f"{flops / BF16_FLOP_PER_S * 1e3:.3f} ms; f32 outside them "
            f"{flops / FP32_FLOP_PER_S * 1e3:.3f} ms)")
        if label.startswith("main path"):
            rows["flash_prefill"] = dict(
                name="flash_prefill", route="cuda",
                source="src/repro_torch/kernels/flash_prefill/"
                       "flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill/"
                         "flash_prefill.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                library_call="scaled_dot_product_attention, fp32, "
                             f"is_causal, {call} (memory-efficient "
                             "backend)",
                bound_3xtf32_ms=3 * flops / TF32_FLOP_PER_S * 1e3,
                bound_f32_ms=flops / FP32_FLOP_PER_S * 1e3,
                bound_tf32_ms=flops / TF32_FLOP_PER_S * 1e3,
                bound_bf16_ms=flops / BF16_FLOP_PER_S * 1e3,
                back_to_back_ms=b2b, sass=sass, ptxas=ptxas)
        del sets, case
    return rows


# The fused paged kernels' cases: the continuous phase's shapes first
# (8 KV heads, G=4, hd=128, bs=16; contexts 1-4K, a 264-block table), then
# the edges.  The last ones exercise the cluster split of
# paged_attention.cu and paged_quest.cu: 32K contexts (several tiles or
# chunks of bounds a rank), a tie-heavy case at sparsity 2 whose selected
# ties span ranks, requests shorter than one rank's range (whole ranks
# idle) and, for SOCKET and hard LSH, pooled selection (GS 1).
MAIN_LENS = [1024, 2048, 3072, 4096, 1024, 2048, 3072, 4096]
_CLUSTER_CASES = [
    ("32K contexts", dict(lengths=[32768, 20000, 9000, 32000], nb=2048)),
    ("ties across ranks", dict(lengths=[600, 1500, 2900, 333], nb=200,
                               sink=16, window=16, ties=True,
                               sparsity=2.0)),
    ("idle ranks", dict(lengths=[5, 4096, 17, 1000], nb=264)),
    ("pooled GS 1", dict(lengths=MAIN_LENS, nb=264, pooled=True)),
]
# the cases also run on stored pools (bf16, int8, fp8)
STORED_CASES = ("main path", "tie-heavy") + tuple(c[0] for c in
                                                  _CLUSTER_CASES)
PAGED_CASES = {
    "paged_attention": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("short tables, sink/window 16", dict(lengths=[33, 600, 1500, 57],
                                              nb=96, sink=16, window=16)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16,
                           window=16, ties=True)),
        # the gemma3 continuous phase's global layers: KVH 16, G 2
        ("gemma3 global layers, KVH 16 G 2",
         dict(lengths=[2080, 3104, 4128, 6176, 2079, 3103, 4127, 6175],
              nb=392, kvh=16, g=2)),
        *_CLUSTER_CASES,
    ],
    "paged_hard_lsh": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("l=37 unaligned tables", dict(lengths=[33, 600, 1500, 57], nb=96,
                                       l=37, sink=16, window=16)),
        *_CLUSTER_CASES,
    ],
    "paged_quest": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > live pages", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("ps=8, two pages a block", dict(lengths=[33, 600, 1500, 57], nb=96,
                                         ps=8, sink=16, window=16)),
        _CLUSTER_CASES[0],
        # a table of more than 256 pages (two ranks or more) and a request
        # with more live pages than the budget, so ties are cut
        ("ties across ranks", dict(lengths=[600, 1500, 5800, 333], nb=520,
                                   sink=16, window=16, ties=True,
                                   sparsity=2.0)),
        _CLUSTER_CASES[2],
    ],
}


def kv_row_bytes(case, scales) -> int:
    """Bytes of one K and one V row of ``case``'s pool, with their scales
    when it has them (int8/fp8: 2 * (hd + 4))."""
    kp = case[1]
    return 2 * (kp.shape[-1] * kp.element_size() + (4 if scales else 0))


def lsh_cost(case, args, hard, row_bytes):
    """Bytes and operations the SOCKET (or hard-LSH) function must spend
    on ``case``: the bits and vnorm of each scored token, and the query
    hash, only for requests whose budget exceeds their forced sink and
    window rows (elsewhere the selection is those rows, whatever the
    scores); the selected K/V rows (``row_bytes`` each, scales included),
    forced ones included; q, the table, the output.  Operations: one FMA
    (P split into table lookups) or one compare per (scored token, g, l);
    q.k and p.v per selected row.  Returns (bytes, operations, bytes of
    the pool rows touched)."""
    q, bits, qhash, bt = case[0], case[3], case[5], case[6]
    lens, budget = case[7].cpu().long(), case[8].cpu().long()
    b, kvh, g, hd = q.shape
    w = bits.shape[-1]
    gs, l, p = qhash.shape[2:]
    forced = torch.clamp(lens, max=args["sink_tokens"] + args["window_tokens"])
    live = budget > forced
    scored = int(torch.where(live, lens - forced, 0).sum())
    nsel = int(torch.minimum(budget, lens).sum())
    touched = kvh * (scored * (w * 4 + 2) + nsel * row_bytes)
    nbytes = touched + kvh * (b * 2 * g * hd * 4 +
                              int(live.sum()) * gs * l * p * 4) + \
        bt.numel() * 4
    flops = kvh * (scored * g * l * (1 if hard else 2) + nsel * g * 4 * hd)
    return float(nbytes), float(flops), float(touched)


def quest_cost(case, args, sel, row_bytes):
    """As :func:`lsh_cost` for Quest: kmin and kmax (f32) of each live
    page that is neither sink nor window (for requests whose page budget
    exceeds those forced pages), the selected live K/V rows, q, the
    table, the output; 4 operations per (scored page, g, d), q.k and p.v
    per row."""
    q, bt, length, budget = case[0], case[5], case[6], case[7]
    b, kvh, g, hd = q.shape
    ps, sink = args["page_size"], args["sink_tokens"]
    window = args["window_tokens"]
    scored = 0
    for n, kp in zip(length.tolist(), budget.tolist()):
        start = torch.arange(-(-n // ps)) * ps
        free = (start >= sink) & (start < n - window - ps)
        if kp > len(start) - int(free.sum()):
            scored += int(free.sum())
    nsel = int(sel.sum())
    touched = kvh * scored * 2 * hd * 4 + nsel * row_bytes
    nbytes = touched + b * kvh * 2 * g * hd * 4 + bt.numel() * 4
    flops = kvh * scored * g * hd * 4 + nsel * g * 4 * hd
    return float(nbytes), float(flops), float(touched)


def paged_kernels():
    """name -> (source, replaces, seed offset, case builder, launch, check
    returning (max |err|, note), plain version of a case's args, cost).
    Checks take the case's scale pools (``cases.store_kv``), plain versions
    and costs the same, costs the bytes of one K and V row too."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    from repro_torch.kernels.paged_attention import ref

    def top_k(sets, kw):
        return min(kw["nb"] * 16, int(sets[0][8].max()))

    def check_socket(out, sel, case, args, kw, scales):
        err, near = cases.check_paged(out, sel, case, args,
                                      ties=kw.get("ties", False),
                                      attn_tol=ATTN_TOL, score_tol=SCORE_TOL,
                                      scales=scales)
        return err, (f"budgets {case[8].tolist()}; selection equal" +
                     (f" but {near} rows within the threshold band"
                      if near else ""))

    def check_hard(out, sel, case, args, kw, scales):
        err = cases.check_hard_lsh(out, sel, case, args, attn_tol=ATTN_TOL,
                                   scales=scales)
        eff = cases.plain_hard_eff(case, args)
        return err, (f"budgets {case[8].tolist()}; selection equal bit for "
                     f"bit; {int((eff == 0).sum())} of {eff.numel()} scored "
                     "rows score exactly 0")

    def check_quest(out, sel, case, args, kw, scales):
        err = cases.check_quest(out, sel, case, args, attn_tol=ATTN_TOL,
                                scales=scales)
        return err, (f"page budget {int(case[7][0])} of "
                     f"{kw['nb'] * 16 // args['page_size']}; selection equal "
                     f"bit for bit, {int(sel.sum().item())} rows")

    def plain_socket(sets, args, kw, scales):
        tk = top_k(sets, kw)
        return lambda q, kp, vp, bits, vn, u, bt, length, budget: \
            ref.paged_socket_attend_ref(q, kp, vp, bits, vn, u, bt,
                                        length=length, budget=budget,
                                        top_k=tk, **args, **scales)

    def plain_hard(sets, args, kw, scales):
        tk = top_k(sets, kw)
        return lambda q, kp, vp, bits, vn, us, bt, length, budget: \
            ref.paged_hard_lsh_attend_ref(q, kp, vp, bits, vn, us, bt,
                                          length=length, budget=budget,
                                          top_k=tk, **args, **scales)

    def plain_quest(sets, args, kw, scales):
        pb = int(sets[0][7][0])
        return lambda q, kp, vp, kmin, kmax, bt, length, _budget: \
            ref.paged_quest_attend_ref(q, kp, vp, kmin, kmax, bt,
                                       length=length, page_budget=pb, **args,
                                       **scales)

    src = "src/repro_torch/kernels/paged_attention/"
    tpu = "src/repro/kernels/paged_attention/"
    return {
        "paged_attention": (
            src + "paged_attention.cu", tpu + "paged_attention.py:69", 7,
            cases.paged_case, pa.launch_paged_socket_attend, check_socket,
            plain_socket,
            lambda case, args, sel, rb: lsh_cost(case, args, False, rb)),
        "paged_hard_lsh": (
            src + "paged_attention.cu", tpu + "paged_hard_lsh.py:45", 11,
            cases.hard_lsh_case, pa.launch_paged_hard_lsh_attend, check_hard,
            plain_hard,
            lambda case, args, sel, rb: lsh_cost(case, args, True, rb)),
        "paged_quest": (
            src + "paged_quest.cu", tpu + "paged_quest.py:46", 13,
            cases.quest_case, pa.launch_paged_quest_attend, check_quest,
            plain_quest, quest_cost),
    }


def cluster_note(name, label, case, args, sel) -> str:
    """The cluster split ``paged_attention.cu`` or ``paged_quest.cu`` ran
    ``case`` with, and that the cluster cases exercise it: selected ties
    of one (request, head) on two or more ranks; ranks with no live
    block; Quest's main path split over two ranks or more."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    quest = name == "paged_quest"
    q, kp = case[0], case[1]
    bt, length, budget = case[5:8] if quest else case[6:9]
    if quest:
        plan = pa.paged_quest_plan(q, kp, bt, page_size=args["page_size"])
    else:
        plan = pa.paged_attention_plan(q, kp, case[3], case[5], bt,
                                       hard=name == "paged_hard_lsh")
    c, bs = plan["cluster"], kp.shape[2]
    note = (f"C {c} ({plan['clusters_at_once']} clusters at once), "
            f"{plan['smem_bytes']} B a CTA, {plan['stages']} K/V stages")
    if quest and label.startswith("main path") and c < 2:
        raise AssertionError("paged_quest: the main path ran on one rank a "
                             "(request, head), not a cluster")
    if label == "ties across ranks" and name != "paged_hard_lsh":
        if quest:
            ps = args["page_size"]
            eff = cases.quest_page_eff(case, args).cpu()
            spread = cases.tie_ranks(
                eff, cases.quest_page_selection(sel.cpu(), ps),
                (length.cpu() + ps - 1) // ps, budget.cpu(), bs=bs // ps,
                c=c)
        else:
            eff = cases.plain_eff(case, args).cpu()
            spread = cases.tie_ranks(eff, sel.reshape(eff.shape).cpu(),
                                     length.cpu(), budget.cpu(), bs=bs, c=c)
        if spread < 2 or quest and not cases.ties_cut(
                eff, cases.quest_page_selection(sel.cpu(), args["page_size"])):
            raise AssertionError("the tie case's selected ties lie on one "
                                 "rank, or all of them are selected: it does "
                                 "not test the carried count")
        note += f"; selected ties on up to {spread} ranks"
    if label == "idle ranks":
        idle = sum(r0 == r1 for n in length.tolist()
                   for r0, r1 in cases.cta_ranges(n, bs, c))
        if not idle:
            raise AssertionError("the idle-ranks case left no rank idle")
        note += f"; {idle} idle ranks"
    return note


def paged_rows(dev, seed, kv_dtype="auto"):
    """Each fused paged kernel against its plain version at the continuous
    path's shapes and edges, its pool's K/V pages stored as ``kv_dtype``
    (``auto``: f32 and every case of ``PAGED_CASES``; else the main case
    and the tie-heavy one, stored by ``cases.store_kv``, where SOCKET's
    and hard LSH's selections must also equal the kernel's on the f32
    pages of the same case); times at the main shapes, entries named
    ``name`` or ``name[kv_dtype]``."""
    from repro_torch.kernels.paged_attention import cases
    rows = {}
    for name, (source, replaces, offset, build, launch, check, plain,
               cost) in paged_kernels().items():
        gen = torch.Generator(device=dev).manual_seed(seed + offset)
        quest = name == "paged_quest"
        for label, kw in PAGED_CASES[name]:
            if kv_dtype != "auto" and not label.startswith(STORED_CASES):
                continue
            sets, args = build(gen, **kw)
            out32, sel32 = None, None
            scales = {}
            if kv_dtype != "auto":
                if not quest:
                    out32, sel32 = launch(*sets[0], with_selection=True,
                                          **args)
                sets, scales = cases.store_kv(sets, kv_dtype, quest=quest)
            out, sel = launch(*sets[0], with_selection=True, **args,
                              **scales)
            torch.cuda.synchronize()
            try:
                err, note = check(out, sel, sets[0], args, kw, scales)
                if sel32 is not None and not torch.equal(sel, sel32):
                    raise AssertionError(
                        f"{name}: the selection on {kv_dtype} pages differs "
                        "from the one on the f32 pages of the same case")
            except AssertionError as e:
                raise AssertionError(f"[{kv_dtype}, {label}] {e}") from None
            if sel32 is not None:
                note += "; selection equal to the f32 pages' bit for bit"
            note += "; " + cluster_note(name, label, sets[0], args, sel)
            log(f"{name} [{kv_dtype}, {label}] lengths {kw['lengths']}: "
                f"max|err| {err:.3e} (rtol {ATTN_TOL['rtol']}, atol "
                f"{ATTN_TOL['atol']}); {note}")
            del out32, sel32
            if not label.startswith("main path") or kv_dtype == "bf16":
                continue
            row_b = kv_row_bytes(sets[0], scales)
            nbytes, flops, touched = cost(sets[0], args, sel, row_b)
            sets, args = build(gen, copies=rotations(touched), **kw)
            if kv_dtype != "auto":
                sets, scales = cases.store_kv(sets, kv_dtype, quest=quest)
            kernel = functools.partial(launch, **args, **scales)
            ms = device_time_ms(kernel, sets)
            plain_ms = device_time_ms(plain(sets, args, kw, scales),
                                      sets[:2])
            bms, by = bound(nbytes, flops)
            key = name if kv_dtype == "auto" else f"{name}[{kv_dtype}]"
            rows[key] = dict(
                name=key, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                back_to_back_ms=back_to_back_ms(kernel, sets))
            del sets
    return rows


def ring_rows(dev, seed, kv_dtype="auto"):
    """The ring kernel against its plain version on ``cases.RING_CASES``
    (dead slots and the trash page hold NaN, which the kernel must skip),
    its pool stored as ``kv_dtype`` (``auto``: f32; else stored by
    ``cases.store_kv``, dead rows NaN in their scales and fp8 payloads
    too), each case logged with its launch plan (``ops.paged_ring_plan``,
    raising where it does not exercise the case's label); times at the
    main shape, and at B 2 (``b2``), beside the bound, the plain version
    and, for f32 pages, ``scaled_dot_product_attention`` over the
    pre-gathered ring views (``library_ms``) and the gather from the
    pool, the window mask and SDPA timed as one callable
    (``library_with_gather_ms``; no one PyTorch call dequantizes and
    attends: ``library_ms`` null)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    timed = {}
    for label, kw in cases.RING_CASES:
        sets, args = cases.ring_case(gen, **kw)
        sets, scales = (sets, {}) if kv_dtype == "auto" else \
            cases.store_kv(sets, kv_dtype)
        case = sets[0]
        out = pa.launch_paged_ring_attend(*case, **args, **scales)
        torch.cuda.synchronize()
        try:
            err = cases.check_ring(out, case, args, attn_tol=ATTN_TOL,
                                   scales=scales)
            note = cases.ring_plan_note(
                pa.paged_ring_plan(case[0], case[1], case[3],
                                   window=args["window"]), case, args, label)
        except AssertionError as e:
            raise AssertionError(f"[{kv_dtype}, {label}] {e}") from None
        q, kp, _, bt, pos = case
        b, kvh, g, hd = q.shape
        cap = bt.shape[1] * kp.shape[2]
        live = cases.ring_live(pos, cap, args["window"])
        log(f"paged_ring [{kv_dtype}, {label}] positions {kw['positions']} "
            f"KVH {kvh} G {g} hd {hd} window {args['window']} softcap "
            f"{args['softcap']}: max|err| {err:.3e} (rtol "
            f"{ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}); "
            f"{int(live.sum())} live of {b * cap} slots, dead ones NaN; "
            f"{note}")
        if label.startswith(cases.RING_TIMED) and kv_dtype != "bf16":
            timed[label] = ring_timing(dev, gen, kw, kv_dtype, case, scales,
                                       err, note)
    if not timed:                         # bf16: checked, not timed
        return {}
    row = timed.pop(next(k for k in timed if k.startswith("main path")))
    row["b2"] = timed.pop("B 2")
    key = "paged_ring" if kv_dtype == "auto" else f"paged_ring[{kv_dtype}]"
    return {key: dict(
        name=key, route="cuda",
        source="src/repro_torch/kernels/paged_attention/paged_ring.cu",
        replaces="src/repro/kernels/paged_attention/paged_ring.py:42",
        **row)}


def ring_timing(dev, gen, kw, kv_dtype, case, scales, err, note) -> dict:
    """The ring kernel's time on the shape of ``case`` (a ring case's
    ``kw``, inputs rotated past the L2 cache) beside its bound, its plain
    version and, on f32 pages, SDPA without and with the gather (see
    :func:`ring_rows`)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_ring_attend_ref
    from repro_torch.models.backends.base import gather_block_leaf
    q, kp, _, bt, pos = case
    b, kvh, g, hd = q.shape
    cap = bt.shape[1] * kp.shape[2]
    window = kw.get("window", 1024)
    nlive = int(cases.ring_live(pos, cap, window).sum())
    # the live K/V rows once (scales included), q, the output, the table
    # and positions
    nbytes = kvh * nlive * kv_row_bytes(case, scales) + \
        2 * b * kvh * g * hd * 4 + bt.numel() * 4 + b * 4
    flops = kvh * nlive * g * 4 * hd
    sets, args = cases.ring_case(gen, copies=rotations(nbytes), **kw)
    if kv_dtype != "auto":
        sets, scales = cases.store_kv(sets, kv_dtype)
    kernel = functools.partial(pa.launch_paged_ring_attend, **args, **scales)
    ms = device_time_ms(kernel, sets)
    plain_ms = device_time_ms(
        lambda q, kp, vp, bt, pos: paged_ring_attend_ref(
            q, kp, vp, bt, pos=pos, **args, **scales), sets[:2])
    lib_ms, extra = None, {}
    if kv_dtype == "auto":
        # the library call: SDPA over the ring views gathered beforehand
        # (the gather, which the kernel does itself, is not timed), the
        # query group as SDPA's L axis, the window mask as a bool mask
        views = [(q, gather_block_leaf(kp, bt).nan_to_num(0.0),
                  gather_block_leaf(vp, bt).nan_to_num(0.0),
                  cases.ring_live(pos, cap, args["window"])[:, None, None])
                 for q, kp, vp, bt, pos in sets]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = functools.partial(sdpa, scale=args["scale"])
        check_close("paged_ring[SDPA yardstick]",
                    lib(*views[0][:3], attn_mask=views[0][3]),
                    cases.plain_ring(sets[0], args), ATTN_TOL)
        lib_ms = device_time_ms(
            lambda q, k, v, m: lib(q, k, v, attn_mask=m), views)
        del views

        # the same call with the gather from the pool and the window mask
        # inside it: the whole function, as the kernel does it
        def gather_sdpa(q, kp, vp, bt, pos):
            live = cases.ring_live(pos, cap, args["window"])
            return lib(q, gather_block_leaf(kp, bt).nan_to_num(0.0),
                       gather_block_leaf(vp, bt).nan_to_num(0.0),
                       attn_mask=live[:, None, None])

        check_close("paged_ring[gather + SDPA yardstick]",
                    gather_sdpa(*sets[0]), cases.plain_ring(sets[0], args),
                    ATTN_TOL)
        gather_ms = device_time_ms(gather_sdpa, sets)
        extra = dict(library_call="scaled_dot_product_attention over "
                     "the ring views gathered beforehand (gather not "
                     "timed), bool window mask",
                     library_with_gather_ms=gather_ms,
                     library_with_gather_call="gather_block_leaf of "
                     "K and V, nan_to_num, the window mask and "
                     "scaled_dot_product_attention, one callable")
    bms, by = bound(nbytes, flops)
    log(f"paged_ring [{kv_dtype}] B {b} timed: kernel {ms:.4f} ms, bound "
        f"{bms:.4f} ({by}), plain {plain_ms:.4f}" +
        (f", SDPA over gathered views {lib_ms:.4f}, gather + mask + SDPA "
         f"{extra['library_with_gather_ms']:.4f}" if lib_ms else "") +
        f"; {note}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, **extra,
                back_to_back_ms=back_to_back_ms(kernel, sets))


# --------------------------------------------------------------- phase 4

@torch.no_grad()
def prefill_routes(cfg, params, prompt, capacity, dev):
    """The static prefill three more times, the plain op swapped in for
    ``attention``'s reference to ``flash_prefill`` (the same head layout,
    flattening and merge):

    * through the kernel and through the plain op, each route's layers fed
      by its own earlier layers: the last-token logits within
      LOGITS_ATOL, layer 0's K/V bit for bit, SOCKET bits bitwise outside
      |proj| ~ 0; the deeper layers' K/V drift logged;
    * layer by layer: every layer's call runs the kernel and the plain op
      on the same q/k/v, the kernel route's, and goes on with the
      kernel's output.  Both routes' K/V of a layer are then projected
      from the same input before any attention (equal to the kernel
      route's bit for bit, gated at PREFILL_TOL), and each layer's
      attention output is held to the plain version in float64: within
      ATTN_TOL of it or, where the plain op is farther, no farther than
      the plain op (in ATTN_TOL units), its largest |error| within
      F64_RATIO of the plain op's; the kernel's distance from the plain
      op is logged.  The same inputs through two deliberately wrong ops
      (K/V row ``bh % BKV`` for ``bh // G``, a head order G = 1 cannot
      tell apart; each query seeing one key too many) give the readings
      a fault would, which must fail that gate.

    Returns the kernel route's (logits, caches) and the stats (times and
    peak memory of the first two)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.models import attention
    from repro_torch.runtime.steps import make_prefill_step

    def plain_op(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
        return flash_prefill_ref(q, k, v, scale=scale, window=window,
                                 softcap=softcap,
                                 q_chunk=q_chunk or PREFILL_PLAIN_CHUNK)

    layers = []

    def both_ops(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
        kw = dict(scale=scale, window=window, softcap=softcap)
        out = fp.launch_flash_prefill(q, k, v, **kw)
        plain = plain_op(q, k, v, **kw)
        exact = plain_op(q.double(), k.double(), v.double(), **kw)
        row = dict(err=(out - plain).abs().max().item(),
                   ratio=tol_ratio(out, plain),
                   ratio_f64=tol_ratio(out, exact),
                   plain_ratio_f64=tol_ratio(plain, exact),
                   max_abs=plain.abs().max().item(),
                   kernel_vs_f64=(out - exact).abs().max().item(),
                   plain_vs_f64=(plain - exact).abs().max().item())
        del plain
        # two faults a kernel could have: K/V row bh % BKV for bh // G (a
        # head order G = 1 cannot tell apart), and one key too many (each
        # query also sees the next: the mask shifted by one)
        g = q.shape[0] // k.shape[0]
        wrong = plain_op(q, k.repeat(g, 1, 1), v.repeat(g, 1, 1), **kw)
        row["head_order_ratio"] = tol_ratio(wrong, exact)
        ahead = torch.cat([q[:, :1], q[:, :-1]], dim=1)
        wrong = plain_op(ahead, k, v, **kw)[:, 1:]
        row["next_key_ratio"] = tol_ratio(wrong, exact[:, :-1])
        # the gate's limit: ATTN_TOL, or the plain op's own distance
        row["limit"] = max(1.0, row["plain_ratio_f64"])
        layers.append(row)
        return out

    def prefill(op):
        with mock.patch.object(attention.fp_ops, "flash_prefill", op):
            return make_prefill_step(cfg, capacity)(params,
                                                    {"tokens": prompt})

    stats, routes = {}, {}
    for route, op in (("kernel", fp.flash_prefill), ("plain", plain_op)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        routes[route] = prefill(op)
        torch.cuda.synchronize()
        stats[f"prefill_s_{route}"] = time.perf_counter() - t0
        stats[f"prefill_peak_bytes_above_weights_{route}"] = \
            torch.cuda.max_memory_allocated(dev) - base
    (lk, ck), (lp, cp) = routes.pop("kernel"), routes.pop("plain")
    err = (lk - lp).abs().max().item()
    drift = [max((a[n] - b[n]).abs().max().item() for n in "kv")
             for a, b in zip(ck, cp)]
    stats.update(prefill_socket_checks(cfg, params, prompt, ck, cp))
    del lp, cp                  # before the layer-by-layer caches
    _, cf = prefill(both_ops)
    kv_err = [max((a[n] - b[n]).abs().max().item() for n in "kv")
              for a, b in zip(ck, cf)]
    del cf
    worst = max(range(len(layers)),
                key=lambda i: layers[i]["ratio_f64"] / layers[i]["limit"])
    f64 = max(r["kernel_vs_f64"] / r["plain_vs_f64"] for r in layers)
    stats.update(prefill_logits_err=err, prefill_kv_drift_by_layer=drift,
                 prefill_kv_err_by_layer=kv_err,
                 prefill_attention_by_layer=layers)
    w = layers[worst]
    log(f"prefill, kernel vs plain op: max|logits err| {err:.3e} (atol "
        f"{LOGITS_ATOL}); layer 0 K/V {drift[0]:.1e}; free-running K/V "
        f"drift {max(drift):.3e} (not a gate); "
        f"{stats['prefill_bit_flips']} SOCKET signs flipped, all among the "
        f"{stats['prefill_bits_near_zero']} with |proj| ~ 0; kernel "
        f"{stats['prefill_s_kernel']:.3f} s, plain "
        f"{stats['prefill_s_plain']:.3f} s")
    log(f"prefill layer by layer, both ops fed the kernel route's q/k/v: "
        f"max|K/V err| {max(kv_err):.1e} (atol {PREFILL_TOL['atol']}); "
        f"attention output from the float64 version, in ATTN_TOL units "
        f"(rtol {ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}): the kernel "
        f"{min(r['ratio_f64'] for r in layers):.3f} to "
        f"{max(r['ratio_f64'] for r in layers):.3f}, the plain op "
        f"{min(r['plain_ratio_f64'] for r in layers):.3f} to "
        f"{max(r['plain_ratio_f64'] for r in layers):.3f}; the kernel at "
        f"most {w['ratio_f64'] / w['limit']:.3f} of its limit (layer "
        f"{worst}: kernel {w['ratio_f64']:.3f}, limit {w['limit']:.3f}, "
        f"max|out| {w['max_abs']:.3f}, max|err| kernel "
        f"{w['kernel_vs_f64']:.3e}, plain {w['plain_vs_f64']:.3e}); over "
        f"all layers max|err| of the kernel at most {f64:.3f}x the plain "
        f"op's (limit {F64_RATIO}); kernel vs plain op (not a gate) "
        f"{min(r['ratio'] for r in layers):.3f} to "
        f"{max(r['ratio'] for r in layers):.3f} of ATTN_TOL, max|err| "
        f"{max(r['err'] for r in layers):.3e}; a wrong head order reads "
        f"{min(r['head_order_ratio'] / r['limit'] for r in layers):.3g}x "
        f"the limit or more, one key too many "
        f"{min(r['next_key_ratio'] / r['limit'] for r in layers):.3g}x or "
        f"more")
    if err > LOGITS_ATOL or drift[0] != 0.0 or \
            max(kv_err) > PREFILL_TOL["atol"] or \
            w["ratio_f64"] > w["limit"] or f64 > F64_RATIO:
        raise AssertionError(f"prefill routes differ: logits {err:.3e}, "
                             f"layer 0 K/V {drift[0]:.3e}, layer by layer "
                             f"K/V {max(kv_err):.3e}; layer {worst}'s "
                             "attention from float64 at "
                             f"{w['ratio_f64']:.3f} of ATTN_TOL, limit "
                             f"{w['limit']:.3f}; the kernel's max|err| "
                             f"{f64:.3f}x the plain op's")
    if len(layers) != cfg.num_layers or min(
            min(r["head_order_ratio"], r["next_key_ratio"]) / r["limit"]
            for r in layers) <= 1.0:
        raise AssertionError("the layer-by-layer gate cannot see a wrong "
                             "head order or mask")
    return lk, ck, stats


def tol_ratio(out, ref, tol=ATTN_TOL) -> float:
    """max |out - ref| / (atol + rtol |ref|): above 1 fails ``tol``."""
    err = (out.double() - ref.double()).abs()
    return (err / (tol["atol"] + tol["rtol"] * ref.double().abs())) \
        .max().item()


def prefill_socket_checks(cfg, params, prompt, ck, cp):
    """SOCKET bits of the kernel route's caches ``ck`` and the plain
    route's ``cp``: equal wherever a key's projection is clear of
    rounding (|proj| > 1e-5 x the sum of |terms|)."""
    from repro_torch.core import hashing
    s, t = cfg.socket, prompt.shape[1]
    flips, band = 0, 0
    for i, (a, b) in enumerate(zip(ck, cp)):
        sa = hashing.unpack_signs(a["bits"], s.num_tables,
                                  s.num_planes)[:, :, :t]
        sb = hashing.unpack_signs(b["bits"], s.num_tables,
                                  s.num_planes)[:, :, :t]
        w = params["layers"][i]["attn"]["hash_w"].double()
        keys = a["k"][:, :, :t].double()
        proj = torch.einsum("bhnd,lpd->bhnlp", keys, w)
        mag = torch.einsum("bhnd,lpd->bhnlp", keys.abs(), w.abs())
        near = proj.abs() <= 1e-5 * mag
        if bool((sa != sb)[~near].any()):
            raise AssertionError(f"layer {i}: SOCKET bits of the kernel and "
                                 "plain prefills differ where |proj| is "
                                 "clear of rounding")
        flips += int((sa != sb).sum().item())
        band += int(near.sum().item())
        del sa, sb, proj, mag, near
    return dict(prefill_bit_flips=flips, prefill_bits_near_zero=band)


def phase_main(dev, seed, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import apply_backend_arg, run_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_serve_step

    arch, batch, prompt_len, steps = "llama31-8b", 2, 8192, 32
    cfg = apply_backend_arg(get_config(arch), "socket").replace(
        attn_q_chunk=512)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"main: {arch} {cfg.param_count() / 1e9:.3f} B params "
        f"(fp32) drawn in {time.perf_counter() - t0:.1f} s; batch {batch}, "
        f"prompt {prompt_len}, {steps} decode steps")

    torch.cuda.reset_peak_memory_stats(dev)
    ss.LAUNCHES = fd.LAUNCHES = fp.LAUNCHES = 0
    toks, prefill_s, decode_s = run_serve(cfg, batch, prompt_len, steps,
                                          seed=seed, prompt=prompt,
                                          params=params, device=dev)
    launches = {"socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES,
                "flash_prefill": fp.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    # the decode kernels: layers x (steps + the warm-up step); the
    # prefill kernel: layers x the one whole-prompt prefill
    expected = {"socket_score": cfg.num_layers * (steps + 1),
                "flash_decode": cfg.num_layers * (steps + 1),
                "flash_prefill": cfg.num_layers}
    for name, count in launches.items():
        if count != expected[name]:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {expected[name]}")
    if tuple(toks.shape) != (batch, steps + 1) or not bool(
            ((toks >= 0) & (toks < cfg.padded_vocab())).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    log(json.dumps({
        "main_path": arch, "batch": batch, "prompt_len": prompt_len,
        "decode_steps": steps, "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": batch * steps / decode_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "expected_launches": expected, "card": card}))

    # the same run on int8 plane bytes (socket.bits_storage "int8"): the
    # kernel forms the same words from their sign bits, so the scores, and
    # with them every greedy token, equal the packed run's
    cfg8 = cfg.replace(socket=dataclasses.replace(cfg.socket,
                                                  bits_storage="int8"))
    ss.LAUNCHES = 0
    toks8, _, decode8_s = run_serve(cfg8, batch, prompt_len, steps,
                                    seed=seed, prompt=prompt, params=params,
                                    device=dev)
    launches["socket_score[int8]"] = ss.LAUNCHES
    if ss.LAUNCHES != expected["socket_score"]:
        raise AssertionError(f"socket_score[int8]: {ss.LAUNCHES} launches, "
                             f"expected {expected['socket_score']}")
    if not torch.equal(toks8, toks):
        raise AssertionError("int8 plane bytes gave other greedy tokens "
                             "than packed words")
    log(f"main path on int8 plane bytes: {ss.LAUNCHES} socket_score "
        f"launches, greedy tokens equal to the packed run's; decode "
        f"{batch * steps / decode8_s:.2f} tokens/s")

    # the prefill through the kernel and through the plain op
    capacity = prompt_len + steps
    logits, caches, stats = prefill_routes(cfg, params, prompt, capacity,
                                           dev)
    log(json.dumps({"main_path_prefill": arch, **stats, "card": card}))
    # decode step 0 again on a clone of the prefilled cache, kernel path vs
    # the plain versions (both kernel flags off)
    cfg_plain = cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=False, use_flash_decode=False))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if not torch.equal(tok[:, 0], toks[:, 0]):
        raise AssertionError("prefill is not deterministic: first token "
                             "differs between two runs")
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    serve_plain = make_serve_step(cfg_plain)
    swapped = []
    with static_ties_shared(swapped) as to_plain:
        lk, _ = make_serve_step(cfg)(params, caches, tok, prompt_len)
        to_plain()
        lp, _ = serve_plain(params, plain_caches, tok, prompt_len)
    del caches
    log(f"decode step 0: the plain top-k took the kernel route's selection "
        f"in {len(swapped)} of {cfg.num_layers} layers (rows inside the "
        f"score band: {swapped})")
    for name, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {name} path")
    err = (lk - lp).abs().max().item()
    log(f"decode step 0, kernels vs plain versions: max|logits err| "
        f"{err:.3e} (atol {LOGITS_ATOL}; max|logits| "
        f"{lp.abs().max().item():.3f})")
    if err > LOGITS_ATOL:
        raise AssertionError(f"step-0 logits differ by {err:.3e} > "
                             f"{LOGITS_ATOL}")
    plain_toks = [tok, torch.argmax(lp[:, -1], dim=-1)[:, None]]
    for t in range(1, steps):
        lp, _ = serve_plain(params, plain_caches, plain_toks[-1],
                            prompt_len + t)
        plain_toks.append(torch.argmax(lp[:, -1], dim=-1)[:, None])
    plain_toks = torch.cat(plain_toks, dim=1)
    same = (plain_toks == toks)
    prefix = [int(same[b].long().cumprod(0).sum().item())
              for b in range(batch)]
    log(f"greedy tokens shared by kernel and plain paths: "
        f"{int(same.sum().item())}/{same.numel()} (identical prefix per "
        f"request: {prefix})")
    return launches, params


# --------------------------------------------------------------- phase 5

# fused backend -> (its paged kernel's row name, its counter in
# kernels.paged_attention.ops, the config field whose use_paged_kernel
# turns it on)
FUSED = {"socket_fused": ("paged_attention", "LAUNCHES", "socket"),
         "hard_lsh_fused": ("paged_hard_lsh", "HARD_LSH_LAUNCHES", "socket"),
         "quest_fused": ("paged_quest", "QUEST_LAUNCHES", "quest")}


def draw_params(dev, seed, arch):
    """The continuous card case's weights of ``arch``, drawn from
    ``seed`` (logged with the depth the case cuts to)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.models import transformer as tfm
    full = get_config(arch)
    cfg, _ = card_continuous_case(full, seed, 32)
    kinds = [s.attn_type for s in cfg.layer_specs]
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed, dev)
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.param_count() / 1e9:.3f} B params (fp32) drawn "
        f"in {time.perf_counter() - t0:.1f} s; {cfg.num_layers} of "
        f"{full.num_layers} layers ({kinds.count('local')} local, "
        f"{kinds.count('global')} global): depth cut to num_groups "
        f"{cfg.num_groups} of {full.num_groups}, widths as published")
    return params


@torch.no_grad()
def forced_logits_err(cfg, cfg_plain, params, kernel_pages, plain_pages,
                      tokens, pos, bt, live):
    """One decode iteration through the kernel route and the plain route
    layer by layer, each layer of both routes fed the kernel route's
    input to it (teacher forcing): both append the same quantized row,
    so only the attention routes differ.  Every layer's two outputs go
    through the final norm and the head; returns the largest |logits
    difference| over layers and the live requests."""
    from repro_torch.models import transformer as tfm
    x = tfm.embed_tokens(cfg, params["embed"], tokens)
    worst = 0.0
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        xk, _ = tfm._block_decode(cfg, lp, spec, x, kernel_pages[i], pos, bt)
        xp, _ = tfm._block_decode(cfg_plain, lp, spec, x, plain_pages[i],
                                  pos, bt)
        lk, lp_ = (tfm.lm_head(cfg, params["embed"],
                               tfm.rmsnorm(params["final_norm"], y))[live]
                   for y in (xk, xp))
        if not (torch.isfinite(lk).all() and torch.isfinite(lp_).all()):
            raise AssertionError(f"non-finite logits at layer {i}")
        worst = max(worst, (lk - lp_).abs().max().item())
        x = xk
    return worst


def share_in_band(cfg, scores, vnorm, ksel, idx, mask, *, k, length,
                  n_total, budget, swapped):
    """The plain SOCKET top-k ``(idx, mask)`` of ``scores`` against the
    kernel route's selection ``ksel`` (B, KVH, N) bool.  Where the two
    differ only at rows whose plain effective score lies within SCORE_TOL
    of the top-k threshold (the kernel check's band: both sum the same
    fp32 terms in other orders), returns the kernel's selection and
    appends the count of differing rows to ``swapped``; a difference
    outside the band raises."""
    from repro_torch.core import socket as sk
    if ksel.shape != scores.shape or scores.shape[-1] != n_total:
        raise AssertionError(f"kernel selection {tuple(ksel.shape)} vs "
                             f"plain scores {tuple(scores.shape)}")
    psel = torch.zeros_like(ksel).scatter_(-1, idx, mask)
    diff = psel != ksel
    if not bool(diff.any()):
        return idx, mask
    # the plain effective scores and the k-th largest, as value_aware_topk
    # ranks them
    pos = torch.arange(n_total, device=scores.device)
    ln = sk.per_batch(length, scores.ndim)
    eff = scores.float() * vnorm.float()
    eff = torch.where((pos < cfg.sink_tokens) |
                      (pos >= ln - cfg.window_tokens), sk.FLT_MAX, eff)
    eff = torch.where(pos < ln, eff, sk.NEG_INF)
    top = torch.as_tensor(k if budget is None else budget,
                          device=scores.device).long().clamp(1, k) - 1
    top = top.reshape(-1, 1, 1).expand(*scores.shape[:2], 1)
    thr = torch.sort(eff, dim=-1, descending=True).values.gather(-1, top)
    close = (eff - thr).abs() <= SCORE_TOL["atol"] + \
        SCORE_TOL["rtol"] * thr.abs()
    if bool((diff & ~close).any()) or int(ksel.sum(-1).max()) > k:
        raise AssertionError("the plain and kernel SOCKET selections "
                             "differ outside the threshold band")
    swapped.append(int(diff.sum().item()))
    vals, order = torch.sort(ksel.int(), dim=-1, descending=True,
                             stable=True)
    return order[..., :k], vals[..., :k].bool()


@contextlib.contextmanager
def socket_ties_shared(swapped):
    """While active, each call of the fused paged SOCKET kernel keeps its
    selection, and the plain SOCKET top-k (``core.socket.
    value_aware_topk``) of the call it pairs with (the same layer: calls
    pair in order) is held to it by :func:`share_in_band`."""
    from repro_torch.core import socket as sk
    from repro_torch.kernels.paged_attention import ops as pa
    kernel, topk = pa.paged_socket_attend, sk.value_aware_topk
    pending, inside = collections.deque(), []

    def spy(*args, **kw):
        inside.append(True)     # a plain version of the kernel (CPU
        try:                    # tensors) ranks with the real top-k
            out, sel = kernel(*args, with_selection=True, **kw)
        finally:
            inside.pop()
        pending.append(sel)
        return out

    def shared_topk(cfg, scores, vnorm, *, k, length, n_total, budget=None):
        idx, mask = topk(cfg, scores, vnorm, k=k, length=length,
                         n_total=n_total, budget=budget)
        if inside:
            return idx, mask
        if not pending:
            raise AssertionError("a plain SOCKET top-k with no kernel call "
                                 "to pair with")
        ksel = pending.popleft()
        ksel = ksel.reshape(*ksel.shape[:2], -1).bool()
        return share_in_band(cfg, scores, vnorm, ksel, idx, mask, k=k,
                             length=length, n_total=n_total, budget=budget,
                             swapped=swapped)

    with mock.patch.object(pa, "paged_socket_attend", spy), \
            mock.patch.object(sk, "value_aware_topk", shared_topk):
        yield
    if pending:
        raise AssertionError(f"{len(pending)} kernel SOCKET calls with no "
                             "plain top-k to pair with")


@contextlib.contextmanager
def static_ties_shared(swapped):
    """The static path's step-0 gate: while active, the SOCKET top-k
    (``core.socket.value_aware_topk``) calls made before the yielded
    ``to_plain()`` is called are the kernel route's (``socket_score``'s
    scores) and keep their selections; each call after it is the plain
    route's, pairs in order with one of them (the same layer) and is held
    to it by :func:`share_in_band`."""
    from repro_torch.core import socket as sk
    topk = sk.value_aware_topk
    kept, plain = collections.deque(), []

    def shared_topk(cfg, scores, vnorm, *, k, length, n_total, budget=None):
        idx, mask = topk(cfg, scores, vnorm, k=k, length=length,
                         n_total=n_total, budget=budget)
        if not plain:
            kept.append(torch.zeros(scores.shape, dtype=torch.bool,
                                    device=scores.device)
                        .scatter_(-1, idx, mask))
            return idx, mask
        if not kept:
            raise AssertionError("a plain SOCKET top-k with no kernel-route "
                                 "top-k to pair with")
        return share_in_band(cfg, scores, vnorm, kept.popleft(), idx, mask,
                             k=k, length=length, n_total=n_total,
                             budget=budget, swapped=swapped)

    with mock.patch.object(sk, "value_aware_topk", shared_topk):
        yield lambda: plain.append(True)
    if kept:
        raise AssertionError(f"{len(kept)} kernel-route SOCKET top-k calls "
                             "with no plain top-k to pair with")


def kv_block_bytes(pages):
    """Bytes of the K/V leaves (scales included) one block id holds
    across all layers: as stored, and as ``auto`` (f32) would store
    them."""
    names = ("k", "v", "k_scale", "v_scale")
    stored = sum(layer[n][0].numel() * layer[n].element_size()
                 for layer in pages for n in names if n in layer)
    auto = sum(2 * layer["k"][0].numel() * 4 for layer in pages)
    return stored, auto


def phase_continuous(dev, seed, card, params, backend, arch="llama31-8b",
                     kv_dtype="auto", ref_tokens=None, legacy=False):
    """One continuous run of ``arch`` with ``backend`` on K/V pages stored
    as ``kv_dtype`` (see the module docstring, phases 5 to 7), on the
    card case's weights ``params``; ``legacy``: whole-prompt bucketed
    prefill.  ``ref_tokens``: (label, the generated tokens of another run
    of the same case), whose agreement with this run's is logged (a
    number, not a gate).  Returns (the launches of the kernels the run is
    read for, the generated tokens)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving.engine import ContinuousBatchingEngine

    new_tokens = 32
    name, counter, gate = FUSED[backend]
    full = get_config(arch)
    cfg, reqs = card_continuous_case(full, seed, new_tokens, backend,
                                     kv_dtype, legacy=legacy)
    sv = cfg.serving
    kinds = [s.attn_type for s in cfg.layer_specs]
    # kernel -> layers it runs on
    layers = {name: kinds.count("global")}
    if cfg.use_ring_kernel:
        layers["paged_ring"] = kinds.count("local")
    if legacy:
        layers["flash_prefill"] = cfg.num_layers
    engine = ContinuousBatchingEngine(cfg, params=params, device=dev)
    block_bytes, block_bytes_auto = kv_block_bytes(engine.pages)
    # the widest decode batch of the run, captured with a clone of the
    # pool for the kernel-vs-plain check below (never an iteration whose
    # next decode opens a block: every write then lands in a real page)
    snap = {}

    def hook(eng, it):
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) <= len(snap.get("reqs", ())) or any(
                r.done or len(r.blocks) * sv.block_size <= r.pos
                for r in running):
            return
        snap.update(reqs=[r.rid for r in running], iteration=it,
                    inputs=eng._batch_inputs(running),
                    pages=[{k: v.clone() for k, v in layer.items()}
                           for layer in eng.pages])

    engine.iter_hook = hook
    torch.cuda.reset_peak_memory_stats(dev)
    for c in FUSED.values():
        setattr(pa, c[1], 0)
    ss.LAUNCHES = fd.LAUNCHES = pa.RING_LAUNCHES = fp.LAUNCHES = 0
    t0 = time.perf_counter()
    engine.warmup(reqs)
    warm_s = time.perf_counter() - t0
    m = engine.run(reqs, realtime=False)
    torch.cuda.synchronize()
    launches = {c[0]: getattr(pa, c[1]) for c in FUSED.values()}
    launches.update(socket_score=ss.LAUNCHES, flash_decode=fd.LAUNCHES,
                    paged_ring=pa.RING_LAUNCHES, flash_prefill=fp.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [r.rid for r in reqs if r.state != "finished"
           or len(r.generated) != new_tokens]
    if bad:
        raise AssertionError(f"{backend}: requests {bad} did not finish "
                             f"with {new_tokens} tokens")
    # decode calls: the engine's iterations + the warm-up's decode step
    # (chunked: + its mixed step); whole-prompt prefills: the run's + one
    # a warm-up bucket
    warm_prefills = sum(k.startswith("prefill_") for k in engine.warmup_s)
    warm_steps = len(engine.warmup_s) - warm_prefills
    calls = {k: m.decode_iters + warm_steps for k in layers}
    if legacy:
        calls["flash_prefill"] = len(engine.prefill_trace) + warm_prefills
        if len(engine.prefill_trace) != len(reqs):
            raise AssertionError(f"{len(engine.prefill_trace)} whole-prompt "
                                 f"prefills for {len(reqs)} requests")
    expected = {k: n * calls[k] for k, n in layers.items()}
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(
                f"{k}: {launches[k]} launches, expected {want} ({layers[k]} "
                f"layers x {calls[k]} calls)")
    others = {k: v for k, v in launches.items() if k not in layers and v}
    if others:
        raise AssertionError(f"{backend}: other kernels ran on its paged "
                             f"path: {others}")
    if m.preemptions:
        raise AssertionError(f"{m.preemptions} preemptions in a pool sized "
                             "to need none")
    # offline run: every request arrives at the run's start, and the
    # engine stamps no TTFT (0); take it from the first token's wall time
    first = np.array([r.token_walls[0] for r in reqs])
    report = dict(m.to_json(), ttft_s_mean=float(first.mean()),
                  ttft_s_p99=float(np.percentile(first, 99)))
    generated = [list(r.generated) for r in reqs]
    if ref_tokens is not None:
        label, tokens = ref_tokens
        same = np.array(generated) == np.array(tokens)
        report.update({
            f"tokens_equal_to_{label}": f"{int(same.sum())}/{same.size}",
            f"identical_prefix_with_{label}": [int(np.cumprod(row).sum())
                                               for row in same]})
    if legacy:
        per_bucket = {}
        for _, _, bucket, secs in engine.prefill_trace:
            per_bucket.setdefault(bucket, []).append(secs)
        prompt_len = {r.rid: len(r.prompt) for r in reqs}
        padded = [1 - prompt_len[rid] / bucket
                  for _, rid, bucket, _ in engine.prefill_trace]
        report.update(prefill_buckets=list(sv.prefill_buckets),
                      prefill_s_by_bucket={b: v for b, v in
                                           sorted(per_bucket.items())},
                      prefill_padded_share=padded,
                      warmup_call_s=engine.warmup_s)
    log(json.dumps({
        "continuous_path": arch, "backend": backend, "kv_dtype": kv_dtype,
        "prefill": "whole-prompt buckets" if legacy else "chunked",
        "kv_bytes_per_block_id": block_bytes,
        "kv_bytes_per_block_id_auto": block_bytes_auto,
        "use_ring_kernel": cfg.use_ring_kernel,
        "layers": cfg.num_layers, "reduced": (
            None if cfg.num_groups == full.num_groups else
            f"num_groups {cfg.num_groups} of {full.num_groups}: "
            f"{cfg.num_layers} of {full.num_layers} layers"),
        "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
        "max_new_tokens": new_tokens, "prefill_chunk": sv.prefill_chunk,
        "num_blocks": sv.num_blocks, "warmup_s": warm_s,
        **report, "max_memory_allocated_bytes": peak,
        "launches": launches, "expected_launches": expected,
        "card": card}))

    # one decode iteration of the captured state, kernel vs plain path
    if "pages" not in snap:
        raise AssertionError("no decode iteration was captured")
    engine.pages = None                                   # free the pool
    del engine
    tokens, bt, pos = snap["inputs"]
    plain_pages = snap.pop("pages")
    clone = lambda pool: [{k: v.clone() for k, v in layer.items()}  # noqa
                          for layer in pool]
    kernel_pages = clone(plain_pages)
    cfg_plain = cfg.replace(use_ring_kernel=False, **{
        gate: dataclasses.replace(getattr(cfg, gate),
                                  use_paged_kernel=False)})
    live = pos > 0                   # idle slots decode the trash page
    forced, swapped = None, []
    with (socket_ties_shared(swapped) if backend == "socket_fused" else
          contextlib.nullcontext()):
        if kv_dtype != "auto":
            forced = forced_logits_err(cfg, cfg_plain, params, kernel_pages,
                                       clone(plain_pages), tokens, pos, bt,
                                       live)
            kernel_pages = clone(plain_pages)
        lk, _ = make_serve_step(cfg)(params, kernel_pages, tokens, pos, bt)
        del kernel_pages
        lp, _ = make_serve_step(cfg_plain)(params, plain_pages, tokens, pos,
                                           bt)
        del plain_pages
    lk, lp = lk[live], lp[live]
    for label, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {label} path")
    err = (lk - lp).abs().max().item()
    same = (lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
    log(f"{arch} continuous{' legacy' if legacy else ''} decode iteration "
        f"{snap['iteration'] + 1} ({len(snap['reqs'])} requests), {backend} "
        f"on {kv_dtype} pages, "
        f"kernels vs plain paged path: max|logits err| {err:.3e} "
        + (f"(atol {LOGITS_ATOL}; " if forced is None else
           "(not a gate: the two routes' rows round to the quantization "
           f"grid apart; layer by layer, teacher-forced: {forced:.3e}, "
           f"atol {LOGITS_ATOL}; ")
        + f"max|logits| {lp.abs().max().item():.3f}); greedy tokens "
        f"shared {int(same.sum().item())}/{same.numel()}"
        + ("" if backend != "socket_fused" else
           f"; SOCKET rows inside the top-k threshold band that the plain "
           f"path took from the kernel's selection: {sum(swapped)} in "
           f"{len(swapped)} calls"))
    gated = err if forced is None else forced
    if gated > LOGITS_ATOL:
        raise AssertionError(f"{arch} {backend} {kv_dtype}: continuous "
                             f"logits differ by {gated:.3e} > {LOGITS_ATOL}")
    return {k: launches[k] for k in layers}, generated


def legacy_phase(dev, seed, card, params, arch, chunked, launches):
    """Phase 7 for ``arch``: the legacy whole-prompt prefill run, its
    tokens compared with the chunked f32 run's (``chunked[arch]``); its
    launches land in ``launches`` as ``name[legacy arch]``."""
    t0 = time.perf_counter()
    counts, _ = phase_continuous(dev, seed, card, params, "socket_fused",
                                 arch=arch, legacy=True,
                                 ref_tokens=("chunked", chunked[arch]))
    launches.update({f"{k}[legacy {arch}]": v for k, v in counts.items()})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"legacy phase ({arch}): {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    # the port is not installed: outside a checkout this import fails
    from repro_torch.launch.serve import card_line
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    rows = phase_kernels(dev, args.seed)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, params = phase_main(dev, args.seed, card)
    log(f"main phase: {time.perf_counter() - t0:.1f} s")
    # the continuous runs: each fused backend on f32 pages, then on int8
    # and fp8 pages (entries name[int8], name[fp8]) on the same weights
    chunked = {}                # arch -> socket_fused f32 run's tokens
    for backend in FUSED:
        auto = None
        for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
            t0 = time.perf_counter()
            counts, tokens = phase_continuous(
                dev, args.seed, card, params, backend, kv_dtype=kv_dtype,
                ref_tokens=auto and ("auto", auto))
            auto = auto or tokens
            suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
            launches.update({k + suffix: v for k, v in counts.items()})
            gc.collect()
            torch.cuda.empty_cache()
            log(f"continuous phase ({backend}, {kv_dtype}): "
                f"{time.perf_counter() - t0:.1f} s")
        if backend == "socket_fused":
            chunked["llama31-8b"] = auto
    legacy_phase(dev, args.seed, card, params, "llama31-8b", chunked,
                 launches)
    del params                                  # llama31-8b's 32 GB
    gc.collect()
    torch.cuda.empty_cache()
    params = draw_params(dev, args.seed, "gemma3-27b")
    auto = None
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
        t0 = time.perf_counter()
        gemma, tokens = phase_continuous(
            dev, args.seed, card, params, "socket_fused", arch="gemma3-27b",
            kv_dtype=kv_dtype, ref_tokens=auto and ("auto", auto))
        auto = auto or tokens
        suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
        launches["paged_ring" + suffix] = gemma["paged_ring"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"gemma3-continuous phase ({kv_dtype}): "
            f"{time.perf_counter() - t0:.1f} s")
    chunked["gemma3-27b"] = auto
    legacy_phase(dev, args.seed, card, params, "gemma3-27b", chunked,
                 launches)
    kernels = [dict(row, launches=launches[name]) for name, row in
               rows.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
