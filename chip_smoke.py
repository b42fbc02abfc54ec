#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:

1. device   — a CUDA card must be present; prints its name and power
              limit as nvidia-smi reports them.
2. build    — builds the CUDA kernels (nvcc, sm_90a, one process per source,
              all started together: socket_score.cu, paged_attention.cu,
              paged_quest.cu, paged_ring.cu) and compiles the Triton kernel
              from the sources in this checkout.
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at edge shapes, with the tolerance
              stated; times kernel, plain version and (where one exists) the
              one PyTorch call computing the same function on the device
              (CUDA-graph replay), beside the least time the card could
              take, and the kernel once more launched back to back from
              Python (the host's launch rate).  The four fused paged
              kernels again on pools stored as bf16, int8 and fp8 (the main
              case and an edge: ties, or a ring whose dead rows hold NaN in
              scales and fp8 payloads), SOCKET's and hard LSH's selections
              also equal to their own on the f32 pages; int8 and fp8 are
              timed as entries ``name[int8]``, ``name[fp8]``.
4. main     — llama31-8b at full width and depth through
              ``repro_torch.launch.serve.run_serve``: batch 2, an 8192-token
              prompt drawn from --seed, 32 greedy decode steps, SOCKET with
              both contiguous-path kernels on.  Each kernel's launch count
              must equal layers x decode calls.  Decode step 0 is run again
              on a clone of the prefilled cache through the plain versions;
              its logits must agree with the kernel path's, and the greedy
              tokens of the two paths are compared.
5. continuous — llama31-8b at full width and depth, the same weights,
              through ``ContinuousBatchingEngine.warmup()`` and
              ``run(realtime=False)``, once with each fused backend
              (``socket_fused``, ``hard_lsh_fused``, ``quest_fused``): 8
              requests (prompts of 1024/2048/3072/4096 tokens from --seed,
              each twice), 32 greedy tokens each, chunked prefill of 512,
              a pool that never preempts.  Every request must finish with
              32 tokens; the backend's paged kernel must launch exactly
              layers x (engine iterations + the 2 warm-up steps) times,
              and no other kernel at all.  One decode iteration of the
              engine's state (the widest batch the run held, on a clone of
              the pool) is run again through the kernel and through the
              plain paged path; their logits must agree.  Each run's pool
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

The last line of output is ``{"ok": true, "device": {...}}``; the line before
it lists every kernel's numbers as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import gc
import json
import math
import sys
import time
from pathlib import Path

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
# the stored K/V page modes the paged kernels are checked in besides f32
# (serving.kv_dtype); int8 and fp8 also get timed entries and main-path
# runs
QUANT_KV_DTYPES = ("bf16", "int8", "fp8")
TIMED_ITERS = 50
GRAPH_REPLAYS = 4
L2_BYTES = 50 * 2 ** 20


def log(*parts) -> None:
    print(*parts, flush=True)


def device_time_ms(fn, input_sets) -> float:
    """Device milliseconds of one ``fn(*inputs)``.  TIMED_ITERS calls,
    cycling through ``input_sets`` (sized together past the L2 cache, so
    every call reads its inputs from device memory), are captured in one
    CUDA graph; its replays are timed with CUDA events, which leaves the
    host's launch cost out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up before capture
        for inputs in input_sets[:3]:
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(TIMED_ITERS):
            fn(*input_sets[i % len(input_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (GRAPH_REPLAYS * TIMED_ITERS)
    del graph
    return ms


def back_to_back_ms(fn, input_sets) -> float:
    """Milliseconds per call of TIMED_ITERS calls launched one after the
    other from Python (CUDA events): the host's launch rate wherever it
    exceeds the device time."""
    for inputs in input_sets[:3]:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TIMED_ITERS):
        fn(*input_sets[i % len(input_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_ITERS


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


def flash_decode_case(dev, gen, *, bh, k, g, hd, dtype, dead_row=None):
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    kk = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    vv = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    mask = torch.rand((bh, k), generator=gen, device=dev) < 0.9
    if dead_row is not None:
        mask[dead_row] = False
    return q, kk, vv, mask


def phase_kernels(dev, seed):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.kernels.socket_score.ref import socket_score_ref

    # -- build: one nvcc per CUDA source, all at once; Triton compiles at
    # first launch
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as ex:
        list(ex.map(build.load_library,
                    (ss.SOURCE, pa.SOURCE, pa.QUEST_SOURCE, pa.RING_SOURCE)))
    log(f"build socket_score.cu + paged_attention.cu + paged_quest.cu + "
        f"paged_ring.cu: {time.perf_counter() - t0:.2f} s")
    for stem, (secs, report) in build.BUILD_LOGS.items():
        log(f"  nvcc {stem}: {secs:.2f} s\n  " +
            report.replace("\n", "\n  "))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    fd.launch_flash_decode(*flash_decode_case(
        dev, gen, bh=2, k=40, g=4, hd=128, dtype=torch.float32), scale=0.1)
    torch.cuda.synchronize()
    import triton
    log(f"build flash_decode (Triton {triton.__version__} compile + first "
        f"launch): {time.perf_counter() - t0:.2f} s")

    rows = {}
    # -- socket_score: main-path shapes first, then the edges
    L, P, G = 60, 10, 4
    score_cases = [
        ("main path", dict(bh=16, n=8224, g=G, l=L, p=P, int8=False,
                           vnorm=False)),
        ("main path + vnorm", dict(bh=16, n=8224, g=G, l=L, p=P, int8=False,
                                   vnorm=True)),
        ("int8 planes", dict(bh=16, n=8224, g=G, l=L, p=P, int8=True,
                             vnorm=True)),
        ("ragged N, G=1", dict(bh=3, n=1001, g=1, l=L, p=P, int8=False,
                               vnorm=True)),
        ("smoke P=6 L=12", dict(bh=4, n=77, g=2, l=12, p=6, int8=False,
                                vnorm=False)),
    ]
    for label, kw in score_cases:
        bits, u, vn = socket_score_case(dev, gen, **kw)
        args = dict(num_tables=kw["l"], num_planes=kw["p"], tau=0.4)
        out = ss.launch_socket_score(bits, u, vn, **args)
        torch.cuda.synchronize()
        ref = socket_score_ref(bits, u, vn, **args)
        err = check_close(f"socket_score[{label}]", out, ref, SCORE_TOL)
        log(f"socket_score [{label}] {tuple(bits.shape)} "
            f"{str(bits.dtype)[6:]}: max|err| {err:.3e} "
            f"(rtol {SCORE_TOL['rtol']}, atol {SCORE_TOL['atol']})")
        if label == "main path":
            bh, n, g = kw["bh"], kw["n"], kw["g"]
            nbytes = bits.numel() * bits.element_size() + u.numel() * 4 + \
                bh * n * 4
            # what the function needs, not what this kernel does: with P
            # split into two halves, each looked up in a per-(g, l) table
            # of exp(.), a (key, g, l) term is one FMA
            flops = bh * n * g * L * 2
            sets = [socket_score_case(dev, gen, **kw)
                    for _ in range(rotations(nbytes))]
            kernel = functools.partial(ss.launch_socket_score, **args)
            ms = device_time_ms(kernel, sets)
            plain_ms = device_time_ms(
                functools.partial(socket_score_ref, **args), sets)
            bms, by = bound(nbytes, flops)
            rows["socket_score"] = dict(
                name="socket_score", route="cuda",
                source="src/repro_torch/kernels/socket_score/socket_score.cu",
                replaces="src/repro/kernels/socket_score/socket_score.py:45",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                back_to_back_ms=back_to_back_ms(kernel, sets))

    # -- flash_decode
    fd_cases = [
        ("main path", dict(bh=16, k=823, g=4, hd=128, dtype=torch.float32)),
        ("stablelm hd=160", dict(bh=16, k=823, g=4, hd=160,
                                 dtype=torch.float32)),
        ("ragged K, dead row", dict(bh=5, k=77, g=4, hd=128,
                                    dtype=torch.float32, dead_row=2)),
        ("K < block, bf16 K/V", dict(bh=3, k=9, g=2, hd=64,
                                     dtype=torch.bfloat16, dead_row=0)),
    ]
    for label, kw in fd_cases:
        q, kk, vv, mask = flash_decode_case(dev, gen, **kw)
        scale = 1.0 / math.sqrt(kw["hd"])
        out = fd.launch_flash_decode(q, kk, vv, mask, scale=scale)
        torch.cuda.synchronize()
        ref = flash_decode_ref(q, kk, vv, mask, scale=scale)
        err = check_close(f"flash_decode[{label}]", out, ref, ATTN_TOL)
        if kw.get("dead_row") is not None and \
                out[kw["dead_row"]].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode[{label}]: a fully masked "
                                 "row must return 0")
        log(f"flash_decode [{label}] K={kw['k']} hd={kw['hd']} "
            f"{str(kw['dtype'])[6:]}: max|err| {err:.3e} "
            f"(rtol {ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']})")
        if label == "main path":
            bh, k, g, hd = kw["bh"], kw["k"], kw["g"], kw["hd"]
            sets = [flash_decode_case(dev, gen, **kw)
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
                name="flash_decode", route="triton",
                source="src/repro_torch/kernels/flash_decode/flash_decode.py",
                replaces="src/repro/kernels/flash_decode/flash_decode.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                back_to_back_ms=back_to_back_ms(kernel, sets))

    for kv_dtype in ("auto",) + QUANT_KV_DTYPES:
        rows.update(paged_rows(dev, seed, kv_dtype))
        rows.update(ring_rows(dev, seed, kv_dtype))
    return rows


# The fused paged kernels' cases: the continuous phase's shapes first
# (8 KV heads, G=4, hd=128, bs=16; contexts 1-4K, a 264-block table), then
# the edges.
MAIN_LENS = [1024, 2048, 3072, 4096, 1024, 2048, 3072, 4096]
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
    ],
    "paged_hard_lsh": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("l=37 unaligned tables", dict(lengths=[33, 600, 1500, 57], nb=96,
                                       l=37, sink=16, window=16)),
    ],
    "paged_quest": [
        ("main path, ragged", dict(lengths=MAIN_LENS, nb=264)),
        ("length 1, budget > live pages", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16, window=16,
                           ties=True)),
        ("ps=8, two pages a block", dict(lengths=[33, 600, 1500, 57], nb=96,
                                         ps=8, sink=16, window=16)),
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
            if kv_dtype != "auto" and not label.startswith(("main path",
                                                             "tie-heavy")):
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
    its pool stored as ``kv_dtype`` (``auto``: f32 and every case; else
    the main case and the window-1000 one, stored by ``cases.store_kv``,
    dead rows NaN in their scales and fp8 payloads too); times at the
    main shapes beside the bound, the plain version and, for f32 pages,
    ``scaled_dot_product_attention`` over the pre-gathered ring views (no
    one PyTorch call dequantizes and attends: ``library_ms`` null)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_ring_attend_ref
    from repro_torch.models.backends.base import gather_block_leaf
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rows = {}
    for label, kw in cases.RING_CASES:
        if kv_dtype != "auto" and not label.startswith(("main path",
                                                        "window 1000")):
            continue
        sets, args = cases.ring_case(gen, **kw)
        sets, scales = (sets, {}) if kv_dtype == "auto" else \
            cases.store_kv(sets, kv_dtype)
        case = sets[0]
        out = pa.launch_paged_ring_attend(*case, **args, **scales)
        torch.cuda.synchronize()
        try:
            err = cases.check_ring(out, case, args, attn_tol=ATTN_TOL,
                                   scales=scales)
        except AssertionError as e:
            raise AssertionError(f"[{kv_dtype}, {label}] {e}") from None
        q, kp, _, bt, pos = case
        b, kvh, g, hd = q.shape
        cap = bt.shape[1] * kp.shape[2]
        live = cases.ring_live(pos, cap, args["window"])
        log(f"paged_ring [{kv_dtype}, {label}] positions {kw['positions']} "
            f"KVH {kvh} G {g} window {args['window']} softcap "
            f"{args['softcap']}: max|err| {err:.3e} (rtol "
            f"{ATTN_TOL['rtol']}, atol {ATTN_TOL['atol']}); "
            f"{int(live.sum())} live of {b * cap} slots, dead ones NaN")
        if not label.startswith("main path") or kv_dtype == "bf16":
            continue
        nlive = int(live.sum())
        # the live K/V rows once (scales included), q, the output, the
        # table and positions
        nbytes = kvh * nlive * kv_row_bytes(case, scales) + \
            2 * b * kvh * g * hd * 4 + bt.numel() * 4 + b * 4
        flops = kvh * nlive * g * 4 * hd
        sets, args = cases.ring_case(gen, copies=rotations(nbytes), **kw)
        if kv_dtype != "auto":
            sets, scales = cases.store_kv(sets, kv_dtype)
        kernel = functools.partial(pa.launch_paged_ring_attend, **args,
                                   **scales)
        ms = device_time_ms(kernel, sets)
        plain_ms = device_time_ms(
            lambda q, kp, vp, bt, pos: paged_ring_attend_ref(
                q, kp, vp, bt, pos=pos, **args, **scales), sets[:2])
        lib_ms, extra = None, {}
        if kv_dtype == "auto":
            # the library call: SDPA over the ring views gathered
            # beforehand (the gather, which the kernel does itself, is not
            # timed), the query group as SDPA's L axis, the window mask as
            # a bool mask
            views = [(q, gather_block_leaf(kp, bt).nan_to_num(0.0),
                      gather_block_leaf(vp, bt).nan_to_num(0.0),
                      cases.ring_live(pos, cap, args["window"])[:, None,
                                                                None])
                     for q, kp, vp, bt, pos in sets]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = functools.partial(sdpa, scale=args["scale"])
            check_close("paged_ring[SDPA yardstick]",
                        lib(*views[0][:3], attn_mask=views[0][3]),
                        cases.plain_ring(sets[0], args), ATTN_TOL)
            lib_ms = device_time_ms(
                lambda q, k, v, m: lib(q, k, v, attn_mask=m), views)
            del views
            extra = dict(library_call="scaled_dot_product_attention over "
                         "the ring views gathered beforehand (gather not "
                         "timed), bool window mask")
        bms, by = bound(nbytes, flops)
        key = "paged_ring" if kv_dtype == "auto" else \
            f"paged_ring[{kv_dtype}]"
        rows[key] = dict(
            name=key, route="cuda",
            source="src/repro_torch/kernels/paged_attention/paged_ring.cu",
            replaces="src/repro/kernels/paged_attention/paged_ring.py:42",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms, **extra,
            back_to_back_ms=back_to_back_ms(kernel, sets))
        del sets
    return rows



# --------------------------------------------------------------- phase 4

def phase_main(dev, seed, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import apply_backend_arg, run_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

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
    ss.LAUNCHES = 0
    fd.LAUNCHES = 0
    toks, prefill_s, decode_s = run_serve(cfg, batch, prompt_len, steps,
                                          seed=seed, prompt=prompt,
                                          params=params, device=dev)
    launches = {"socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    expected = cfg.num_layers * (steps + 1)          # + the warm-up step
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {expected}")
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

    # decode step 0 again on a clone of the prefilled cache, kernel path vs
    # the plain versions (both kernel flags off)
    cfg_plain = cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=False, use_flash_decode=False))
    capacity = prompt_len + steps
    logits, caches = make_prefill_step(cfg, capacity)(
        params, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if not torch.equal(tok[:, 0], toks[:, 0]):
        raise AssertionError("prefill is not deterministic: first token "
                             "differs between two runs")
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    lk, _ = make_serve_step(cfg)(params, caches, tok, prompt_len)
    del caches
    serve_plain = make_serve_step(cfg_plain)
    lp, _ = serve_plain(params, plain_caches, tok, prompt_len)
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
                     kv_dtype="auto", auto_tokens=None):
    """One continuous run of ``arch`` with ``backend`` on K/V pages stored
    as ``kv_dtype`` (see the module docstring, phases 5 and 6), on the
    card case's weights ``params``.  ``auto_tokens``: the generated
    tokens of the ``auto`` run of the same case, whose agreement with
    this run's is logged (a number, not a gate).  Returns (the launches
    of the kernels the run is read for, the generated tokens)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving.engine import ContinuousBatchingEngine

    new_tokens = 32
    name, counter, gate = FUSED[backend]
    full = get_config(arch)
    cfg, reqs = card_continuous_case(full, seed, new_tokens, backend,
                                     kv_dtype)
    sv = cfg.serving
    kinds = [s.attn_type for s in cfg.layer_specs]
    # kernel -> layers it runs on
    layers = {name: kinds.count("global")}
    if cfg.use_ring_kernel:
        layers["paged_ring"] = kinds.count("local")
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
    ss.LAUNCHES = fd.LAUNCHES = pa.RING_LAUNCHES = 0
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    m = engine.run(reqs, realtime=False)
    torch.cuda.synchronize()
    launches = {c[0]: getattr(pa, c[1]) for c in FUSED.values()}
    launches.update(socket_score=ss.LAUNCHES, flash_decode=fd.LAUNCHES,
                    paged_ring=pa.RING_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [r.rid for r in reqs if r.state != "finished"
           or len(r.generated) != new_tokens]
    if bad:
        raise AssertionError(f"{backend}: requests {bad} did not finish "
                             f"with {new_tokens} tokens")
    calls = m.decode_iters + 2
    expected = {k: n * calls for k, n in layers.items()}
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(
                f"{k}: {launches[k]} launches, expected {want} ({layers[k]} "
                "layers x (engine iterations + 2 warm-up steps))")
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
    if auto_tokens is not None:
        same = np.array(generated) == np.array(auto_tokens)
        report.update(
            tokens_equal_to_auto=f"{int(same.sum())}/{same.size}",
            identical_prefix_with_auto=[int(np.cumprod(row).sum())
                                        for row in same])
    log(json.dumps({
        "continuous_path": arch, "backend": backend, "kv_dtype": kv_dtype,
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
    forced = None
    if kv_dtype != "auto":
        forced = forced_logits_err(cfg, cfg_plain, params, kernel_pages,
                                   clone(plain_pages), tokens, pos, bt, live)
        kernel_pages = clone(plain_pages)
    lk, _ = make_serve_step(cfg)(params, kernel_pages, tokens, pos, bt)
    del kernel_pages
    lp, _ = make_serve_step(cfg_plain)(params, plain_pages, tokens, pos, bt)
    del plain_pages
    lk, lp = lk[live], lp[live]
    for label, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {label} path")
    err = (lk - lp).abs().max().item()
    same = (lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
    log(f"{arch} continuous decode iteration {snap['iteration'] + 1} "
        f"({len(snap['reqs'])} requests), {backend} on {kv_dtype} pages, "
        f"kernels vs plain paged path: max|logits err| {err:.3e} "
        + (f"(atol {LOGITS_ATOL}; " if forced is None else
           "(not a gate: the two routes' rows round to the quantization "
           f"grid apart; layer by layer, teacher-forced: {forced:.3e}, "
           f"atol {LOGITS_ATOL}; ")
        + f"max|logits| {lp.abs().max().item():.3f}); greedy tokens "
        f"shared {int(same.sum().item())}/{same.numel()}")
    gated = err if forced is None else forced
    if gated > LOGITS_ATOL:
        raise AssertionError(f"{arch} {backend} {kv_dtype}: continuous "
                             f"logits differ by {gated:.3e} > {LOGITS_ATOL}")
    return {k: launches[k] for k in layers}, generated


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
    for backend in FUSED:
        auto = None
        for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
            t0 = time.perf_counter()
            counts, tokens = phase_continuous(
                dev, args.seed, card, params, backend, kv_dtype=kv_dtype,
                auto_tokens=auto)
            auto = auto or tokens
            suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
            launches.update({k + suffix: v for k, v in counts.items()})
            gc.collect()
            torch.cuda.empty_cache()
            log(f"continuous phase ({backend}, {kv_dtype}): "
                f"{time.perf_counter() - t0:.1f} s")
    del params                                  # llama31-8b's 32 GB
    gc.collect()
    torch.cuda.empty_cache()
    params = draw_params(dev, args.seed, "gemma3-27b")
    auto = None
    for kv_dtype in ("auto",) + QUANT_KV_DTYPES[1:]:
        t0 = time.perf_counter()
        gemma, tokens = phase_continuous(
            dev, args.seed, card, params, "socket_fused", arch="gemma3-27b",
            kv_dtype=kv_dtype, auto_tokens=auto)
        auto = auto or tokens
        suffix = "" if kv_dtype == "auto" else f"[{kv_dtype}]"
        launches["paged_ring" + suffix] = gemma["paged_ring"]
        gc.collect()
        torch.cuda.empty_cache()
        log(f"gemma3-continuous phase ({kv_dtype}): "
            f"{time.perf_counter() - t0:.1f} s")
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
