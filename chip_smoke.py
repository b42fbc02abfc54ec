#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:

1. device   — a CUDA card must be present; prints its name and power
              limit as nvidia-smi reports them.
2. build    — builds the CUDA kernels (nvcc, sm_90a, one process per source,
              all started together) and compiles the Triton kernels from the
              sources in this checkout.
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at edge shapes, with the tolerance
              stated; times kernel, plain version and (where one exists) the
              one PyTorch call computing the same function on the device
              (CUDA-graph replay), beside the least time the card could
              take, and the kernel once more launched back to back from
              Python (the host's launch rate).
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
              ``run(realtime=False)`` with ``--backend socket_fused``: 8
              requests (prompts of 1024/2048/3072/4096 tokens from --seed,
              each twice), 32 greedy tokens each, chunked prefill of 512,
              a pool that never preempts.  Every request must finish with
              32 tokens; the paged kernel's launch count must equal layers x
              (engine iterations + the 2 warm-up steps), with no launch of
              the contiguous-path kernels.  One decode iteration of the
              engine's state (the widest batch the run held, on a clone of
              the pool) is run again through the kernel and through the
              plain paged path; their logits must agree.

The last line of output is ``{"ok": true, "device": {...}}``; the line before
it lists every kernel's numbers as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
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


def check_paged(label, case, kw, ties):
    """Kernel vs plain version on one input set (the check of
    ``repro_torch.kernels.paged_attention.cases``)."""
    from repro_torch.kernels.paged_attention import cases, ops as pa
    q, kp, vp, bits, vnorm, u, bt, length, budget = case
    out, sel = pa.launch_paged_socket_attend(
        q, kp, vp, bits, vnorm, u, bt, length, budget, with_selection=True,
        **kw)
    torch.cuda.synchronize()
    try:
        err, near = cases.check_paged(out, sel, case, kw, ties=ties,
                                      attn_tol=ATTN_TOL, score_tol=SCORE_TOL)
    except AssertionError as e:
        raise AssertionError(f"[{label}] {e}") from None
    log(f"paged_attention [{label}] lengths {length.tolist()} budgets "
        f"{budget.tolist()}: max|err| {err:.3e} (rtol {ATTN_TOL['rtol']}, "
        f"atol {ATTN_TOL['atol']}); selection equal"
        + (f" but {near} rows within the threshold band" if near else ""))
    return err


def phase_kernels(dev, seed):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.cases import paged_case
    from repro_torch.kernels.paged_attention.ref import \
        paged_socket_attend_ref
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.kernels.socket_score.ref import socket_score_ref

    # -- build: one nvcc per CUDA source, all at once; Triton compiles at
    # first launch
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as ex:
        list(ex.map(build.load_library, (ss.SOURCE, pa.SOURCE)))
    log(f"build socket_score.cu + paged_attention.cu: "
        f"{time.perf_counter() - t0:.2f} s")
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

    # -- paged_attention: the continuous phase's shapes first, then edges
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    main_lens = [1024, 2048, 3072, 4096, 1024, 2048, 3072, 4096]
    paged_cases = [
        ("main path, ragged", dict(lengths=main_lens, nb=264)),
        ("length 1, budget > valid rows", dict(lengths=[1, 7, 200, 130],
                                               nb=264)),
        ("short tables, sink/window 16", dict(lengths=[33, 600, 1500, 57],
                                              nb=96, sink=16, window=16)),
        ("tie-heavy", dict(lengths=[900, 2500], nb=200, sink=16,
                           window=16, ties=True)),
    ]
    for label, kw in paged_cases:
        sets, args = paged_case(gen, **kw)
        err = check_paged(label, sets[0], args, kw.get("ties", False))
        if label.startswith("main path"):
            b, kvh, g, hd = sets[0][0].shape
            w = sets[0][3].shape[-1]
            sink, window = args["sink_tokens"], args["window_tokens"]
            lens = torch.tensor(kw["lengths"])
            sel = torch.minimum(sets[0][8].cpu().long(), lens)
            # sink and window rows are selected by position: their bits
            # and vnorm are never needed
            scored = lens - torch.clamp(lens, max=sink + window)
            # what the function must move: bits + vnorm of every scored
            # token, the selected K/V rows (forced ones included), q, u,
            # the table, the output; and do: one FMA per (scored token,
            # g, l), q.k and p.v per selected row
            per_head = scored.sum() * (w * 4 + 2) + sel.sum() * 2 * hd * 4
            nbytes = float(kvh * per_head + b * kvh * (2 * g * hd * 4 +
                           g * args["num_tables"] * args["num_planes"] * 4)
                           + sets[0][6].numel() * 4)
            flops = float(kvh * (scored.sum() * g * args["num_tables"] * 2 +
                                 sel.sum() * g * 4 * hd))
            touched = float(kvh * per_head)
            sets, args = paged_case(gen, copies=rotations(touched), **kw)
            kernel = functools.partial(pa.launch_paged_socket_attend,
                                       **args)
            ms = device_time_ms(kernel, sets)
            top_k = min(kw["nb"] * 16, int(sets[0][8].max()))

            def plain(q, kp, vp, bits, vnorm, u, bt, length, budget):
                return paged_socket_attend_ref(
                    q, kp, vp, bits, vnorm, u, bt, length=length,
                    budget=budget, top_k=top_k, **args)

            plain_ms = device_time_ms(plain, sets[:2])
            bms, by = bound(nbytes, flops)
            rows["paged_attention"] = dict(
                name="paged_attention", route="cuda",
                source="src/repro_torch/kernels/paged_attention/"
                       "paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/"
                         "paged_attention.py:69",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
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

def phase_continuous(dev, seed, card, params):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import card_continuous_case
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving.engine import ContinuousBatchingEngine

    arch, new_tokens = "llama31-8b", 32
    cfg, reqs = card_continuous_case(get_config(arch), seed, new_tokens)
    sv = cfg.serving
    engine = ContinuousBatchingEngine(cfg, params=params, device=dev)
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
    pa.LAUNCHES = ss.LAUNCHES = fd.LAUNCHES = 0
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    m = engine.run(reqs, realtime=False)
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.LAUNCHES,
                "socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    bad = [r.rid for r in reqs if r.state != "finished"
           or len(r.generated) != new_tokens]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with "
                             f"{new_tokens} tokens")
    expected = cfg.num_layers * (m.decode_iters + 2)
    if launches["paged_attention"] != expected:
        raise AssertionError(f"paged_attention: {launches} launches, "
                             f"expected {expected} (layers x engine "
                             "iterations + 2 warm-up steps)")
    if launches["socket_score"] or launches["flash_decode"]:
        raise AssertionError(f"contiguous-path kernels ran on the paged "
                             f"path: {launches}")
    if m.preemptions:
        raise AssertionError(f"{m.preemptions} preemptions in a pool sized "
                             "to need none")
    # offline run: every request arrives at the run's start, and the
    # engine stamps no TTFT (0); take it from the first token's wall time
    first = np.array([r.token_walls[0] for r in reqs])
    report = dict(m.to_json(), ttft_s_mean=float(first.mean()),
                  ttft_s_p99=float(np.percentile(first, 99)))
    log(json.dumps({
        "continuous_path": arch, "backend": "socket_fused",
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
    tokens, bt, pos = snap["inputs"]
    plain_pages = snap.pop("pages")
    kernel_pages = [{k: v.clone() for k, v in layer.items()}
                    for layer in plain_pages]
    lk, _ = make_serve_step(cfg)(params, kernel_pages, tokens, pos, bt)
    del kernel_pages
    cfg_plain = cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_paged_kernel=False))
    lp, _ = make_serve_step(cfg_plain)(params, plain_pages, tokens, pos, bt)
    del plain_pages
    live = pos > 0                   # idle slots decode the trash page
    lk, lp = lk[live], lp[live]
    for name, t in (("kernel", lk), ("plain", lp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite logits on the {name} path")
    err = (lk - lp).abs().max().item()
    same = (lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
    log(f"continuous decode iteration {snap['iteration'] + 1} "
        f"({len(snap['reqs'])} requests), fused kernel vs plain paged path: "
        f"max|logits err| {err:.3e} (atol {LOGITS_ATOL}; max|logits| "
        f"{lp.abs().max().item():.3f}); greedy tokens shared "
        f"{int(same.sum().item())}/{same.numel()}")
    if err > LOGITS_ATOL:
        raise AssertionError(f"continuous logits differ by {err:.3e} > "
                             f"{LOGITS_ATOL}")
    return {"paged_attention": launches["paged_attention"]}


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
    t0 = time.perf_counter()
    launches.update(phase_continuous(dev, args.seed, card, params))
    log(f"continuous phase: {time.perf_counter() - t0:.1f} s")
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
