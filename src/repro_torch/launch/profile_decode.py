"""Where a decode step's time goes on the card.

Prefills a batch through the static path, then times decode steps with
CUDA events and traces a few of them with ``torch.profiler``: device time
by kernel, grouped into the path's parts (cuBLAS/CUTLASS matrix
products, SOCKET scoring, top-k sort, gathers, flash decode, the rest),
and the device's busy share of a step.  Each backend in ``BACKENDS``
(SOCKET with both kernels on, and dense) runs on the same weights and
prompt:

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

at chip_smoke.py's main-path shapes (llama31-8b, batch 2, prompt 8192).
Needs a CUDA card.  Prints one JSON line per backend.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import (apply_backend_arg, card_line,
                                      device_name, resolve_device)
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

__all__ = ["kernel_part", "main"]

ARCH, BATCH, PROMPT_LEN, Q_CHUNK = "llama31-8b", 2, 8192, 512
BACKENDS = ("socket", "dense")
TRACED_STEPS, TIMED_STEPS = 4, 16

# kernel-name substrings -> part of the decode path (first match wins)
PARTS = (
    ("socket_score", ("socket_score",)),
    ("flash_decode", ("_split_kernel", "_combine_kernel")),
    ("topk_sort", ("sort", "radix", "scan")),
    ("matmuls", ("gemm", "gemv", "sm90", "xmma", "cutlass", "splitk",
                 "dot_kernel")),
    ("gather_scatter", ("index", "gather", "scatter")),
)


def kernel_part(name: str) -> str:
    low = name.lower()
    for part, keys in PARTS:
        if any(k in low for k in keys):
            return part
    return "other"


def _profile_steps(serve, params, caches, tok, pos0, steps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            logits, caches = serve(params, caches, tok, pos0 + t)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
    return wall_ms, dict(by_kernel)


def run_backend(cfg, params, prompt, steps, timed_steps):
    capacity = prompt.shape[1] + steps + timed_steps + 2
    prefill = make_prefill_step(cfg, capacity)
    serve = make_serve_step(cfg)
    logits, caches = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    pos = prompt.shape[1]
    for _ in range(2):                                  # warm-up
        logits, caches = serve(params, caches, tok, pos)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos += 1
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed_steps):
        logits, caches = serve(params, caches, tok, pos)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos += 1
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed_steps
    wall_ms, by_kernel = _profile_steps(serve, params, caches, tok, pos,
                                        steps)
    parts = defaultdict(float)
    for name, ms in by_kernel.items():
        parts[kernel_part(name)] += ms / steps
    busy = sum(by_kernel.values())
    return {
        "step_ms": step_ms,
        "profiled_step_wall_ms": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        # busy time against the untraced step (the profiler slows the host)
        "device_busy_share": busy / steps / step_ms,
        "parts_ms_per_step": dict(sorted(parts.items(),
                                         key=lambda kv: -kv[1])),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(ARCH).replace(attn_q_chunk=Q_CHUNK)
    params = tfm.init_model(base, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, base.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device=dev)
    card = card_line()
    for backend in BACKENDS:
        cfg = apply_backend_arg(base, backend)
        row = run_backend(cfg, params, prompt, TRACED_STEPS, TIMED_STEPS)
        print(json.dumps({"arch": ARCH, "backend": backend, "batch": BATCH,
                          "prompt_len": PROMPT_LEN,
                          "device": device_name(dev), "card": card,
                          **row}), flush=True)


if __name__ == "__main__":
    main()
