"""Where a decode step's time goes on the card.

Static path: prefills a batch, then times decode steps with CUDA events
and traces a few of them with ``torch.profiler``: device time by kernel,
grouped into the path's parts (cuBLAS/CUTLASS matrix products, SOCKET
scoring, top-k sort, gathers, flash decode, the fused paged kernels, the
rest), and the device's busy share of a step.  Each backend in
``BACKENDS`` (SOCKET with both kernels on, and dense) runs on the same
weights and prompt, at chip_smoke.py's main-path shapes (llama31-8b,
batch 2, prompt 8192).

Continuous engine: the same weights through ``ContinuousBatchingEngine``
at chip_smoke.py's continuous case (``launch.serve.card_continuous_case``:
8 requests of 1024-4096 prompt tokens, chunks of 512), once for each
fused backend in ``CONTINUOUS_BACKENDS`` (SOCKET, hard LSH, Quest), and
for SOCKET once more on int8 and on fp8 K/V pages
(``CONTINUOUS_QUANT``, ``serving.kv_dtype``); each run ends once all 8
decode together, and that decode iteration is replayed (it rewrites the
same rows) — timed and traced like a static step.  Then, with llama31-8b's weights freed, gemma3-27b's case (full
width, 14 of 62 layers: 12 local through ``paged_ring``, 2 global
through the paged SOCKET kernel; 8 requests of 2048-6144 tokens) the
same way.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Needs a CUDA card.  Prints one JSON line per path.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from collections import defaultdict

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import (apply_backend_arg, card_line,
                                      card_continuous_case, device_name,
                                      resolve_device)
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

__all__ = ["kernel_part", "run_backend", "run_continuous", "main"]

ARCH, BATCH, PROMPT_LEN, Q_CHUNK = "llama31-8b", 2, 8192, 512
BACKENDS = ("socket", "dense")
CONTINUOUS_BACKENDS = ("socket_fused", "hard_lsh_fused", "quest_fused")
# (backend, kv_dtype) of the quantized-page rows
CONTINUOUS_QUANT = (("socket_fused", "int8"), ("socket_fused", "fp8"))
TRACED_STEPS, TIMED_STEPS = 4, 16

# kernel-name substrings -> part of the decode path (first match wins)
PARTS = (
    ("paged_ring", ("paged_ring_kernel",)),
    ("paged_quest", ("paged_quest_kernel",)),
    # paged_attention.cu's kernel, in SOCKET or hard-LSH mode
    ("paged_attention", ("paged_socket_kernel",)),
    ("socket_score", ("socket_score",)),
    ("flash_decode", ("flash_decode_kernel",)),
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


def _profile(step, steps):
    """Trace ``steps`` calls of ``step()``: (host wall ms, device ms by
    kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
    return wall_ms, dict(by_kernel)


def _time_ms(step, steps):
    """CUDA-event milliseconds per call of ``step()``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _breakdown(step_ms, wall_ms, by_kernel, steps):
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
    state = {"tok": tok, "pos": pos}

    def step():
        logits, _ = serve(params, caches, state["tok"], state["pos"])
        state["tok"] = torch.argmax(logits[:, -1], dim=-1)[:, None]
        state["pos"] += 1

    step_ms = _time_ms(step, timed_steps)
    wall_ms, by_kernel = _profile(step, steps)
    return _breakdown(step_ms, wall_ms, by_kernel, steps)


def run_continuous(params, seed, steps, timed_steps, device,
                   backend="socket_fused", arch=ARCH, kv_dtype="auto"):
    """The continuous engine's full-width decode iteration of ``arch``
    with ``backend`` on K/V pages stored as ``kv_dtype`` (see the module
    docstring), replayed ``timed_steps`` times under CUDA events and
    ``steps`` times under the profiler; ``params`` None draws the case's
    weights from ``seed``."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg, reqs = card_continuous_case(get_config(arch), seed, 64, backend,
                                     kv_dtype)
    if params is None:
        params = tfm.init_model(cfg, seed, device)
    engine = ContinuousBatchingEngine(cfg, params=params, device=device)
    bs = cfg.serving.block_size
    snap = {}

    def hook(eng, it):
        """Ends the run at the first iteration after which all requests
        decode together and none opens a block on its next token."""
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) < len(reqs) or any(len(r.blocks) * bs <= r.pos
                                           for r in running):
            return False
        snap["inputs"] = eng._batch_inputs(running)
        snap["context"] = [r.pos for r in running]
        return True

    engine.iter_hook = hook
    engine.warmup()
    engine.run(reqs, realtime=False)
    tokens, bt, pos = snap["inputs"]

    def step():
        engine._decode_body(tokens, bt, pos)

    for _ in range(2):                                  # warm-up
        step()
    step_ms = _time_ms(step, timed_steps)
    wall_ms, by_kernel = _profile(step, steps)
    return {"batch": len(reqs), "context": snap["context"],
            "layers": cfg.num_layers,
            **_breakdown(step_ms, wall_ms, by_kernel, steps)}


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
        print(json.dumps({"arch": ARCH, "engine": "static",
                          "backend": backend, "batch": BATCH,
                          "prompt_len": PROMPT_LEN,
                          "device": device_name(dev), "card": card,
                          **row}), flush=True)
    runs = [(b, "auto") for b in CONTINUOUS_BACKENDS] + \
        list(CONTINUOUS_QUANT)
    for backend, kv_dtype in runs:
        row = run_continuous(params, args.seed, TRACED_STEPS, TIMED_STEPS,
                             dev, backend, kv_dtype=kv_dtype)
        print(json.dumps({"arch": ARCH, "engine": "continuous",
                          "backend": backend, "kv_dtype": kv_dtype,
                          "device": device_name(dev), "card": card, **row}),
              flush=True)
        gc.collect()                     # the engine's pool, before the next
        torch.cuda.empty_cache()
    del params                           # llama31-8b's weights
    gc.collect()
    torch.cuda.empty_cache()
    row = run_continuous(None, args.seed, TRACED_STEPS, TIMED_STEPS, dev,
                         "socket_fused", arch="gemma3-27b")
    print(json.dumps({"arch": "gemma3-27b", "engine": "continuous",
                      "backend": "socket_fused", "use_ring_kernel": True,
                      "device": device_name(dev), "card": card, **row}),
          flush=True)


if __name__ == "__main__":
    main()
