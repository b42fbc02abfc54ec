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
same rows) — timed and traced like a static step.  Then, with llama31-8b's weights freed, gemma-7b's case
(full width and depth, MHA at hd 256: 28 layers through the paged
SOCKET kernel at 16 KV heads, G 1; llama31-8b's traffic) and
gemma3-27b's (full width, 14 of 62 layers: 12 local through
``paged_ring``, 2 global through the paged SOCKET kernel; 8 requests of
2048-6144 tokens) the same way, each on weights of its own.  Last,
jamba-v0.1-52b's case (full width, 8 of 32 layers: 1 attention through
the paged SOCKET kernel, 7 Mamba, 4 MoE of 16 experts; llama31-8b's
traffic), its MoE expert products (``moe_experts``), the rest of its MoE
layers (``moe``: routing, dispatch, combine) and its Mamba layers
(``mamba``) as their own parts: each is a ``torch.profiler``
``record_function`` span while traced, and a device kernel belongs to
the innermost span whose device-side range holds its start
(``spans_seen`` lists the spans the trace held); then mamba2-780m's (48
Mamba layers at full width, no pool blocks; the same traffic and spans).
Then the same at the deployment's bf16 numerics (``launch/specs.py``'s
``dryrun_model_config`` for a 32K decode): llama31-8b's static and
continuous rows again (no quantized-page rows), and llama4-maverick's
one group (a dense and an MoE layer of 128 experts; ``BF16_ARCHS``,
bf16 only), its expert products a part of their own.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch jamba-v0.1-52b --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch llama4-maverick-400b-a17b

``run_bf16`` runs the bf16 rows alone (llama31-8b's, then llama4's).

Needs a CUDA card.  Prints one JSON line per path.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
from collections import defaultdict

import torch

from repro_torch.launch.serve import (apply_backend_arg, card_config,
                                      card_line, card_continuous_case,
                                      device_name, resolve_device)
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

__all__ = ["kernel_part", "run_backend", "run_continuous", "run_llama",
           "run_bf16", "run_later", "span_part", "main"]

ARCH, BATCH, PROMPT_LEN, Q_CHUNK = "llama31-8b", 2, 8192, 512
BACKENDS = ("socket", "dense")
CONTINUOUS_BACKENDS = ("socket_fused", "hard_lsh_fused", "quest_fused")
# (backend, kv_dtype) of the quantized-page rows
CONTINUOUS_QUANT = (("socket_fused", "int8"), ("socket_fused", "fp8"))
TRACED_STEPS, TIMED_STEPS = 4, 16
# the continuous cases run after llama31-8b's, each on weights of its own
LATER_ARCHS = ("gemma-7b", "gemma3-27b", "jamba-v0.1-52b", "mamba2-780m")
# the cases at the deployment's bf16 numerics (launch/specs.py's
# dryrun_model_config for a 32K decode): llama31-8b's static and
# continuous rows again, then llama4-maverick's one group (bf16 only: it
# is 73.7 GB in fp32)
BF16_ARCHS = ("llama4-maverick-400b-a17b",)

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
                 "dot_kernel", "nvjet")),
    ("gather_scatter", ("index", "gather", "scatter")),
)


# (span name, module, function) traced as their own parts: a device
# kernel inside one of these ``record_function`` spans is its part
SPANS = (("moe_experts", "repro_torch.models.moe", "_expert_ffn"),
         ("moe", "repro_torch.models.moe", "apply_moe"),
         ("mamba", "repro_torch.models.mamba", "mamba_decode"))
SPAN_PREFIX = "span:"


def kernel_part(name: str) -> str:
    if name.startswith(SPAN_PREFIX):
        return name[len(SPAN_PREFIX):].split("|", 1)[0]
    low = name.lower()
    for part, keys in PARTS:
        if any(k in low for k in keys):
            return part
    return "other"


@contextlib.contextmanager
def _spans():
    """Each function of ``SPANS`` wrapped in a ``record_function`` span of
    its name."""
    import importlib
    saved = []
    for label, mod_name, fn_name in SPANS:
        mod = importlib.import_module(mod_name)
        inner = getattr(mod, fn_name)

        def wrapped(*args, _inner=inner, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _inner(*args, **kw)

        saved.append((mod, fn_name, inner))
        setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, inner in saved:
            setattr(mod, fn_name, inner)


def span_part(kernels, spans):
    """``kernels``: (name, start, ms) device kernels; ``spans``: (label,
    start, end) device-side ``record_function`` ranges.  Each kernel
    inside a span is renamed ``span:<label>|<name>`` after the innermost
    (shortest) span holding its start.  Returns name -> ms."""
    by_kernel = defaultdict(float)
    for name, start, ms in kernels:
        inside = [(end - s0, label) for label, s0, end in spans
                  if s0 <= start < end]
        if inside:
            name = f"{SPAN_PREFIX}{min(inside)[1]}|{name}"
        by_kernel[name] += ms
    return dict(by_kernel)


def _profile(step, steps, spans=False):
    """Trace ``steps`` calls of ``step()``: (host wall ms, device ms by
    kernel name, the span labels the trace held).  ``spans``: trace the
    functions of ``SPANS`` as their own parts (:func:`span_part`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            (_spans() if spans else contextlib.nullcontext()):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    labels = {label for label, _, _ in SPANS}
    kernels, ranges = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        tr = evt.time_range
        if evt.is_user_annotation:
            if evt.name in labels:
                ranges.append((evt.name, tr.start, tr.end))
            continue
        kernels.append((evt.name, tr.start, tr.elapsed_us() / 1e3))
    return wall_ms, span_part(kernels, ranges), \
        sorted({label for label, _, _ in ranges})


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
    wall_ms, by_kernel, _ = _profile(step, steps)
    return _breakdown(step_ms, wall_ms, by_kernel, steps)


def run_continuous(params, seed, steps, timed_steps, device,
                   backend="socket_fused", arch=ARCH, kv_dtype="auto",
                   numerics="f32"):
    """The continuous engine's full-width decode iteration of ``arch``
    with ``backend`` on K/V pages stored as ``kv_dtype`` at ``numerics``
    (see the module docstring), replayed ``timed_steps`` times under CUDA
    events and ``steps`` times under the profiler; ``params`` None draws
    the case's weights from ``seed``."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg, reqs = card_continuous_case(card_config(arch, numerics), seed, 64,
                                     backend, kv_dtype)
    if params is None:
        params = tfm.init_model(cfg, seed, device)
    engine = ContinuousBatchingEngine(cfg, params=params, device=device)
    snap = {}

    def hook(eng, it):
        """Ends the run at the first iteration after which all requests
        decode together and none opens a block on its next token."""
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) < len(reqs) or any(
                eng.scheduler._blocks_for(r.pos + 1) > len(r.blocks)
                for r in running):
            return False
        snap["inputs"] = eng._batch_inputs(running)
        snap["reqs"] = [eng.scheduler.running.get(i)
                        for i in range(cfg.serving.max_batch)]
        snap["context"] = [r.pos for r in running]
        return True

    engine.iter_hook = hook
    engine.warmup()
    engine.run(reqs, realtime=False)
    tokens, bt, pos = snap["inputs"]

    def step():
        engine._decode_body(tokens, bt, pos, snap["reqs"])

    for _ in range(2):                                  # warm-up
        step()
    step_ms = _time_ms(step, timed_steps)
    spans = cfg.uses_moe or any(s.kind == "mamba" for s in cfg.layer_specs)
    wall_ms, by_kernel, seen = _profile(step, steps, spans=spans)
    return {"batch": len(reqs), "context": snap["context"],
            "layers": cfg.num_layers,
            **({"spans_seen": seen} if spans else {}),
            **_breakdown(step_ms, wall_ms, by_kernel, steps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", action="append",
                    choices=LATER_ARCHS + BF16_ARCHS,
                    help="run only these later continuous cases (again "
                         "for more), not llama31-8b's")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    if not args.arch:
        run_llama(args.seed, dev, card)
        run_llama(args.seed, dev, card, "bf16")
    for arch in args.arch or LATER_ARCHS + BF16_ARCHS:
        run_later(arch, args.seed, dev, card)


def run_later(arch, seed, dev, card):
    """One later architecture's continuous row (``socket_fused``; at bf16
    for ``BF16_ARCHS``) on weights of its own, freed after it."""
    numerics = "bf16" if arch in BF16_ARCHS else "f32"
    row = run_continuous(None, seed, TRACED_STEPS, TIMED_STEPS, dev,
                         "socket_fused", arch=arch, numerics=numerics)
    print(json.dumps({"arch": arch, "engine": "continuous",
                      "backend": "socket_fused", "numerics": numerics,
                      "use_ring_kernel": arch == "gemma3-27b",
                      "device": device_name(dev), "card": card, **row}),
          flush=True)
    gc.collect()                         # the arch's weights and pool
    torch.cuda.empty_cache()


def run_bf16(seed, dev, card):
    """The rows at the deployment's bf16 numerics: llama31-8b's
    (:func:`run_llama` at "bf16"), then llama4-maverick's continuous
    case."""
    run_llama(seed, dev, card, "bf16")
    for arch in BF16_ARCHS:
        run_later(arch, seed, dev, card)


def run_llama(seed, dev, card, numerics="f32"):
    """llama31-8b's static and continuous rows (see the module
    docstring) at ``numerics`` ("f32", or "bf16": the deployment's, its
    quantized-page rows left out); its weights are freed at the end."""
    base = card_config(ARCH, numerics)
    if numerics == "f32":
        base = base.replace(attn_q_chunk=Q_CHUNK)
    params = tfm.init_model(base, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, base.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device=dev)
    for backend in BACKENDS:
        cfg = apply_backend_arg(base, backend)
        row = run_backend(cfg, params, prompt, TRACED_STEPS, TIMED_STEPS)
        print(json.dumps({"arch": ARCH, "engine": "static",
                          "numerics": numerics,
                          "backend": backend, "batch": BATCH,
                          "prompt_len": PROMPT_LEN,
                          "device": device_name(dev), "card": card,
                          **row}), flush=True)
    runs = [(b, "auto") for b in CONTINUOUS_BACKENDS] + \
        (list(CONTINUOUS_QUANT) if numerics == "f32" else [])
    for backend, kv_dtype in runs:
        row = run_continuous(params, seed, TRACED_STEPS, TIMED_STEPS,
                             dev, backend, kv_dtype=kv_dtype,
                             numerics=numerics)
        print(json.dumps({"arch": ARCH, "engine": "continuous",
                          "numerics": numerics,
                          "backend": backend, "kv_dtype": kv_dtype,
                          "device": device_name(dev), "card": card, **row}),
              flush=True)
        gc.collect()                     # the engine's pool, before the next
        torch.cuda.empty_cache()
    del params                           # llama31-8b's weights
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
