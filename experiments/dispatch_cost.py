#!/usr/bin/env python3
"""The static path's step times of one source tree, to compare two trees
(for example a commit and its parent) on one card.

    PYTHONPATH=<tree>/src python3 experiments/dispatch_cost.py --label X

Needs a CUDA card.  Imports ``repro_torch`` from ``PYTHONPATH`` (this
script uses only entry points that every tree since the bf16 numerics
has: ``launch.serve.card_config``/``apply_backend_arg``,
``runtime.steps.make_prefill_step``/``make_serve_step``), so one copy of
it times any tree.  The case is ``launch/profile_decode.py``'s static
one at the deployment's bf16 numerics: llama31-8b at full width and
depth, the SOCKET backend with both kernels on, batch 2, an 8192-token
prompt.  It times ``PREFILLS`` prefills (host seconds, each ended with
the card's work) and ``STEPS`` decode steps after 2 warm-up steps: host
ms a step (the loop's wall clock, the card's work included; the step
is host-bound) and CUDA-event ms a step.  Where the tree's kernels have
``torch.library`` operators (``kernels.build.dispatch_free`` chooses a
call's route), it then times ``PAIRS`` pairs of steps in one process,
one step of a pair with every call through the operators and the other
as the wrappers call the kernels on plain CUDA tensors (straight to the
launch), the order alternating from pair to pair: the host noise that
parts two processes cancels in a pair's difference.  Prints one
JSON line: the label, the card's name and power limit, the medians and
every sample, and the kernels' launches in one prefill and one step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

ARCH, BATCH, PROMPT_LEN = "llama31-8b", 2, 8192
PREFILLS, STEPS, PAIRS = 3, 24, 48


def _launches():
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    return {"socket_score": ss.LAUNCHES, "flash_decode": fd.LAUNCHES,
            "flash_prefill": fp.LAUNCHES}


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _timed(step):
    """(host ms, CUDA-event ms) of one call of ``step()``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def _operator_pairs(step):
    """The paired steps (see the module docstring), or None where the
    tree's kernels have no operators."""
    from repro_torch.kernels import build
    route = getattr(build, "dispatch_free", None)
    if route is None:
        return None
    host = {"operator": [], "direct": []}
    try:
        for k in range(PAIRS):
            order = ("operator", "direct") if k % 2 == 0 else \
                ("direct", "operator")
            for name in order:
                build.dispatch_free = route if name == "direct" else \
                    (lambda t: False)
                host[name].append(_timed(step)[0])
    finally:
        build.dispatch_free = route
    diffs = [a - b for a, b in zip(host["operator"], host["direct"])]
    return {"pairs": PAIRS,
            "operator_host_ms_median": statistics.median(host["operator"]),
            "direct_host_ms_median": statistics.median(host["direct"]),
            "pair_diff_ms_median": statistics.median(diffs),
            "pair_diff_ms_mean": statistics.mean(diffs),
            "operator_host_ms": host["operator"],
            "direct_host_ms": host["direct"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import repro_torch
    from repro_torch.launch.serve import (apply_backend_arg, card_config,
                                          card_line)
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step

    dev = torch.device("cuda")
    cfg = apply_backend_arg(card_config(ARCH, "bf16"), "socket")
    params = tfm.init_model(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device=dev)
    capacity = PROMPT_LEN + STEPS + 2 * PAIRS + 4
    prefill = make_prefill_step(cfg, capacity)
    serve = make_serve_step(cfg)

    logits, caches = prefill(params, {"tokens": prompt})   # builds, warms
    torch.cuda.synchronize()
    prefill_s, prefill_launches = [], None
    for _ in range(PREFILLS):
        before = _launches()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        prefill_launches = _diff(_launches(), before)

    tok = torch.argmax(logits[:, -1], -1)[:, None]
    pos = PROMPT_LEN
    for _ in range(2):                                   # warm-up
        logits, caches = serve(params, caches, tok, pos)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        pos += 1
    torch.cuda.synchronize()
    state = {"tok": tok, "pos": pos}

    def step():
        logits, _ = serve(params, caches, state["tok"], state["pos"])
        state["tok"] = torch.argmax(logits[:, -1], -1)[:, None]
        state["pos"] += 1

    host_ms, event_ms, step_launches = [], [], None
    for _ in range(STEPS):
        before = _launches()
        host, event = _timed(step)
        host_ms.append(host)
        event_ms.append(event)
        step_launches = _diff(_launches(), before)
    pairs = _operator_pairs(step)
    print(json.dumps({
        "label": args.label, "tree": repro_torch.__file__,
        "card": card_line(), "arch": ARCH, "numerics": "bf16",
        "batch": BATCH, "prompt_len": PROMPT_LEN,
        "prefill_s_median": statistics.median(prefill_s),
        "prefill_s": prefill_s, "prefill_launches": prefill_launches,
        "step_host_ms_median": statistics.median(host_ms),
        "step_event_ms_median": statistics.median(event_ms),
        "step_host_ms": host_ms, "step_event_ms": event_ms,
        "step_launches": step_launches, "operator_pairs": pairs}),
        flush=True)


if __name__ == "__main__":
    main()
