"""Serving launcher: the static engine (prefill one fixed-shape batch,
decode greedily in lockstep, report throughput).

Port of ``repro.launch.serve --engine static``.  It runs on the card by
default; with no card it raises unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu

For the ``socket`` backend both of the port's kernels are on
(``socket.use_score_kernel`` and ``socket.use_flash_decode``); on the CPU
their wrappers run the plain PyTorch versions.  The continuous engine
comes with the next slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

__all__ = ["run_serve", "resolve_device", "apply_backend_arg",
           "device_name", "card_line", "SERVING_BACKENDS"]

SERVING_BACKENDS = ("socket", "dense")


def apply_backend_arg(cfg, backend: str):
    """Resolve a serving backend name onto the config: ``socket`` routes
    scoring and subset attention through the port's kernels."""
    if backend not in SERVING_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {SERVING_BACKENDS}")
    if backend == "socket":
        return cfg.replace(attention_backend="socket", socket=dataclasses
                           .replace(cfg.socket, use_score_kernel=True,
                                    use_flash_decode=True))
    return cfg.replace(attention_backend=backend)


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device with no card raises (never a
    silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    card may be set below its maximum power, and then runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serve(cfg, batch: int, prompt_len: int, decode_steps: int,
              seed: int = 0, prompt=None, params: Optional[dict] = None,
              device="cuda"):
    """Prefill + greedy decode; returns (tokens (B, 1+steps), prefill_s,
    decode_s).

    ``params``: optional parameters (e.g. from
    :func:`repro_torch.models.weights.from_jax_params`); by default they
    are drawn from ``seed``.  ``prompt``: optional (batch, prompt_len)
    token array; by default drawn from ``seed``.
    """
    dev = resolve_device(device)
    # the reference computes in float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if params is None:
        params = tfm.init_model(cfg, seed, dev)
    capacity = prompt_len + decode_steps
    if prompt is None:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen, device=dev)
    tokens = torch.as_tensor(prompt).to(device=dev, dtype=torch.int64)

    prefill = make_prefill_step(cfg, capacity)
    serve = make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens})
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
    # warm-up step outside the timed loop (kernel builds, allocator); it
    # writes row prompt_len in place, which timed step 0 rewrites with
    # the same values
    serve(params, caches, toks[-1], prompt_len)
    _sync(dev)

    t0 = time.perf_counter()
    for t in range(decode_steps):
        logits, caches = serve(params, caches, toks[-1], prompt_len + t)
        toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return torch.cat(toks, dim=1), prefill_s, decode_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--backend", default="socket",
                    choices=list(SERVING_BACKENDS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card unless 'cpu' is given)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = apply_backend_arg(cfg, args.backend)
    dev = resolve_device(args.device)
    toks, prefill_s, decode_s = run_serve(cfg, args.batch, args.prompt_len,
                                          args.decode_steps, seed=args.seed,
                                          device=dev)
    print(json.dumps({
        "arch": cfg.name, "backend": args.backend, "engine": "static",
        "prefill_s": round(prefill_s, 3),
        "decode_s": round(decode_s, 3),
        "decode_tokens_per_s": round(
            args.batch * args.decode_steps / decode_s, 1),
        "generated_shape": list(toks.shape),
        "device": device_name(dev),
    }, indent=2))


if __name__ == "__main__":
    main()
