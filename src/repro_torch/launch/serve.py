"""Serving launcher.  Two engines:

* ``--engine static``: prefill one fixed-shape batch, decode greedily in
  lockstep, report throughput.
* ``--engine continuous``: the paged-KV continuous-batching engine
  (:mod:`repro_torch.serving`) fed Poisson-arriving requests of mixed
  prompt lengths; reports throughput, TTFT and p50/p99 token latency.
  ``--prefill-chunk 0`` serves through the legacy whole-prompt bucketed
  prefill (``serving.prefill_buckets``) instead of chunked prefill;
  ``--temperature``/``--top-p`` sample instead of decoding greedily;
  ``--prefix-cache`` shares the pages of cached prompt prefixes, and
  ``--workload chatbot|rag`` sends traffic that has such prefixes.
  Observability: ``--trace`` streams the JSONL event trace
  (``--perfetto`` also exports it as Chrome trace-event JSON),
  ``--metrics-json``/``--metrics-prom`` write the run's metrics,
  ``--probe-every N`` samples the selection-quality probe (its summary
  lands in the report) and ``--profile-dir`` captures a
  ``torch.profiler`` window of ``--profile-steps`` iterations.

Port of ``repro.launch.serve``.  It runs on the card by default; with no
card it raises unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu --engine continuous --backend socket_fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \\
        --smoke --device cpu --engine continuous --backend socket_fused \\
        --ring-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu --engine continuous --backend socket_fused \\
        --kv-dtype fp8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu --engine continuous --backend socket_fused \\
        --prefill-chunk 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \\
        --smoke --device cpu --engine continuous --backend socket_fused \\
        --prefix-cache --workload rag --temperature 0.8 --top-p 0.9
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --smoke --device cpu --engine continuous --backend socket_fused \\
        --trace t.jsonl --perfetto t.perfetto.json --probe-every 2 \\
        --metrics-json m.json --metrics-prom m.prom --profile-dir prof

Backends: ``socket`` turns on the contiguous-path kernels
(``socket.use_score_kernel``: CUDA scoring, ``socket.use_flash_decode``:
CUDA flash decode), which the continuous engine also runs on the
gathered logical view; ``hard_lsh`` and ``quest`` are the paper's
baselines in plain PyTorch; the ``*_fused`` names (continuous engine
only) route paged decode through their fused CUDA kernel in
``kernels/paged_attention`` (``socket.use_paged_kernel`` for socket and
hard_lsh, ``quest.use_paged_kernel`` for quest); ``dense`` is full
attention.  ``--ring-kernel`` (continuous engine only) routes the
sliding-window layers' decode (gemma3-27b's local layers) through the
fused CUDA ring kernel.  ``--kv-dtype`` sets the K/V page storage
(``serving.kv_dtype``): ``auto`` (the compute dtype), ``bf16``, or
``int8``/``fp8`` rows with per-row scales, dequantized in-register by the
fused kernels; the config refuses what a path cannot consume (fp8 needs
the fused kernels, dense takes no fp8).  Whole-prompt prefill (the static
engine, and the continuous engine's legacy mode) attends through the
``flash_prefill`` CUDA kernel.  On the CPU every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.backends.kvquant import KV_DTYPES
from repro_torch.runtime.steps import make_prefill_step, make_serve_step
from repro_torch.serving.obs.events import strict_dumps

__all__ = ["run_serve", "run_continuous", "make_poisson_requests",
           "card_continuous_case", "card_prefix_case", "CARD_CASES",
           "CARD_PREEMPT_BLOCKS", "PREFIX_CASE",
           "resolve_device", "apply_backend_arg", "apply_kv_dtype",
           "device_name", "card_line", "SERVING_BACKENDS", "KV_DTYPES"]

# the DecodeBackend registry's names plus the *_fused pseudo-backends
# (backend + its use_paged_kernel gate: continuous engine only)
SERVING_BACKENDS = ("socket", "socket_fused", "dense", "quest",
                    "quest_fused", "hard_lsh", "hard_lsh_fused")


def apply_backend_arg(cfg, backend: str):
    """Resolve a serving backend name onto the config: ``socket`` routes
    scoring and subset attention through the port's contiguous-path
    kernels; ``socket_fused`` and ``hard_lsh_fused`` set
    ``socket.use_paged_kernel`` (hard_lsh shares SOCKET's cache layout
    and kernel gate), ``quest_fused`` sets ``quest.use_paged_kernel``;
    the rest name the backend (the JAX launcher's mapping)."""
    if backend not in SERVING_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {SERVING_BACKENDS}")
    if backend == "socket":
        return cfg.replace(attention_backend="socket", socket=dataclasses
                           .replace(cfg.socket, use_score_kernel=True,
                                    use_flash_decode=True))
    if backend in ("socket_fused", "hard_lsh_fused"):
        return cfg.replace(
            attention_backend=backend[: -len("_fused")],
            socket=dataclasses.replace(cfg.socket, use_paged_kernel=True))
    if backend == "quest_fused":
        return cfg.replace(
            attention_backend="quest",
            quest=dataclasses.replace(cfg.quest, use_paged_kernel=True))
    return cfg.replace(attention_backend=backend)


def apply_kv_dtype(cfg, kv_dtype):
    """Resolve a ``--kv-dtype`` value onto the config's serving settings
    (the JAX launcher's resolver).  ``None`` keeps the config's own
    ``serving.kv_dtype``; the dtype matrix itself (fp8 needs the fused
    kernels, quest needs round-trip stats, ...) is enforced by
    ``cfg.validate()``."""
    if kv_dtype is None:
        return cfg
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {KV_DTYPES}")
    return cfg.replace(serving=cfg.serving.replace(kv_dtype=kv_dtype))


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


def make_poisson_requests(cfg, num_requests: int, rate_rps: float,
                          prompt_lens, max_new_tokens: int, seed: int = 0):
    """Poisson arrival process with prompt lengths drawn from
    ``prompt_lens`` (numpy-seeded, the JAX launcher's draw)."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for _ in range(num_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = int(rng.choice(prompt_lens))
        prompt = rng.integers(0, cfg.vocab_size, size=plen,
                              dtype=np.int64).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=max_new_tokens,
                            arrival=t))
    return reqs


# arch -> (prompt lengths, max_blocks_per_seq, num_blocks, num_groups or
# None) of the continuous card case; gemma3-27b's depth is cut to 2
# groups (14 of 62 layers: 12 local, 2 global), as all 62 do not fit the
# card's 80 GB in fp32.  The legacy case's prefill buckets are 2048, 4096
# and max_context, so most prompts run padded (llama31-8b: 1024 and 3072;
# gemma3-27b: 3072 and 6144) and their logits and rings are taken at the
# last real token, short of the bucket's end.
CARD_CASES = {
    "llama31-8b": ([1024, 2048, 3072, 4096], 264, 1536, None),
    "gemma3-27b": ([2048, 3072, 4096, 6144], 392, 2048, 2),
}


# a pool llama31-8b's continuous card case (32 new tokens) preempts
# decoders in, not only requests mid-prefill (the schedule depends on the
# lengths alone; tests/test_torch_sampling.py pins it at smoke width)
CARD_PREEMPT_BLOCKS = 840


def card_continuous_case(cfg, seed: int, max_new_tokens: int,
                         backend: str = "socket_fused",
                         kv_dtype: str = "auto", legacy: bool = False,
                         num_blocks: Optional[int] = None):
    """The continuous engine's case at full width on the card, shared by
    ``chip_smoke.py``, the card tests and ``profile_decode.py``: ``cfg``
    with ``backend`` (a fused name) and serving settings for 8 requests
    (the prompt lengths of ``CARD_CASES[cfg.name]`` drawn from ``seed``,
    each twice, all arriving at once), chunks of 512 (``legacy``:
    whole-prompt prefill in buckets of 2048, 4096 and ``max_context``),
    16-token blocks, K/V pages stored as ``kv_dtype``
    and a pool that needs no preemption (``num_blocks``: another pool,
    which may preempt).  Sliding-window layers decode through the ring
    kernel (``use_ring_kernel``).  Returns (cfg, requests)."""
    from repro_torch.configs import ServingSettings
    from repro_torch.serving import Request
    base_lens, max_blocks, case_blocks, groups = CARD_CASES[cfg.name]
    lens = base_lens * 2
    if groups is not None:
        cfg = cfg.replace(num_groups=groups)
    if any(s.attn_type == "local" for s in cfg.layer_specs):
        cfg = cfg.replace(use_ring_kernel=True)
    sv = ServingSettings(block_size=16, max_batch=8, prefill_chunk=512,
                         max_blocks_per_seq=max_blocks,
                         num_blocks=case_blocks, kv_dtype=kv_dtype)
    if legacy:
        sv = sv.replace(prefill_chunk=0,
                        prefill_buckets=(2048, 4096, sv.max_context))
    # 1 trash block + every request's lifetime
    blocks = [-(-(n + max_new_tokens) // sv.block_size) for n in lens]
    if 1 + sum(blocks) > sv.num_blocks or max(blocks) > \
            sv.max_blocks_per_seq:
        raise ValueError(f"max_new_tokens={max_new_tokens} does not fit "
                         f"the case's pool without preemption")
    if num_blocks is not None:
        sv = sv.replace(num_blocks=num_blocks)
    cfg = apply_backend_arg(cfg, backend).replace(serving=sv)
    rng = np.random.default_rng(seed + 2)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=max_new_tokens) for n in lens]
    return cfg, reqs


# the prefix-cache card case: RAG traffic of 8 prompts of 3072 tokens
# sharing a 2300-token template (not a multiple of the 16-token page: a
# SOCKET hit shares a partial tail page, Quest's page-aligns down to 2288)
PREFIX_CASE = dict(requests=8, prompt_len=3072, template=2300)


def card_prefix_case(cfg, seed: int, max_new_tokens: int = 16,
                     backend: str = "socket_fused", kv_dtype: str = "auto"):
    """The prefix cache's case at full width on the card, shared by
    ``chip_smoke.py`` and its CPU tests: ``cfg`` with ``backend`` (a
    fused name) and the prefix cache on, chunks of 512, 16-token blocks,
    K/V pages stored as ``kv_dtype`` and a pool that needs no preemption
    even with the cache off; the prompts of
    :func:`~repro_torch.serving.prefix_cache.rag_prompts` (``PREFIX_CASE``,
    drawn from ``seed``).  Returns (cfg, template, prompts): the shared
    template is served alone first to seed the cache with its tail page
    (the radix index shares a partial page only as a finished prompt's
    tail)."""
    from repro_torch.configs import ServingSettings
    from repro_torch.serving.prefix_cache import rag_prompts
    n, plen, tlen = (PREFIX_CASE[k] for k in ("requests", "prompt_len",
                                              "template"))
    prompts = rag_prompts(n, prompt_len=plen, overlap=tlen / plen,
                          vocab_size=cfg.vocab_size, seed=seed)
    bs = 16
    per = -(-(plen + max_new_tokens) // bs)
    # 1 trash block + every request's lifetime, cold, + the template's
    num_blocks = 1 + n * per + -(-(tlen + max_new_tokens) // bs)
    sv = ServingSettings(block_size=bs, max_batch=n, prefill_chunk=512,
                         max_blocks_per_seq=per, num_blocks=num_blocks,
                         kv_dtype=kv_dtype, prefix_cache=True)
    cfg = apply_backend_arg(cfg, backend).replace(serving=sv)
    return cfg, prompts[0][:tlen], prompts


def run_continuous(cfg, num_requests: int, rate_rps: float, prompt_lens,
                   max_new_tokens: int, seed: int = 0, realtime=True,
                   warmup=False, params=None, device="cuda",
                   temperature: float = 0.0, top_p: float = 1.0,
                   prompts=None, obs=None):
    """Continuous-batching serve of Poisson-arriving requests; returns
    (requests, ServeMetrics, engine).  ``warmup=True`` runs the step
    shapes the workload needs first (chunked: the mixed and decode steps;
    legacy: the decode step and the buckets the prompts hit), so the
    reported latencies measure serving.  ``temperature > 0`` samples
    with ``top_p`` from per-request streams seeded from ``seed``.
    ``prompts``: explicit token lists (e.g. from
    :mod:`repro_torch.serving.prefix_cache.workloads`, whose shared
    prefixes independent random prompts never have) in place of the
    random draw; ``prompt_lens`` is then ignored.  ``obs``: an optional
    :class:`~repro_torch.serving.obs.Observability` bundle (event trace,
    selection probe, profiler) handed to the engine, whose run's metrics
    registry (``engine.registry``) gives the snapshot and Prometheus
    exposition."""
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(cfg, params=params, seed=seed,
                                      device=device, temperature=temperature,
                                      top_p=top_p, sample_seed=seed, obs=obs)
    if prompts is None:
        reqs = make_poisson_requests(cfg, num_requests, rate_rps,
                                     prompt_lens, max_new_tokens, seed=seed)
    else:
        if len(prompts) != num_requests:
            raise ValueError(f"prompts ({len(prompts)}) must match "
                             f"num_requests ({num_requests})")
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, num_requests))
        reqs = [Request(prompt=list(p), max_new_tokens=max_new_tokens,
                        arrival=float(t)) for p, t in zip(prompts, arrivals)]
    if warmup:
        engine.warmup(reqs)
    metrics = engine.run(reqs, realtime=realtime)
    return reqs, metrics, engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--backend", default="socket",
                    choices=list(SERVING_BACKENDS),
                    help="decode backend; the *_fused names route the "
                         "continuous engine through a fused paged kernel")
    ap.add_argument("--kv-dtype", default=None, choices=list(KV_DTYPES),
                    help="K/V pool page storage: 'auto' (compute dtype), "
                         "'bf16', or quantized 'int8'/'fp8' pages with "
                         "per-row scales dequantized in-kernel (default: "
                         "the config's serving.kv_dtype)")
    ap.add_argument("--ring-kernel", action="store_true",
                    help="route sliding-window (local) layer decode "
                         "through the fused CUDA ring kernel (continuous "
                         "engine; no-op for all-global architectures)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card unless 'cpu' is given)")
    # continuous-engine knobs
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill token budget per engine "
                         "iteration (0 = legacy whole-prompt bucketed "
                         "prefill; default: the config's "
                         "serving.prefill_chunk)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy (default)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the radix-tree prefix cache (continuous "
                         "engine, chunked prefill, all-paged plans; "
                         "hybrid/ring plans fall back to no sharing)")
    ap.add_argument("--workload", default="mixed",
                    choices=["mixed", "chatbot", "rag"],
                    help="request generator: 'mixed' = independent "
                         "random prompts of mixed lengths (default); "
                         "'chatbot' = multi-turn sessions whose prompts "
                         "share growing histories; 'rag' = shared "
                         "template + unique suffix")
    ap.add_argument("--overlap", type=float, default=0.6,
                    help="shared-template fraction of each prompt "
                         "(--workload rag)")
    ap.add_argument("--sessions", type=int, default=2,
                    help="number of concurrent chat sessions "
                         "(--workload chatbot)")
    # observability (continuous engine)
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="stream a schema-validated JSONL event trace "
                         "of the run to FILE")
    ap.add_argument("--perfetto", default=None, metavar="FILE",
                    help="also export the trace as Chrome trace-event "
                         "JSON (open at https://ui.perfetto.dev); "
                         "requires --trace")
    ap.add_argument("--metrics-json", default=None, metavar="FILE",
                    help="write the run's metrics-registry snapshot as "
                         "strict JSON")
    ap.add_argument("--metrics-prom", default=None, metavar="FILE",
                    help="write the run's metrics registry in "
                         "Prometheus text exposition format")
    ap.add_argument("--probe-every", type=int, default=0,
                    help="sample the selection-quality probe every N "
                         "engine iterations (0 = off; socket with "
                         "kvhead/pooled selection, hard_lsh, quest)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the engine "
                         "loop into this directory (engine.trace.json)")
    ap.add_argument("--profile-steps", type=int, default=20,
                    help="profiled window length in engine iterations "
                         "(with --profile-dir)")
    args = ap.parse_args(argv)

    if args.backend.endswith("_fused") and args.engine != "continuous":
        ap.error(f"--backend {args.backend} requires --engine continuous: "
                 "the fused kernels serve the paged decode path only")
    if args.ring_kernel and args.engine != "continuous":
        ap.error("--ring-kernel requires --engine continuous: the ring "
                 "kernel streams the paged pool's circular page lists")
    if args.prefill_chunk is not None and args.engine != "continuous":
        ap.error("--prefill-chunk requires --engine continuous")
    if args.temperature > 0 and args.engine != "continuous":
        ap.error("--temperature requires --engine continuous: sampling "
                 "lives in the continuous engine's decode step (the static "
                 "engine would silently decode greedily)")
    if not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.prefix_cache and args.engine != "continuous":
        ap.error("--prefix-cache requires --engine continuous: the prefix "
                 "cache shares pages of the continuous engine's paged pool")
    if args.workload != "mixed" and args.engine != "continuous":
        ap.error("--workload chatbot/rag requires --engine continuous")
    if not 0.0 <= args.overlap < 1.0:
        ap.error(f"--overlap must be in [0, 1), got {args.overlap}")
    obs_flags = (args.trace, args.perfetto, args.metrics_json,
                 args.metrics_prom, args.profile_dir)
    if (any(f is not None for f in obs_flags) or args.probe_every) \
            and args.engine != "continuous":
        ap.error("observability flags (--trace/--perfetto/--metrics-*/"
                 "--probe-every/--profile-dir) require --engine "
                 "continuous")
    if args.perfetto and not args.trace:
        ap.error("--perfetto needs --trace (it exports the event trace)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = apply_backend_arg(cfg, args.backend)
    cfg = apply_kv_dtype(cfg, args.kv_dtype)
    if args.ring_kernel:
        cfg = cfg.replace(use_ring_kernel=True)
    if args.prefill_chunk is not None:
        cfg = cfg.replace(serving=cfg.serving.replace(
            prefill_chunk=args.prefill_chunk))
    if args.prefix_cache:
        cfg = cfg.replace(serving=cfg.serving.replace(prefix_cache=True))
    dev = resolve_device(args.device)
    if args.engine == "continuous":
        max_new = args.max_new_tokens or (8 if args.smoke else 64)
        # legacy mode's largest bucket covers max_context (validate())
        top = cfg.serving.max_context - max_new
        if top < 1:
            ap.error(f"--max-new-tokens {max_new} leaves no prompt room "
                     f"under the serving context ceiling "
                     f"({cfg.serving.max_context} tokens)")
        lens = sorted({max(1, top // 4), max(1, top // 2),
                       max(1, (3 * top) // 4), top})
        prompts = None
        if args.workload == "chatbot":
            from repro_torch.serving.prefix_cache import chatbot_prompts
            prompts = chatbot_prompts(args.num_requests,
                                      sessions=args.sessions,
                                      max_prompt_len=top,
                                      vocab_size=cfg.vocab_size,
                                      seed=args.seed)
        elif args.workload == "rag":
            from repro_torch.serving.prefix_cache import rag_prompts
            prompts = rag_prompts(args.num_requests, prompt_len=top,
                                  overlap=args.overlap,
                                  vocab_size=cfg.vocab_size, seed=args.seed)
        obs = None
        if any(f is not None for f in obs_flags) or args.probe_every:
            from repro_torch.serving.obs import Observability
            obs = Observability(args.trace, probe_every=args.probe_every,
                                profile_dir=args.profile_dir,
                                profile_steps=args.profile_steps)
        reqs, m, engine = run_continuous(
            cfg, args.num_requests, args.rate, lens, max_new, seed=args.seed,
            device=dev, temperature=args.temperature, top_p=args.top_p,
            prompts=prompts, obs=obs)
        report = {
            "arch": cfg.name, "backend": args.backend,
            "engine": "continuous",
            "kv_dtype": cfg.serving.kv_dtype,
            "prefill_chunk": cfg.serving.prefill_chunk,
            "workload": args.workload,
            "prompt_lens": lens if prompts is None else sorted(
                {len(p) for p in prompts}),
            "max_new_tokens": max_new,
            "temperature": args.temperature, "top_p": args.top_p,
            "finished": sum(r.state == "finished" for r in reqs),
            **m.to_json(), "device": device_name(dev)}
        if args.prefix_cache:
            reg = engine.registry
            hits = reg.value("prefix_cache_hits_total")
            misses = reg.value("prefix_cache_misses_total")
            report["prefix_cache"] = {
                # None where the plan cannot share (hybrid or ring plans,
                # legacy prefill): the flag is then a no-op
                "active": engine.prefix_cache is not None,
                "hits": hits, "misses": misses,
                "hit_rate": hits / (hits + misses) if hits + misses
                else None,
                "cached_tokens": reg.value(
                    "prefix_cache_cached_tokens_total"),
                "prompt_tokens": reg.value(
                    "prefix_cache_prompt_tokens_total"),
                "cow_copies": reg.value("prefix_cache_cow_total"),
                "evicted_blocks": reg.value("prefix_cache_evicted_total"),
            }
        if obs is not None:
            obs.close()
            if args.probe_every:
                report["probe"] = obs.probe_summary()
            if args.perfetto:
                from repro_torch.serving.obs import write_chrome_trace
                write_chrome_trace(args.trace, args.perfetto)
            if args.metrics_json:
                with open(args.metrics_json, "w") as f:
                    f.write(strict_dumps(engine.registry.snapshot(),
                                         indent=2, sort_keys=True))
            if args.metrics_prom:
                with open(args.metrics_prom, "w") as f:
                    f.write(engine.registry.prometheus_text())
        print(strict_dumps(report, indent=2))
        return
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
