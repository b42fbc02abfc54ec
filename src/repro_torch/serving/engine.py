"""Continuous-batching serving engine on a paged K/V pool.

Port of ``repro.serving.engine`` (greedy decoding, layouts of global and
sliding-window attention layers) with its two execution models:

* **chunked prefill** (``serving.prefill_chunk > 0``, the default): the
  token-budget mixed step.  Each iteration the scheduler grants at most
  ONE fixed-size prefill chunk alongside the full ragged decode batch,
  and one mixed step runs both: the chunk writes its pages and attends
  over the pages earlier chunks committed
  (:func:`repro_torch.models.attention.attention_prefill_chunk`), then
  the decode batch runs one token.  Iterations with no chunk run the
  decode-only step.  A long prompt stalls in-flight decodes by at most
  one chunk.
* **legacy whole-prompt prefill** (``prefill_chunk == 0``): each
  iteration admits up to ``max_prefill_per_iter`` requests and prefills
  each whole prompt, zero-padded to the smallest of
  ``serving.prefill_buckets`` that holds it, through the static stack
  (causal attention through the ``flash_prefill`` CUDA kernel on the
  card) into a fresh batch=1 cache, which ``paged.write_prefill``
  scatters into the request's pages; the request then joins the same
  iteration's decode.  Logits and sliding-window rings are taken at the
  prompt's last real token.  The largest bucket must cover
  ``max_context`` (``ServingSettings.validate``).

For paged-capable backends (``DecodeBackend.supports_paged``: socket,
hard_lsh, quest) the decode step hands the pool and block tables straight
to the model: appends write pages in place and attention reads the
metadata leaves plus the selected K/V rows — with ``use_paged_kernel``
(``cfg.socket`` for socket and hard_lsh, ``cfg.quest`` for quest) all of
it in one CUDA pass (``kernels/paged_attention``).  Sliding-window
layers keep a circular page list of ``ring_blocks`` pages per request
(``cfg.cache_plan()`` kind ``ring``) and decode from it in place, with
``cfg.use_ring_kernel`` through the fused CUDA ring kernel.  Otherwise
(dense) the engine falls back to the gather/scatter round trip
(``paged.gather_views`` / ``scatter_token``), window-bounded for ring
layers.

Where the JAX engine jits and donates the pool, the port runs eagerly
and updates the pool in place.  Preemption is recompute-style and
token-exact: a resumed request re-prefills its prompt and replays its
recorded tokens through the decode path.

The pool's K/V pages are stored at ``serving.kv_dtype`` (``auto``,
``bf16``, or int8/fp8 rows with per-row scale leaves; see
:mod:`repro_torch.models.backends.kvquant`): every write quantizes, every
read dequantizes, the fused kernels in-register, and a preempted request
re-quantizes the same prompt rows when it is prefilled again.

Not ported yet, each raising :class:`NotImplementedError` naming its
ROADMAP.md queue 1 item: the prefix cache and sampling (item 8),
observability (item 9), state (Mamba) and MoE layers (item 7).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import backends as bk
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import (make_chunk_prefill_step,
                                      make_prefill_step, make_serve_step)
from repro_torch.serving import paged
from repro_torch.serving.block_pool import TRASH_BLOCK, BlockPool
from repro_torch.serving.obs.metrics import Registry
from repro_torch.serving.scheduler import (PREFILL, PrefillChunk, Request,
                                           Scheduler)

__all__ = ["ContinuousBatchingEngine", "ServeMetrics"]


@dataclasses.dataclass
class ServeMetrics:
    """Aggregate serving metrics for one engine run."""

    num_requests: int
    total_generated: int
    wall_s: float
    throughput_tok_s: float
    ttft_s_mean: float
    ttft_s_p99: float
    token_latency_s_p50: float
    token_latency_s_p99: float
    preemptions: int
    decode_iters: int
    prefill_chunks: int
    # longest wall-clock gap between consecutive token emissions of any
    # single request (the head-of-line-blocking metric)
    intertoken_stall_s_max: float
    # p99 over step-call durations (mixed or decode-only)
    decode_iter_s_p99: float

    def to_json(self) -> Dict:
        """Strict-JSON dict: non-finite floats (empty-series percentiles
        are NaN) become ``None``."""
        out = {}
        for k, v in dataclasses.asdict(self).items():
            if isinstance(v, float):
                v = round(v, 6) if math.isfinite(v) else None
            out[k] = v
        return out


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md queue 1 item "
        f"{item}")


class ContinuousBatchingEngine:
    """Paged-cache continuous batching over one model replica.

    ``params``: the port's parameters (drawn from ``seed`` on ``device``
    when None).  ``device``: where the pool lives and the steps run,
    ``"cuda"`` by default (a CUDA device with no card raises).  Decoding
    is greedy.
    """

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0, *,
                 device="cuda", temperature: float = 0.0, obs=None):
        from repro_torch.launch.serve import resolve_device
        self._validate(cfg, temperature, obs)
        self.cfg = cfg
        self.serving = cfg.serving
        self.serving.validate()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference computes in float32: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = tfm.init_model(cfg, seed, self.device)
        self.params = params
        self.backend = bk.get_backend(cfg.attention_backend)
        plan = cfg.cache_plan()
        has_paged = any(p.kind == "paged" for p in plan)
        ring_blocks = max((p.ring_blocks for p in plan
                           if p.kind == "ring"), default=0)
        # page-native decode: a paged-capable backend, or no global layer
        # consumes the backend at all (ring layers are page-native)
        self._paged_native = self.backend.supports_paged or not has_paged
        self.pages = paged.init_paged_caches(cfg, self.serving, self.device)
        self.pool = BlockPool(self.serving.num_blocks)
        self.scheduler = Scheduler(
            self.pool, max_batch=self.serving.max_batch,
            max_blocks_per_seq=self.serving.max_blocks_per_seq,
            block_size=self.serving.block_size,
            has_paged_layers=has_paged, ring_blocks=ring_blocks,
            prefill_chunk=self.serving.prefill_chunk)
        self._serve = make_serve_step(cfg)
        self._chunk = make_chunk_prefill_step(cfg)
        self._prefilling: Optional[Request] = None
        # called as iter_hook(engine, iteration) at the end of every engine
        # iteration (tests, profiling); a true return ends the run there.
        # None in production
        self.iter_hook = None
        # (iteration, rid, chunk.start, chunk.tokens) per chunk co-run
        self.chunk_trace: List[Tuple[int, int, int, int]] = []
        # legacy mode: (iteration, rid, bucket, host seconds) per
        # whole-prompt prefill of the run
        self.prefill_trace: List[Tuple[int, int, int, float]] = []
        # host seconds of each step call warmup() made, by shape:
        # "decode", "mixed" or "prefill_{bucket}"
        self.warmup_s: Dict[str, float] = {}
        self.registry = Registry()
        self._bind_instruments(self.registry)

    @staticmethod
    def _validate(cfg: ModelConfig, temperature, obs) -> None:
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                "continuous engine serves token models only")
        sv = cfg.serving
        if sv.prefix_cache:
            raise _not_ported("the prefix cache (serving.prefix_cache)", 8)
        if temperature > 0:
            raise _not_ported(
                "sampling (temperature > 0): it needs per-request generator "
                "streams that replay across preemption,", 8)
        if obs is not None:
            raise _not_ported("serving observability (obs)", 9)
        if any(s.kind != "attn" or s.mlp not in ("dense", "none")
               for s in cfg.layer_specs):
            raise _not_ported("state (Mamba) and MoE layers", 7)
        # resolves the backend (ValueError on unknown names)
        bk.get_backend(cfg.attention_backend).cache_spec(cfg)

    @property
    def chunked(self) -> bool:
        return self.serving.prefill_chunk > 0

    # ------------------------------------------------------ metrics
    def _bind_instruments(self, reg: Registry) -> None:
        """Create the run-scoped serving series (exact samples, so the
        end-of-run percentiles equal ``np.percentile`` over the run)."""
        self._c_tokens = reg.counter("serve_tokens_total")
        self._h_ttft = reg.histogram("serve_ttft_s", exact=True)
        self._h_lat = reg.histogram("serve_token_latency_s", exact=True)
        self._h_stall = reg.histogram("serve_intertoken_stall_s",
                                      exact=True)
        self._h_iter = reg.histogram("serve_iter_s", exact=True)

    def _set_gauges(self, reg: Registry) -> None:
        st = self.pool.stats()
        reg.gauge("pool_blocks_free").set(st["free"])
        reg.gauge("pool_blocks_used").set(st["used"])
        reg.gauge("pool_blocks_high_water").set(st["high_water"])
        sched = self.scheduler
        reg.gauge("batch_running").set(len(sched.running))
        reg.gauge("batch_prefilling").set(len(sched.prefilling))
        reg.gauge("batch_waiting").set(len(sched.waiting))

    def _note_token(self, req: Request, w: float) -> None:
        self._c_tokens.inc()
        req.token_walls.append(w)
        if len(req.token_walls) >= 2:
            self._h_stall.record(req.token_walls[-1] - req.token_walls[-2])

    def _note_first_token(self, req: Request, t: float) -> None:
        req.t_first_token = t
        self._h_ttft.record(t - req.arrival)

    # ------------------------------------------------------ steps
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _pick(logits: torch.Tensor) -> torch.Tensor:
        """Greedy next token from one step's ``(B, 1, V)`` logits (the
        first maximum, as ``jnp.argmax``)."""
        return torch.argmax(logits[:, -1], dim=-1)

    def _decode_body(self, tokens, bt, pos) -> torch.Tensor:
        """The ragged decode shared by the decode-only and mixed steps;
        inactive slots hold trash-page block tables, so their writes land
        in block 0."""
        if self._paged_native:
            logits, _ = self._serve(self.params, self.pages, tokens, pos, bt)
        else:
            views = paged.gather_views(self.cfg, self.pages, bt)
            logits, views = self._serve(self.params, views, tokens, pos)
            paged.scatter_token(self.cfg, self.pages, views, bt, pos)
        return self._pick(logits)

    def _mixed_step(self, ch_tokens, ch_bt, ch_hist: int, ch_last: int,
                    tokens, bt, pos) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill chunk + the ragged decode batch.  The chunk runs
        first (its writes land in blocks disjoint from every decoding
        request)."""
        logits_c, _ = self._chunk(self.params, self.pages, ch_tokens, ch_bt,
                                  ch_hist, ch_last)
        return self._pick(logits_c)[0], self._decode_body(tokens, bt, pos)

    def _chunk_bt_len(self) -> int:
        """Chunk block-table row length: the full per-request table plus
        one chunk of slack, so the final (padded) chunk's block window
        never clamps — its overhang entries are trash.  It always covers
        the ring's ``ring_blocks`` entries (``ring_geometry`` clamps them
        to ``max_blocks_per_seq``), also when a ring is shorter than one
        chunk: ring layers address entries modulo ``ring_blocks``."""
        sv = self.serving
        return sv.max_blocks_per_seq + sv.prefill_chunk // sv.block_size

    def _batch_inputs(self, runnable: List[Request]):
        sv = self.serving
        tokens = np.zeros((sv.max_batch, 1), np.int64)
        bt = np.full((sv.max_batch, sv.max_blocks_per_seq), TRASH_BLOCK,
                     np.int32)
        pos = np.zeros((sv.max_batch,), np.int64)
        for r in runnable:
            tokens[r.slot, 0] = r.input_token(r.pos)
            bt[r.slot, :len(r.blocks)] = r.blocks
            pos[r.slot] = r.pos
        return self._to_dev(tokens), self._to_dev(bt), self._to_dev(pos)

    def _bt_row_len(self, bucket: int) -> int:
        """Legacy prefill block-table row length: the bucket's blocks, but
        at least the circular window pages (a short prompt's ring still
        spans ``ring_blocks`` table entries; unallocated ones are
        trash)."""
        return max(bucket // self.serving.block_size,
                   self.scheduler.ring_blocks)

    def _bucket_for(self, n: int) -> int:
        for b in sorted(self.serving.prefill_buckets):
            if b >= n:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds largest prefill bucket "
            f"{max(self.serving.prefill_buckets)} (chunked prefill — "
            f"serving.prefill_chunk > 0 — serves prompts up to "
            f"max_context {self.serving.max_context})")

    def _prefill_step(self, tokens: torch.Tensor, last_index: int,
                      bt_row: torch.Tensor, slot: int) -> torch.Tensor:
        """One whole-prompt prefill of a bucket-padded ``(1, bucket)``
        prompt into a fresh cache, scattered into the pages of
        ``bt_row``; returns the greedy token at ``last_index``."""
        bucket = tokens.shape[1]
        prefill = make_prefill_step(self.cfg, bucket, paged=True)
        logits, caches = prefill(self.params, {"tokens": tokens},
                                 torch.tensor([last_index],
                                              device=self.device))
        paged.write_prefill(self.cfg, self.pages, caches, bt_row, slot)
        return self._pick(logits)[0]

    def _prefill_one(self, req: Request, wall, iteration: int) -> None:
        """Legacy mode: prefill ``req``'s whole prompt into its pages and
        record its first token (unless replay already holds it)."""
        prompt = req.prefill_tokens
        bucket = self._bucket_for(len(prompt))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(prompt)] = prompt
        bt_row = np.full((self._bt_row_len(bucket),), TRASH_BLOCK, np.int32)
        bt_row[:len(req.blocks)] = req.blocks
        t_p = time.perf_counter()
        first_tok = int(self._prefill_step(self._to_dev(tokens),
                                           len(prompt) - 1,
                                           self._to_dev(bt_row), req.slot))
        self.prefill_trace.append((iteration, req.rid, bucket,
                                   time.perf_counter() - t_p))
        if not req.generated:
            req.generated.append(first_tok)
            self._note_token(req, wall())
        # resumed after preemption: the prefill only rebuilt the prompt's
        # pages and window rings (bit-exact recomputation); the recorded
        # tokens now replay through the decode path, which produced them,
        # so generation is token-exact regardless of pool pressure

    def warmup(self, requests: Optional[List[Request]] = None) -> None:
        """Run the step shapes a run needs against the trash page, so a
        following run's latencies measure serving, not kernel builds and
        allocator growth: the decode-only step, then the mixed step
        (chunked mode) or one whole-prompt prefill a bucket (legacy mode:
        only the buckets ``requests`` hit when given, all of them
        otherwise).  Each call's host seconds land in ``warmup_s``."""
        sv = self.serving

        def timed(tag, fn, *args):
            t_w = time.perf_counter()
            fn(*args)
            self._sync()
            self.warmup_s[tag] = time.perf_counter() - t_w

        tokens, bt, pos = self._batch_inputs([])
        timed("decode", self._decode_body, tokens, bt, pos)
        if self.chunked:
            ch_bt = self._to_dev(np.full((self._chunk_bt_len(),),
                                         TRASH_BLOCK, np.int32))
            ch_tokens = self._to_dev(np.zeros((1, sv.prefill_chunk),
                                              np.int64))
            timed("mixed", self._mixed_step, ch_tokens, ch_bt, 0, 0, tokens,
                  bt, pos)
            return
        buckets = sv.prefill_buckets if requests is None else sorted(
            {self._bucket_for(len(r.prefill_tokens)) for r in requests})
        for bucket in buckets:
            bt_row = self._to_dev(np.full((self._bt_row_len(bucket),),
                                          TRASH_BLOCK, np.int32))
            timed(f"prefill_{bucket}", self._prefill_step,
                  self._to_dev(np.zeros((1, bucket), np.int64)), 0, bt_row,
                  0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ run
    def run(self, requests: List[Request],
            realtime: bool = True) -> ServeMetrics:
        """Serve ``requests`` (arrival times in seconds relative to run
        start) to completion.  ``realtime=False`` treats arrivals as
        already-arrived (offline batch; deterministic)."""
        sched = self.scheduler
        reg = self.registry = Registry()     # run-scoped
        self._bind_instruments(reg)
        sched.bind_obs(reg, None)
        self.chunk_trace = []
        self.prefill_trace = []
        for r in requests:
            sched.submit(r)
        t0 = time.perf_counter()
        wall = lambda: time.perf_counter() - t0
        now = wall if realtime else (lambda: float("inf"))
        stamp = wall if realtime else (lambda: 0.0)
        decode_iters = 0
        c_iters_mixed = reg.counter("serve_iters_total", kind="mixed")
        c_iters_decode = reg.counter("serve_iters_total", kind="decode")
        c_chunks = reg.counter("serve_chunks_total")

        while sched.has_work:
            chunk: Optional[PrefillChunk] = None
            if self.chunked:
                # decode-table growth FIRST (it may evict the prefiller,
                # which must not happen after a chunk has been granted)...
                runnable = sched.ensure_decode_blocks()
                if self._prefilling is not None and \
                        self._prefilling.state != PREFILL:
                    self._prefilling = None  # evicted by decode growth
                # ...then the chunk grant (alloc-only)
                if self._prefilling is None:
                    self._prefilling = sched.try_admit(now())
                if self._prefilling is not None:
                    chunk = sched.grant_chunk(self._prefilling)
                    if chunk is None and \
                            self._prefilling.state != PREFILL:
                        self._prefilling = None   # safety self-preempt
            else:
                # legacy order: whole-prompt prefill phase, then growth —
                # a request admitted this iteration decodes this
                # iteration
                for _ in range(self.serving.max_prefill_per_iter):
                    req = sched.try_admit(now())
                    if req is None:
                        break
                    self._prefill_one(req, wall, decode_iters)
                    if req.t_first_token is None:
                        self._note_first_token(req, stamp())
                    sched.activate(req)
                    if req.done:      # max_new_tokens == 1 degenerate case
                        sched.finish(req, stamp())
                runnable = sched.ensure_decode_blocks()

            if not runnable and chunk is None:
                if sched.waiting and not sched.running and \
                        self._prefilling is None:
                    nxt = min(r.arrival for r in sched.waiting)
                    wait = nxt - now()
                    if realtime and wait > 0:
                        time.sleep(min(wait, 0.05))
                continue
            t_it = time.perf_counter()
            tokens, bt, pos = self._batch_inputs(runnable)
            if chunk is not None:
                first_tok, next_tok = self._run_mixed(chunk, tokens, bt, pos)
                self.chunk_trace.append((decode_iters, self._prefilling.rid,
                                         chunk.start, chunk.tokens))
                c_chunks.inc()
                self._finish_chunk(chunk, first_tok, wall, stamp)
            else:
                next_tok = self._decode_body(tokens, bt, pos)
            next_tok = next_tok.cpu().numpy()
            it_s = time.perf_counter() - t_it
            self._h_iter.record(it_s)
            (c_iters_mixed if chunk is not None else c_iters_decode).inc()
            for r in runnable:
                # post-preemption replay: steps whose output token is
                # already recorded only rebuild the cache; the produced
                # token is discarded (token-exact resume)
                replaying = r.pos - len(r.prompt) + 1 < len(r.generated)
                if not replaying:
                    r.generated.append(int(next_tok[r.slot]))
                    r.token_latencies.append(it_s)
                    self._h_lat.record(it_s)
                    self._note_token(r, wall())
                r.pos += 1
                if r.done and not replaying:
                    sched.finish(r, stamp())
            self._set_gauges(reg)
            decode_iters += 1
            if self.iter_hook is not None and \
                    self.iter_hook(self, decode_iters):
                break

        wall_total = time.perf_counter() - t0
        return self._metrics(requests, wall_total)

    # ------------------------------------------------------ chunk
    def _run_mixed(self, chunk: PrefillChunk, tokens, bt, pos):
        """Dispatch the mixed step for ``chunk`` plus the decode batch."""
        req = self._prefilling
        c = self.serving.prefill_chunk
        ch_tokens = np.zeros((1, c), np.int64)
        ch_tokens[0, :chunk.tokens] = \
            req.prefill_tokens[chunk.start:chunk.start + chunk.tokens]
        ch_bt = np.full((self._chunk_bt_len(),), TRASH_BLOCK, np.int32)
        ch_bt[:len(req.blocks)] = req.blocks
        return self._mixed_step(self._to_dev(ch_tokens), self._to_dev(ch_bt),
                                chunk.start, chunk.tokens - 1, tokens, bt,
                                pos)

    def _finish_chunk(self, chunk: PrefillChunk, first_tok, wall,
                      stamp) -> None:
        """Advance the cursor; on the final chunk record the first token
        (unless replay already holds it) and activate into decode."""
        req = self._prefilling
        sched = self.scheduler
        sched.advance_chunk(req, chunk)
        if not chunk.final:
            return
        if not req.generated:
            req.generated.append(int(first_tok))
            self._note_token(req, wall())
        if req.t_first_token is None:
            self._note_first_token(req, stamp())
        sched.activate(req)
        if req.done:                  # max_new_tokens == 1 degenerate case
            sched.finish(req, stamp())
        self._prefilling = None

    # ------------------------------------------------------ metrics
    def _metrics(self, requests: List[Request],
                 wall: float) -> ServeMetrics:
        """End-of-run aggregate, derived from the run's registry."""
        reg = self.registry
        total = int(reg.value("serve_tokens_total"))
        return ServeMetrics(
            num_requests=len(requests),
            total_generated=total,
            wall_s=wall,
            throughput_tok_s=total / wall if wall > 0 else float("nan"),
            ttft_s_mean=self._h_ttft.mean_exact(),
            ttft_s_p99=self._h_ttft.percentile_exact(99),
            token_latency_s_p50=self._h_lat.percentile_exact(50),
            token_latency_s_p99=self._h_lat.percentile_exact(99),
            preemptions=int(reg.value("serve_preemptions_total")),
            decode_iters=int(reg.value("serve_iters_total")),
            prefill_chunks=int(reg.value("serve_chunks_total")),
            intertoken_stall_s_max=self._h_stall.max_exact(),
            decode_iter_s_p99=self._h_iter.percentile_exact(99),
        )
