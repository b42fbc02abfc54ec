"""Continuous-batching serving engine on a paged K/V pool.

Port of ``repro.serving.engine`` (layouts of global and sliding-window
attention layers) with its two execution models:

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

**Prefix cache** (``serving.prefix_cache``): where the plan can share
pages — chunked prefill and every layer paged (ring layers recycle their
pages in place; legacy whole-prompt prefill has no chunk cursor; hybrid
and legacy plans keep the flag and serve with no sharing) — admission
matches each prompt against a radix index of committed prompt pages
(:mod:`repro_torch.serving.prefix_cache`) and starts the prefill cursor
past the cached prefix.  A page with pool refcount > 1 is never written
in place: before a chunk or decode write lands in a shared page, the
engine clones it (:func:`repro_torch.serving.paged.clone_block`, keeping
the matched rows and scrubbing the rest) and swaps the clone into the
request's table.  Plans with page-granular leaves (Quest's page bounds)
share page-aligned prefixes only and never clone.

**Sampling** is greedy by default (``torch.argmax``, bit for bit);
``temperature > 0`` samples with temperature and top-p
(:func:`repro_torch.serving.sampling.sample_tokens`).  Each request owns
a Gumbel noise stream (:class:`~repro_torch.serving.sampling
.GumbelStream`: a ``torch.Generator`` on the engine's device seeded from
``sample_seed`` and the request's submission index), restarted at every
admission and drawn once for each token its slot consumes: one draw an
active decode step, one on the final prefill chunk (the whole-prompt
prefill in legacy mode), replayed tokens after a preemption included
(the draw is made and the token discarded).  A request's draw for token
``t`` is therefore a pure function of (seed, submission index, t).

**Observability** (``obs=``, a :class:`~repro_torch.serving.obs
.Observability`; the JAX engine's): a schema-validated JSONL event trace
(``trace_start``, ``run_start``/``run_end``, request lifecycles from the
scheduler and the prefix cache, one ``step`` record an iteration, a
``compile`` event at the first dispatch of each step shape — in the port
that dispatch includes the lazy ``nvcc`` builds and library set-up —
and ``cow_copy``), the sampled selection-quality probe and a
``torch.profiler`` window.  The probe re-runs the decode batch before
the production step as a shadow step with the capture flag up
(:mod:`repro_torch.models.backends.probe`): the plain selection route,
which is the fused kernels' selection bit for bit (SOCKET: but for rows
inside the top-k threshold band).  Its host seconds are left out of the
iteration's ``step_s``.  Since the port's pool updates in place, the
shadow step's appends would stay in the pool (Quest's page bounds are
read-modify-write, so a shadow write could move a later selection): the
engine saves every block the shadow step can write (each active slot's
current page, its ring page, the trash page) in every leaf and restores
them, so the pool is bitwise what it was.  The shadow step picks no
token and draws no noise.  With ``obs=None`` the engine holds no tracer,
probe or profiler, and greedy tokens are bit-identical either way.

Not ported yet, raising :class:`NotImplementedError` naming ROADMAP.md
queue 1 item 7: state (Mamba) and MoE layers.
"""

from __future__ import annotations

import contextlib
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
from repro_torch.serving import paged, sampling
from repro_torch.serving.block_pool import TRASH_BLOCK, BlockPool
from repro_torch.serving.obs import Observability
from repro_torch.serving.obs.metrics import Registry
from repro_torch.serving.prefix_cache import PrefixCache
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
    ``"cuda"`` by default (a CUDA device with no card raises).
    ``temperature`` 0 decodes greedily; above 0 it samples with ``top_p``
    from per-request noise streams seeded from ``sample_seed``.  ``obs``:
    an :class:`~repro_torch.serving.obs.Observability` bundle (event
    trace, selection probe, profiler), or None for none of it.
    """

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0, *,
                 device="cuda", temperature: float = 0.0, top_p: float = 1.0,
                 sample_seed: int = 0, obs: Optional[Observability] = None):
        from repro_torch.launch.serve import resolve_device
        self._validate(cfg)
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
        has_paged = self._has_paged = any(p.kind == "paged" for p in plan)
        ring_blocks = max((p.ring_blocks for p in plan
                           if p.kind == "ring"), default=0)
        # page-native decode: a paged-capable backend, or no global layer
        # consumes the backend at all (ring layers are page-native)
        self._paged_native = self.backend.supports_paged or not has_paged
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.sample_seed = sample_seed
        self._submitted = 0
        # the class of the per-request noise streams (tests feed another
        # noise source through a subclass)
        self.stream_cls = sampling.GumbelStream
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
        # Cross-request page reuse is valid exactly when chunked prefill is
        # on (a hit IS a prefill starting at a nonzero cursor) and every
        # layer is paged (ring layers recycle their block-table prefix
        # circularly, so a "shared prefix" would be rewritten in place).
        # Other plans fall back to no sharing: the flag stays on, no cache
        # is built, serving is unchanged.
        self.prefix_cache = None
        if self.serving.prefix_cache and self.chunked and \
                all(p.kind == "paged" for p in plan):
            # granularity > 1 leaves (Quest's page bounds) summarize every
            # row of a page: such plans share page-aligned prefixes only
            # and never reach the CoW clone
            tail_ok = all(s.granularity == 1 for s in
                          self.backend.cache_spec(cfg).values())
            self.prefix_cache = PrefixCache(
                self.pool, block_size=self.serving.block_size,
                tail_shareable=tail_ok)
            self.scheduler.prefix_cache = self.prefix_cache
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
        # ---- observability: the metrics registry is always on (the
        # end-of-run ServeMetrics derive from it); tracer, probe and
        # profiler exist only when ``obs`` is given
        self.obs = obs
        self.registry = Registry()
        self._bind_instruments(self.registry)
        self._compile_seen: set = set()
        self._probe_capable = (
            (cfg.attention_backend in ("hard_lsh", "quest")
             or (cfg.attention_backend == "socket"
                 and cfg.socket.selection in ("kvhead", "pooled")))
            and has_paged)
        if obs is not None:
            if obs.profiler is not None:
                obs.profiler.device = self.device
            counts = paged.cache_kind_counts(cfg)
            obs.tracer.ensure_start(
                arch=cfg.name, backend=cfg.attention_backend,
                prefill_chunk=self.serving.prefill_chunk,
                layers_paged=counts["paged"], layers_ring=counts["ring"],
                layers_state=counts["state"],
                prefix_cache=self.prefix_cache is not None)

    @staticmethod
    def _validate(cfg: ModelConfig) -> None:
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                "continuous engine serves token models only")
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
        if self.prefix_cache is not None:
            reg.gauge("prefix_cache_shared_blocks").set(
                self.prefix_cache.shared_blocks)
            reg.gauge("prefix_cache_evictable_blocks").set(
                self.prefix_cache.evictable_blocks())

    def _note_call(self, tag: str, seconds: float) -> None:
        """The first dispatch of a step shape (``decode``, ``mixed``,
        ``probe``, ``cow_clone``, ``prefill_{bucket}``) includes the lazy
        kernel builds and library set-up: record it as a ``compile`` event
        so latency analysis can discount it (warm-up marks the shapes it
        covers)."""
        if tag in self._compile_seen:
            return
        self._compile_seen.add(tag)
        if self.obs is not None:
            self.obs.tracer.emit("compile", fn=tag,
                                 seconds=round(seconds, 6))

    def _annotate(self, name: str):
        """The profiler's ``record_function`` for ``name`` inside its
        window, a null context otherwise."""
        if self.obs is None or self.obs.profiler is None:
            return contextlib.nullcontext()
        return self.obs.profiler.annotate(name)

    def _note_token(self, req: Request, w: float) -> None:
        """Per-emitted-token bookkeeping (the token is already appended);
        when sampling, the index of the draw it was sampled with."""
        if self.temperature > 0:
            req.sample_key.emitted.append(req.sample_key.draws - 1)
        self._c_tokens.inc()
        req.token_walls.append(w)
        if len(req.token_walls) >= 2:
            self._h_stall.record(req.token_walls[-1] - req.token_walls[-2])

    def _note_first_token(self, req: Request, t: float) -> None:
        req.t_first_token = t
        ttft = t - req.arrival
        self._h_ttft.record(ttft)
        if self.obs is not None:
            self.obs.tracer.emit("first_token", rid=req.rid,
                                 ttft_s=round(ttft, 6))

    # ------------------------------------------------------ steps
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pick(self, logits: torch.Tensor, reqs=()) -> torch.Tensor:
        """Next token of each row of one step's ``(B, 1, V)`` logits:
        greedy at temperature 0 (the first maximum, as ``jnp.argmax``);
        otherwise sampled, each row with one draw of its request's noise
        stream (``reqs[i]``; None, or past the end of ``reqs``: an idle
        row, which draws nothing)."""
        last = logits[:, -1]
        if self.temperature <= 0:
            return torch.argmax(last, dim=-1)
        gumbel = torch.zeros(last.shape, dtype=torch.float32,
                             device=last.device)
        for i, r in enumerate(reqs):
            if r is not None:
                gumbel[i] = r.sample_key.draw(last.shape[-1])
        return sampling.sample_tokens(last, gumbel,
                                      temperature=self.temperature,
                                      top_p=self.top_p,
                                      vocab_size=self.cfg.vocab_size)

    def _decode_body(self, tokens, bt, pos, reqs=()) -> torch.Tensor:
        """The ragged decode shared by the decode-only and mixed steps;
        inactive slots hold trash-page block tables, so their writes land
        in block 0.  ``reqs``: the request of each slot (None where idle),
        whose noise streams a sampling engine draws from."""
        if self._paged_native:
            logits, _ = self._serve(self.params, self.pages, tokens, pos, bt)
        else:
            views = paged.gather_views(self.cfg, self.pages, bt)
            logits, views = self._serve(self.params, views, tokens, pos)
            paged.scatter_token(self.cfg, self.pages, views, bt, pos)
        return self._pick(logits, reqs)

    def _mixed_step(self, ch_tokens, ch_bt, ch_hist: int, ch_last: int,
                    tokens, bt, pos, ch_req=None,
                    reqs=()) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill chunk + the ragged decode batch.  The chunk runs
        first (its writes land in blocks disjoint from every decoding
        request).  ``ch_req``: the chunk's request where the chunk is its
        final one (it draws for the first token), else None."""
        logits_c, _ = self._chunk(self.params, self.pages, ch_tokens, ch_bt,
                                  ch_hist, ch_last)
        return (self._pick(logits_c, [ch_req])[0],
                self._decode_body(tokens, bt, pos, reqs))

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
                      bt_row: torch.Tensor, slot: int,
                      req: Optional[Request] = None) -> torch.Tensor:
        """One whole-prompt prefill of a bucket-padded ``(1, bucket)``
        prompt into a fresh cache, scattered into the pages of
        ``bt_row``; returns the token picked at ``last_index`` (a sampling
        engine draws once from ``req``'s stream; the warm-up passes
        None and draws nothing)."""
        bucket = tokens.shape[1]
        prefill = make_prefill_step(self.cfg, bucket, paged=True)
        logits, caches = prefill(self.params, {"tokens": tokens},
                                 torch.tensor([last_index],
                                              device=self.device))
        paged.write_prefill(self.cfg, self.pages, caches, bt_row, slot)
        return self._pick(logits, [req])[0]

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
                                           self._to_dev(bt_row), req.slot,
                                           req))
        secs = time.perf_counter() - t_p
        self.prefill_trace.append((iteration, req.rid, bucket, secs))
        self._note_call(f"prefill_{bucket}", secs)
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
        otherwise).  Each call's host seconds land in ``warmup_s`` (and,
        traced, in a ``compile`` event).  No noise stream is drawn from."""
        sv = self.serving

        def timed(tag, fn, *args):
            t_w = time.perf_counter()
            fn(*args)
            self._sync()
            self.warmup_s[tag] = time.perf_counter() - t_w
            self._note_call(tag, self.warmup_s[tag])

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

    # ------------------------------------------------------ noise streams
    def _register(self, req: Request) -> None:
        """Count the request's submission and, when sampling, give it its
        noise stream at its first submission (a re-submission after a
        preemption keeps the stream it has)."""
        if self.temperature > 0 and req.sample_key is None:
            req.sample_key = self.stream_cls(self.sample_seed,
                                             self._submitted, self.device)
        self._submitted += 1

    def _admitted(self, req: Optional[Request]) -> Optional[Request]:
        """Restart an admitted request's noise stream: a replay after a
        preemption then draws exactly as the original run did, one draw
        for each token its slot consumes."""
        if req is not None and self.temperature > 0:
            req.sample_key.restart()
        return req

    # ------------------------------------------------------ run
    def run(self, requests: List[Request],
            realtime: bool = True) -> ServeMetrics:
        """Serve ``requests`` (arrival times in seconds relative to run
        start) to completion.  ``realtime=False`` treats arrivals as
        already-arrived (offline batch; deterministic)."""
        sched = self.scheduler
        obs = self.obs
        tracer = obs.tracer if obs is not None else None
        probe = obs.probe if obs is not None and obs.probe.every > 0 \
            and self._probe_capable else None
        profiler = obs.profiler if obs is not None else None
        reg = self.registry = Registry()     # run-scoped
        self._bind_instruments(reg)
        sched.bind_obs(reg, tracer)
        self.chunk_trace = []
        self.prefill_trace = []
        run_ord = tracer.begin_run(requests=len(requests)) if tracer \
            else 0
        for r in requests:
            self._register(r)
            sched.submit(r)
            if tracer:
                tracer.emit("submit", rid=r.rid,
                            prompt_tokens=len(r.prompt),
                            max_new_tokens=r.max_new_tokens,
                            arrival=float(r.arrival))
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
                if self.prefix_cache is not None:
                    self._resolve_decode_cow(runnable)
                if self._prefilling is not None and \
                        self._prefilling.state != PREFILL:
                    self._prefilling = None  # evicted by decode growth/CoW
                # ...then the chunk grant (alloc-only: its cache-evict tier
                # frees refcount-1 pages, never a live request)
                if self._prefilling is None:
                    self._prefilling = self._admitted(sched.try_admit(now()))
                if self._prefilling is not None:
                    chunk = sched.grant_chunk(self._prefilling)
                    if chunk is None and \
                            self._prefilling.state != PREFILL:
                        self._prefilling = None   # safety self-preempt
                if chunk is not None and self.prefix_cache is not None \
                        and not self._resolve_chunk_cow(self._prefilling,
                                                        chunk):
                    # the prefiller itself was preempted making room for
                    # its CoW clone: the granted chunk is void
                    chunk = None
                    self._prefilling = None
                if self.prefix_cache is not None:
                    # a CoW allocation may have LRU-preempted decoders out
                    # of the snapshot taken above
                    runnable = [r for r in runnable
                                if sched.running.get(r.slot) is r]
            else:
                # legacy order: whole-prompt prefill phase, then growth —
                # a request admitted this iteration decodes this
                # iteration
                for _ in range(self.serving.max_prefill_per_iter):
                    req = self._admitted(sched.try_admit(now()))
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
            if profiler is not None:
                profiler.maybe_start(decode_iters, tracer)
            t_it = time.perf_counter()
            tokens, bt, pos = self._batch_inputs(runnable)
            reqs = [None] * self.serving.max_batch
            for r in runnable:
                reqs[r.slot] = r
            probe_s = 0.0
            if probe is not None and runnable and probe.due(decode_iters):
                probe_s = self._run_probe(decode_iters, tokens, bt, pos,
                                          runnable)
            kind = "decode" if chunk is None else "mixed"
            with self._annotate(kind):
                if chunk is not None:
                    first_tok, next_tok = self._run_mixed(chunk, tokens, bt,
                                                          pos, reqs)
                else:
                    next_tok = self._decode_body(tokens, bt, pos, reqs)
            if chunk is not None:
                self.chunk_trace.append((decode_iters, self._prefilling.rid,
                                         chunk.start, chunk.tokens))
                c_chunks.inc()
                self._finish_chunk(chunk, first_tok, wall, stamp)
            next_tok = next_tok.cpu().numpy()
            # the probe's host seconds are not the iteration's
            it_s = time.perf_counter() - t_it - probe_s
            self._note_call(kind, it_s)
            self._h_iter.record(it_s)
            (c_iters_mixed if chunk is not None else c_iters_decode).inc()
            for r in runnable:
                # post-preemption replay: steps whose output token is
                # already recorded only rebuild the cache; the produced
                # token (and its draw) is discarded (token-exact resume)
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
            if tracer:
                st = self.pool.stats()
                tracer.emit(
                    "step", iter=decode_iters, kind=kind,
                    occupancy=len(runnable),
                    chunk_tokens=chunk.tokens if chunk is not None else 0,
                    step_s=round(it_s, 6), pool_free=st["free"],
                    pool_used=st["used"],
                    pool_high_water=st["high_water"],
                    waiting=len(sched.waiting),
                    prefilling=len(sched.prefilling),
                    running=len(sched.running))
            decode_iters += 1
            if self.iter_hook is not None and \
                    self.iter_hook(self, decode_iters):
                break
            if profiler is not None:
                profiler.maybe_stop(decode_iters, tracer)

        if profiler is not None:
            profiler.stop(tracer)           # run shorter than the window
        wall_total = time.perf_counter() - t0
        m = self._metrics(requests, wall_total)
        if tracer:
            tracer.end_run(run_ord, requests=len(requests),
                           generated=m.total_generated,
                           wall_s=round(wall_total, 6))
        return m

    # ------------------------------------------------------ cow
    def _cow(self, req: Request, idx: int, keep: int) -> bool:
        """Un-share block ``idx`` of ``req`` before a write: allocate a
        fresh block (cache-evict, then LRU-preempt tiers), clone the
        page's first ``keep`` token rows into it across every paged leaf
        — scrubbing the rest to the fill value, so the donor's tokens past
        the matched prefix (or its generated continuation) never leak into
        the new owner — and swap it into the request's table.  The old
        block is deref'd, never written: the CoW invariant.  Returns False
        iff ``req`` itself was preempted to make room."""
        old = req.blocks[idx]
        new = self.scheduler.cow_alloc(req)
        if new is None:
            return False
        t_c = time.perf_counter()
        paged.clone_block(self.cfg, self.pages, old, new, keep)
        self._note_call("cow_clone", time.perf_counter() - t_c)
        req.blocks[idx] = new
        self.pool.free([old])
        self.registry.counter("prefix_cache_cow_total").inc()
        if self.obs is not None:
            self.obs.tracer.emit("cow_copy", rid=req.rid, block=old,
                                 clone=new, keep_tokens=keep)
        return True

    def _resolve_chunk_cow(self, req: Request,
                           chunk: PrefillChunk) -> bool:
        """Clone any shared block the granted chunk would write.  Only the
        chunk's first block can be shared (a cache hit's cursor may sit
        mid-way through the matched tail page), but every touched block
        is checked.  Returns False iff ``req`` was preempted while
        allocating a clone."""
        bs = self.serving.block_size
        first = chunk.start // bs
        last = (chunk.start + chunk.tokens - 1) // bs
        for idx in range(first, min(last + 1, len(req.blocks))):
            if self.pool.is_shared(req.blocks[idx]):
                if not self._cow(req, idx,
                                 keep=max(0, chunk.start - idx * bs)):
                    return False
        return True

    def _resolve_decode_cow(self, runnable: List[Request]) -> None:
        """The CoW invariant for the decode batch.  A decode write
        (``pos >= prompt_len``) cannot land in a shared page — the cache
        indexes prompt-pure pages only, and a hit's tail page is un-shared
        by the first chunk write — but the check is local and cheap."""
        bs = self.serving.block_size
        for r in runnable:
            idx = r.pos // bs
            if idx < len(r.blocks) and self.pool.is_shared(r.blocks[idx]):
                self._cow(r, idx, keep=r.pos % bs)

    # ------------------------------------------------------ chunk
    def _run_mixed(self, chunk: PrefillChunk, tokens, bt, pos, reqs):
        """Dispatch the mixed step for ``chunk`` plus the decode batch
        (``reqs``: the request of each decode slot, None where idle)."""
        req = self._prefilling
        c = self.serving.prefill_chunk
        ch_tokens = np.zeros((1, c), np.int64)
        ch_tokens[0, :chunk.tokens] = \
            req.prefill_tokens[chunk.start:chunk.start + chunk.tokens]
        ch_bt = np.full((self._chunk_bt_len(),), TRASH_BLOCK, np.int32)
        ch_bt[:len(req.blocks)] = req.blocks
        return self._mixed_step(self._to_dev(ch_tokens), self._to_dev(ch_bt),
                                chunk.start, chunk.tokens - 1, tokens, bt,
                                pos, req if chunk.final else None, reqs)

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

    # ------------------------------------------------------ probe
    def _written_blocks(self, runnable: List[Request]) -> torch.Tensor:
        """Every block a decode step of ``runnable`` writes: each active
        slot's page at ``pos`` (paged layers) and its ring page (ring
        layers), and the trash page the idle slots write; from host
        state, so no device sync."""
        bs = self.serving.block_size
        rb = self.scheduler.ring_blocks
        blocks = {TRASH_BLOCK}
        for r in runnable:
            if self._has_paged:
                blocks.add(r.blocks[r.pos // bs])
            if rb:
                blocks.add(r.blocks[(r.pos // bs) % rb])
        return torch.tensor(sorted(blocks), device=self.device)

    def _run_probe(self, iteration: int, tokens, bt, pos,
                   runnable: List[Request]) -> float:
        """Sampled selection-quality probe: re-run the current decode
        batch as a shadow step with the capture flag up
        (:mod:`repro_torch.models.backends.probe`), so every sparse layer
        records its per-request recall / budget-utilization /
        forced-share stats on the plain selection route, then reduce them
        over the active slots and emit one ``probe`` event per layer.

        The shadow step appends this token's rows to the pool in place,
        as every step does; the production step that follows writes the
        same rows again, but not every leaf is overwritten whole (Quest's
        page bounds merge with what they hold).  So the blocks the step
        writes are saved in every leaf first and restored after: the pool
        is left bitwise as it was.  The shadow step's logits are dropped:
        no token is picked and no noise stream drawn from.  Returns the
        probe's host seconds."""
        from repro_torch.models.backends import probe as bprobe
        t_p = time.perf_counter()
        blocks = self._written_blocks(runnable)
        saved = [(raw, raw[blocks].clone()) for layer in self.pages
                 for raw in map(paged.raw_view, layer.values())]
        bprobe.drain()                       # drop anything stale
        with self._annotate("probe"), bprobe.capture():
            if self._paged_native:
                self._serve(self.params, self.pages, tokens, pos, bt)
            else:                            # the views are copies
                views = paged.gather_views(self.cfg, self.pages, bt)
                self._serve(self.params, views, tokens, pos)
        stats = bprobe.drain()               # one transfer, synchronizes
        for raw, rows in saved:
            raw[blocks] = rows
        probe_s = time.perf_counter() - t_p
        self._note_call("probe", probe_s)
        rows = self.obs.probe.add(iteration, stats,
                                  [r.slot for r in runnable])
        for row in rows:
            self.obs.tracer.emit("probe", **row)
            if row["recall"] is not None:
                self.registry.histogram("probe_recall").record(
                    row["recall"])
                self.registry.histogram(
                    "probe_budget_utilization").record(
                        row["budget_utilization"])
        return probe_s

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
