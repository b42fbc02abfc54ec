"""Request lifecycle + continuous-batching scheduler (host side).

A copy of ``repro.serving.scheduler``: the same lifecycle, admission,
chunk grants and preemption, so the port schedules exactly as the JAX
engine does, with the same prefix-cache hooks (the engine sets
``prefix_cache`` where the plan can share pages); ``bind_obs`` takes the
port's metrics :class:`~repro_torch.serving.obs.metrics.Registry` and
event :class:`~repro_torch.serving.obs.tracing.Tracer`.

Lifecycle::

    WAITING --admit--> PREFILL --activate--> DECODE --finish--> FINISHED
       ^                  |                    |
       +--- preempt (blocks freed, cursor reset) ---+

Admission is by free-block accounting: a waiting request is admitted only
when a decode slot is free and the pool can cover its first prefill grant
(the whole prompt in legacy whole-bucket mode, one chunk when
``prefill_chunk > 0``) plus one block of decode headroom.  Block demand
follows the per-layer cache plan (see :meth:`Scheduler._blocks_for`):
linear with context when any global-attention layer pages, capped at the
circular window page list for sliding-window-only models, zero for
SSM-only models.

Under **chunked prefill** the admitted request stays in PREFILL across
iterations while :meth:`Scheduler.grant_chunk` hands the engine one
:class:`PrefillChunk` at a time, growing the block table through the same
per-kind accounting; the :attr:`Request.prefill_pos` cursor tracks the
committed prompt prefix.  A request preempted mid-prefill (its blocks are
gone) re-chunks from cursor 0 on re-admission — chunk boundaries are a
pure function of the prompt length, so the recompute is bit-exact.

On pool exhaustion mid-decode the scheduler preempts the
least-recently-used running request (recompute-style: its blocks are
freed and it re-enters the waiting queue keeping its generated tokens; on
re-admission the original prompt is re-prefilled — rebuilding paged KV,
window rings and SSM state bit-exactly — and recorded tokens replay
through the decode path — resume is token-exact, see
:attr:`Request.prefill_tokens`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional

from repro_torch.serving.block_pool import BlockPool

__all__ = ["Request", "PrefillChunk", "Scheduler",
           "WAITING", "PREFILL", "DECODE", "FINISHED"]

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"

_rid = itertools.count()


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One granted prefill chunk: the engine runs prompt tokens
    ``[start, start + tokens)`` this iteration (``final`` marks the chunk
    whose last real token produces the request's first output)."""

    start: int
    tokens: int
    final: bool


@dataclasses.dataclass
class Request:
    """One serving request and its mutable engine-side state."""

    prompt: List[int]                      # original prompt token ids
    max_new_tokens: int
    arrival: float = 0.0                   # seconds relative to run start
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))

    state: str = WAITING
    slot: Optional[int] = None             # decode slot while running
    blocks: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                           # next cache index to write
    prefill_pos: int = 0                   # chunked-prefill cursor
    # prefix-cache hit length at the latest admission (0 = miss/disabled):
    # the prefill cursor starts here instead of 0
    cached_tokens: int = 0
    last_used: int = 0                     # scheduler clock, for LRU
    preemptions: int = 0
    # per-request sampling noise stream (the port's
    # :class:`~repro_torch.serving.sampling.GumbelStream`), assigned by
    # the engine at first submission and restarted on every admission, so
    # temperature/top-p streams replay bit-exactly after preemption and
    # never depend on the slot's previous occupants.
    sample_key: Optional[object] = None

    # metrics (seconds relative to run start)
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    token_latencies: List[float] = dataclasses.field(default_factory=list)
    # wall-clock emission time of each token (engine-relative seconds) —
    # feeds the max inter-token-stall metric
    token_walls: List[float] = dataclasses.field(default_factory=list)

    @property
    def effective_prompt(self) -> List[int]:
        """Original prompt plus everything already generated — after a
        preemption the KV for generated tokens is gone and gets recomputed,
        but the tokens themselves are kept."""
        return self.prompt + self.generated

    @property
    def prefill_tokens(self) -> List[int]:
        """Tokens whose KV the (re-)prefill builds: always the *original*
        prompt.  Generated tokens are NOT re-prefilled on resume — prefill
        runs dense attention, but their KV was originally produced under
        the sparse decode backend, so re-prefilling them would change the
        hidden states and hence the continuation.  Instead the engine
        *replays* the recorded tokens through the decode path (see
        :meth:`input_token`), which repeats the original computation
        exactly — preemption is token-exact, not just count-exact."""
        return self.prompt

    def input_token(self, pos: int) -> int:
        """The token consumed by a decode step writing at cache index
        ``pos``; during post-preemption replay this is a recorded token
        rather than the last generated one."""
        i = pos - len(self.prompt)
        assert 0 <= i < len(self.generated), (pos, len(self.prompt),
                                              len(self.generated))
        return self.generated[i]

    @property
    def num_remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    """Slot + block bookkeeping for the continuous-batching engine.

    ``has_paged_layers`` / ``ring_blocks`` carry the host half of the
    per-layer cache plan (``cfg.cache_plan()``): with any global-attention
    layer, block demand grows linearly with context (every block id is
    live in that layer's pages); with only sliding-window layers it is
    capped at ``ring_blocks`` (the circular page list recycles the ids in
    place); SSM-only models hold zero blocks and are admitted on free
    decode slots alone.
    """

    def __init__(self, pool: BlockPool, *, max_batch: int,
                 max_blocks_per_seq: int, block_size: int,
                 has_paged_layers: bool = True, ring_blocks: int = 0,
                 prefill_chunk: int = 0):
        self.pool = pool
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.block_size = block_size
        self.has_paged_layers = has_paged_layers
        self.ring_blocks = ring_blocks
        self.prefill_chunk = prefill_chunk     # 0 = whole-prompt prefill
        self.waiting: List[Request] = []       # FCFS by (arrival, rid)
        self.prefilling: List[Request] = []    # admitted, mid-prefill
        self.running: Dict[int, Request] = {}  # slot -> request
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self._clock = 0
        # cross-request prefix cache (set by the engine when enabled and
        # the config supports it: chunked prefill + all-paged plan).
        # When present it changes three things here: admission matches
        # prompts against the radix index and starts the prefill cursor
        # past the cached prefix; block allocation gains a first
        # reclamation tier (LRU cache eviction) ahead of
        # recompute-preemption; and committed prompt pages are indexed at
        # activation / finish / preemption so later requests can share
        # them.
        self.prefix_cache = None
        # observability (bound by the engine per run; None = standalone)
        self.registry = None
        self.tracer = None

    # -------------------------------------------------------- observability
    def bind_obs(self, registry=None, tracer=None) -> None:
        """Attach the engine's per-run metrics registry and (optional)
        event tracer.  The scheduler emits its own lifecycle events —
        admission, chunk grants/withholds, preemptions (by cause),
        finishes — so the trace sees scheduling decisions, not just
        their engine-side consequences."""
        self.registry = registry
        self.tracer = tracer
        if self.prefix_cache is not None:
            self.prefix_cache.bind_obs(registry, tracer)

    def _emit(self, event_type: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.emit(event_type, **fields)

    def _count(self, name: str, **labels) -> None:
        if self.registry is not None:
            self.registry.counter(name, **labels).inc()

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt")
        need = self._blocks_for(len(req.prompt) + req.max_new_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"request {req.rid} needs {need} blocks > "
                f"max_blocks_per_seq={self.max_blocks_per_seq}")
        if need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs {need} blocks over its lifetime "
                f"but the pool only has {self.pool.num_blocks - 1} — "
                "unservable even alone (the engine would spin forever)")
        req.state = WAITING
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def _blocks_for(self, tokens: int) -> int:
        """Blocks a request holding ``tokens`` cache tokens occupies,
        under the per-kind accounting (see class docstring)."""
        full = -(-tokens // self.block_size)
        if self.has_paged_layers:
            return full
        if self.ring_blocks:
            return min(full, self.ring_blocks)
        return 0

    def _alloc(self, n: int):
        """Pool allocation with the prefix-cache reclamation tier: when
        the free list cannot cover ``n``, LRU-evict unpinned cached pages
        (tree-only, refcount 1) to make up the deficit before reporting
        failure — cached-but-idle data is always cheaper to drop than
        preempting a live request (recompute) or stalling a prefill."""
        got = self.pool.alloc(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.pool.num_free)
            got = self.pool.alloc(n)
        return got

    # ---------------------------------------------------------- admission
    def try_admit(self, now: float) -> Optional[Request]:
        """Pop the first arrived waiting request that fits (free slot AND
        first-grant blocks + 1 decode-headroom block); allocate those
        blocks and move it to PREFILL.  Returns None if nothing fits.

        The first grant is the whole prompt in legacy mode, just the
        first chunk under chunked prefill — a long prompt is admissible
        long before the pool could hold all of it (later chunks grow the
        table via :meth:`grant_chunk`)."""
        if not self._free_slots:
            return None
        for i, req in enumerate(self.waiting):
            if req.arrival > now:
                break                       # sorted: nothing arrived yet
            p = len(req.prefill_tokens)
            # prefix-cache match: pin (ref) the shared blocks BEFORE any
            # eviction below can run — matched pages are refcount-1
            # (tree-only) until pinned, i.e. themselves evictable.
            shared, cached = [], 0
            if self.prefix_cache is not None:
                shared, cached = self.prefix_cache.match(req.prefill_tokens)
                for b in shared:
                    self.pool.ref(b)
            first = min(cached + self.prefill_chunk, p) \
                if self.prefill_chunk else p
            first_blocks = self._blocks_for(first)
            need = first_blocks - len(shared)
            lifetime = self._blocks_for(
                len(req.effective_prompt) + req.num_remaining)
            # decode headroom only if the request will ever grow past its
            # first-grant blocks — otherwise a prompt filling the whole
            # pool could pass submit() yet never admit (engine would spin).
            headroom = 1 if lifetime > first_blocks else 0
            deficit = need + headroom - self.pool.num_free
            if deficit > 0 and self.prefix_cache is not None and \
                    self.prefix_cache.evictable_blocks() >= deficit:
                self.prefix_cache.evict(deficit)
            if need + headroom > self.pool.num_free:
                if shared:
                    self.pool.free(shared)  # unpin: admission failed
                continue                    # try a smaller request behind it
            blocks = self.pool.alloc(need)
            assert blocks is not None
            self.waiting.pop(i)
            req.blocks = shared + blocks
            req.slot = self._free_slots.pop()
            req.state = PREFILL
            req.pos = len(req.prefill_tokens)
            req.prefill_pos = cached        # a hit is a prefill starting
            req.cached_tokens = cached      # at a nonzero cursor
            self.prefilling.append(req)
            if self.prefix_cache is not None:
                if cached > 0:
                    self._count("prefix_cache_hits_total")
                    if self.registry is not None:
                        self.registry.counter(
                            "prefix_cache_cached_tokens_total").inc(cached)
                        self.registry.histogram(
                            "prefix_cache_cached_tokens").record(cached)
                    self._emit("cache_hit", rid=req.rid, cached_tokens=cached,
                               prompt_tokens=p, shared_blocks=len(shared))
                else:
                    self._count("prefix_cache_misses_total")
                    self._emit("cache_miss", rid=req.rid, prompt_tokens=p)
                if self.registry is not None:
                    self.registry.counter(
                        "prefix_cache_prompt_tokens_total").inc(p)
            # admission-queue wait: only measurable under realtime
            # clocks (offline runs pass now=inf — everything "arrived")
            wait = now - req.arrival if math.isfinite(now) else None
            if wait is not None and self.registry is not None:
                self.registry.histogram("admission_wait_s").record(wait)
            self._emit("admit", rid=req.rid, slot=req.slot,
                       blocks=len(req.blocks),
                       resume=req.preemptions > 0,
                       **({"wait_s": round(wait, 6)}
                          if wait is not None else {}))
            return req
        return None

    def grant_chunk(self, req: Request) -> Optional[PrefillChunk]:
        """Grant the next prefill chunk for a PREFILL-state request,
        growing its block table to cover the chunk end through the
        per-kind accounting.  Prefill never evicts decoders: on pool
        exhaustion the grant is simply withheld (None, request stays
        PREFILL) and retried next iteration — decoders always finish
        within ``max_new_tokens`` steps and free their blocks, so the
        chunk eventually proceeds (eager eviction ping-pongs: the
        evicted decoder re-admits cheaply and evicts the prefiller right
        back).  Decode *growth* may preempt the prefiller instead
        (:meth:`ensure_decode_blocks`) — in-flight tokens outrank queued
        prompts.  If the pool cannot cover the chunk while nothing else
        holds blocks — unreachable while :meth:`submit`'s lifetime guard
        holds — the request is preempted as a safety valve."""
        assert self.prefill_chunk and req.state == PREFILL
        self._clock += 1
        req.last_used = self._clock
        p = len(req.prefill_tokens)
        end = min(req.prefill_pos + self.prefill_chunk, p)
        while len(req.blocks) < self._blocks_for(end):
            got = self._alloc(1)
            if got is not None:
                req.blocks.extend(got)
                continue
            if self.running or len(self.prefilling) > 1:
                # wait for blocks to free up
                self._count("serve_chunks_withheld_total")
                self._emit("chunk_withheld", rid=req.rid,
                           free_blocks=self.pool.num_free)
                return None
            self.preempt(req, cause="prefill_stall")  # no progress at all
            return None
        chunk = PrefillChunk(start=req.prefill_pos,
                             tokens=end - req.prefill_pos, final=end == p)
        self._emit("chunk_grant", rid=req.rid, start=chunk.start,
                   tokens=chunk.tokens, final=chunk.final,
                   blocks=len(req.blocks))
        return chunk

    def advance_chunk(self, req: Request, chunk: PrefillChunk) -> None:
        """The engine ran ``chunk``; move the cursor past it."""
        assert req.state == PREFILL and req.prefill_pos == chunk.start
        req.prefill_pos += chunk.tokens

    def activate(self, req: Request) -> None:
        """Prefill done; request joins the ragged decode batch.  With the
        prefix cache, this is where the prompt's **full** pages become
        shareable: they are immutable from here on (decode writes land
        strictly past the prompt).  The partial tail page — which decode
        *does* keep writing — is only indexed once the owner stops
        touching it (:meth:`finish` / preemption after prefill)."""
        assert req.state == PREFILL
        self.prefilling.remove(req)
        req.state = DECODE
        self.running[req.slot] = req
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prefill_tokens, req.blocks,
                                     committed=len(req.prefill_tokens),
                                     include_tail=False, rid=req.rid)

    # ----------------------------------------------------------- stepping
    def ensure_decode_blocks(self) -> List[Request]:
        """Grow each running request's block table to cover writing index
        ``pos`` (capped by the per-kind accounting: sliding-window-only
        demand stops at ``ring_blocks``, SSM-only at zero); preempt LRU
        victims on exhaustion — mid-prefill requests are eligible victims
        too (in-flight decodes outrank queued prompts; a preempted
        prefill re-chunks from cursor 0 bit-exactly).  Returns the
        requests runnable this step (sorted by slot)."""
        self._clock += 1
        for slot in sorted(self.running):
            req = self.running.get(slot)
            if req is None:
                continue
            req.last_used = self._clock
            while len(req.blocks) < self._blocks_for(req.pos + 1):
                got = self._alloc(1)
                if got is not None:
                    req.blocks.extend(got)
                    continue
                victim = self._lru_victim()
                self.preempt(victim, cause="decode_growth")
                if victim is req:
                    break
        return [self.running[s] for s in sorted(self.running)]

    def _lru_victim(self) -> Request:
        # Mid-prefill requests are evicted before any decoder: they hold
        # pages but no in-flight generation (re-chunking from cursor 0
        # redoes prefill work only, never emitted tokens), which is the
        # "in-flight tokens outrank queued prompts" policy — LRU clocks
        # alone would favor the prefiller (stamped fresher by its grant
        # each iteration) and evict an active decoder instead.
        pool = self.prefilling or list(self.running.values())
        return min(pool, key=lambda r: (r.last_used, -r.arrival, -r.rid))

    def preempt(self, req: Request, cause: str = "manual") -> None:
        """Free the request's slot + blocks and requeue it (recompute).
        A request caught mid-chunked-prefill loses its committed pages,
        so its chunk cursor resets — re-chunking is bit-exact because
        chunk boundaries depend only on the prompt length.

        ``cause`` labels the eviction for the preemption counter/event:
        ``decode_growth`` (a running request's table had to grow on an
        exhausted pool), ``prefill_stall`` (the grant_chunk safety
        valve), or ``manual`` (direct callers/tests)."""
        assert req.state == DECODE or req.state == PREFILL
        self._count("serve_preemptions_total", cause=cause)
        self._emit("preempt", rid=req.rid, cause=cause, state=req.state,
                   blocks_freed=len(req.blocks))
        if self.prefix_cache is not None and req.blocks:
            # Index the committed prefix before freeing: the pages stay
            # alive under the tree's ref (evictable, but often still
            # there at re-admission — the preempted request re-matches
            # its own pages and resumes its prefill near where it left
            # off instead of recomputing from cursor 0).
            committed = len(req.prefill_tokens) if req.state == DECODE \
                else req.prefill_pos
            self.prefix_cache.insert(req.prefill_tokens, req.blocks,
                                     committed=committed,
                                     include_tail=req.state == DECODE,
                                     rid=req.rid)
        self.pool.free(req.blocks)
        req.blocks = []
        if req in self.prefilling:
            self.prefilling.remove(req)
        self.running.pop(req.slot, None)
        self._free_slots.append(req.slot)
        req.slot = None
        req.prefill_pos = 0
        req.preemptions += 1
        self.submit(req)

    def cow_alloc(self, req: Request):
        """One block for a copy-on-write clone (the engine needs it to
        un-share a page ``req`` is about to write).  Escalates through
        the same tiers as decode growth — cache eviction, then LRU
        preemption — and returns None if ``req`` itself ended up the
        victim (then there is nothing left to clone for)."""
        while True:
            got = self._alloc(1)
            if got is not None:
                return got[0]
            victim = self._lru_victim()
            self.preempt(victim, cause="cow")
            if victim is req:
                return None

    def finish(self, req: Request, now: float) -> None:
        assert req.state == DECODE
        self._count("serve_requests_total")
        self._emit("finish", rid=req.rid, generated=len(req.generated),
                   preemptions=req.preemptions)
        if self.prefix_cache is not None and req.blocks:
            # full pages + the now-quiescent partial tail page become
            # shareable; the tree's refs keep them alive past the free.
            self.prefix_cache.insert(req.prefill_tokens, req.blocks,
                                     committed=len(req.prefill_tokens),
                                     include_tail=True, rid=req.rid)
        self.pool.free(req.blocks)
        req.blocks = []
        self.running.pop(req.slot)
        self._free_slots.append(req.slot)
        req.slot = None
        req.state = FINISHED
        req.t_finished = now

    # ------------------------------------------------------------- status
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    @property
    def num_running(self) -> int:
        return len(self.running)
