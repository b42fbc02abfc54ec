"""Prefix cache facade: radix index + pool refcounts + CoW policy.

A copy of ``repro.serving.prefix_cache.cache`` (it imports nothing of the
JAX package); ``bind_obs`` takes the port's metrics registry and, until
the observability slice (ROADMAP.md queue 1 item 9), no tracer.

Ties the token-keyed :class:`~repro_torch.serving.prefix_cache.radix
.RadixIndex` to the refcounted :class:`~repro_torch.serving.block_pool
.BlockPool` and owns
every policy decision the scheduler/engine consult:

* **match** — longest cached prefix of a prompt, capped at
  ``len(prompt) - 1`` (the final prompt token is always prefilled so the
  request computes its first-output logits), and page-aligned **down**
  unless tail pages are shareable (``tail_shareable`` is False whenever
  any paged leaf has ``granularity > 1`` — quest's per-page min/max
  stats summarize *all* rows of a page, so sharing a partially-valid
  page, or partially keeping one under CoW, would score junk keys).
* **insert** — full prompt-pure pages index at activation (they are
  immutable from that point: decode writes land strictly past the
  prompt), the partial tail page only once the owner stops writing it
  (finish, or preemption after prefill completed).  The tree takes one
  pool ref per adopted page, which is what keeps page data alive after
  its producing request is gone.
* **evict** — LRU trim of pages only the tree still references
  (pool refcount 1); this is the engine's *first* reclamation tier,
  ahead of recompute-preemption.

The refcount/CoW contract: a block with pool refcount > 1 is never
written in place.  The engine enforces it by cloning (with scrub) the
one page a cache hit can write into — see ``engine._resolve_chunk_cow``
and ``engine._resolve_decode_cow``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.serving.block_pool import BlockPool
from repro_torch.serving.prefix_cache.radix import RadixIndex

__all__ = ["PrefixCache"]


class PrefixCache:
    """Cross-request KV page reuse over a refcounted block pool."""

    def __init__(self, pool: BlockPool, *, block_size: int,
                 tail_shareable: bool = True):
        self.pool = pool
        self.block_size = block_size
        self.tail_shareable = tail_shareable
        self.index = RadixIndex(block_size)
        self._held: set = set()        # blocks the tree holds a ref on
        # observability (bound by the engine per run; None = standalone)
        self.registry = None
        self.tracer = None

    # -------------------------------------------------------- observability
    def bind_obs(self, registry=None, tracer=None) -> None:
        self.registry = registry
        self.tracer = tracer

    def _emit(self, event_type: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.emit(event_type, **fields)

    def _count(self, name: str, n: int = 1, **labels) -> None:
        if self.registry is not None:
            self.registry.counter(name, **labels).inc(n)

    # --------------------------------------------------------------- query
    @property
    def shared_blocks(self) -> int:
        """Pages the tree currently references (the shared-block gauge)."""
        return self.index.num_blocks

    def evictable_blocks(self) -> int:
        """Pages reclaimable right now (tree-only, refcount 1)."""
        return sum(1 for b in self._held if self.pool.refcount(b) == 1)

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest usable cached prefix of ``prompt``.

        Returns ``(blocks, cached_tokens)`` — the physical blocks covering
        the cached prefix (possibly ending in a partially-valid tail page)
        and its token length.  Takes **no** refs; the caller pins the
        blocks (``pool.ref``) before any eviction can run."""
        p = len(prompt)
        blocks, full_pages, tail = self.index.match(prompt)
        cached = full_pages * self.block_size
        out = list(blocks)
        if tail is not None and self.tail_shareable:
            entry, rows = tail
            out.append(entry.block)
            cached += rows
        cached = min(cached, p - 1)    # final prompt token always prefills
        if not self.tail_shareable:
            cached -= cached % self.block_size
        if cached <= 0:
            return [], 0
        return out[:-(-cached // self.block_size)], cached

    # -------------------------------------------------------------- insert
    def insert(self, prompt: Sequence[int], blocks: Sequence[int],
               committed: int, include_tail: bool = False,
               rid: Optional[int] = None) -> int:
        """Index the committed, prompt-pure prefix of a request: the first
        ``min(committed, len(prompt)) // block_size`` full pages, plus —
        only when ``include_tail`` (the owner has stopped writing the
        page: finish, or preemption after prefill completed) — the
        partial tail page.  Generated-token KV is never indexed (decode
        produces it under the sparse backend; a dense re-prefill of the
        same tokens would differ bitwise) — sharers CoW-scrub any
        generated rows sitting past the prompt in a shared tail page.
        Returns pages adopted."""
        p = len(prompt)
        full = min(committed, p) // self.block_size
        adopted = self.index.insert(prompt, list(blocks[:full]))
        tail = False
        if (include_tail and committed >= p and p % self.block_size
                and self.tail_shareable and len(blocks) > full
                and self.index.insert_tail(prompt, blocks[full], p)):
            adopted.append(blocks[full])
            tail = True
        for b in adopted:
            self.pool.ref(b)
            self._held.add(b)
        if adopted:
            self._count("prefix_cache_pages_shared_total", n=len(adopted))
            self._emit("page_share", rid=rid if rid is not None else -1,
                       blocks=len(adopted), tail=tail)
        return len(adopted)

    # ------------------------------------------------------------ eviction
    def evict(self, want: int) -> int:
        """First reclamation tier: LRU-drop up to ``want`` tree-only pages
        back to the pool free list.  Pages any live request still shares
        (refcount > 1) are pinned and skipped.  Returns pages freed."""
        if want <= 0:
            return 0
        freed = self.index.evict(
            want, can_evict=lambda b: self.pool.refcount(b) == 1)
        for b in freed:
            self._held.discard(b)
        self.pool.free(freed)
        if freed:
            self._count("prefix_cache_evicted_total", n=len(freed))
            self._emit("cache_evict", blocks=len(freed),
                       remaining_blocks=self.index.num_blocks)
        return len(freed)

    def stats(self) -> dict:
        return {"shared_blocks": self.index.num_blocks,
                "tail_blocks": self.index.num_tail_blocks,
                "evictable": self.evictable_blocks()}
