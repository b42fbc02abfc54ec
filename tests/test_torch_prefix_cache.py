"""Port parity for the prefix cache: every case of the JAX package's
``tests/test_prefix_cache.py`` but its trace test (the trace comes with
the observability slice), each held to the JAX functions on the same
seeds, and the copy-on-write clone ``serving.paged.clone_block`` against
JAX's, leaf for leaf.

* The pool, radix and facade units run the same operations on the JAX
  classes and on the port's copies; every ``match``/``insert``/``evict``
  result is asserted as the JAX test asserts it and equal between the two.
* The engine cases serve through the port's ``ContinuousBatchingEngine``
  on the CPU (the paged kernels' plain versions) and through the JAX
  engine (Pallas paged kernels in interpret mode) on the same weights:
  warm tokens equal the port's cold tokens and the JAX engine's warm
  tokens, for ``socket``, ``dense``, ``hard_lsh`` and ``quest`` and the
  fused names.

Tolerance: tokens equal; ``clone_block`` bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import BlockPool as JBlockPool
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import paged as jpaged
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro.serving.prefix_cache import RadixIndex as JRadixIndex
from repro.serving.prefix_cache import workloads as jworkloads
from repro_torch.launch.serve import main
from repro_torch.serving import (FINISHED, BlockPool, Request, Scheduler,
                                 paged)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.prefix_cache import (PrefixCache, RadixIndex,
                                              workloads)
from test_torch_engine import _configs, _params
from test_torch_smoke_checks import one_thread

# (BlockPool, RadixIndex, PrefixCache, Scheduler, Request) of each side
JAX = (JBlockPool, JRadixIndex, JPrefixCache, JScheduler, JRequest)
PORT = (BlockPool, RadixIndex, PrefixCache, Scheduler, Request)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _both(body):
    """Run ``body(*classes)`` on the JAX classes and on the port's; each
    asserts as the JAX test does and returns what it observed, which must
    be equal between the two."""
    assert body(*PORT) == body(*JAX)


def _toks(rng, n):
    return rng.integers(0, 256, size=n).tolist()


# ------------------------------------------------------------ pool units


def test_pool_refcount_lifecycle():
    def body(BlockPool, *_):
        pool = BlockPool(6)
        (b,) = pool.alloc(1)
        assert pool.refcount(b) == 1 and not pool.is_shared(b)
        pool.ref(b)
        assert pool.refcount(b) == 2 and pool.is_shared(b)
        assert pool.stats()["shared"] == 1
        free_before = pool.num_free
        pool.free([b])                   # deref: still held by one owner
        assert pool.refcount(b) == 1 and pool.num_free == free_before
        pool.free([b])                   # last holder: back on free list
        assert pool.refcount(b) == 0 and pool.num_free == free_before + 1
        with pytest.raises(ValueError, match="double free"):
            pool.free([b])
        with pytest.raises(ValueError, match="unallocated"):
            pool.ref(b)
        with pytest.raises(ValueError, match="trash"):
            pool.ref(0)
        return b, pool.stats()
    _both(body)


# ----------------------------------------------------------- radix units


def test_radix_insert_match_roundtrip():
    def body(_, RadixIndex, *__):
        idx = RadixIndex(4)
        rng = np.random.default_rng(0)
        t = _toks(rng, 11)               # 2 full pages + 3 spare tokens
        assert idx.insert(t, [5, 6]) == [5, 6]
        got = idx.match(t)
        assert got == ([5, 6], 2, None)
        # re-inserting the same pages under other blocks adopts nothing
        assert idx.insert(t, [7, 8]) == []
        assert idx.match(t)[0] == [5, 6]
        assert idx.num_blocks == 2
        assert idx.match(_toks(rng, 8)) == ([], 0, None)
        return got, idx.stats()
    _both(body)


def test_radix_split_on_mid_edge_divergence():
    def body(_, RadixIndex, *__):
        idx = RadixIndex(4)
        rng = np.random.default_rng(1)
        a, b, c, d = (_toks(rng, 4) for _ in range(4))
        idx.insert(a + b + c, [1, 2, 3])     # one compressed 3-page edge
        assert idx.insert(a + b + d, [9, 9, 4]) == [4]   # a+b reused
        out = [idx.match(a + b + c), idx.match(a + b + d), idx.match(a + b)]
        assert out == [([1, 2, 3], 3, None), ([1, 2, 4], 3, None),
                       ([1, 2], 2, None)]
        blocks, full, _ = idx.match(a + b + c + _toks(rng, 4))
        assert blocks == [1, 2, 3] and full == 3
        return out, idx.stats()
    _both(body)


def test_radix_tail_insert_and_match():
    def body(_, RadixIndex, *__):
        idx = RadixIndex(4)
        rng = np.random.default_rng(2)
        t = _toks(rng, 10)               # 2 full pages + 2-row tail
        assert not idx.insert_tail(t, 30, 10)   # full pages not indexed
        idx.insert(t, [1, 2])
        assert idx.insert_tail(t, 30, 10)
        assert not idx.insert_tail(t, 31, 10)   # identical run: dedup
        assert idx.num_tail_blocks == 1
        probe = t[:9] + _toks(rng, 4)
        blocks, full, tail = idx.match(probe)
        assert blocks == [1, 2] and full == 2
        entry, rows = tail
        assert entry.block == 30 and rows == 1
        half = t[:2] + _toks(rng, 6)
        assert idx.match(half) == ([], 0, None)
        return blocks, full, entry.block, entry.tokens, rows, idx.stats()
    _both(body)


def test_radix_evict_lru_leaves_inward():
    def body(_, RadixIndex, *__):
        idx = RadixIndex(4)
        rng = np.random.default_rng(3)
        a, b, c = (_toks(rng, 4) for _ in range(3))
        idx.insert(a + b, [1, 2])
        idx.insert(a + c, [1, 3])        # branch: [a] -> {b: 2, c: 3}
        idx.match(a + b)                 # refresh the b-branch
        first = idx.evict(1, can_evict=lambda blk: True)
        assert first == [3]              # LRU leaf (c-branch) goes first
        second = idx.evict(2, can_evict=lambda blk: True)
        assert second == [2, 1] and idx.num_blocks == 0
        assert idx.match(a + b) == ([], 0, None)
        return first, second
    _both(body)


def test_radix_evict_stops_at_pinned_blocks():
    def body(_, RadixIndex, *__):
        idx = RadixIndex(4)
        rng = np.random.default_rng(4)
        a, b = _toks(rng, 4), _toks(rng, 4)
        idx.insert(a + b, [1, 2])
        freed = idx.evict(5, can_evict=lambda blk: blk != 1)
        assert freed == [2]
        assert idx.match(a) == ([1], 1, None)
        rest = idx.evict(5, can_evict=lambda blk: True)
        assert rest == [1]
        return freed, rest
    _both(body)


# ---------------------------------------------------------- facade units


def test_prefix_cache_match_caps_at_final_token():
    def body(BlockPool, _, PrefixCache, *__):
        pool = BlockPool(12)
        pc = PrefixCache(pool, block_size=4)
        rng = np.random.default_rng(5)
        t = _toks(rng, 8)                # exact page multiple
        blocks = pool.alloc(2)
        pc.insert(t, blocks, committed=8)
        pool.free(blocks)                # tree refs keep them alive
        a = pc.match(t)
        assert a == (blocks, 7)          # final token always prefills
        b = pc.match(t + _toks(rng, 3))
        assert b == (blocks, 8)          # longer prompt: full pages
        return a, b, pc.stats()
    _both(body)


def test_prefix_cache_page_aligns_without_tail_sharing():
    def body(BlockPool, _, PrefixCache, *__):
        pool = BlockPool(12)
        pc = PrefixCache(pool, block_size=4, tail_shareable=False)
        rng = np.random.default_rng(6)
        t = _toks(rng, 10)
        blocks = pool.alloc(3)
        pc.insert(t, blocks, committed=10, include_tail=True)
        assert pc.index.num_tail_blocks == 0
        got = pc.match(t[:8])            # would cap to 7 mid-page
        assert got == (blocks[:1], 4)    # aligned down to the page edge
        return got, pc.stats()
    _both(body)


def test_prefix_cache_insert_tail_only_when_owner_quiesces():
    def body(BlockPool, _, PrefixCache, *__):
        pool = BlockPool(12)
        pc = PrefixCache(pool, block_size=4)
        rng = np.random.default_rng(7)
        t = _toks(rng, 10)
        blocks = pool.alloc(3)
        n0 = pc.insert(t, blocks, committed=10, include_tail=False)
        assert pc.index.num_tail_blocks == 0
        assert pool.refcount(blocks[2]) == 1
        n1 = pc.insert(t, blocks, committed=10, include_tail=True)
        assert pc.index.num_tail_blocks == 1
        assert pool.refcount(blocks[2]) == 2
        return n0, n1, pc.stats()
    _both(body)


def test_prefix_cache_evict_skips_live_sharers():
    def body(BlockPool, _, PrefixCache, *__):
        pool = BlockPool(12)
        pc = PrefixCache(pool, block_size=4)
        rng = np.random.default_rng(8)
        t = _toks(rng, 12)
        blocks = pool.alloc(3)
        pc.insert(t, blocks, committed=12)
        pool.free(blocks)                # owner gone: tree-only, rc 1
        pool.ref(blocks[0])              # a live request pins page 0
        assert pc.evictable_blocks() == 2
        assert pc.evict(3) == 2          # deep pages drop, pinned stays
        assert pool.is_allocated(blocks[0])
        assert not pool.is_allocated(blocks[2])
        got = pc.match(t)
        assert got == ([blocks[0]], 4)
        return got, pc.stats()
    _both(body)


def test_scheduler_alloc_uses_cache_eviction_tier():
    """Cache eviction is the first reclamation tier: an admission whose
    deficit tree-only pages cover evicts them instead of failing (and
    never preempts anyone)."""
    def body(BlockPool, _, PrefixCache, Scheduler, Request):
        pool = BlockPool(8)              # 7 usable blocks
        s = Scheduler(pool, max_batch=2, max_blocks_per_seq=8, block_size=4,
                      prefill_chunk=8)
        pc = s.prefix_cache = PrefixCache(pool, block_size=4)
        rng = np.random.default_rng(9)
        stale = _toks(rng, 20)
        blocks = pool.alloc(5)
        pc.insert(stale, blocks, committed=20)
        pool.free(blocks)                # 5 tree-only pages, 2 free
        r = Request(prompt=_toks(rng, 16), max_new_tokens=4, arrival=0.0)
        s.submit(r)
        assert s.try_admit(0.0) is r     # needs 2 + headroom: evicts 1
        assert pool.is_allocated(r.blocks[0])
        assert pc.shared_blocks < 5
        return r.blocks, pc.shared_blocks, pool.stats()
    _both(body)


# ------------------------------------------------------- engine helpers


def _cfgs(backend="socket", arch="stablelm-12b", **serving):
    """(JAX config, port config) of ``arch .smoke()`` with ``backend``
    (a fused name turns its kernel on) and the prefix cache on."""
    return _configs(arch, backend, prefix_cache=True, **serving)


def _off(cfg, **serving):
    return cfg.replace(serving=cfg.serving.replace(prefix_cache=False,
                                                   **serving))


def _run(cfg, params, prompts, steps, engine=None):
    """Serve ``prompts`` on the port's engine (a fresh one unless given)."""
    if engine is None:
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=steps) for p in prompts]
    metrics = engine.run(reqs, realtime=False)
    return engine, reqs, metrics


def _jrun(cfg, params, prompts, steps, engine=None):
    if engine is None:
        engine = JEngine(cfg, params=params)
    reqs = [JRequest(prompt=list(p), max_new_tokens=steps, arrival=0.0)
            for p in prompts]
    metrics = engine.run(reqs, realtime=False)
    return engine, reqs, metrics


def _shared_prefix_prompts(rng, share=17, uniques=(7, 7, 11), vocab=256):
    base = rng.integers(0, vocab, size=share).tolist()
    return [base + rng.integers(0, vocab, size=u).tolist()
            for u in uniques]


def _tail_prompts(seed, vocab=256):
    """A 21-token prompt (two full pages of 8 and a 5-row tail) and its
    extension past the tail page."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, vocab, size=21).tolist()
    return first, first + rng.integers(0, vocab, size=11).tolist()


def _counts(reg):
    return {k: reg.value(f"prefix_cache_{k}_total") for k in
            ("hits", "misses", "cached_tokens", "prompt_tokens", "cow")}


def _assert_warm_matches(jc, tc, prompts, steps, params, hits):
    """Warm port tokens equal the port's cold tokens and the JAX engine's
    warm tokens; the two engines count the same hits, cached tokens and
    clones.  Returns the warm port engine."""
    jparams, tparams = params
    _, cold, _ = _run(_off(tc), tparams, prompts, steps)
    eng, warm, _ = _run(tc, tparams, prompts, steps)
    jeng, jwarm, _ = _jrun(jc, jparams, prompts, steps)
    assert eng.prefix_cache is not None
    assert eng.registry.value("prefix_cache_hits_total") >= hits
    for w, c, j in zip(warm, cold, jwarm):
        assert w.state == FINISHED and w.generated == c.generated
        assert w.generated == j.generated
    assert _counts(eng.registry) == _counts(jeng.registry)
    return eng


# --------------------------------------------------- engine: parity


@pytest.mark.parametrize("backend", ["socket", "socket_fused", "dense",
                                     "hard_lsh", "hard_lsh_fused", "quest",
                                     "quest_fused"])
def test_hit_vs_cold_token_parity(backend):
    """Cache-on serving of a shared-prefix workload generates the exact
    cold tokens, and the JAX engine's warm tokens, for every paged backend
    (plain and fused) and the dense fallback, and actually hits (the
    17-token shared prefix spans 2 full pages of 8)."""
    jc, tc = _cfgs(backend)
    rng = np.random.default_rng(10)
    prompts = _shared_prefix_prompts(rng)
    eng = _assert_warm_matches(jc, tc, prompts, 6, _params(jc, tc), hits=2)
    assert eng.registry.value("prefix_cache_cached_tokens_total") >= 2 * 16


def test_quest_shares_page_aligned_only():
    """Quest's page bounds summarize every row of a page, so its plan
    shares page-aligned prefixes only (no tail entries, CoW unreachable),
    and a direct CoW clone on such a plan refuses, as JAX's does."""
    jc, tc = _cfgs("quest")
    eng = ContinuousBatchingEngine(tc, device="cpu")
    assert eng.prefix_cache is not None
    assert not eng.prefix_cache.tail_shareable
    before = [{k: v.clone() for k, v in layer.items()} for layer in eng.pages]
    with pytest.raises(ValueError, match="page-granular"):
        paged.clone_block(tc, eng.pages, 1, 2, 3)
    with pytest.raises(ValueError, match="page-granular"):
        jpaged.clone_block(jc, jpaged.init_paged_caches(jc, jc.serving), 1,
                           2, 3)
    for old, layer in zip(before, eng.pages):    # nothing was written
        assert all(torch.equal(old[k], layer[k]) for k in layer)
    first, ext = _tail_prompts(18)
    eng, _, _ = _run(tc, eng.params, [first], 5, engine=eng)
    assert eng.prefix_cache.index.num_tail_blocks == 0
    eng, _, _ = _run(tc, eng.params, [ext], 5, engine=eng)
    assert eng.registry.value("prefix_cache_cached_tokens_total") == 16
    assert eng.registry.value("prefix_cache_cow_total") == 0


def test_warm_engine_tail_hit_triggers_cow_and_stays_exact():
    """Second batch on a warm engine: its prompt extends a finished
    request's prompt past the partial tail page, so admission installs the
    shared tail, the first chunk starts mid-page, and the engine clones
    (with scrub) before writing: tokens equal a cold engine's and the JAX
    engine's on the same sequence of runs."""
    jc, tc = _cfgs("socket")
    jparams, tparams = _params(jc, tc)
    first, ext = _tail_prompts(11)
    _, cold, _ = _run(_off(tc), tparams, [ext], 5)
    eng, _, _ = _run(tc, tparams, [first], 5)
    assert eng.prefix_cache.index.num_tail_blocks == 1
    eng, warm, _ = _run(tc, tparams, [ext], 5, engine=eng)
    jeng, _, _ = _jrun(jc, jparams, [first], 5)
    jeng, jwarm, _ = _jrun(jc, jparams, [ext], 5, engine=jeng)
    reg = eng.registry
    assert reg.value("prefix_cache_hits_total") == 1
    # 2 full pages + 5 tail rows matched; the chunk write un-shares the
    # tail page with exactly one clone
    assert reg.value("prefix_cache_cached_tokens_total") == 21
    assert reg.value("prefix_cache_cow_total") == 1
    assert warm[0].generated == cold[0].generated == jwarm[0].generated
    assert _counts(reg) == _counts(jeng.registry)


def test_cow_invariant_shared_pages_bitwise_frozen():
    """Across a whole warm serve, any physical page with pool refcount > 1
    is bitwise unchanged from one engine iteration to the next (writers
    clone, never write in place)."""
    _, tc = _cfgs("socket")
    rng = np.random.default_rng(12)
    prompts = _shared_prefix_prompts(rng, share=21, uniques=(9, 13, 7))
    eng, _, _ = _run(tc, None, [prompts[0]], 6)    # seed the cache
    prev, checked = {}, [0]

    def hook(engine, _it):
        shared = {b for b in range(1, engine.pool.num_blocks)
                  if engine.pool.is_shared(b)}
        snap = {b: [leaf[b].clone() for layer in engine.pages
                    for leaf in layer.values()] for b in shared}
        for b in shared & set(prev):
            for old, new in zip(prev[b], snap[b]):
                assert torch.equal(old, new), f"shared block {b} mutated"
            checked[0] += 1
        prev.clear()
        prev.update(snap)

    eng.iter_hook = hook
    eng, warm, _ = _run(tc, None, prompts[1:], 6, engine=eng)
    assert checked[0] > 0, "no shared pages were ever live across steps"
    assert eng.registry.value("prefix_cache_hits_total") >= 2
    assert all(r.state == FINISHED for r in warm)


def _poison(pages, value):
    """Set every allocatable page of every leaf to ``value`` (block 0, the
    trash page, keeps its fill); one-byte leaves through their bytes."""
    for layer in pages:
        for leaf in layer.values():
            v = torch.full((), value, dtype=leaf.dtype)
            paged.raw_view(leaf)[1:] = paged.raw_view(v)


def test_poisoned_pool_shared_prefix_parity():
    """Scrub on clone: with every paged leaf poisoned, a warm serve through
    shared pages and a tail clone still matches a clean cold engine bit
    for bit (a kept or exposed stale row would surface in the logits)."""
    _, tc = _cfgs("socket")
    first, ext = _tail_prompts(13)
    eng = ContinuousBatchingEngine(tc, device="cpu")
    _, cold, _ = _run(_off(tc), eng.params, [ext], 5)
    _poison(eng.pages, 1e4)
    eng, _, _ = _run(tc, None, [first], 5, engine=eng)
    eng, warm, _ = _run(tc, None, [ext], 5, engine=eng)
    assert eng.registry.value("prefix_cache_cow_total") >= 1
    assert warm[0].generated == cold[0].generated


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_poisoned_pool_cow_scrub_parity_quantized(kv_dtype):
    """The same under quantized pages: the clone copies and scrubs the K/V
    leaves and their per-row scale leaves (a stale scale rescales poisoned
    rows into the logits as surely as a stale key row).  100 is finite in
    every leaf dtype (1e4 is NaN in float8_e4m3fn)."""
    _, tc = _cfgs("socket_fused" if kv_dtype == "fp8" else "socket",
                  kv_dtype=kv_dtype)
    first, ext = _tail_prompts(13)
    eng = ContinuousBatchingEngine(tc, device="cpu")
    assert all("k_scale" in layer and "v_scale" in layer
               for layer in eng.pages)
    _, cold, _ = _run(_off(tc), eng.params, [ext], 5)
    _poison(eng.pages, 100.0)
    eng, _, _ = _run(tc, None, [first], 5, engine=eng)
    eng, warm, _ = _run(tc, None, [ext], 5, engine=eng)
    assert eng.registry.value("prefix_cache_cow_total") >= 1
    assert warm[0].generated == cold[0].generated


@pytest.mark.parametrize("backend,kv_dtype", [
    ("socket", "int8"), ("dense", "int8"), ("hard_lsh", "int8"),
    ("quest", "int8"), ("socket_fused", "fp8")])
def test_hit_vs_cold_token_parity_quantized(backend, kv_dtype):
    """Warm hits on quantized pages reproduce the same storage mode's cold
    tokens and the JAX engine's warm tokens: sharing a quantized page
    shares its scale rows with it."""
    jc, tc = _cfgs(backend, kv_dtype=kv_dtype)
    rng = np.random.default_rng(10)
    prompts = _shared_prefix_prompts(rng)
    _assert_warm_matches(jc, tc, prompts, 6, _params(jc, tc), hits=2)


# ------------------------------------------- engine: pressure + fallback


def test_preemption_with_shared_pages_token_exact():
    """Pool pressure on a cache-on shared-prefix workload: preemptions (of
    requests holding shared pages) and cache evictions interleave, and the
    run reproduces the calm cache-off tokens and the JAX engine's under
    the same pressure."""
    jc, tc = _cfgs("socket", num_blocks=10, max_batch=2)
    jparams, tparams = _params(jc, tc)
    rng = np.random.default_rng(14)
    prompts = _shared_prefix_prompts(rng, share=17, uniques=(7, 7))
    _, calm, mc = _run(_off(tc, num_blocks=48), tparams, prompts, 20)
    eng, hot, mh = _run(tc, tparams, prompts, 20)
    _, jhot, jm = _jrun(jc, jparams, prompts, 20)
    assert mh.preemptions > 0 and mc.preemptions == 0
    assert mh.preemptions == jm.preemptions
    for h, c, j in zip(hot, calm, jhot):
        assert h.state == FINISHED and len(h.generated) == 20
        assert h.generated == c.generated == j.generated
    assert eng.pool.num_used == eng.prefix_cache.shared_blocks


def test_preemption_quantized_token_parity():
    """Quantized-vs-itself parity under pool pressure: a preempted request
    re-quantizes the same prompt rows, so an int8 pressured run reproduces
    the calm int8 tokens exactly."""
    _, tc = _cfgs("socket", num_blocks=10, max_batch=2, kv_dtype="int8")
    rng = np.random.default_rng(14)
    prompts = _shared_prefix_prompts(rng, share=17, uniques=(7, 7))
    eng, hot, mh = _run(tc, None, prompts, 20)
    _, calm, mc = _run(_off(tc, num_blocks=48), eng.params, prompts, 20)
    assert mh.preemptions > 0 and mc.preemptions == 0
    for h, c in zip(hot, calm):
        assert h.state == FINISHED and h.generated == c.generated


def test_eviction_under_pressure_never_frees_live_sharers():
    """While a pressured run executes, every cache eviction leaves the
    blocks of live requests allocated, checked at every iteration."""
    _, tc = _cfgs("socket", num_blocks=10, max_batch=2)
    rng = np.random.default_rng(15)
    prompts = _shared_prefix_prompts(rng, share=17, uniques=(7, 7))

    def hook(engine, _it):
        for r in list(engine.scheduler.running.values()) + \
                engine.scheduler.prefilling:
            for b in r.blocks:
                assert engine.pool.is_allocated(b), (
                    f"request {r.rid} holds freed block {b}")

    eng = ContinuousBatchingEngine(tc, device="cpu")
    eng.iter_hook = hook
    _, reqs, m = _run(tc, None, prompts, 20, engine=eng)
    assert all(r.state == FINISHED for r in reqs)
    assert eng.registry.value("prefix_cache_evicted_total") >= 0
    assert m.preemptions > 0


def test_hybrid_plans_fall_back_to_no_share():
    """gemma3's ring layers recycle their page prefix in place, so the flag
    degrades to a plain serve (no cache object, tokens unchanged)."""
    jc, tc = _cfgs("socket", arch="gemma3-27b")
    tc = tc.replace(num_groups=1)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, tc.vocab_size, size=n).tolist()
               for n in (12, 20)]
    eng = ContinuousBatchingEngine(tc, device="cpu")
    assert eng.prefix_cache is None
    _, off, _ = _run(_off(tc), eng.params, prompts, 4)
    _, on, _ = _run(tc, None, prompts, 4, engine=eng)
    for a, b in zip(on, off):
        assert a.state == FINISHED and a.generated == b.generated
    assert JEngine(jc.replace(num_groups=1)).prefix_cache is None


def test_legacy_prefill_falls_back_to_no_share():
    """Whole-bucket prefill has no chunk cursor, so a hit cannot resume
    mid-prompt: the flag degrades to no cache, as in the JAX engine."""
    jc, tc = _cfgs("socket", prefill_chunk=0)
    assert ContinuousBatchingEngine(tc, device="cpu").prefix_cache is None
    assert JEngine(jc).prefix_cache is None


# ------------------------------------------------------------ workloads


def test_workload_generators_shape_and_overlap():
    """The generators' shapes and overlaps, and the same token lists as
    the JAX package's for the same seeds."""
    kw = dict(sessions=2, system_len=16, turn_len=12, max_prompt_len=48,
              vocab_size=256)
    for seed in (0, 3):
        chat = workloads.chatbot_prompts(6, seed=seed, **kw)
        assert chat == jworkloads.chatbot_prompts(6, seed=seed, **kw)
        rag = workloads.rag_prompts(5, prompt_len=40, overlap=0.6,
                                    vocab_size=256, seed=seed)
        assert rag == jworkloads.rag_prompts(5, prompt_len=40, overlap=0.6,
                                             vocab_size=256, seed=seed)
    assert len(chat) == 6 and all(len(p) <= 48 for p in chat)
    assert chat[2][:len(chat[0])] == chat[0]
    assert chat[3][:len(chat[1])] == chat[1]
    assert chat[0][:16] == chat[1][:16] and chat[0] != chat[1]
    assert all(len(p) == 40 for p in rag)
    assert all(p[:24] == rag[0][:24] for p in rag)
    assert len({tuple(p) for p in rag}) == 5
    with pytest.raises(ValueError, match="overlap"):
        workloads.rag_prompts(2, overlap=1.5)
    # the card's prefix traffic: a 2300-token template of 3072
    big = workloads.rag_prompts(8, prompt_len=3072, overlap=2300 / 3072,
                                vocab_size=128256, seed=0)
    assert big == jworkloads.rag_prompts(8, prompt_len=3072,
                                         overlap=2300 / 3072,
                                         vocab_size=128256, seed=0)
    assert all(p[:2300] == big[0][:2300] for p in big)
    assert len({p[2300] for p in big}) > 1


# ------------------------------------------------------------ clone_block


def _random_pools(jc, tc, seed):
    """The JAX pool and the port's of the same config, every leaf of every
    layer filled with the same random bytes or values (one-byte leaves
    avoid the fp8 NaN codes)."""
    jpages = jpaged.init_paged_caches(jc, jc.serving)
    rng = np.random.default_rng(seed)
    filled = {}

    def fill(path, leaf):
        a = np.asarray(leaf)
        if a.dtype.itemsize == 1:
            raw = rng.integers(0, 0x7f, size=a.shape, dtype=np.uint8)
            raw |= rng.integers(0, 2, size=a.shape, dtype=np.uint8) << 7
            a = raw.view(a.dtype)
        elif np.issubdtype(a.dtype, np.integer):
            a = rng.integers(-2 ** 31, 2 ** 31, size=a.shape).astype(a.dtype)
        else:
            a = rng.normal(size=a.shape).astype(a.dtype)
        filled[jax.tree_util.keystr(path)] = a
        return jnp.asarray(a)

    jpages = jax.tree_util.tree_map_with_path(fill, jpages)
    tpages = paged.init_paged_caches(tc, tc.serving)
    _copy_into(tc, jpages, tpages)
    return jpages, tpages


def _leaf_pairs(tc, jpages, tpages):
    """(JAX leaf as numpy, port leaf) for every leaf of every layer."""
    per = len(tc.pattern)
    for i, layer in enumerate(tpages):
        jl = jpages["groups"][f"slot_{i % per}"]
        for name, leaf in layer.items():
            yield name, np.asarray(jl[name][i // per]), leaf


def _copy_into(tc, jpages, tpages):
    for _, a, leaf in _leaf_pairs(tc, jpages, tpages):
        _port_bits(leaf).copy_(torch.from_numpy(_bits(a).copy()))


def _bits(a):
    """A JAX leaf's values as numpy integers of its width (one-byte and
    bf16 payloads; SOCKET's uint32 bit words as the port's int32) or as
    they are."""
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    if a.dtype.itemsize == 2:
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _port_bits(leaf):
    """The port's leaf as a tensor of the same integers as :func:`_bits`
    (a view: writing it writes the leaf)."""
    if leaf.element_size() == 1:
        return leaf.view(torch.uint8)
    if leaf.element_size() == 2:
        return leaf.view(torch.int16)
    return leaf


@pytest.mark.parametrize("keep", ["0", "1", "bs-1", "bs"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8", "fp8"])
def test_clone_block_matches_jax(kv_dtype, keep):
    """``clone_block`` on one pool, leaf for leaf against JAX's: page 3
    copied into page 5 in every layer, its first ``keep`` rows kept and
    the rest at each leaf's fill (K/V, SOCKET's bits and vnorm, and on
    int8/fp8 pages the k_scale/v_scale rows); every other page untouched."""
    jc, tc = _cfgs("socket_fused" if kv_dtype == "fp8" else "socket",
                   kv_dtype=kv_dtype)
    bs = tc.serving.block_size
    keep = {"0": 0, "1": 1, "bs-1": bs - 1, "bs": bs}[keep]
    jpages, tpages = _random_pools(jc, tc, seed=keep + 7)
    jout = jpaged.clone_block(jc, jpages, 3, 5, keep)
    assert paged.clone_block(tc, tpages, 3, 5, keep) is tpages
    names = set()
    for name, a, leaf in _leaf_pairs(tc, jout, tpages):
        names.add(name)
        np.testing.assert_array_equal(_port_bits(leaf).numpy(), _bits(a),
                                      err_msg=name)
    want = {"k", "v", "bits", "vnorm"} | (
        {"k_scale", "v_scale"} if kv_dtype != "auto" else set())
    assert names == want
    # the scrub: rows past keep at the fill, rows before it the source's
    for layer in tpages:
        for name, leaf in layer.items():
            raw = paged.raw_view(leaf)
            assert torch.equal(raw[5, :, :keep], raw[3, :, :keep])
            fill = paged.raw_view(torch.zeros((), dtype=leaf.dtype))
            assert bool((raw[5, :, keep:] == fill).all()), name


def test_clone_block_passes_ring_layers_through():
    """On a ring plan (gemma3) the ring layers' pages are untouched and the
    global layers' page is cloned, as in JAX's."""
    jc, tc = _configs("gemma3-27b", "socket")
    jc, tc = jc.replace(num_groups=1), tc.replace(num_groups=1)
    jpages, tpages = _random_pools(jc, tc, seed=3)
    jout = jpaged.clone_block(jc, jpages, 2, 4, 5)
    paged.clone_block(tc, tpages, 2, 4, 5)
    kinds = [s.attn_type for s in tc.layer_specs]
    for name, a, leaf in _leaf_pairs(tc, jout, tpages):
        np.testing.assert_array_equal(_port_bits(leaf).numpy(), _bits(a),
                                      err_msg=name)
    assert "local" in kinds and "global" in kinds


# ------------------------------------------------------------ the CLI


def test_cli_prefix_cache_rag_rehearsal(capsys):
    """The CLI's continuous engine with the prefix cache on RAG traffic:
    every request finishes, the cache hits and the JSON reports it."""
    main(["--arch", "stablelm-12b", "--smoke", "--device", "cpu",
          "--engine", "continuous", "--backend", "socket_fused",
          "--prefix-cache", "--workload", "rag", "--num-requests", "4",
          "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 4
    assert out["workload"] == "rag"
    pc = out["prefix_cache"]
    assert pc["active"] and pc["hits"] >= 1 and pc["cached_tokens"] > 0
    assert pc["hits"] + pc["misses"] == 4


def test_cli_chatbot_and_fallback_report(capsys):
    """``--workload chatbot`` serves its multi-turn prompts; on gemma3's
    hybrid plan ``--prefix-cache`` reports an inactive cache."""
    main(["--arch", "stablelm-12b", "--smoke", "--device", "cpu",
          "--engine", "continuous", "--backend", "socket", "--prefix-cache",
          "--workload", "chatbot", "--num-requests", "4",
          "--max-new-tokens", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == 4 and out["prefix_cache"]["hits"] >= 1
    main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
          "--engine", "continuous", "--backend", "socket", "--prefix-cache",
          "--num-requests", "2", "--max-new-tokens", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == 2 and not out["prefix_cache"]["active"]


@pytest.mark.parametrize("argv,match", [
    (["--prefix-cache"], "--prefix-cache requires --engine continuous"),
    (["--workload", "rag"], "--workload chatbot/rag requires"),
    (["--engine", "continuous", "--workload", "rag", "--overlap", "1.0"],
     "--overlap must be in"),
])
def test_cli_refuses_prefix_flags_as_jax_does(argv, match, capsys):
    with pytest.raises(SystemExit):
        main(["--arch", "stablelm-12b", "--smoke", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err
