"""Port parity for the serving pieces beneath the engine: the copied
block pool and scheduler (mirroring ``tests/test_serving.py``), the
serving config and cache plan, ``PagedView`` reads and writes, the
chunk writers and the dense fallback's gather/scatter, against the JAX
package on the same numpy inputs.

Tolerances: every comparison here is bitwise (copies and index moves).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import backends as jbk
from repro.serving import paged as jpaged
from repro_torch.configs import LayerSpec
from repro_torch.configs import get_config as tget
from repro_torch.models import backends as tbk
from repro_torch.serving import (DECODE, FINISHED, WAITING, BlockPool,
                                 Request, Scheduler, TRASH_BLOCK)
from repro_torch.serving import paged as tpaged
from repro_torch.serving.obs.metrics import Registry

import torch


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# --------------------------------------------------------------- block pool

def test_pool_alloc_free_roundtrip():
    pool = BlockPool(num_blocks=8)          # block 0 reserved
    assert pool.num_free == 7
    a = pool.alloc(3)
    assert len(a) == 3 and TRASH_BLOCK not in a
    assert pool.num_free == 4 and pool.num_used == 3
    b = pool.alloc(4)
    assert pool.num_free == 0
    assert pool.alloc(1) is None            # exhausted
    pool.free(a)
    assert pool.num_free == 3
    pool.free(b)
    assert pool.num_free == 7 and pool.num_used == 0
    assert pool.high_water == 7


def test_pool_alloc_is_all_or_nothing():
    pool = BlockPool(num_blocks=4)
    assert pool.alloc(5) is None
    assert pool.num_free == 3               # state unchanged on failure
    assert sorted(pool.alloc(3)) == [1, 2, 3]


def test_pool_rejects_bad_frees():
    pool = BlockPool(num_blocks=4)
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError):
        pool.free(blocks)                   # double free
    with pytest.raises(ValueError):
        pool.free([TRASH_BLOCK])            # trash page is not freeable


# ---------------------------------------------------------------- scheduler

def _sched(num_blocks=16, max_batch=2, max_nb=8, bs=8, chunk=0):
    return Scheduler(BlockPool(num_blocks), max_batch=max_batch,
                     max_blocks_per_seq=max_nb, block_size=bs,
                     prefill_chunk=chunk)


def test_scheduler_admission_is_fcfs_and_slot_gated():
    s = _sched(max_batch=2)
    reqs = [Request(prompt=[1] * 8, max_new_tokens=4, arrival=0.1 * i)
            for i in range(3)]
    for r in reqs:
        s.submit(r)
    first = s.try_admit(now=1.0)
    second = s.try_admit(now=1.0)
    assert (first.rid, second.rid) == (reqs[0].rid, reqs[1].rid)
    assert s.try_admit(now=1.0) is None     # both slots taken
    assert first.state == "prefill" and first.blocks
    s.activate(first)
    s.activate(second)
    s.finish(first, now=2.0)
    assert first.state == FINISHED and first.blocks == []
    assert s.try_admit(now=2.0).rid == reqs[2].rid


def test_scheduler_respects_arrival_times():
    s = _sched()
    s.submit(Request(prompt=[1] * 8, max_new_tokens=4, arrival=5.0))
    assert s.try_admit(now=1.0) is None     # not arrived yet
    assert s.try_admit(now=5.0) is not None


def test_scheduler_admission_accounts_free_blocks():
    s = _sched(num_blocks=4, max_batch=2, bs=8)
    a = Request(prompt=[1] * 16, max_new_tokens=4, arrival=0.0)
    b = Request(prompt=[2] * 16, max_new_tokens=4, arrival=0.0)
    s.submit(a)
    s.submit(b)
    assert s.try_admit(now=0.0).rid == a.rid
    assert s.try_admit(now=0.0) is None     # blocks exhausted, slot free
    s.activate(a)
    s.finish(a, now=1.0)
    assert s.try_admit(now=1.0).rid == b.rid


def test_scheduler_preempts_lru_on_block_exhaustion():
    s = _sched(num_blocks=6, max_batch=2, bs=8)
    a = Request(prompt=[1] * 16, max_new_tokens=20, arrival=0.0)
    b = Request(prompt=[2] * 16, max_new_tokens=20, arrival=0.1)
    s.submit(a)
    s.submit(b)
    for r in (s.try_admit(1.0), s.try_admit(1.0)):
        s.activate(r)
    a.generated = [7, 8]
    b.generated = [9]
    a.pos = 18
    b.pos = 17
    reg = Registry()
    s.bind_obs(reg, None)
    runnable = s.ensure_decode_blocks()
    assert len(runnable) == 1               # one survivor, one preempted
    preempted, survivor = (a, b) if a.state == WAITING else (b, a)
    assert survivor.state == DECODE and len(survivor.blocks) == 3
    assert preempted.blocks == [] and preempted.preemptions == 1
    assert preempted in s.waiting
    assert preempted.effective_prompt[:16] == preempted.prompt
    assert reg.value("serve_preemptions_total") == 1


def test_scheduler_admits_pool_filling_request_without_headroom():
    s = _sched(num_blocks=4, max_batch=1, bs=8)
    r = Request(prompt=[1] * 22, max_new_tokens=2, arrival=0.0)
    s.submit(r)
    assert s.try_admit(now=0.0) is r and len(r.blocks) == 3


def test_scheduler_rejects_unservable_requests():
    s = _sched(num_blocks=4, max_nb=64, bs=8)
    with pytest.raises(ValueError):         # needs more than the whole pool
        s.submit(Request(prompt=[1] * 64, max_new_tokens=8, arrival=0.0))
    with pytest.raises(ValueError):         # exceeds per-seq block table
        _sched(max_nb=2).submit(
            Request(prompt=[1] * 32, max_new_tokens=8, arrival=0.0))


def test_scheduler_chunk_grants_grow_blocks_per_chunk():
    s = _sched(num_blocks=16, max_batch=1, bs=8, chunk=16)
    r = Request(prompt=list(range(40)), max_new_tokens=4, arrival=0.0)
    s.submit(r)
    assert s.try_admit(now=0.0) is r and len(r.blocks) == 2
    chunks = []
    while r.state == "prefill" and r.prefill_pos < len(r.prompt):
        c = s.grant_chunk(r)
        chunks.append((c.start, c.tokens, c.final, len(r.blocks)))
        s.advance_chunk(r, c)
    assert chunks == [(0, 16, False, 2), (16, 16, False, 4),
                      (32, 8, True, 5)]


# ------------------------------------------------------------ config + plan

@pytest.mark.parametrize("arch", ["llama31-8b", "stablelm-12b"])
def test_serving_settings_and_plan_match_jax(arch):
    for smoke in (False, True):
        jc, tc = jget(arch), tget(arch)
        if smoke:
            jc, tc = jc.smoke(), tc.smoke()
        assert dataclasses.asdict(tc.serving) == \
            dataclasses.asdict(jc.serving)
        assert tc.serving.max_context == jc.serving.max_context
        assert [dataclasses.asdict(p) for p in tc.cache_plan()] == \
            [dataclasses.asdict(p) for p in jc.cache_plan()]
    for backend in ("socket", "dense"):
        # the pool's leaves: names, per-layer shapes and bytes per
        # element (the port keeps the packed bits' uint32 pattern in int32)
        jc = jget(arch).smoke().replace(attention_backend=backend)
        tc = tget(arch).smoke().replace(attention_backend=backend)
        jpool = jpaged.init_paged_caches(jc, jc.serving)["groups"]["slot_0"]
        tpool = tpaged.init_paged_caches(tc, tc.serving)
        assert len(tpool) == jc.num_layers
        for name, leaf in jpool.items():
            assert tuple(tpool[0][name].shape) == tuple(leaf.shape[1:])
            assert tpool[0][name].element_size() == leaf.dtype.itemsize
        assert set(tpool[0]) == set(jpool)
    ssm = tget(arch).smoke().replace(
        pattern=(LayerSpec(kind="mamba", mlp="none"),))
    assert {dataclasses.astuple(p) for p in ssm.cache_plan()} == \
        {("state", 0, "auto")}


# ---------------------------------------------------------- paged view + io

def _pool(seed, nblocks=9, kvh=2, bs=8, hd=4, w=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.standard_normal((nblocks, kvh, bs, hd)).astype(
                np.float32),
            "bits": rng.integers(0, 2 ** 31, (nblocks, kvh, bs, w)).astype(
                np.int32),
            "vnorm": rng.standard_normal((nblocks, kvh, bs)).astype(
                np.float32)}


def _spec():
    jspec = {"k": jbk.LeafSpec(suffix=(4,)),
             "bits": jbk.LeafSpec(suffix=(3,), dtype=jnp.int32),
             "vnorm": jbk.LeafSpec(suffix=())}
    tspec = {"k": tbk.LeafSpec(suffix=(4,)),
             "bits": tbk.LeafSpec(suffix=(3,), dtype=torch.int32),
             "vnorm": tbk.LeafSpec(suffix=())}
    return jspec, tspec


def test_paged_view_reads_and_writes_bitwise():
    pool = _pool(0)
    bt = np.array([[3, 7, 0, 0], [5, 1, 8, 0], [0, 0, 0, 0]], np.int32)
    jspec, tspec = _spec()
    jv = jbk.PagedView({k: jnp.asarray(v) for k, v in pool.items()}, jspec,
                       jnp.asarray(bt), 8)
    tpool = {k: _t(v) for k, v in pool.items()}
    tv = tbk.PagedView(tpool, tspec, _t(bt), 8)
    assert tv.n_tokens == jv.n_tokens == 32
    for name in pool:
        np.testing.assert_array_equal(tv.leaf(name).numpy(),
                                      np.asarray(jv.leaf(name)))
    idx = np.random.default_rng(1).integers(0, 24, (3, 2, 5))
    for name in pool:
        np.testing.assert_array_equal(
            tv.gather_rows(name, _t(idx)).numpy(),
            np.asarray(jv.gather_rows(name, jnp.asarray(idx))))
    pos = np.array([9, 17, 0], np.int32)      # slot 2 idles on the trash
    rng = np.random.default_rng(2)
    for name, a in pool.items():
        val = rng.standard_normal((3, 2) + a.shape[3:]).astype(a.dtype)
        jv.write_token(name, jnp.asarray(pos), jnp.asarray(val))
        before = tpool[name]
        tv.write_token(name, _t(pos), _t(val))
        assert tv.arrays[name] is before    # in place
        np.testing.assert_array_equal(tpool[name][1:].numpy(),
                                      np.asarray(jv.arrays[name])[1:])


@pytest.mark.parametrize("history,last", [(0, 15), (16, 15), (8, 5),
                                          (3, 9)])
def test_chunk_writers_bitwise(history, last):
    """Row-granular commits (page-aligned, a padded final chunk, a
    mid-page start) and whole-block commits, into a trash-padded row."""
    rng = np.random.default_rng(history * 31 + last)
    pages = rng.standard_normal((9, 2, 8, 4)).astype(np.float32)
    leaf = rng.standard_normal((1, 2, 16, 4)).astype(np.float32)
    bt_row = np.array([4, 2, 7, 6, 0, 0], np.int32)
    j = jbk.write_chunk_rows(jnp.asarray(pages), jnp.asarray(leaf),
                             jnp.asarray(bt_row), history, last)
    t = _t(pages)
    tbk.write_chunk_rows(t, _t(leaf), _t(bt_row), history, last)
    np.testing.assert_array_equal(t[1:].numpy(), np.asarray(j)[1:])
    if history % 8 == 0:
        jb = jbk.write_chunk_blocks(jnp.asarray(pages), jnp.asarray(leaf),
                                    jnp.asarray(bt_row), history // 8)
        tb = _t(pages)
        tbk.write_chunk_blocks(tb, _t(leaf), _t(bt_row), history // 8)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_dense_fallback_gather_scatter_bitwise():
    """``gather_views`` / ``scatter_token`` (the dense backend's route
    through the engine) on the llama31-8b smoke pool."""
    jc = jget("llama31-8b").smoke().replace(attention_backend="dense")
    tc = tget("llama31-8b").smoke().replace(attention_backend="dense")
    rng = np.random.default_rng(4)
    tpages = tpaged.init_paged_caches(tc, tc.serving)
    assert len(tpages) == tc.num_layers
    for layer in tpages:
        for leaf in layer.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
    jpages = {"groups": {"slot_0": {
        name: jnp.stack([jnp.asarray(layer[name].numpy())
                         for layer in tpages]) for name in tpages[0]}},
        "remainder": {}}
    bt = np.zeros((4, 8), np.int32)
    bt[0, :3] = [5, 9, 2]
    bt[1, :1] = [11]
    pos = np.array([20, 3, 0, 0], np.int32)
    jviews = jpaged.gather_views(jc, jpages, jnp.asarray(bt))
    tviews = tpaged.gather_views(tc, tpages, _t(bt))
    for i, v in enumerate(tviews):
        for name in v:
            np.testing.assert_array_equal(
                v[name].numpy(),
                np.asarray(jviews["groups"]["slot_0"][name][i]))
            v[name].add_(1.0)
    jviews = {"groups": {"slot_0": {
        name: jnp.stack([jnp.asarray(v[name].numpy()) for v in tviews])
        for name in tviews[0]}}, "remainder": {}}
    jout = jpaged.scatter_token(jc, jpages, jviews, jnp.asarray(bt),
                                jnp.asarray(pos))
    tpaged.scatter_token(tc, tpages, tviews, _t(bt), _t(pos))
    for i, layer in enumerate(tpages):
        for name in layer:
            np.testing.assert_array_equal(
                layer[name][1:].numpy(),
                np.asarray(jout["groups"]["slot_0"][name][i])[1:])
