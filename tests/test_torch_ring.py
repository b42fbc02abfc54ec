"""Port parity for the sliding-window (ring) modules: the ring kernel's
plain version, the ring page writes, ``RingView``, ``RingCacheHandler``,
the cache plan and the local layers' attention, against the JAX package
on numpy-seeded inputs.

The ring kernel's plain version (what a CPU tensor runs) is held to the
JAX Pallas kernel in interpret mode and to its jnp oracle on the float32
ring cases of the JAX kernel harness (``tests/test_kernels.py``), at the
harness's float32 policy atol 2e-5 (float32 softmax in another summation
order).  Page writes, views and handlers move data only, so they are
held to JAX bit for bit, trash page included.  The local layers'
prefill, chunked prefill and decode outputs are held at rtol 1e-5 / atol
1e-4 (float32 projections in another summation order).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_kernels as jk
from repro.configs import get_config as jget
from repro.kernels.paged_attention.ref import \
    paged_ring_attend_ref as j_ring_ref
from repro.models import attention as jattn
from repro.models import backends as jbk
from repro.models import param as pm
from repro.models.backends.ring import RingCacheHandler as JRingHandler
from repro_torch.configs import LayerSpec
from repro_torch.configs import get_config as tget
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import paged_ring_attend_ref
from repro_torch.models import attention as tattn
from repro_torch.models import backends as tbk
from repro_torch.models.backends.ring import RingCacheHandler

ATOL = 2e-5
TOL = dict(rtol=1e-5, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _ring_case(label):
    op = next(o for o in jk.KERNEL_OPS if o.name == "paged_ring")
    return next(c for c in op.cases if c.label == label).kwargs


# ------------------------------------------------------------ ring kernel

@pytest.mark.parametrize("label", ["wrap-mix", "unwrapped", "softcap",
                                   "window-lt-cap"])
def test_ring_plain_matches_pallas_and_oracle(label):
    args, kw = jk._ring_fixture(**_ring_case(label))
    jout = jk.paged_ring_attend(*args, **kw)
    rout = j_ring_ref(*args, **kw)
    targs = [_t(a) for a in args]
    tkw = dict(kw, pos=_t(kw["pos"]))
    before = tpa.RING_LAUNCHES
    out = tpa.paged_ring_attend(*targs, **tkw)
    out5 = tpa.paged_ring_attend(targs[0][:, :, :, None], *targs[1:], **tkw)
    assert tpa.RING_LAUNCHES == before
    torch.testing.assert_close(out5[:, :, :, 0], out, rtol=0, atol=0)
    torch.testing.assert_close(paged_ring_attend_ref(*targs, **tkw), out,
                               rtol=0, atol=0)
    for want in (jout, rout):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_ring_plain_masks_dead_slots():
    """Slots out of the window or never written, and the trash page, may
    hold anything: NaN keys and huge values there leave the output as it
    was (the card test holds the kernel to NaN values too, which it
    skips; the plain version's 0 · NaN would not)."""
    args, kw = jk._ring_fixture(**_ring_case("window-lt-cap"))
    q, kp, vp, bt = [_t(a) for a in args]
    tkw = dict(kw, pos=_t(kw["pos"]))
    want = tpa.paged_ring_attend(q, kp, vp, bt, **tkw)
    rb, bs = bt.shape[1], kp.shape[2]
    cap = rb * bs
    for i, p in enumerate(kw["pos"].tolist()):
        for s in range(cap):
            rp = p - (p - s) % cap
            if rp < 0 or p - rp >= kw["window"]:
                kp[bt[i, s // bs], :, s % bs] = float("nan")
                vp[bt[i, s // bs], :, s % bs] = 1e30
    kp[0], vp[0] = float("nan"), 1e30
    got = tpa.paged_ring_attend(q, kp, vp, bt, **tkw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("positions,window", [
    ([5, 40, 200, 29], 64), ([3, 150, 77], 60)])
def test_ring_card_check_holds_plain_and_rejects_faults(positions, window):
    """The card check of ``cases.py`` passes the plain version on the
    case's pool (NaN dead rows zeroed) and catches an output computed
    with a wrong position or a wrong window."""
    from repro_torch.kernels.paged_attention import cases
    gen = torch.Generator().manual_seed(len(positions))
    (case,), kw = cases.ring_case(gen, positions, kvh=2, g=2, hd=16, bs=8,
                                  rb=8, window=window)
    q, kp, vp, bt, pos = case
    assert torch.isnan(kp[0]).all() and torch.isnan(kp).any()
    clean = (kp.nan_to_num(0.0), vp.nan_to_num(0.0))
    good = paged_ring_attend_ref(q, *clean, bt, pos=pos, **kw)
    assert cases.check_ring(good, case, kw, attn_tol=dict(rtol=1e-4,
                                                          atol=1e-5)) == 0
    for wrong in (dict(kw, window=window - 3),
                  dict(kw, pos=pos + 1)):
        bad = paged_ring_attend_ref(q, *clean, bt, **dict(
            dict(pos=pos), **wrong))
        with pytest.raises(AssertionError, match="paged_ring"):
            cases.check_ring(bad, case, kw, attn_tol=dict(rtol=1e-4,
                                                          atol=1e-5))


def test_ring_wrapper_rejects_scales():
    """A lone scale pool raises the JAX wrapper's ValueError."""
    args, kw = jk._ring_fixture(**_ring_case("wrap-mix"))
    targs = [_t(a) for a in args]
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_ring_attend(*targs, **dict(kw, pos=_t(kw["pos"])),
                              k_scale=torch.ones(1))


# ------------------------------------------------------------ page writes

def _pools(seed, nblocks=7, kvh=2, bs=8, hd=4):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((nblocks, kvh, bs, hd)).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("pos", [
    [0, 16, 3],          # first pass: page-opening writes scrub the page
    [24, 40, 33],        # later passes: the dead band [1, cap - window]
    [8, 56, 63],         # a page reopening and the ring's last row
])
def test_ring_write_page_bitwise(pos):
    """One token per request through ``ring_write_page`` (rb 3, bs 8,
    cap 24, window 20: dead band rows 1..4); slot 2's block is the trash
    page, aliased by the inactive slot 3."""
    pools = _pools(0)
    blk = np.array([3, 5, 0, 0], np.int32)
    pos = np.array(pos + [7], np.int32)
    val = np.random.default_rng(1).standard_normal((4, 2, 4)).astype(
        np.float32)
    kw = dict(block_size=8, ring_blocks=3, window=20)
    want = jbk.ring_write_page(jnp.asarray(pools["k"]), jnp.asarray(blk),
                               jnp.asarray(pos), jnp.asarray(val), **kw)
    got = tbk.ring_write_page(_t(pools["k"]), _t(blk), _t(pos), _t(val),
                              **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a scalar position (the JAX views broadcast it to (B,) first)
    want = jbk.ring_write_page(jnp.asarray(pools["v"]), jnp.asarray(blk),
                               jnp.full((4,), 16, jnp.int32),
                               jnp.asarray(val), **kw)
    got = tbk.ring_write_page(_t(pools["v"]), _t(blk), 16, _t(val), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("history,last,rb,window,held", [
    (0, 15, 3, 20, 3),   # first chunk, wraps the 24-row ring
    (16, 9, 3, 20, 3),   # padded final chunk: rows 10.. to the trash page
    (40, 15, 4, 32, 4),  # later pass, window == cap: no dead band
    (8, 15, 1, 8, 1),    # a one-block ring, shorter than the chunk
    (0, 5, 3, 20, 1),    # a short prompt: unheld ring entries are trash
])
def test_ring_write_chunk_equals_sequential_writes(history, last, rb,
                                                   window, held):
    """The chunk writer's one pass equals the JAX package's token-by-token
    ``ring_write_page`` loop (``attention_prefill_chunk``'s local branch)
    bit for bit, trash page included.  ``held``: the ring entries the
    request holds blocks for; the rest point at the trash page."""
    pools = _pools(2)
    c, bs = 16, 8
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((1, 2, c, 4)).astype(np.float32)
    bt_row = np.array([4, 2, 6, 1, 0, 0], np.int32)
    bt_row[held:] = 0
    want = jnp.asarray(pools["k"])
    for j in range(c):
        p = history + j
        blk = bt_row[(p // bs) % rb] if j <= last else 0
        want = jbk.ring_write_page(want, jnp.asarray([blk], jnp.int32),
                                   jnp.asarray([p], jnp.int32),
                                   jnp.asarray(vals[:, :, j]), block_size=bs,
                                   ring_blocks=rb, window=window)
    got = tbk.ring_write_chunk(_t(pools["k"]), _t(vals), _t(bt_row), history,
                               last, block_size=bs, ring_blocks=rb,
                               window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_view_reads_and_writes_bitwise():
    pools = _pools(4)
    bt = np.array([[3, 6, 2, 0], [5, 1, 4, 0]], np.int32)
    spec_j = {n: jbk.LeafSpec(suffix=(4,)) for n in ("k", "v")}
    spec_t = {n: tbk.LeafSpec(suffix=(4,)) for n in ("k", "v")}
    jv = jbk.RingView({n: jnp.asarray(a) for n, a in pools.items()}, spec_j,
                      jnp.asarray(bt), 8, 3, 20)
    tv = tbk.RingView({n: _t(a) for n, a in pools.items()}, spec_t, _t(bt),
                      8, 3, 20)
    assert tv.n_tokens == jv.n_tokens == 24
    np.testing.assert_array_equal(tv.leaf("k").numpy(),
                                  np.asarray(jv.leaf("k")))
    idx = np.array([[[0, 9, 23, 30]] * 2, [[5, 24, 47, 1]] * 2], np.int32)
    np.testing.assert_array_equal(tv.gather_rows("v", _t(idx)).numpy(),
                                  np.asarray(jv.gather_rows("v",
                                                            jnp.asarray(idx))))
    val = np.random.default_rng(5).standard_normal((2, 2, 4)).astype(
        np.float32)
    pos = np.array([48, 13], np.int32)
    jv.write_token("k", jnp.asarray(pos), jnp.asarray(val))
    tv.write_token("k", _t(pos), _t(val))
    np.testing.assert_array_equal(tv.arrays["k"].numpy(),
                                  np.asarray(jv.arrays["k"]))


def test_ring_handler_gather_scatter_bitwise():
    """The dense fallback's round trip through ``RingCacheHandler`` on the
    gemma3 smoke geometry (rb 4, bs 8, window 32): the bounded views, and
    the write-back with scrub of one row per slot (slot 2 inactive, on
    the trash page); then the legacy whole-prompt prefill's scatter of a
    flat 32-slot ring into a request's pages."""
    jc, tc = jget("gemma3-27b").smoke(), tget("gemma3-27b").smoke()
    rng = np.random.default_rng(6)
    pools = {n: rng.standard_normal((9, 2, 8, 16)).astype(np.float32)
             for n in ("k", "v")}
    bt = np.array([[3, 6, 2, 8, 0, 0, 0, 0], [5, 1, 4, 7, 0, 0, 0, 0],
                   [0] * 8], np.int32)
    pos = np.array([40, 31, 0], np.int32)
    jh, th = JRingHandler(), RingCacheHandler()
    assert dataclasses.asdict(th.spec(tc))["ring_blocks"] == \
        jh.spec(jc).ring_blocks == 4
    jviews = jh.gather(jc, {n: jnp.asarray(a) for n, a in pools.items()},
                       jnp.asarray(bt))
    tpool = {n: _t(a) for n, a in pools.items()}
    tviews = th.gather(tc, tpool, _t(bt))
    for n in pools:
        np.testing.assert_array_equal(tviews[n].numpy(), np.asarray(jviews[n]))
    # the decode step's ring write in the contiguous views, then back
    new = rng.standard_normal((3, 2, 16)).astype(np.float32)
    jviews = {n: v.at[jnp.arange(3), :, jnp.asarray(pos) % 32].set(new)
              for n, v in jviews.items()}
    for v in tviews.values():
        v[torch.arange(3), :, _t(pos).long() % 32] = _t(new)
    want = jh.scatter(jc, {n: jnp.asarray(a) for n, a in pools.items()},
                      jviews, jnp.asarray(bt), jnp.asarray(pos))
    th.scatter(tc, tpool, tviews, _t(bt), _t(pos))
    for n in pools:
        np.testing.assert_array_equal(tpool[n].numpy(), np.asarray(want[n]))
    ring = {n: rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
            for n in pools}
    row = np.array([5, 1, 0, 0, 0], np.int32)        # a 2-page allocation
    want = jh.write_prefill(jc, want, {n: jnp.asarray(a)
                                       for n, a in ring.items()},
                            jnp.asarray(row), jnp.int32(1))
    th.write_prefill(tc, tpool, {n: _t(a) for n, a in ring.items()},
                     _t(row), 1)
    for n in pools:
        np.testing.assert_array_equal(tpool[n][1:].numpy(),
                                      np.asarray(want[n])[1:])


# ------------------------------------------------------------- cache plan

def test_gemma3_cache_plan_and_ring_geometry_match_jax():
    for full in (True, False):
        jc, tc = jget("gemma3-27b"), tget("gemma3-27b")
        if not full:
            jc, tc = jc.smoke(), tc.smoke()
        assert tc.ring_geometry() == jc.ring_geometry()
        assert [dataclasses.asdict(p) for p in tc.cache_plan()] == \
            [dataclasses.asdict(p) for p in jc.cache_plan()]
        for spec in tc.layer_specs[:6]:
            got = tbk.layer_cache_spec(tc, spec)
            want = jbk.layer_cache_spec(jc, spec)
            assert (got.kind, got.ring_blocks, set(got.leaves)) == \
                (want.kind, want.ring_blocks, set(want.leaves))
    assert tget("gemma3-27b").ring_geometry() == (64, 1024)
    # use_ring_kernel needs block_size % 8 == 0, as in the JAX package
    for cfgs in ((jget("gemma3-27b").smoke(), tget("gemma3-27b").smoke()),):
        for c in cfgs:
            bad = c.replace(use_ring_kernel=True,
                            serving=c.serving.replace(block_size=12,
                                                      prefill_buckets=(24,),
                                                      prefill_chunk=24))
            with pytest.raises(ValueError, match="use_ring_kernel"):
                bad.cache_plan()
            c.replace(use_ring_kernel=True).cache_plan()
    mamba = LayerSpec(kind="mamba", mlp="none")
    with pytest.raises(NotImplementedError, match="item 7"):
        tbk.layer_cache_handler(tget("gemma3-27b"), mamba)


def test_pool_layout_matches_jax():
    """Ring layers get full block_size-row K/V pages, global layers the
    backend's leaves, one block id addressing every layer."""
    from repro.serving import paged as jpaged
    from repro_torch.serving import paged as tpaged
    jc, tc = jget("gemma3-27b").smoke(), tget("gemma3-27b").smoke()
    jpool = jpaged.init_paged_caches(jc, jc.serving)
    tpool = tpaged.init_paged_caches(tc, tc.serving)
    assert len(tpool) == tc.num_layers == 13
    for i, spec in enumerate(tc.layer_specs):
        if i < 12:
            leaves = jpool["groups"][f"slot_{i % 6}"]
            shape = lambda a: a.shape[1:]
        else:
            leaves = jpool["remainder"]["slot_0"]
            shape = lambda a: a.shape
        assert set(tpool[i]) == set(leaves)
        for name, leaf in leaves.items():
            assert tuple(tpool[i][name].shape) == tuple(shape(leaf))


# ------------------------------------------------------- local attention

def _local_params(seed=0):
    jc = jget("gemma3-27b").smoke().replace(attn_logit_softcap=30.0)
    tc = tget("gemma3-27b").smoke().replace(attn_logit_softcap=30.0)
    jp = pm.unbox(jattn.init_attention(jc, jax.random.PRNGKey(seed)))
    tp = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jp)
    return jc, tc, jp, tp


def test_local_prefill_and_static_decode_allclose():
    """The static path: sliding-window prompt attention (T 40 > window
    32) and the contiguous ring it builds, then two ring decode steps
    (one wrapping) with a scalar position."""
    jc, tc, jp, tp = _local_params()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    jy, jcache = jax.jit(lambda x, p: jattn.attention_prefill(
        jc, jp, x, p, "local", 48))(jnp.asarray(x), jnp.asarray(pos))
    ty, tcache = tattn.attention_prefill(tc, tp, _t(x), _t(pos).long(),
                                         "local", 48)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL)
    jdecode = jax.jit(lambda x, c, p: jattn.attention_decode(
        jc, jp, x, c, p, "local"))
    for step in (40, 41):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jcache = jdecode(jnp.asarray(xd), jcache, jnp.int32(step))
        ty, tcache = tattn.attention_decode(tc, tp, _t(xd), tcache, step,
                                            "local")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]), **TOL)


@pytest.mark.parametrize("ring_kernel", [False, True])
def test_local_chunk_and_paged_decode_allclose(ring_kernel):
    """The continuous engine's local layer: three chunks of 16 (the last
    padded) against the pool, then a ragged decode step through the
    RingView (plain masked softmax, or the ring kernel's plain version)
    with an inactive slot on the trash page."""
    jc, tc, jp, tp = _local_params(1)
    jc = jc.replace(use_ring_kernel=ring_kernel)
    tc = tc.replace(use_ring_kernel=ring_kernel)
    rng = np.random.default_rng(8)
    pools = {n: rng.standard_normal((12, 2, 8, 16)).astype(np.float32)
             for n in ("k", "v")}
    jpool = {n: jnp.asarray(a) for n, a in pools.items()}
    tpool = {n: _t(a) for n, a in pools.items()}
    bt_row = np.array([3, 9, 5, 1, 0, 0, 0, 0, 0, 0], np.int32)
    jchunk = jax.jit(lambda x, p, c, bt, h, li:
                     jattn.attention_prefill_chunk(jc, jp, x, p, "local", c,
                                                   bt, h, li))
    for history, last in ((0, 15), (16, 15), (32, 9)):
        x = rng.standard_normal((1, 16, 64)).astype(np.float32)
        pos = (history + np.arange(16))[None].astype(np.int32)
        jy, jpool = jchunk(jnp.asarray(x), jnp.asarray(pos), jpool,
                           jnp.asarray(bt_row), jnp.int32(history),
                           jnp.asarray([last]))
        ty, tpool = tattn.attention_prefill_chunk(
            tc, tp, _t(x), _t(pos).long(), "local", tpool, _t(bt_row),
            history, last)
        np.testing.assert_allclose(ty[:, :last + 1].numpy(),
                                   np.asarray(jy)[:, :last + 1], **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tpool[n].numpy(),
                                       np.asarray(jpool[n]), **TOL)
    bt = np.stack([bt_row[:8], [7, 2, 11, 4, 0, 0, 0, 0], [0] * 8]).astype(
        np.int32)
    pos = np.array([42, 3, 0], np.int32)
    xd = rng.standard_normal((3, 1, 64)).astype(np.float32)
    jy, jpool = jattn.attention_decode(jc, jp, jnp.asarray(xd), jpool,
                                       jnp.asarray(pos), "local",
                                       block_tables=jnp.asarray(bt))
    before = tpa.RING_LAUNCHES
    ty, tpool = tattn.attention_decode(tc, tp, _t(xd), tpool, _t(pos).long(),
                                       "local", block_tables=_t(bt))
    assert tpa.RING_LAUNCHES == before
    np.testing.assert_allclose(ty[:2].numpy(), np.asarray(jy)[:2], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n][1:].numpy(),
                                   np.asarray(jpool[n])[1:], **TOL)
