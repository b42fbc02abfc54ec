"""Port parity: the fused hard-LSH and Quest paged kernels' plain PyTorch
versions (what a CPU tensor runs) against the JAX package's Pallas
kernels in interpret mode and their jnp oracles, on the float32 cases of
the JAX kernel harness (``tests/test_kernels.py``: the same fixtures,
numpy-seeded); the Quest baseline module and the views' read-modify-write;
and the card checks of ``kernels/paged_attention/cases.py``.

Tolerances: selections bit for bit; outputs atol 2e-5 (the harness's
float32 policy: float32 attention in another summation order); Quest page
scores rtol 1e-6 / atol 1e-5 against JAX's float32 sums (the port
accumulates each bound in float64 and rounds once), hard collision
counts bit for bit.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import test_kernels as jk
from repro.baselines import quest as jquest
from repro.configs import get_config as jget
from repro.kernels.paged_attention.ref import (
    paged_hard_lsh_attend_ref as j_hard_ref,
    paged_quest_attend_ref as j_quest_ref)
from repro.models.backends import base as jbase
from repro.models.backends.hard_lsh import \
    _hard_collision_scores as j_hard_scores
from repro_torch.baselines import quest as tquest
from repro_torch.configs import get_config
from repro_torch.core import socket as tsk
from repro_torch.kernels.paged_attention import cases as tcases
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.models.backends import ContiguousView, PagedView, get_backend
from repro_torch.models.backends.hard_lsh import _hard_collision_scores

ATOL = 2e-5
SCORE_TOL = dict(rtol=1e-6, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _case(op_name, label):
    op = next(o for o in jk.KERNEL_OPS if o.name == op_name)
    return next(c for c in op.cases if c.label == label).kwargs


@pytest.mark.parametrize("label", ["ragged", "pooled-hash", "collision-ties",
                                   "unaligned-tables", "budget-floor"])
def test_hard_lsh_plain_matches_pallas_and_oracle(label):
    args, kw, kq = jk._paged_fixture(**_case("paged_hard_lsh", label))
    q, kp, vp, bits, vn, u, bt = args
    u_signs = jnp.where(u >= 0, 1.0, -1.0).astype(jnp.float32)
    kw = {k: v for k, v in kw.items() if k != "tau"}
    jout, jsel = jk.paged_hard_lsh_attend(q, kp, vp, bits, vn, u_signs, bt,
                                          with_selection=True, **kw)
    rout, rsel = j_hard_ref(q, kp, vp, bits, vn, u_signs, bt, top_k=kq,
                            **kw)
    targs = [_t(q), _t(kp), _t(vp), _t(np.asarray(bits).view(np.int32)),
             _t(np.asarray(vn.astype(jnp.float32))).to(torch.bfloat16),
             _t(u_signs), _t(bt)]
    tkw = dict(kw, length=_t(kw["length"]), budget=_t(kw["budget"]))
    before = tpa.HARD_LSH_LAUNCHES
    out, sel = tpa.paged_hard_lsh_attend(*targs, with_selection=True, **tkw)
    assert tpa.HARD_LSH_LAUNCHES == before
    for js, jo in ((jsel, jout), (rsel, rout)):
        np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)
    length, budget = np.asarray(kw["length"]), np.asarray(kw["budget"])
    np.testing.assert_array_equal(
        sel.numpy().sum(-1),
        np.broadcast_to(np.minimum(budget, length)[:, None], sel.shape[:2]))


@pytest.mark.parametrize("label", ["ragged-ppb2", "page-per-block",
                                   "page-score-ties", "single-seq",
                                   "budget-floor"])
def test_quest_plain_matches_pallas_and_oracle(label):
    args, op_kw, ref_kw = jk._quest_fixture(**_case("paged_quest", label))
    jout, jsel = jk.paged_quest_attend(*args, with_selection=True, **op_kw)
    rout, rsel = j_quest_ref(*args, **ref_kw)
    targs = [_t(a) for a in args]
    tkw = dict(op_kw, length=_t(op_kw["length"]))
    before = tpa.QUEST_LAUNCHES
    out, sel = tpa.paged_quest_attend(*targs, with_selection=True, **tkw)
    out5 = tpa.paged_quest_attend(targs[0][:, :, :, None], *targs[1:],
                                  **tkw)
    assert tpa.QUEST_LAUNCHES == before
    torch.testing.assert_close(out5[:, :, :, 0], out, rtol=0, atol=0)
    for js, jo in ((jsel, jout), (rsel, rout)):
        np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)


def test_hard_collision_scores_bitwise():
    """Hard counts from packed words with P=10, L=37 (15 words, 11 padded
    tables that must never count) equal the JAX function's exactly."""
    rng = np.random.default_rng(4)
    l, p = 37, 10
    bits = rng.integers(0, 2 ** 32, (2, 3, 50, 15), dtype=np.uint32)
    u_signs = np.where(rng.random((2, 3, 4, l, p)) < 0.5, 1.0,
                       -1.0).astype(np.float32)
    # force collisions: some keys copy a query's pattern in every table
    jcfg = jk.socket.SocketConfig(num_planes=p, num_tables=l)
    want = np.asarray(j_hard_scores(jcfg, jnp.asarray(bits),
                                    jnp.asarray(u_signs)))
    got = _hard_collision_scores(tsk.SocketConfig(num_planes=p, num_tables=l),
                                 _t(bits.view(np.int32)), _t(u_signs))
    np.testing.assert_array_equal(got.numpy(), want)
    signs = torch.from_numpy(u_signs[0, 0, 1] > 0)          # (L, P)
    from repro_torch.core import hashing
    packed = hashing.pack_signs(signs[None]).numpy()         # (1, W)
    bits[0, 0, 7] = packed.view(np.uint32)[0]
    got = _hard_collision_scores(tsk.SocketConfig(num_planes=p, num_tables=l),
                                 _t(bits.view(np.int32)), _t(u_signs))
    assert got[0, 0, 1, 7].item() == l


def test_quest_score_pages_and_select_tokens():
    """Page bounds within SCORE_TOL of JAX's float32 sums, the selection
    of ``select_tokens`` equal to JAX's (ragged lengths, a budget above
    the live pages, exact page ties), and ``build`` equal bit for bit."""
    rng = np.random.default_rng(9)
    b, kvh, g, n, hd, ps = 3, 2, 2, 64, 16, 8
    keys = rng.standard_normal((b, kvh, n - 3, hd)).astype(np.float32)
    keys[:, :, 8:16] = keys[:, :, 24:32]                    # a page tie
    jcfg = jquest.QuestConfig(page_size=ps, sparsity=4.0, sink_tokens=4,
                              window_tokens=4, min_pages=2)
    tcfg = tquest.QuestConfig(**dataclasses.asdict(jcfg))
    jstate = jquest.build(jcfg, None, jnp.asarray(keys), None)
    tstate = tquest.build(tcfg, None, _t(keys), None)
    np.testing.assert_array_equal(tstate.kmin.numpy(), np.asarray(jstate.kmin))
    np.testing.assert_array_equal(tstate.kmax.numpy(), np.asarray(jstate.kmax))
    q = rng.standard_normal((b, kvh, g, 1, hd)).astype(np.float32)
    tg = tquest.QuestState(kmin=tstate.kmin[:, :, None],
                           kmax=tstate.kmax[:, :, None])
    jg = jquest.QuestState(kmin=jstate.kmin[:, :, None],
                           kmax=jstate.kmax[:, :, None])
    np.testing.assert_allclose(                       # (B, KVH, G, n_pages)
        tquest.score_pages(tg, _t(q[:, :, :, 0])).numpy(),
        np.asarray(jquest.score_pages(jg, jnp.asarray(q[:, :, :, 0]))),
        **SCORE_TOL)
    length = np.array([61, 9, 30], np.int32)
    jidx, jmask = jquest.select_tokens(jcfg, jstate, jnp.asarray(q),
                                       length=jnp.asarray(length), n=n)
    tidx, tmask = tquest.select_tokens(tcfg, tstate, _t(q),
                                       length=_t(length), n=n)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tquest.page_budget(tcfg, 8, n) == jquest.page_budget(jcfg, 8, n)
    k_cache = rng.standard_normal((b, kvh, n, hd)).astype(np.float32)
    v_cache = rng.standard_normal((b, kvh, n, hd)).astype(np.float32)
    kpad = np.pad(keys, ((0, 0), (0, 0), (0, 3), (0, 0)))
    jout = jquest.attend(jcfg, jstate, jnp.asarray(q), jnp.asarray(kpad),
                         jnp.asarray(v_cache), length=jnp.asarray(length),
                         scale=0.25)
    tout = tquest.attend(tcfg, tstate, _t(q), _t(kpad), _t(v_cache),
                         length=_t(length), scale=0.25)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    del k_cache


@pytest.mark.parametrize("paged", [False, True])
def test_rmw_token_matches_jax_views(paged):
    """``rmw_token`` on the contiguous and paged views, with an int and a
    ragged (B,) position, equals the JAX views' result."""
    rng = np.random.default_rng(1)
    spec_t = {"kmin": get_backend("quest").cache_spec(
        get_config("llama31-8b").smoke())["kmin"]}
    jspec = {"kmin": jbase.LeafSpec(suffix=(16,), granularity=8)}
    new = rng.standard_normal((2, 2, 16)).astype(np.float32)
    for pos in (13, np.array([3, 17], np.int32)):
        if paged:
            pool = rng.standard_normal((5, 2, 1, 16)).astype(np.float32)
            bt = np.array([[2, 4, 1], [3, 0, 1]], np.int32)
            jv = jbase.PagedView({"kmin": jnp.asarray(pool)}, jspec,
                                 jnp.asarray(bt), 8)
            tv = PagedView({"kmin": _t(pool)}, spec_t, _t(bt), 8)
        else:
            cache = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
            jv = jbase.ContiguousView({"kmin": jnp.asarray(cache)}, jspec)
            tv = ContiguousView({"kmin": _t(cache)}, spec_t)
        jpos = jnp.asarray(pos)
        tpos = pos if isinstance(pos, int) else _t(pos)
        jv.rmw_token("kmin", jpos, lambda old: jnp.minimum(
            old, jnp.asarray(new)))
        tv.rmw_token("kmin", tpos, lambda old: torch.minimum(old, _t(new)))
        np.testing.assert_array_equal(tv.arrays["kmin"].numpy(),
                                      np.asarray(jv.arrays["kmin"]))


def test_quest_append_resets_a_reused_page():
    """A decode write opening a page resets its stats, so a reused pool
    block still holding an earlier owner's min/max bounds only the new
    key; the next write into that page merges (port of the JAX backend
    test ``test_quest_append_resets_stats_on_reused_page``)."""
    cfg = get_config("llama31-8b").smoke().replace(attention_backend="quest")
    backend = get_backend("quest")
    spec = backend.cache_spec(cfg)
    hd, bs = cfg.head_dim, cfg.serving.block_size
    pool = backend.init_cache(cfg, 4, 2, bs, torch.float32, "cpu")
    pool["kmin"][2] = -100.0                           # stale owner's stats
    pool["kmax"][2] = 100.0
    view = PagedView(pool, spec, torch.tensor([[1, 2], [3, 0]]), bs)
    gen = torch.Generator().manual_seed(0)
    k1 = torch.randn((2, 2, 1, hd), generator=gen)
    backend.append(cfg, None, view, k1, k1, torch.tensor([bs, 5]))
    torch.testing.assert_close(pool["kmin"][2, :, 0], k1[0, :, 0])
    torch.testing.assert_close(pool["kmax"][2, :, 0], k1[0, :, 0])
    k2 = torch.randn((2, 2, 1, hd), generator=gen)
    backend.append(cfg, None, view, k2, k2, torch.tensor([bs + 1, 6]))
    torch.testing.assert_close(pool["kmin"][2, :, 0],
                               torch.minimum(k1[0, :, 0], k2[0, :, 0]))
    torch.testing.assert_close(pool["kmax"][2, :, 0],
                               torch.maximum(k1[0, :, 0], k2[0, :, 0]))
    assert torch.isinf(pool["kmin"][3, :, 0]).logical_not().all()


def test_quest_gates_and_smoke_geometry():
    """Page size 8 in smoke (as in the JAX package), and the config and
    backend refuse what the fused kernel and the pool layout cannot
    take: block_size % 8 and page_size dividing block_size."""
    cfg = get_config("llama31-8b").smoke()
    assert cfg.quest.page_size == jget("llama31-8b").smoke().quest.page_size
    fused = dataclasses.replace(cfg.quest, use_paged_kernel=True)
    cfg.replace(quest=fused).validate()
    with pytest.raises(ValueError, match="block_size % 8"):
        cfg.replace(quest=fused, serving=cfg.serving.replace(
            block_size=12)).validate()
    with pytest.raises(ValueError, match="divide"):
        cfg.replace(quest=dataclasses.replace(fused, page_size=16)
                    ).validate()
    with pytest.raises(ValueError, match="divide"):
        get_backend("quest").cache_spec(cfg.replace(
            quest=dataclasses.replace(cfg.quest, page_size=3)))
    for name in ("hard_lsh", "quest"):
        assert get_backend(name).supports_paged
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_quest_attend(*[torch.zeros(1)] * 6, length=1,
                               page_budget=1, page_size=8, scale=1.0,
                               sink_tokens=0, window_tokens=0,
                               v_scale=torch.ones(1))


@pytest.mark.parametrize("kind", ["hard_lsh", "quest"])
def test_card_checks_accept_plain_and_reject_faults(kind):
    """The checks that hold the CUDA kernels to their plain versions on
    the card, run here on their own CPU inputs (tie-heavy pools, a
    length-1 request, budgets above the live rows): the plain version
    passes; a dropped row, a swapped tie or an output off by more than
    the tolerance fails."""
    gen = torch.Generator().manual_seed(5)
    tol = dict(atol=1e-5, rtol=1e-5)
    small = dict(kvh=2, hd=16, sink=4, window=4)
    if kind == "hard_lsh":
        (case,), kw = tcases.hard_lsh_case(gen, [1, 40, 300, 77], nb=24,
                                           l=12, p=6, **small)
        run = tpa.paged_hard_lsh_attend
        check = tcases.check_hard_lsh
    else:
        (case,), kw = tcases.quest_case(gen, [1, 40, 300, 77], nb=24, ps=8,
                                        bs=16, min_pages=2, sparsity=4.0,
                                        **small)
        run = tpa.paged_quest_attend
        check = tcases.check_quest
    q, kp, vp, a, b_, c, bt, length, *rest = case
    if kind == "hard_lsh":
        out, sel = run(*case[:7], length=length, budget=rest[0],
                       with_selection=True, **kw)
    else:
        out, sel = run(*case[:6], length=case[6], page_budget=case[7],
                       with_selection=True, **kw)
    assert check(out, sel, case, kw, attn_tol=tol) == 0.0
    row = sel[2, 0, :300]
    on, off = torch.nonzero(row).flatten(), torch.nonzero(~row).flatten()
    dropped = sel.clone()
    dropped[2, 0, on[0]] = False
    swapped = sel.clone()
    swapped[2, 0, on[-1]], swapped[2, 0, off[0]] = False, True
    for bad in (dropped, swapped):
        with pytest.raises(AssertionError, match="select"):
            check(out, bad, case, kw, attn_tol=tol)
    with pytest.raises(AssertionError, match="exceeds"):
        check(out + 1e-3, sel, case, kw, attn_tol=tol)


def test_card_cases_shapes():
    """The continuous path's shapes of the two cases (8 KV heads, G=4,
    hd=128, bs=16, 264-block tables) and their static Quest budget of 26
    pages (416 rows of n = 264 * 16)."""
    gen = torch.Generator().manual_seed(0)
    sets, kw = tcases.quest_case(gen, [1024, 2048], nb=264)
    assert int(sets[0][7][0]) == 26 and kw["page_size"] == 16
    assert sets[0][3].shape[1:] == (8, 1, 128)
    sets, kw = tcases.hard_lsh_case(gen, [1024, 37], nb=264)
    u_signs = sets[0][5]
    assert u_signs.shape == (2, 8, 4, 60, 10) and "tau" not in kw
    assert set(u_signs.unique().tolist()) == {-1.0, 1.0}
