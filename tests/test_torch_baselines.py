"""Port parity for the baselines (``repro_torch.baselines``: oracle,
hard_lsh, hash_attn, magicpig, pqcache) against the JAX package, then
JAX's ``tests/test_baselines.py`` checks on the port's own draws.

Each JAX draw is handed to the port just after it is made: the hash
planes (``hashing.make_hash_params`` patched to return JAX's) and
PQCache's initial centroids (JAX's ``jax.random.choice`` indices, one
set a sub-space, given to ``pqcache._quantize``).  Inputs are drawn with
numpy.  Integers, bits, counts and codes compare bitwise; floats at rtol
1e-5 / atol 1e-6.
"""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.baselines import hard_lsh as jhl
from repro.baselines import hash_attn as jha
from repro.baselines import magicpig as jmp
from repro.baselines import oracle as jor
from repro.baselines import pqcache as jpq
from repro.core import hashing as jh
from repro.core import socket as jsk
from repro_torch import baselines
from repro_torch.baselines import hard_lsh as thl
from repro_torch.baselines import hash_attn as tha
from repro_torch.baselines import magicpig as tmp
from repro_torch.baselines import oracle as tor
from repro_torch.baselines import pqcache as tpq
from repro_torch.baselines import quest as tqu
from repro_torch.core import hashing as th
from repro_torch.core import socket as tsk
from test_torch_smoke_checks import one_thread

TOL = dict(rtol=1e-5, atol=1e-6)
KEY = jax.random.PRNGKey(11)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _n(x):
    return np.asarray(x)


def _kv(lead=(2, 3), n=96, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, n, d)).astype(np.float32),
            rng.standard_normal((*lead, n, d)).astype(np.float32))


def _built(jmod, tmod, jcfg, tcfg, keys, values, d, planes, tables):
    """Both packages' states on the same keys and JAX's planes."""
    jst = jmod.build(jcfg, KEY, jnp.asarray(keys), jnp.asarray(values))
    w = jh.make_hash_params(KEY, d, planes, tables)
    with mock.patch.object(th, "make_hash_params",
                           lambda *a, **k: _t(_n(w))):
        tst = tmod.build(tcfg, torch.Generator(), _t(keys), _t(values))
    np.testing.assert_array_equal(tst.w.numpy(), _n(jst.w))
    np.testing.assert_array_equal(tst.packed.numpy().view(np.uint32),
                                  _n(jst.packed))
    return jst, tst


def test_package_exports_six_baselines():
    assert baselines.__all__ == ["hard_lsh", "hash_attn", "magicpig",
                                 "oracle", "pqcache", "quest"]
    from repro_torch.models.backends import dense
    assert not hasattr(dense, "dense_attention")


# ------------------------------------------------------------- oracle

@pytest.mark.parametrize("length", [None, 70, "ragged"])
def test_oracle_matches_jax(length):
    keys, values = _kv()
    q = np.random.default_rng(1).standard_normal((2, 3, 4, 1, 32)).astype(
        np.float32)
    st = tor.build(None, None, _t(keys), _t(values))
    np.testing.assert_allclose(
        tor.score(st, _t(q[:, :, 0, 0])).numpy(),
        _n(jor.score(jor.build(None, KEY, jnp.asarray(keys), None),
                     jnp.asarray(q[:, :, 0, 0]))), **TOL)
    if length == "ragged":
        length = np.array([50, 96], np.int32)
    tl = _t(length).long() if isinstance(length, np.ndarray) else length
    jl = jnp.asarray(length) if length is not None else None
    np.testing.assert_allclose(
        tor.dense_attention(_t(q), _t(keys), _t(values), scale=0.17,
                            length=tl).numpy(),
        _n(jor.dense_attention(jnp.asarray(q), jnp.asarray(keys),
                               jnp.asarray(values), scale=0.17, length=jl)),
        **TOL)


# ----------------------------------------------------------- hard LSH

@pytest.mark.parametrize("planes,tables", [(2, 300), (10, 60)])
def test_hard_lsh_matches_jax(planes, tables):
    keys, values = _kv()
    jcfg = jhl.HardLSHConfig(num_planes=planes, num_tables=tables)
    tcfg = thl.HardLSHConfig(num_planes=planes, num_tables=tables)
    assert tcfg.bits_per_token == jcfg.bits_per_token
    jst, tst = _built(jhl, thl, jcfg, tcfg, keys, values, 32, planes,
                      tables)
    np.testing.assert_allclose(tst.vnorm.numpy(), _n(jst.vnorm), **TOL)
    q = np.random.default_rng(2).standard_normal((2, 3, 32)).astype(
        np.float32)
    np.testing.assert_array_equal(thl.score(tst, tcfg, _t(q)).numpy(),
                                  _n(jhl.score(jst, jcfg, jnp.asarray(q))))


@pytest.mark.parametrize("length", [96, "ragged"])
def test_hard_lsh_attend_matches_jax_on_every_head(length):
    """JAX's ``attend`` runs as documented at B = KVH = 1 only (its
    query's group axis broadcasts against the state's heads; it raises at
    these shapes): the port's batched ``attend`` equals it on every (b,
    h) slice, each slice's state built on that head's keys."""
    keys, values = _kv(n=160)
    kw = dict(sink_tokens=4, window_tokens=8, min_k=8)
    jcfg, tcfg = jhl.HardLSHConfig(**kw), thl.HardLSHConfig(**kw)
    jst, tst = _built(jhl, thl, jcfg, tcfg, keys, values, 32, 2, 300)
    q = np.random.default_rng(3).standard_normal((2, 3, 4, 1, 32)).astype(
        np.float32)
    lengths = [96, 96] if length == 96 else [90, 160]
    tl = 96 if length == 96 else torch.tensor(lengths)
    got = thl.attend(tcfg, tst, _t(q), _t(keys), _t(values), length=tl,
                     scale=0.17)
    with pytest.raises(ValueError):
        jhl.attend(jcfg, jst, jnp.asarray(q), jnp.asarray(keys),
                   jnp.asarray(values), length=96, scale=0.17)
    for b in range(2):
        for h in range(3):
            sl = (slice(b, b + 1), slice(h, h + 1))
            st = jhl.HardLSHState(w=jst.w, packed=jst.packed[sl],
                                  vnorm=jst.vnorm[sl])
            want = jhl.attend(jcfg, st, jnp.asarray(q[sl]),
                              jnp.asarray(keys[sl]), jnp.asarray(values[sl]),
                              length=lengths[b], scale=0.17)
            np.testing.assert_allclose(got[sl].numpy(), _n(want), **TOL)


# ------------------------------------------------- HashAttention, MagicPig

def test_hash_attn_matches_jax():
    keys, values = _kv()
    jcfg, tcfg = jha.HashAttnConfig(), tha.HashAttnConfig()
    jst, tst = _built(jha, tha, jcfg, tcfg, keys, values, 32, 128, 1)
    q = np.random.default_rng(4).standard_normal((2, 3, 32)).astype(
        np.float32)
    np.testing.assert_array_equal(tha.score(tst, tcfg, _t(q)).numpy(),
                                  _n(jha.score(jst, jcfg, jnp.asarray(q))))


@pytest.mark.parametrize("min_collisions", [1, 2])
def test_magicpig_matches_jax(min_collisions):
    keys, values = _kv()
    kw = dict(num_planes=4, num_tables=64, min_collisions=min_collisions)
    jcfg, tcfg = jmp.MagicPigConfig(**kw), tmp.MagicPigConfig(**kw)
    jst, tst = _built(jmp, tmp, jcfg, tcfg, keys, values, 32, 4, 64)
    q = np.random.default_rng(5).standard_normal((2, 3, 32)).astype(
        np.float32)
    counts = tmp.collision_counts(tst, tcfg, _t(q))
    jcounts = jmp.collision_counts(jst, jcfg, jnp.asarray(q))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), _n(jcounts))
    np.testing.assert_allclose(
        tmp.attend_estimate(tcfg, tst, _t(q), _t(keys), _t(values),
                            scale=0.17).numpy(),
        _n(jmp.attend_estimate(jcfg, jst, jnp.asarray(q), jnp.asarray(keys),
                               jnp.asarray(values), scale=0.17)), **TOL)


# ------------------------------------------------------------ PQCache

def _jax_init(key, n, c, m):
    return _n(jax.vmap(lambda r: jax.random.choice(
        r, n, (c,), replace=n < c))(jax.random.split(key, m)))


@pytest.mark.parametrize("n", [96, 8])
def test_pqcache_matches_jax_on_its_draw(n):
    """``_quantize`` from JAX's initial indices equals ``_build_impl``
    (codebooks, codes), ``build`` with the draw handed equals JAX's
    ``build``, and the ADC scores equal JAX's; ``n`` 8 draws with
    replacement (fewer points than centroids: empty clusters)."""
    keys, values = _kv(lead=(2,), n=n)
    jcfg = jpq.PQConfig(num_subspaces=8, nbits=4, kmeans_iters=5)
    tcfg = tpq.PQConfig(num_subspaces=8, nbits=4, kmeans_iters=5)
    idx = _jax_init(KEY, 2 * n, 16, 8)
    jcb, jcodes = jpq._build_impl(KEY, jnp.asarray(keys.reshape(-1, 32)),
                                  8, 16, 5)
    cb, codes = tpq._quantize(_t(keys.reshape(-1, 32)), _t(idx).long(), 8,
                              5)
    np.testing.assert_allclose(cb.numpy(), _n(jcb), **TOL)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), _n(jcodes))
    jst = jpq.build(jcfg, KEY, jnp.asarray(keys), None)
    with mock.patch.object(tpq, "_init_indices",
                           lambda *a: _t(idx).long()):
        tst = tpq.build(tcfg, torch.Generator(), _t(keys), None)
    np.testing.assert_array_equal(tst.codes.numpy(), _n(jst.codes))
    q = np.random.default_rng(6).standard_normal((2, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        tpq.score(tst, tcfg, _t(q)).numpy(),
        _n(jpq.score(jst, jcfg, jnp.asarray(q))), **TOL)


def test_pqcache_init_indices():
    got = tpq._init_indices(torch.Generator().manual_seed(0), 100, 16, 8)
    assert got.shape == (8, 16)
    assert all(len(set(r.tolist())) == 16 for r in got)
    assert int(got.min()) >= 0 and int(got.max()) < 100
    few = tpq._init_indices(torch.Generator().manual_seed(0), 5, 16, 2)
    assert few.shape == (2, 16) and int(few.max()) < 5


# -------------------- JAX's tests/test_baselines.py, on the port's draws

def _planted(d=64, n=512, target=37, seed=0):
    gen = torch.Generator().manual_seed(seed)
    keys = torch.randn((n, d), generator=gen)
    values = torch.randn((n, d), generator=gen)
    q = 2.0 * keys[target] + 0.05 * torch.randn((d,), generator=gen)
    return keys, values, q


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["oracle", "hard_lsh", "hash_attn",
                                  "pqcache"])
def test_scorer_finds_the_planted_neighbor(name):
    keys, values, q = _planted()
    if name == "oracle":
        s = tor.score(tor.build(None, None, keys, values), q)
    elif name == "hard_lsh":
        cfg = thl.HardLSHConfig(num_planes=2, num_tables=300)
        s = thl.score(thl.build(cfg, _gen(), keys, values), cfg, q)
        assert cfg.bits_per_token == 600
    elif name == "hash_attn":
        cfg = tha.HashAttnConfig(num_bits=128)
        s = tha.score(tha.build(cfg, _gen(), keys, values), cfg, q)
    else:
        cfg = tpq.PQConfig(num_subspaces=16, nbits=4, kmeans_iters=4)
        st1 = tpq.build(cfg, _gen(), keys, values)
        st2 = tpq.build(cfg, _gen(), keys, values)
        assert torch.equal(st1.codes, st2.codes)
        s = tpq.score(st1, cfg, q)
        corr = float(torch.corrcoef(torch.stack([s, keys @ q]))[0, 1])
        assert corr > 0.7, corr
    assert int(torch.argmax(s)) == 37


def test_quest_page_bounds():
    keys, values, q = _planted()
    cfg = tqu.QuestConfig(page_size=16)
    ps = tqu.score_pages(tqu.build(cfg, None, keys, values), q)
    true = keys @ q
    for page in range(ps.shape[0]):
        assert float(ps[page]) >= float(true[page * 16:(page + 1) * 16]
                                        .max()) - 1e-4
    assert int((ps > ps[37 // 16]).sum()) < ps.shape[0] // 4


def test_magicpig_estimator_reasonable():
    keys, values, q = _planted()
    cfg = tmp.MagicPigConfig(num_planes=4, num_tables=64, min_collisions=1)
    st = tmp.build(cfg, _gen(), keys, values)
    y = tmp.attend_estimate(cfg, st, q, keys, values, scale=0.125)
    ref = tor.dense_attention(q[None, None, None, None], keys[None, None],
                              values[None, None], scale=0.125)[0, 0, 0, 0]
    rel = float((y - ref).norm() / ref.norm())
    assert rel < 0.25, rel


def test_socket_vs_hard_lsh_at_equal_budget():
    """At 600 bits: hard LSH at SOCKET's (P 10, L 60) collapses (Table
    2), the tuned (P 2, L 300) is no better than SOCKET (Table 7)."""
    d, n, k = 64, 2048, 64
    gen = _gen(1)
    keys = torch.randn((n, d), generator=gen)
    cfg = tsk.SocketConfig(num_planes=10, num_tables=60, tau=0.4)
    w = th.make_hash_params(_gen(2), d, 10, 60)
    packed = th.pack_signs(th.hash_keys_signs(w, keys))
    tuned = thl.HardLSHConfig(num_planes=2, num_tables=300)
    st_tuned = thl.build(tuned, _gen(3), keys, keys)
    same = thl.HardLSHConfig(num_planes=10, num_tables=60)
    st_same = thl.build(same, _gen(4), keys, keys)

    def recall(s, true_top):
        got = set(torch.sort(s, descending=True, stable=True)
                  .indices[:k].tolist())
        return len(got & true_top) / k

    r = {"socket": [], "hard_tuned": [], "hard_same": []}
    for trial in range(8):
        q = keys[trial * 10] + 0.5 * torch.randn((d,), generator=gen)
        true_top = set(torch.sort(keys @ q, descending=True, stable=True)
                       .indices[:k].tolist())
        r["socket"].append(recall(tsk.soft_scores_factorized(
            cfg, packed, tsk.soft_hash_query(w, q)), true_top))
        r["hard_tuned"].append(recall(thl.score(st_tuned, tuned, q),
                                      true_top))
        r["hard_same"].append(recall(thl.score(st_same, same, q), true_top))
    m = {key: float(np.mean(v)) for key, v in r.items()}
    assert m["socket"] > m["hard_same"] + 0.2, m
    assert m["socket"] >= m["hard_tuned"] - 0.05, m
    assert m["socket"] > 0.45, m


def test_socket_config_is_the_selection_config():
    """hard_lsh.attend builds its selection from JAX's SocketConfig
    fields: the port's accepts the same keywords."""
    kw = dict(sparsity=10.0, sink_tokens=128, window_tokens=128, min_k=16)
    assert jsk.SocketConfig(**kw).min_k == tsk.SocketConfig(**kw).min_k
