"""Port parity: SOCKET core math (``repro_torch.core``) against the JAX
package's ``repro.core`` on the same numpy inputs.

Tolerances: selections, packed bits and budgets must match bitwise;
float32 results computed in another summation order must agree to
rtol 1e-5 / atol 1e-6 (attention outputs: rtol 1e-5 / atol 1e-5).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.core import socket as jsk
from repro_torch.core import hashing as th
from repro_torch.core import socket as tsk

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# Soft hash u = tanh(W q) / sqrt(d) from a d=128 fp32 dot product: each of
# the JAX and the port's u lies ~5e-7 from the float64 value (the sum taken
# in another order; the JAX side's order changes with the process, e.g.
# under pytest-xdist), and |u| <= 1/sqrt(128), so rtol 1e-5 is ~1e-7 and
# the absolute term carries the limit.  atol 4e-6 is ~8x the measured
# 5.4e-7 gap between the two and far below the 1e-3 spacing of u values.
SOFT_HASH_TOL = dict(rtol=1e-5, atol=4e-6)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("l,p", [(60, 10), (12, 6), (7, 4), (3, 32)])
def test_pack_unpack_bitwise(l, p):
    rng = np.random.default_rng(l * 100 + p)
    signs = rng.random((2, 3, 17, l, p)) < 0.5
    assert th.num_words(l, p) == jh.num_words(l, p)
    jw = np.asarray(jh.pack_signs(jnp.asarray(signs)))
    tw = th.pack_signs(_t(signs))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    ju = np.asarray(jh.unpack_signs(jnp.asarray(jw), l, p))
    tu = th.unpack_signs(tw, l, p).numpy()
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tu > 0, signs)


def test_hash_keys_signs_bitwise_outside_zero_band():
    """Signs match bitwise wherever |proj| is clear of float32 rounding;
    inside the band a different accumulation order may flip a few."""
    rng = np.random.default_rng(1)
    d = 64
    keys = rng.standard_normal((2, 3, 257, d)).astype(np.float32)
    w = rng.standard_normal((60, 10, d)).astype(np.float32)
    js = np.asarray(jh.hash_keys_signs(jnp.asarray(w), jnp.asarray(keys)))
    ts = th.hash_keys_signs(_t(w), _t(keys)).numpy()
    proj = np.einsum("...nd,lpd->...nlp", keys.astype(np.float64),
                     w.astype(np.float64))
    mag = np.einsum("...nd,lpd->...nlp", np.abs(keys).astype(np.float64),
                    np.abs(w).astype(np.float64))
    band = np.abs(proj) <= 1e-5 * mag
    np.testing.assert_array_equal(ts[~band], js[~band])
    flips = int((ts[band] != js[band]).sum())
    assert band.mean() < 1e-3
    assert flips <= max(3, band.sum() // 2), (flips, int(band.sum()))


@pytest.mark.parametrize("sink,window,sparsity,min_k", [
    (128, 128, 10.0, 16), (4, 4, 4.0, 8), (0, 16, 3.0, 1)])
def test_topk_budgets_equal(sink, window, sparsity, min_k):
    kw = dict(sink_tokens=sink, window_tokens=window, sparsity=sparsity,
              min_k=min_k)
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    for n in (1, 7, 31, 64, 255, 256, 257, 2559, 2560, 8224):
        assert tsk.topk_budget(tc, n) == jsk.topk_budget(jc, n), n
    lengths = np.array([1, 5, 9, 100, 255, 256, 300, 1000, 8224], np.int32)
    cap = jsk.topk_budget(jc, 8224)
    np.testing.assert_array_equal(
        tsk.dynamic_topk_budget(tc, _t(lengths), cap).numpy(),
        np.asarray(jsk.dynamic_topk_budget(jc, jnp.asarray(lengths), cap)))


def test_soft_hash_and_log_normalizer_allclose():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((60, 10, 128)).astype(np.float32)
    q = rng.standard_normal((2, 8, 4, 128)).astype(np.float32)
    ju = np.asarray(jsk.soft_hash_query(jnp.asarray(w), jnp.asarray(q)))
    tu = tsk.soft_hash_query(_t(w), _t(q)).numpy()
    proj = np.einsum("...d,lpd->...lp", q.astype(np.float64),
                     w.astype(np.float64))
    u64 = np.tanh(proj) / np.sqrt(128.0)
    np.testing.assert_allclose(ju, u64, **SOFT_HASH_TOL)
    np.testing.assert_allclose(tu, u64, **SOFT_HASH_TOL)
    np.testing.assert_allclose(tu, ju, **SOFT_HASH_TOL)
    for tau in (0.3, 0.4, 0.5):
        np.testing.assert_allclose(
            tsk.log_normalizer(_t(ju), tau).numpy(),
            np.asarray(jsk.log_normalizer(jnp.asarray(ju), tau)),
            **SCORE_TOL)


@pytest.mark.parametrize("storage,chunk", [("packed", 0), ("packed", 32),
                                           ("int8", 0)])
def test_soft_scores_factorized_allclose(storage, chunk):
    rng = np.random.default_rng(3)
    kw = dict(num_planes=6, num_tables=12, tau=0.4, bits_storage=storage,
              score_chunk=chunk)
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    keys = rng.standard_normal((2, 2, 128, 16)).astype(np.float32)
    vals = rng.standard_normal((2, 2, 128, 16)).astype(np.float32)
    w = rng.standard_normal((12, 6, 16)).astype(np.float32)
    q = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
    jside = jsk.precompute_key_hashes(jc, jnp.asarray(w), jnp.asarray(keys),
                                      jnp.asarray(vals))
    bits = np.asarray(jside.bits)
    tbits = _t(bits.view(np.int32) if storage == "packed" else bits)
    tside = tsk.precompute_key_hashes(tc, _t(w), _t(keys), _t(vals))
    np.testing.assert_array_equal(tside.bits.numpy(), tbits.numpy())
    np.testing.assert_array_equal(
        tside.vnorm.float().numpy(),
        np.asarray(jside.vnorm.astype(jnp.float32)))
    u = np.asarray(jsk.soft_hash_query(jnp.asarray(w), jnp.asarray(q)))
    js = np.asarray(jsk.soft_scores_factorized(
        jc, jnp.asarray(bits)[:, :, None], jnp.asarray(u)))
    ts = tsk.soft_scores_factorized(tc, tbits[:, :, None], _t(u))
    assert ts.shape == (2, 2, 3, 128)
    np.testing.assert_allclose(ts.numpy(), js, **SCORE_TOL)


def _tied_scores(rng, shape):
    """Scores drawn from a few levels so ties are everywhere."""
    return (rng.integers(0, 4, shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("case", ["scalar_short", "scalar_long",
                                  "ragged_budget", "qhead_shape"])
def test_value_aware_topk_bitwise_with_ties(case):
    rng = np.random.default_rng(4)
    cfg_kw = dict(sink_tokens=4, window_tokens=4, min_k=8, sparsity=4.0)
    jc, tc = jsk.SocketConfig(**cfg_kw), tsk.SocketConfig(**cfg_kw)
    n = 64
    shape = (3, 2, n) if case != "qhead_shape" else (3, 2, 4, n)
    scores = _tied_scores(rng, shape)
    vnorm = np.ones(shape, np.float32)
    vnorm[..., ::3] = 2.0
    k = jsk.topk_budget(jc, n)
    budget = None
    if case == "scalar_short":
        length = 6                       # < sink + window
    elif case == "scalar_long":
        length = 50
    elif case == "ragged_budget":
        length = np.array([5, 33, 64], np.int32)
        budget = np.asarray(jsk.dynamic_topk_budget(jc, length, k))
    else:
        length = 40
    jl = jnp.asarray(length) if isinstance(length, np.ndarray) else length
    tl = _t(length) if isinstance(length, np.ndarray) else length
    ji, jm = jsk.value_aware_topk(
        jc, jnp.asarray(scores), jnp.asarray(vnorm), k=k, length=jl,
        n_total=n, budget=None if budget is None else jnp.asarray(budget))
    ti, tm = tsk.value_aware_topk(
        tc, _t(scores), _t(vnorm), k=k, length=tl, n_total=n,
        budget=None if budget is None else _t(budget))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_sparse_attention_over_subset_allclose():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 2, 3, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 20, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 20, 16)).astype(np.float32)
    m = rng.random((2, 2, 20)) < 0.7
    out = tsk.sparse_attention_over_subset(_t(q), _t(k), _t(v), _t(m),
                                           scale=0.25)
    ref = jsk.sparse_attention_over_subset(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("selection,use_kernel,ragged", [
    ("kvhead", False, False), ("kvhead", True, False),
    ("pooled", False, True), ("qhead", False, True)])
def test_socket_attend_allclose(selection, use_kernel, ragged):
    rng = np.random.default_rng(6)
    kw = dict(num_planes=6, num_tables=12, tau=0.4, sink_tokens=4,
              window_tokens=4, min_k=8, sparsity=4.0, selection=selection)
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    b, kvh, g, n, hd = 2, 2, 2, 96, 16
    q = rng.standard_normal((b, kvh, g, 1, hd)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, n, hd)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, n, hd)).astype(np.float32)
    w = rng.standard_normal((12, 6, hd)).astype(np.float32)
    jside = jsk.precompute_key_hashes(jc, jnp.asarray(w), jnp.asarray(kc),
                                      jnp.asarray(vc))
    tside = tsk.precompute_key_hashes(tc, _t(w), _t(kc), _t(vc))
    if ragged:
        length = np.array([37, 90], np.int32)
        cap = jsk.topk_budget(jc, n)
        jb = jsk.dynamic_topk_budget(jc, jnp.asarray(length), cap)
        tb = tsk.dynamic_topk_budget(tc, _t(length), cap)
        jl, tl = jnp.asarray(length), _t(length)
    else:
        jl = tl = 70
        jb = tb = None
    ref = jsk.socket_attend(jc, jnp.asarray(w), jnp.asarray(q),
                            jnp.asarray(kc), jnp.asarray(vc), jside,
                            length=jl, use_kernel=use_kernel, budget=jb)
    out = tsk.socket_attend(tc, _t(w), _t(q), _t(kc), _t(vc), tside,
                            length=tl, use_kernel=use_kernel, budget=tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
