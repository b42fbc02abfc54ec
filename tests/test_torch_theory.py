"""Port parity for the rest of ``core/``: the paper-literal scoring form
(``make_hash_params``, ``signs_to_bucket_ids``, ``hypercube_corners``,
``bucket_probs_explicit``, ``soft_scores_gather``) and Section 5's
``core/theory.py``, against the JAX package; then JAX's
``tests/test_theory.py`` properties on the port's own draws.

Random draws cannot be reproduced across the libraries, so a parity case
draws with ``jax.random`` and hands the draw to the port's function just
after it (``hashing.make_hash_params`` and ``theory._choice`` patched to
return JAX's planes and indices).  The port's own draw is checked for
shape, dtype and its first two moments.  Integers and bits compare
bitwise, floats at rtol 1e-5 / atol 1e-6.
"""

from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.core import socket as jsk
from repro.core import theory as jth
from repro_torch.core import hashing as th
from repro_torch.core import socket as tsk
from repro_torch.core import theory as tth
from test_torch_smoke_checks import one_thread

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _handed(w):
    """``make_hash_params`` patched to return the JAX draw ``w``."""
    return mock.patch.object(th, "make_hash_params",
                             lambda *a, **k: _t(np.asarray(w)))


# ------------------------------------------------- the paper-literal form

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_hash_params_draw(dtype):
    gen = torch.Generator().manual_seed(3)
    w = th.make_hash_params(gen, 64, 10, 60, dtype)
    assert w.shape == (60, 10, 64) and w.dtype == dtype
    x = w.double()
    assert abs(float(x.mean())) < 0.01 and abs(float(x.var()) - 1) < 0.02
    again = th.make_hash_params(torch.Generator().manual_seed(3), 64, 10,
                                60, dtype)
    assert torch.equal(w, again)


@pytest.mark.parametrize("p", [1, 6, 10, 31])
def test_signs_to_bucket_ids_match_jax(p):
    signs = np.random.default_rng(p).random((3, 50, 7, p)) < 0.5
    got = th.signs_to_bucket_ids(_t(signs))
    want = np.asarray(jh.signs_to_bucket_ids(jnp.asarray(signs)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_signs_to_bucket_ids_refuse_p_32_as_jax():
    signs = np.zeros((2, 3, 32), bool)
    with pytest.raises(ValueError, match="P=32"):
        jh.signs_to_bucket_ids(jnp.asarray(signs))
    with pytest.raises(ValueError, match="P=32"):
        th.signs_to_bucket_ids(_t(signs))


@pytest.mark.parametrize("p", [1, 3, 10])
def test_hypercube_corners_match_jax(p):
    got, want = th.hypercube_corners(p), jh.hypercube_corners(p)
    assert got.dtype == want.dtype and got.shape == (1 << p, p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tau", [0.05, 0.4, 2.0])
def test_bucket_probs_and_gather_match_jax(tau):
    """Both functions equal JAX's, and the gather form equals the
    factorized scores (P 6, L 12: 64 corners a table)."""
    p, l, n, d = 6, 12, 40, 32
    rng = np.random.default_rng(7)
    w = rng.standard_normal((l, p, d)).astype(np.float32)
    keys = rng.standard_normal((2, n, d)).astype(np.float32)
    q = rng.standard_normal((2, d)).astype(np.float32)
    u = tsk.soft_hash_query(_t(w), _t(q))                  # (2, L, P)
    probs = tsk.bucket_probs_explicit(u, tau)
    jprobs = jsk.bucket_probs_explicit(jnp.asarray(u.numpy()), tau)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    signs = th.hash_keys_signs(_t(w), _t(keys))            # (2, N, L, P)
    ids = th.signs_to_bucket_ids(signs)
    got = tsk.soft_scores_gather(ids, probs)
    want = jsk.soft_scores_gather(jnp.asarray(ids.numpy()), jprobs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cfg = tsk.SocketConfig(num_planes=p, num_tables=l, tau=tau)
    fact = tsk.soft_scores_factorized(cfg, th.pack_signs(signs), u)
    np.testing.assert_allclose(got.numpy(), fact.numpy(), rtol=1e-5,
                               atol=1e-6)
    # a query axis over shared keys broadcasts as JAX's gather does
    got_g = tsk.soft_scores_gather(ids[:, None], probs[:, None].expand(
        2, 3, l, 1 << p))
    np.testing.assert_allclose(got_g.numpy(), got[:, None].expand(
        2, 3, n).numpy(), rtol=0, atol=0)


# ------------------------------------------------------------- theory.py

def _inputs(n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


@pytest.mark.parametrize("p", [1, 4, 10])
def test_angular_weights_and_attention_match_jax(p):
    keys, values, q = _inputs()
    np.testing.assert_allclose(
        tth.angular_weights(_t(q), _t(keys), p).numpy(),
        np.asarray(jth.angular_weights(jnp.asarray(q), jnp.asarray(keys),
                                       p)), **TOL)
    np.testing.assert_allclose(
        tth.angular_attention(_t(q), _t(keys), _t(values), p).numpy(),
        np.asarray(jth.angular_attention(jnp.asarray(q), jnp.asarray(keys),
                                         jnp.asarray(values), p)), **TOL)


def test_soft_count_attention_matches_jax_on_its_draw():
    keys, values, q = _inputs(seed=1)
    jcfg = jsk.SocketConfig(num_planes=4, num_tables=32, tau=0.5)
    tcfg = tsk.SocketConfig(num_planes=4, num_tables=32, tau=0.5)
    key = jax.random.PRNGKey(4)
    jy, ja = jth.soft_count_attention(jcfg, key, jnp.asarray(q),
                                      jnp.asarray(keys), jnp.asarray(values))
    with _handed(jh.make_hash_params(key, 16, 4, 32)):
        ty, ta = tth.soft_count_attention(tcfg, torch.Generator(), _t(q),
                                          _t(keys), _t(values))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_sampling_estimator_matches_jax_on_its_draw():
    keys, values, q = _inputs(seed=2)
    cfg = jsk.SocketConfig(num_planes=4, num_tables=32, tau=0.5)
    _, ja = jth.soft_count_attention(cfg, jax.random.PRNGKey(0),
                                     jnp.asarray(q), jnp.asarray(keys),
                                     jnp.asarray(values))
    key, m = jax.random.PRNGKey(9), 48
    jv = jnp.asarray(values)
    want = jth.sampling_estimator(key, ja, jv, m)
    # JAX's draw, as the function makes it
    p = ja * jnp.linalg.norm(jv, axis=-1)
    idx = jax.random.choice(key, ja.shape[0], (m,), p=p / jnp.sum(p))
    with mock.patch.object(tth, "_choice",
                           lambda *a: _t(np.asarray(idx)).long()):
        got = tth.sampling_estimator(torch.Generator(), _t(np.asarray(ja)),
                                     _t(values), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    draw = tth._choice(torch.Generator().manual_seed(0),
                       torch.tensor([0.0, 0.25, 0.75]), 4000)
    assert draw.shape == (4000,) and int(draw.min()) >= 1
    assert abs(float((draw == 2).float().mean()) - 0.75) < 0.03


@pytest.mark.parametrize("tau", [0.001, 0.5, 50.0])
def test_eps_tau_matches_jax_on_its_draw(tau):
    _, _, q = _inputs(d=32, seed=3)
    key = jax.random.PRNGKey(5)
    want = jth.eps_tau_monte_carlo(key, jnp.asarray(q), tau, 6)
    with _handed(jh.make_hash_params(key, 32, 6, 256)):
        got = tth.eps_tau_monte_carlo(torch.Generator(), _t(q), tau, 6)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_lemma4_gamma_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal(48).astype(np.float32)
    q /= np.linalg.norm(q)
    w = np.linalg.qr(rng.standard_normal((48, 8)))[0].T.astype(np.float32)
    s = np.tanh(w @ q)
    np.testing.assert_allclose(
        float(tth.lemma4_gamma(_t(q), _t(w), _t(s))),
        float(jth.lemma4_gamma(jnp.asarray(q), jnp.asarray(w),
                               jnp.asarray(s))), **TOL)


# ------------------------- JAX's tests/test_theory.py, on the port's draws

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _normal(gen, *shape):
    return torch.randn(shape, generator=gen)


def test_lemma4_correlation_formula():
    gen = _gen(0)
    d, p = 48, 8
    q = _normal(gen, d)
    q = q / q.norm()
    w = torch.linalg.qr(_normal(gen, d, p))[0].T
    s = torch.tanh(w @ q)
    gamma = float(tth.lemma4_gamma(q, w, s))
    keys = _normal(gen, 200_000, d)
    y = torch.sign(keys @ w.T) @ s
    corr = float(torch.corrcoef(torch.stack([keys @ q, y]))[0, 1])
    assert abs(corr - gamma) < 0.02


def test_hard_vs_soft_correlation_inequality():
    d, p = 32, 10
    for seed in range(5):
        gen = _gen(seed)
        q = _normal(gen, d)
        q = q / q.norm()
        w = torch.linalg.qr(_normal(gen, d, p))[0].T
        wq = w @ q
        hard = np.sqrt(2 / np.pi) * float(wq.abs().sum()) / np.sqrt(p)
        assert hard <= float(tth.lemma4_gamma(q, w, torch.tanh(wq))) + 1e-3


def test_eps_tau_limits():
    q = _normal(_gen(0), 32)
    p = 6
    values = [float(tth.eps_tau_monte_carlo(_gen(1), q, tau, p))
              for tau in (0.001, 0.1, 0.5, 2.0, 50.0)]
    assert values[0] < 0.02
    assert abs(values[-1] - (1 - 1 / 2 ** p)) < 0.02
    assert all(a <= b + 1e-6 for a, b in zip(values, values[1:]))


def test_finite_l_error_decays_as_sqrt_l():
    gen = _gen(2)
    d, n = 24, 96
    keys, values, q = _normal(gen, n, d), _normal(gen, n, d), _normal(gen, d)
    ref_cfg = tsk.SocketConfig(num_planes=4, num_tables=4096, tau=0.5)
    y_ref, _ = tth.soft_count_attention(ref_cfg, _gen(999), q, keys, values)

    def err_at(l, trials=12):
        cfg = tsk.SocketConfig(num_planes=4, num_tables=l, tau=0.5)
        return np.mean([float((tth.soft_count_attention(
            cfg, _gen(t), q, keys, values)[0] - y_ref).norm())
            for t in range(trials)])

    ratio = err_at(16) / max(err_at(256), 1e-9)
    assert 2.0 < ratio < 8.0, ratio


def _estimator_case():
    gen = _gen(3)
    d, n = 16, 64
    keys, values, q = _normal(gen, n, d), _normal(gen, n, d), _normal(gen, d)
    cfg = tsk.SocketConfig(num_planes=4, num_tables=32, tau=0.5)
    y, a = tth.soft_count_attention(cfg, _gen(4), q, keys, values)
    return y, a, values


def test_sampling_estimator_unbiased():
    y, a, values = _estimator_case()
    gen = _gen(5)
    mean = torch.stack([tth.sampling_estimator(gen, a, values, 64)
                        for _ in range(800)]).mean(0)
    rel = float((mean - y).norm() / y.norm())
    assert rel < 0.08, rel


def test_sampling_error_decays_with_m():
    y, a, values = _estimator_case()
    gen = _gen(6)

    def rmse(m, trials=60):
        return np.sqrt(np.mean([float((tth.sampling_estimator(
            gen, a, values, m) - y).norm()) ** 2 for _ in range(trials)]))

    r = rmse(8) / max(rmse(128), 1e-9)
    assert 2.0 < r < 8.0, r


def test_correlation_table3_direction():
    gen = _gen(7)
    d, n = 64, 2048
    keys, q = _normal(gen, n, d), _normal(gen, d)
    cfg = tsk.SocketConfig(num_planes=10, num_tables=60, tau=0.5)
    w = th.make_hash_params(_gen(8), d, 10, 60)
    soft = tsk.soft_scores_factorized(
        cfg, th.pack_signs(th.hash_keys_signs(w, keys)),
        tsk.soft_hash_query(w, q))
    w2 = th.make_hash_params(_gen(9), d, 2, 300)
    hard = (th.hash_keys_signs(w2, keys) == th.hash_keys_signs(
        w2, q[None])).all(-1).sum(-1).float()

    def corr(x):
        return float(torch.corrcoef(torch.stack([keys @ q, x]))[0, 1])
    assert corr(soft) > corr(hard)
