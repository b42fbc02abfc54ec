"""Port parity for the Mamba-2 (SSD) block: ``init_mamba``'s leaves,
``mamba_train`` (outputs and returned state, with ``h0``/``conv0``
carries and ``last_index`` padding) and ``mamba_decode`` against the JAX
package's functions on the same weights and inputs (numpy-seeded; the
JAX weights carried across leaf by leaf), and the port's own properties:
causality, decode equal to train, chunk-size invariance, padding past
``last_index`` kept out of the state, and two segments chained through
``h0``/``conv0`` equal to the whole sequence.

Tolerances (``tests/kernel_harness.py``'s float policy): float32 outputs
and states allclose at rtol 1e-5 / atol 1e-5 against JAX (another
summation order in the SSD's contractions); the port's own invariances
at the JAX package's atol 1e-4 (``test_models.py``); padding bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import mamba as jmb
from repro.models import param as pm
from repro_torch.configs import get_config as tget
from repro_torch.models import mamba as tmb
from repro_torch.models import param as tpm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _setup(arch="mamba2-780m", seed=0, **kw):
    jc, tc = jget(arch).smoke().replace(**kw), tget(arch).smoke().replace(
        **kw)
    jp = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jmb.init_mamba(jc, jax.random.PRNGKey(seed))))
    return jc, tc, jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_mamba_leaves_match_jax(arch):
    """Same leaf names, shapes and dtypes (f32 A_log/dt_bias/D), the
    constant leaves equal (A_log to the log's rounding) and the drawn ones
    with the JAX package's moments; dt_bias is the inverse softplus of
    [1e-3, 1e-1]."""
    jc, tc, jp, _ = _setup(arch)
    boxed = tmb.init_mamba(tc, torch.Generator().manual_seed(0))
    tp = tpm.unbox(boxed)
    # the logical axes ride along, one a dim
    assert all(len(b.axes) == b.value.ndim for b in boxed.values())
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
        assert str(tp[name].dtype).split(".")[-1] == str(leaf.dtype), name
    for name in ("conv_b", "D", "norm_scale"):
        np.testing.assert_array_equal(tp[name].numpy(), jp[name])
    # log(1..nh): the two libraries' log may round an ulp apart
    np.testing.assert_allclose(tp["A_log"].numpy(), jp["A_log"], rtol=1e-6)
    dt = torch.nn.functional.softplus(tp["dt_bias"]).numpy()
    assert (dt > 0.999e-3).all() and (dt < 0.1001).all()
    for name, sd in (("in_proj", tc.d_model ** -0.5), ("conv_w", 0.5),
                     ("out_proj", tc.d_inner ** -0.5)):
        assert abs(tp[name].std().item() / sd - 1) < 0.1, name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [40, 32, 3])
def test_mamba_train_matches_jax(arch, s):
    """Whole-sequence outputs and the returned state (SSD state, conv
    tail): a ragged length (40: the SSD pads its last chunk), two whole
    chunks (32) and fewer tokens than the conv tail's rows (3)."""
    jc, tc, jp, tp = _setup(arch)
    x = _x((2, s, jc.d_model))
    jy, jst = jmb.mamba_train(jc, jp, jnp.asarray(x), return_state=True)
    ty, tst = tmb.mamba_train(tc, tp, _t(x), return_state=True)
    _close(ty, jy)
    for name in ("ssm", "conv"):
        _close(tst[name], jst[name])
    _close(tmb.mamba_train(tc, tp, _t(x)), jy)


@pytest.mark.parametrize("last", [[9, 17], [0, 1]])
def test_mamba_train_carry_and_last_index_match_jax(last):
    """A second segment fed the first's state (``h0``/``conv0``) with its
    padding past ``last_index``: outputs and state allclose to JAX,
    including rows whose real tokens number fewer than the conv tail's
    (the tail reaches back into the carried rows)."""
    jc, tc, jp, tp = _setup()
    x = _x((2, 40, jc.d_model))
    _, jst = jmb.mamba_train(jc, jp, jnp.asarray(x[:, :16]),
                             return_state=True)
    _, tst = tmb.mamba_train(tc, tp, _t(x[:, :16]), return_state=True)
    li = np.asarray(last, np.int32)
    jy, j2 = jmb.mamba_train(jc, jp, jnp.asarray(x[:, 16:]),
                             h0=jst["ssm"], conv0=jst["conv"],
                             return_state=True, last_index=jnp.asarray(li))
    ty, t2 = tmb.mamba_train(tc, tp, _t(x[:, 16:]), h0=tst["ssm"],
                             conv0=tst["conv"], return_state=True,
                             last_index=torch.as_tensor(li))
    _close(ty, jy)
    for name in ("ssm", "conv"):
        _close(t2[name], j2[name])


def test_mamba_decode_matches_jax():
    """Ten recurrent steps from a prefilled state: each step's output and
    the state after it allclose to JAX, and the step leaves its input
    cache as it was."""
    jc, tc, jp, tp = _setup()
    x = _x((3, 30, jc.d_model))
    _, jst = jmb.mamba_train(jc, jp, jnp.asarray(x[:, :20]),
                             return_state=True)
    _, tst = tmb.mamba_train(tc, tp, _t(x[:, :20]), return_state=True)
    for i in range(20, 30):
        before = {k: v.clone() for k, v in tst.items()}
        jy, jst = jmb.mamba_decode(jc, jp, jnp.asarray(x[:, i:i + 1]), jst)
        ty, new = tmb.mamba_decode(tc, tp, _t(x[:, i:i + 1]), tst)
        for k in tst:
            assert torch.equal(tst[k], before[k])
        tst = new
        _close(ty, jy)
        for name in ("ssm", "conv"):
            _close(tst[name], jst[name])


def test_init_mamba_cache_matches_jax():
    jc, tc, _, _ = _setup()
    jcache = jmb.init_mamba_cache(jc, 5)
    tcache = tmb.init_mamba_cache(tc, 5)
    assert set(tcache) == set(jcache)
    for name, leaf in jcache.items():
        assert tuple(tcache[name].shape) == leaf.shape
        assert str(tcache[name].dtype).split(".")[-1] == str(leaf.dtype)
        assert not tcache[name].any()


def test_softplus_is_logaddexp_at_every_magnitude():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's ``softplus``
    switches to ``x`` above 20, where the two differ by ~2e-9 relative,
    and the port keeps JAX's."""
    x = np.array([-40.0, -3.0, 0.0, 0.5, 19.9, 20.1, 25.0, 60.0],
                 np.float32)
    np.testing.assert_array_equal(tmb._softplus(_t(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


# --------------------------------------------------- the port's properties

def test_mamba_is_causal():
    _, tc, _, tp = _setup()
    x = _t(_x((2, 40, tc.d_model)))
    np.testing.assert_allclose(tmb.mamba_train(tc, tp, x)[:, :24].numpy(),
                               tmb.mamba_train(tc, tp, x[:, :24]).numpy(),
                               atol=1e-4)


def test_mamba_decode_matches_train():
    _, tc, _, tp = _setup()
    x = _t(_x((2, 33, tc.d_model)))
    ref = tmb.mamba_train(tc, tp, x)
    _, st = tmb.mamba_train(tc, tp, x[:, :32], return_state=True)
    y, _ = tmb.mamba_decode(tc, tp, x[:, 32:33], st)
    np.testing.assert_allclose(y[:, 0].numpy(), ref[:, 32].numpy(),
                               atol=1e-4)


def test_mamba_chunk_size_invariance():
    _, tc, _, tp = _setup()
    x = _t(_x((1, 64, tc.d_model)))
    np.testing.assert_allclose(
        tmb.mamba_train(tc.replace(ssm_chunk=16), tp, x).numpy(),
        tmb.mamba_train(tc.replace(ssm_chunk=32), tp, x).numpy(), atol=1e-4)


def test_padding_past_last_index_is_excluded_from_state():
    """The state at ``last_index`` does not move, bit for bit, whatever
    the padding holds, and equals the unpadded run's."""
    _, tc, _, tp = _setup()
    x = _x((2, 24, tc.d_model))
    li = torch.tensor([9, 17])
    _, padded = tmb.mamba_train(tc, tp, _t(x), return_state=True,
                                last_index=li)
    mask = np.arange(24)[None, :, None] <= li.numpy()[:, None, None]
    garbled = np.where(mask, x, 1e3 * _x(x.shape, seed=2))
    _, got = tmb.mamba_train(tc, tp, _t(garbled), return_state=True,
                             last_index=li)
    for name in ("ssm", "conv"):
        assert torch.equal(padded[name], got[name])
    for b, n in enumerate([10, 18]):
        _, exact = tmb.mamba_train(tc, tp, _t(x[b:b + 1, :n]),
                                   return_state=True)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(padded[name][b].numpy(),
                                       exact[name][0].numpy(), atol=1e-5)


def test_two_segments_chain_to_the_whole_sequence():
    """Two segments cut on the ``ssm_chunk`` grid, the second fed the
    first's ``h0``/``conv0``: outputs and final state equal the
    whole-sequence run's, bit for bit on the CPU."""
    _, tc, _, tp = _setup()
    s, cut = 2 * tc.ssm_chunk, tc.ssm_chunk
    x = _t(_x((2, s, tc.d_model)))
    y, st = tmb.mamba_train(tc, tp, x, return_state=True)
    y1, st1 = tmb.mamba_train(tc, tp, x[:, :cut], return_state=True)
    y2, st2 = tmb.mamba_train(tc, tp, x[:, cut:], h0=st1["ssm"],
                              conv0=st1["conv"], return_state=True)
    assert torch.equal(y[:, :cut], y1) and torch.equal(y[:, cut:], y2)
    assert torch.equal(st["ssm"], st2["ssm"])
    assert torch.equal(st["conv"], st2["conv"])
