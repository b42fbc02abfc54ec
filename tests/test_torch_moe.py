"""Port parity for the MoE FFN: ``apply_moe`` with ``"global"`` and
``"batch"`` dispatch against the JAX package's, also where capacity drops
tokens; the router's expert indices, probabilities and aux losses; decode
dropless; first-come-first-served drops; ``init_moe``'s leaves;
``param_count``/``active_param_count`` of the four MoE and Mamba
architectures (full and smoke).  The ``"alltoall"`` exchange is
``test_torch_moe_alltoall.py``'s.

Tolerances (``tests/kernel_harness.py``'s policy): routing (expert
indices, which assignments are kept) exact; float32 outputs, router
probabilities and losses allclose at rtol 1e-5 / atol 1e-5 (another
summation order); parameter counts exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.models import param as pm
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models import param as tpm

TOL = dict(rtol=1e-5, atol=1e-5)
NEW_ARCHS = ["jamba-v0.1-52b", "mamba2-780m", "mixtral-8x22b",
             "llama4-maverick-400b-a17b"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cfgs(**kw):
    base = dict(name="t", family="moe", d_model=32, d_ff=64, num_experts=4,
                num_experts_per_tok=2, capacity_factor=4.0,
                mlp_activation="swiglu")
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


def _params(jc, seed=0):
    jp = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jmoe.init_moe(jc, jax.random.PRNGKey(seed))))
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jc, tc, jp, tp, x):
    jy, jaux = jmoe.apply_moe(jc, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tc, tp, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in jaux:
        np.testing.assert_allclose(taux[name].item(), float(jaux[name]),
                                   **TOL)
    return ty


def _kept(cfg, top_idx, capacity):
    """Which flat assignments the sort dispatch keeps (numpy, stable)."""
    flat = np.asarray(top_idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    pos = np.empty_like(flat)
    counts = np.zeros(cfg.num_experts, int)
    for i in order:
        pos[i] = counts[flat[i]]
        counts[flat[i]] += 1
    return pos < capacity


@pytest.mark.parametrize("dispatch", ["global", "batch"])
@pytest.mark.parametrize("factor,act", [(4.0, "swiglu"), (0.6, "swiglu"),
                                        (0.6, "geglu")])
def test_apply_moe_matches_jax(dispatch, factor, act):
    """Prefill-shaped input (B 3, T 16): outputs and aux losses allclose
    to JAX, dropless (factor 4) and where capacity drops tokens (0.6)."""
    jc, tc = _cfgs(moe_dispatch=dispatch, capacity_factor=factor,
                   mlp_activation=act)
    jp, tp = _params(jc)
    x = _x((3, 16, 32))
    _both(jc, tc, jp, tp, x)
    if factor < 1:
        # the case does drop: fewer kept assignments than tokens x k
        idx, _, _ = tmoe._router(tc, tp, _t(x.reshape(-1, 32)))
        cap = tmoe._capacity_for(tc, 48, 16)
        assert not _kept(tc, idx.numpy(), cap).all()


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 1)])
def test_router_matches_jax(e, k):
    """Expert indices exact, renormalised probabilities and the
    load-balance and z losses allclose; among equal probabilities the
    lower expert index ranks first, as ``jax.lax.top_k`` ranks them."""
    jc, tc = _cfgs(num_experts=e, num_experts_per_tok=k)
    jp, tp = _params(jc)
    x = _x((40, 32), seed=e)
    ji, jpr, jaux = jmoe._router(jc, jp, jnp.asarray(x))
    ti, tpr, taux = tmoe._router(tc, tp, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), **TOL)
    for name in jaux:
        np.testing.assert_allclose(taux[name].item(), float(jaux[name]),
                                   **TOL)
    # exact ties: a zero router gives every expert the same probability
    zp = dict(tp, router=torch.zeros_like(tp["router"]))
    jz = dict(jp, router=np.zeros_like(jp["router"]))
    ji, _, _ = jmoe._router(jc, jz, jnp.asarray(x))
    ti, tpr, _ = tmoe._router(tc, zp, _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == np.arange(k)).all()


def test_decode_is_dropless():
    """T 1 is dropless whatever the capacity factor: capacity n * k, and
    the output equals JAX's."""
    jc, tc = _cfgs(capacity_factor=0.01)
    jp, tp = _params(jc)
    assert tmoe._capacity_for(tc, 8, 1) == 16
    y = _both(jc, tc, jp, tp, _x((8, 1, 32), seed=2))
    # and equals a generous-capacity prefill of the same 8 tokens
    big = tc.replace(capacity_factor=4.0)
    np.testing.assert_allclose(
        y.reshape(1, 8, 32).numpy(),
        tmoe.apply_moe(big, tp, y.new_tensor(_x((8, 1, 32), seed=2))
                       .reshape(1, 8, 32))[0].numpy(), **TOL)


def test_capacity_drops_are_first_come_first_served():
    """Stable-sort dispatch: earlier flat tokens keep their slots when
    later tokens are appended at the same capacity."""
    _, tc = _cfgs(capacity_factor=0.6)
    _, tp = _params(_cfgs()[0])
    x = _t(_x((1, 24, 32), seed=3))
    y_full, _ = tmoe.apply_moe(tc, tp, x)
    tc2 = tc.replace(capacity_factor=tc.capacity_factor * 24 / 16)
    assert tmoe._capacity_for(tc2, 16, 16) == tmoe._capacity_for(tc, 24, 24)
    y_short, _ = tmoe.apply_moe(tc2, tp, x[:, :16])
    np.testing.assert_allclose(y_full[:, :16].numpy(), y_short.numpy(),
                               atol=2e-5)


def test_capacity_matches_jax():
    jc, tc = _cfgs()
    for factor in (0.01, 0.6, 1.25, 4.0):
        for n, t in ((1, 1), (8, 1), (24, 24), (48, 16), (4096, 512)):
            assert tmoe._capacity_for(tc.replace(capacity_factor=factor),
                                      n, t) == jmoe._capacity_for(
                jc.replace(capacity_factor=factor), n, t), (factor, n, t)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_init_moe_leaves_match_jax(arch):
    """Leaf names, shapes, dtypes (an f32 router) and the JAX package's
    standard deviations."""
    jc, tc = jget(arch).smoke(), tget(arch).smoke()
    jp, _ = _params(jc)
    boxed = tmoe.init_moe(tc, torch.Generator().manual_seed(0))
    tp = tpm.unbox(boxed)
    # the logical axes ride along, one a dim
    assert all(len(b.axes) == b.value.ndim for b in boxed.values())
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
        assert str(tp[name].dtype).split(".")[-1] == str(leaf.dtype), name
    for name, sd in (("router", tc.d_model ** -0.5),
                     ("w_gate", tc.d_model ** -0.5),
                     ("w_down", tc.d_ff ** -0.5)):
        assert abs(tp[name].std().item() / sd - 1) < 0.1, name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_counts_match_jax(arch):
    for full in (True, False):
        jc, tc = jget(arch), tget(arch)
        if not full:
            jc, tc = jc.smoke(), tc.smoke()
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.uses_moe == jc.uses_moe
