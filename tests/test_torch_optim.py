"""Port parity for the optimizer: the learning-rate schedule, the 8-bit
moment quantizer, AdamW stepped from one carried state, the
weight-decay mask and the frozen hash planes, against the JAX package's
``repro.optim`` on the same inputs (numpy-seeded; JAX trees carried
across with ``from_jax_params`` / ``opt_state_from_jax``).

Tolerances:

* schedule: rtol 1e-6 (the same float32 arithmetic; ``cos`` of two
  libraries).
* quantizer: at ``power`` 1 codes and scales bit for bit; at 3 and 6
  (the moments' companding roots) a block's scale is bit for bit where
  XLA's and torch's float32 roots of its largest magnitude agree, one
  float32 ulp apart where they do not (XLA's CPU ``pow`` is the C
  library's ``powf``, torch's its own: they round ~2 % of roots an ulp
  apart), and a code may move by one only where the two roots of its
  value differ; expanding codes back (``dequantize``) bit for bit.
* AdamW, one step from a carried state: parameters, float32 moments
  and 8-bit scales within 1e-6 of the value and of the leaf's largest
  magnitude (measured 1.3e-7 of the largest: the global norm sums in
  another order, so the clip factor moves an ulp and with it every
  update); codes within one, at most 0.5 % of them moved (measured
  0.01 %); the gradient norm and the rate rtol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.configs.base import LayerSpec
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadam
from repro.optim import quantized_state as jq8
from repro.optim.schedule import ScheduleConfig as JSchedule
from repro.optim.schedule import learning_rate as jlr
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.optim import adamw as tadam
from repro_torch.optim import quantized_state as tq8
from repro_torch.optim.schedule import ScheduleConfig as TSchedule
from repro_torch.optim.schedule import learning_rate as tlr
from repro_torch.models.weights import from_jax_params, opt_state_from_jax


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(kind):
    kw = dict(peak_lr=3e-3, warmup_steps=10, decay_steps=120,
              end_lr_frac=0.1, kind=kind)
    steps = np.arange(0, 200, 2)
    j = [float(jlr(JSchedule(**kw), jnp.int32(s))) for s in steps]
    t = [float(tlr(TSchedule(**kw), torch.tensor(s, dtype=torch.int32)))
         for s in steps]
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert t[0] == 0.0 and t[5] == 3e-3 * np.float32(1.0)
    with pytest.raises(ValueError):
        tlr(TSchedule(kind="step"), torch.tensor(5))


# ------------------------------------------------------------ quantizer

@pytest.mark.parametrize("shape", [(), (1,), (5,), (16,), (3, 700),
                                   (2, 3, 17)])
def test_q8_layout_matches_jax(shape):
    x = np.ones(shape, np.float32)
    jz, tz = jq8.qzeros_like(jnp.asarray(x)), tq8.qzeros_like(
        torch.from_numpy(x))
    for k in ("q", "scale"):
        assert tuple(tz[k].shape) == jz[k].shape
        assert str(tz[k].dtype).split(".")[-1] == str(jz[k].dtype)
    d = shape[-1] if shape else 1
    assert tq8.padded_dim(d) == jq8.padded_dim(d)
    back = tq8.dequantize(tq8.quantize(torch.from_numpy(x)), shape)
    assert tuple(back.shape) == shape


def _roots_differ(x: np.ndarray, power: int) -> np.ndarray:
    """Where XLA's and torch's float32 ``|x| ** (1 / power)`` differ."""
    j = np.asarray(jnp.abs(jnp.asarray(x)) ** (1.0 / power))
    t = (torch.from_numpy(x).abs() ** (1.0 / power)).numpy()
    return j != t


@pytest.mark.parametrize("power", [1, 3, 6])
@pytest.mark.parametrize("shape,scale", [((300, 77), 1e-3),
                                         ((4, 16, 48), 1.0),
                                         ((1000,), 1e-7)])
def test_q8_quantize_matches_jax(power, shape, scale):
    rng = np.random.default_rng(power * 7 + len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if power % 2 == 0:
        x = np.abs(x)                   # v: the second moment
    x.reshape(-1)[:5] = 0.0             # an all-zero start of a block
    jq = jq8.quantize(jnp.asarray(x), power=power)
    tq = tq8.quantize(torch.from_numpy(x), power=power)
    jcode, tcode = np.asarray(jq["q"]), tq["q"].numpy()
    jscale, tscale = np.asarray(jq["scale"]), tq["scale"].numpy()
    assert tcode.dtype == np.int8 and tscale.dtype == np.float32
    if power == 1:
        np.testing.assert_array_equal(tcode, jcode)
        np.testing.assert_array_equal(tscale, jscale)
        return
    d = shape[-1]
    pad = tq8.padded_dim(d) - d
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    blocks = xp.reshape(*xp.shape[:-1], -1, min(tq8.BLOCK, d))
    bmax = np.abs(blocks).max(axis=-1)
    same_root = ~_roots_differ(bmax, power)
    np.testing.assert_array_equal(tscale[same_root], jscale[same_root])
    np.testing.assert_array_max_ulp(tscale, jscale, maxulp=1)
    assert (np.abs(tcode.astype(int) - jcode.astype(int)) <= 1).all()
    allowed = _roots_differ(xp, power) | np.repeat(
        ~same_root, blocks.shape[-1], axis=-1)
    assert not ((tcode != jcode) & ~allowed).any()


@pytest.mark.parametrize("power", [1, 3, 6])
def test_q8_dequantize_bit_for_bit(power):
    """Expanding JAX's codes and scales: bit for bit (``integer_pow``'s
    products, in JAX's order)."""
    rng = np.random.default_rng(power)
    x = (rng.standard_normal((40, 50)) * 3e-2).astype(np.float32)
    jq = jq8.quantize(jnp.asarray(x), power=power)
    j = np.asarray(jq8.dequantize(jq, x.shape, power=power))
    t = tq8.dequantize({k: torch.from_numpy(np.array(v))
                        for k, v in jq.items()}, x.shape, power=power)
    np.testing.assert_array_equal(t.numpy(), j)


# ---------------------------------------------------------------- AdamW

def _model(arch, **kw):
    jc, tc = jget(arch).smoke().replace(**kw), tget(arch).smoke().replace(
        **kw)
    return jc, tc, pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch,bits", [("llama31-8b", 32),
                                       ("llama31-8b", 8),
                                       ("jamba-v0.1-52b", 32)])
def test_adamw_step_from_carried_state_matches_jax(arch, bits):
    """Two JAX updates build a state; it is carried across, and one more
    update on both sides gives the same parameters, moments, step, norm
    and rate (jamba: Mamba's ``D`` decayed inside the groups, as JAX
    decays it)."""
    jc, tc, jp = _model(arch)
    sched = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    jo = jadam.AdamWConfig(state_bits=bits, schedule=JSchedule(**sched))
    to = tadam.AdamWConfig(state_bits=bits, schedule=TSchedule(**sched))
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree_util.tree_map(lambda x: jnp.asarray(
            (rng.standard_normal(x.shape) * 1e-2).astype(np.float32)), jp)

    update = jax.jit(lambda g, s, p: jadam.adamw_update(jo, g, s, p))
    p, st = jp, jadam.init_adamw(jo, jp)
    for _ in range(2):
        p, st, _ = update(grads(), st, p)
    g = grads()
    tp = from_jax_params(tc, _np(p))
    ts = opt_state_from_jax(tc, _np(st))
    tg = from_jax_params(tc, _np(g))
    jp3, js3, jm = update(g, st, p)
    tp3, ts3, tm = tadam.adamw_update(
        to, tg, ts, tp, stacked_layers=tc.num_groups * len(tc.pattern))
    assert tp3 is tp                      # updated in place
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts3["step"]) == int(js3["step"]) == 3
    want = from_jax_params(tc, _np(jp3))
    for (path, t), (_, j) in zip(_leaves(tp3), _leaves(want)):
        _close(t, j, path)
    jstate = opt_state_from_jax(tc, _np(js3))
    moved = total = 0
    for name in ("m", "v"):
        for (path, t), (_, j) in zip(_leaves(ts3[name]),
                                     _leaves(jstate[name])):
            if path.endswith("/q"):
                diff = (t.int() - j.int()).abs()
                assert int(diff.max()) <= 1, path
                moved += int((diff > 0).sum())
                total += diff.numel()
            else:
                _close(t, j, path)
    assert moved <= 0.005 * max(total, 1)


def _close(t, j, path):
    """Within 1e-6 of the value and of the leaf's largest magnitude."""
    j = j.numpy()
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6,
                               atol=1e-6 * float(np.abs(j).max()),
                               err_msg=path)


def _jax_decays(jp):
    flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jadam.wants_weight_decay(jax.tree_util.keystr(path), x))
        for path, x in flat])


@pytest.mark.parametrize("arch,extra", [
    ("jamba-v0.1-52b", None), ("mamba2-780m", None),
    ("jamba-v0.1-52b", "mamba"), ("gemma3-27b", None)])
def test_weight_decay_mask_matches_jax(arch, extra):
    """The port decays the leaves JAX decays, judging each by its rank in
    JAX's stacked tree: Mamba's 1-D ``D`` is decayed in a group layer
    (2-D there) and not in a remainder layer (jamba given a Mamba
    remainder layer; gemma3's remainder is an attention layer)."""
    kw = {}
    if extra == "mamba":
        kw = dict(remainder=(LayerSpec(kind="mamba", mlp="dense"),))
    jc, _, jp = _model(arch, **kw)
    tc = tget(arch).smoke().replace(**(
        dict(remainder=(TLayerSpec(kind="mamba", mlp="dense"),))
        if extra else {}))
    want = from_jax_params(tc, _jax_decays(jp))
    tparams = from_jax_params(tc, _np(jp))
    stacked = tc.num_groups * len(tc.pattern)
    got = {path: tadam.wants_weight_decay(
        path, tadam.jax_rank(path, leaf, stacked))
        for path, leaf in tadam.tree_leaves(tparams)}
    want_flat = dict(tadam.tree_leaves(want))
    assert set(got) == set(want_flat)
    for path, decay in got.items():
        assert decay == bool(want_flat[path]), path
    d_paths = [p for p in got if p.endswith("['mamba']['D']")]
    if d_paths:
        in_groups = [got[p] for p in d_paths
                     if int(p.split("][")[1].split("]")[0]) < stacked]
        assert in_groups and all(in_groups)
        if extra:
            assert not got[d_paths[-1]]


def test_hash_planes_frozen_and_counted_in_the_norm():
    """``hash_w`` never changes and keeps its 0-d moment placeholders;
    a gradient given for it counts in the global norm, as in JAX (the
    JAX package's test case, then a smoke model)."""
    sched = dict(peak_lr=0.1, warmup_steps=0, kind="constant")
    jo = jadam.AdamWConfig(schedule=JSchedule(**sched))
    to = tadam.AdamWConfig(schedule=TSchedule(**sched))
    jparams = {"hash_w": jnp.ones((3, 3)), "w": jnp.ones((3,))}
    tparams = {"hash_w": torch.ones(3, 3), "w": torch.ones(3)}
    jg = {"hash_w": jnp.ones((3, 3)), "w": jnp.ones((3,))}
    tg = {"hash_w": torch.ones(3, 3), "w": torch.ones(3)}
    jnew, _, jm = jadam.adamw_update(jo, jg, jadam.init_adamw(jo, jparams),
                                     jparams)
    tnew, ts, tm = tadam.adamw_update(to, tg, tadam.init_adamw(to, tparams),
                                      tparams)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert torch.equal(tnew["hash_w"], torch.ones(3, 3))
    np.testing.assert_allclose(tnew["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)
    assert ts["m"]["hash_w"].shape == () and ts["v"]["hash_w"].shape == ()
    _, tc, jp = _model("llama31-8b")
    params = from_jax_params(tc, _np(jp))
    for bits in (32, 8):
        o = tadam.AdamWConfig(state_bits=bits)
        state = tadam.init_adamw(o, params)
        before = params["layers"][0]["attn"]["hash_w"].clone()
        tadam.adamw_update(o, _ones_but_hash(params), state, params)
        assert torch.equal(params["layers"][0]["attn"]["hash_w"], before)
        assert state["m"]["layers"][0]["attn"]["hash_w"].shape == ()


def _ones_but_hash(tree, key=""):
    """A gradient tree of ones, ``None`` for the hash planes (the train
    step takes no gradient for them)."""
    if isinstance(tree, dict):
        return {k: _ones_but_hash(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ones_but_hash(v) for v in tree]
    return None if key == "hash_w" else torch.ones_like(tree)


def test_adamw_matches_numpy_reference():
    """The JAX package's literal numpy AdamW, 25 steps, on the port."""
    sched = TSchedule(peak_lr=0.05, warmup_steps=0, kind="constant")
    cfg = tadam.AdamWConfig(weight_decay=0.0, grad_clip_norm=1e9,
                            schedule=sched)
    w0 = np.linspace(-2, 2, 16).astype(np.float32)
    params = {"w": torch.from_numpy(w0.copy())}
    state = tadam.init_adamw(cfg, params)
    for _ in range(25):
        g = {"w": 2 * (params["w"] - 0.5)}
        params, state, _ = tadam.adamw_update(cfg, g, state, params)
    w, m, v = w0.astype(np.float64), 0.0, 0.0
    for t in range(1, 26):
        g = 2 * (w - 0.5)
        m = 0.9 * m + 0.1 * g
        v = 0.95 * v + 0.05 * g * g
        w = w - 0.05 * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.95 ** t))
                                               + 1e-8)
    np.testing.assert_allclose(params["w"].numpy(), w, atol=1e-5)
