"""Port parity for the embeddings-input models, musicgen-medium (audio
frames) and internvl2-26b (vision patches), whose frontends are stubs:
the stack takes precomputed embeddings ``(B, T, d)`` where a token model
takes ids.

Against the JAX package at smoke widths, the weights drawn by JAX's
``init_model`` (no embedding table) and carried across with
``from_jax_params``, the inputs drawn with numpy:

* configs (full and smoke), ``param_count``, ``padded_vocab``,
  ``cache_plan`` equal;
* ``forward_train``'s logits and ``loss_and_metrics``' loss, metrics and
  every gradient: float32 within 1e-5 (loss) and 1e-4 (relative L2 a
  leaf, as ``test_torch_train.py``); bf16 (``dryrun_model_config`` at
  ``train_4k``) each side held to a float32 run of the same weights, as
  ``test_torch_train.py``'s bf16 case;
* ``prefill`` then ``decode_step`` on embeddings with the ``dense`` and
  ``socket`` backends: logits within LOGITS_ATOL (1e-4, chip_smoke's
  gate), packed bits bitwise, every SOCKET selection index for index;
* ``batch_specs`` (prefill and train shapes) on ``AbstractMesh`` (16,
  16), entry for entry;
* the continuous engine, ``prefill_chunk`` and the serve CLI refuse
  embeddings models with JAX's message.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.core import socket as jsk
from repro.launch import specs as jspecs
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget
from repro_torch.core import socket as tsk
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as ttfm
from repro_torch.models.weights import caches_to_numpy, from_jax_params
from repro_torch.runtime.steps import make_prefill_step, make_serve_step
from test_torch_model import _assert_config_matches_jax
from test_torch_smoke_checks import one_thread
from test_torch_train import (_check_grads, _jax_loss_grads, _leaves, _np,
                              _port_loss_grads, _rel)

ARCHS = ["musicgen-medium", "internvl2-26b"]
LOGITS_ATOL = 1e-4
B, T = 2, 24


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _setup(arch, backend="socket", numerics="f32"):
    jc, tc = jget(arch).smoke(), tget(arch).smoke()
    if numerics == "bf16":
        jc = jspecs.dryrun_model_config(jc, jspecs.SHAPES["train_4k"])
        tc = tspecs.dryrun_model_config(tc, tspecs.SHAPES["train_4k"])
    jc = jc.replace(attention_backend=backend)
    tc = tserve.apply_backend_arg(tc, backend)
    jp = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp


def _embeds(d, shape=(B, T), seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    _assert_config_matches_jax(arch)
    cfg = tget(arch)
    assert cfg.input_mode == "embeddings"
    assert cfg.padded_vocab() == {"musicgen-medium": 2048,
                                  "internvl2-26b": 92672}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_no_table_and_the_bridge_carries_it(arch):
    jc, tc, jp = _setup(arch)
    assert set(jp["embed"]) == {"head"}
    own = ttfm.init_model(tc, seed=0)
    assert set(own["embed"]) == {"head"}
    params = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    assert set(params["embed"]) == {"head"}
    np.testing.assert_array_equal(params["embed"]["head"].numpy(),
                                  np.asarray(jp["embed"]["head"]))
    assert sorted((p, tuple(t.shape)) for p, t in _leaves(own)) == \
        sorted((p, tuple(t.shape)) for p, t in _leaves(params))
    # param_count counts the table and no hash planes
    assert sum(t.numel() for p, t in _leaves(own) if not p.endswith(
        "hash_w")) == tc.param_count() - tc.padded_vocab() * tc.d_model


def _labels(vocab, seed=1):
    lab = np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)
    lab[0, :5] = -1
    return lab


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    jc, tc, jp = _setup(arch)
    x, lab = _embeds(tc.d_model), _labels(tc.vocab_size)
    tp = from_jax_params(tc, _np(jp))
    jl, _ = jax.jit(lambda p, b: jtfm.forward_train(jc, p, b))(
        jp, {"embeds": jnp.asarray(x)})
    with torch.no_grad():
        tl, _ = ttfm.forward_train(tc, tp, {"embeds": _t(x)})
    assert tl.shape == (B, T, tc.padded_vocab())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=LOGITS_ATOL)
    jloss, jm, jg = _jax_loss_grads(jc, jp, x, lab)
    tloss, tm, tg = _port_loss_grads(tc, tp, x, lab)
    assert set(tm) == set(jm) and tm["tokens"] == B * T - 5
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    _check_grads(tc, tg, jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_at_bf16(arch):
    """Deployment training numerics: the embeddings enter at bf16 (the
    compute dtype); each side's loss and gradients are held to a float32
    run of the same weights, the port within 2x JAX's distance + 1e-3."""
    jc, tc, jp = _setup(arch, numerics="bf16")
    x, lab = _embeds(tc.d_model, seed=2), _labels(tc.vocab_size, seed=3)
    jloss, _, jg = _jax_loss_grads(jc, jp, x, lab)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    assert tp["embed"]["head"].dtype == torch.bfloat16
    tloss, _, tg = _port_loss_grads(tc, tp, x, lab)
    fc = tc.replace(param_dtype="float32", compute_dtype="float32",
                    remat_policy="none")
    floss, _, fg = _port_loss_grads(fc, from_jax_params(fc, _np(jp)), x,
                                    lab)
    assert abs(tloss - floss) <= 2 * abs(jloss - floss) + 1e-3
    for path, jgl in _leaves(from_jax_params(tc, _np(jg))):
        if path.endswith("hash_w"):
            continue
        ref = fg[path]
        assert _rel(tg[path], ref) <= 2 * _rel(jgl, ref) + 1e-3, path
        assert _rel(tg[path], jgl) < 0.05, path


@contextlib.contextmanager
def _recording(module, out):
    """Every ``value_aware_topk`` selection of ``module`` appended to
    ``out`` as numpy (indices, mask), in layer order."""
    real = module.value_aware_topk

    def record(idx, mask):
        out.append((np.asarray(idx).astype(np.int64), np.asarray(mask)))

    def spy(*a, **kw):
        idx, mask = real(*a, **kw)
        if isinstance(idx, torch.Tensor):
            record(idx, mask)
        else:                       # inside JAX's scan over the groups
            jax.debug.callback(record, idx, mask, ordered=True)
        return idx, mask

    with mock.patch.object(module, "value_aware_topk", spy):
        yield


@pytest.mark.parametrize("backend", ["socket", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_embeddings_match_jax(arch, backend):
    """The JAX side runs eagerly through its plain decode (no Pallas
    kernel), so its selections can be recorded; the port's wrappers run
    their plain versions on the CPU."""
    jc, tc, jp = _setup(arch, backend)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    steps = 4
    x = _embeds(tc.d_model, seed=4)
    step_x = _embeds(tc.d_model, (steps, B, 1), seed=5)
    cap = T + steps
    jl, jcache = jtfm.prefill(jc, jp, {"embeds": jnp.asarray(x)},
                              capacity=cap)
    tl, tcache = ttfm.prefill(tc, tp, {"embeds": _t(x)}, cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGITS_ATOL)
    tn = caches_to_numpy(tc, tcache)
    if backend == "socket":
        np.testing.assert_array_equal(
            tn["groups"]["slot_0"]["bits"],
            np.asarray(jcache["groups"]["slot_0"]["bits"]))
    jsel, tsel = [], []
    for t in range(steps):
        with _recording(jsk, jsel):
            jl, jcache = jtfm.decode_step(jc, jp, jcache,
                                          jnp.asarray(step_x[t]),
                                          jnp.int32(T + t))
        with _recording(tsk, tsel), torch.no_grad():
            tl, tcache = ttfm.decode_step(tc, tp, tcache, _t(step_x[t]),
                                          T + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL, err_msg=str(t))
    assert len(tsel) == len(jsel) == (
        steps * tc.num_layers if backend == "socket" else 0)
    for (ti, tm), (ji, jm) in zip(tsel, jsel):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_and_run_serve_take_embeddings(arch):
    """``make_prefill_step``/``make_serve_step`` pass the embeddings
    through; ``run_serve`` draws Gaussian prompt and step embeddings from
    the seed, returns greedy tokens, and a prompt handed in is the one
    it would draw."""
    tc = tserve.apply_backend_arg(tget(arch).smoke(), "socket")
    params = ttfm.init_model(tc, seed=0)
    batch = tserve.serve_inputs(tc, B, 8, 0, "cpu")
    assert set(batch) == {"embeds"} and batch["embeds"].shape == \
        (B, 8, tc.d_model)
    logits, caches = make_prefill_step(tc, 12)(params, batch)
    inp = tserve.step_input(tc, logits.argmax(-1), 0, 0)
    assert inp.shape == (B, 1, tc.d_model) and inp.dtype == torch.float32
    lg, _ = make_serve_step(tc)(params, caches, inp, 8)
    assert lg.shape == (B, 1, tc.padded_vocab())
    assert bool(torch.isfinite(lg).all())
    toks, _, _ = tserve.run_serve(tc, B, 8, 4, params=params, device="cpu")
    again, _, _ = tserve.run_serve(tc, B, 8, 4, params=params, device="cpu",
                                   prompt=batch["embeds"])
    assert toks.shape == (B, 5) and torch.equal(toks, again)
    assert bool(((toks >= 0) & (toks < tc.padded_vocab())).all())


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch, shape):
    from jax.sharding import AbstractMesh
    from repro_torch.launch.mesh import Mesh
    am = AbstractMesh((16, 16), ("data", "model"))
    tm = Mesh(("data", "model"), (16, 16))
    jlog, tlog = [], []
    jb, jbs = jspecs.batch_specs(jget(arch), jspecs.SHAPES[shape], am, {},
                                 jlog)
    tb, tbs = tspecs.batch_specs(tget(arch), tspecs.SHAPES[shape], tm, {},
                                 tlog)
    assert {k: v.spec for k, v in tbs.items()} == \
        {k: tuple(v.spec) for k, v in jbs.items()}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tb.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
    assert "embeds" in tb and tlog == jlog


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_as_jax_does(arch):
    from repro.serving.engine import ContinuousBatchingEngine as JEngine
    from repro_torch.serving.engine import ContinuousBatchingEngine
    msgs = []
    for engine, cfg in ((JEngine, jget(arch).smoke()),
                        (ContinuousBatchingEngine, tget(arch).smoke())):
        with pytest.raises(NotImplementedError) as e:
            engine._validate(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(NotImplementedError, match=msgs[0]):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--engine", "continuous", "--num-requests", "1"])
    tc = tget(arch).smoke()
    with pytest.raises(NotImplementedError, match="token ids"):
        ttfm.prefill_chunk(tc, {}, [], torch.zeros(1, 8, dtype=torch.long),
                           bt_row=torch.zeros(8, dtype=torch.long), slot=0,
                           history=0, last_index=7)
