"""Port parity for the slice as a whole: configs, layers, the weight
bridge, prefill (logits and caches) and greedy decode through
``run_serve``, against the JAX package on the same weights and prompts;
also for the Mamba and MoE architectures (jamba, mamba2, mixtral,
llama4), whose caches hold Mamba state leaves.

The JAX weights are drawn by ``tfm.init_model`` and carried across with
``from_jax_params``.  The JAX side runs with the Pallas kernel flags on
(interpret mode on the CPU); the port's wrappers run their plain
versions on CPU tensors.

Tolerances: logits and K/V rtol 1e-5 / atol 1e-4 (float32, another
summation order, values up to ~10); packed bits bitwise; bf16 value
norms equal; greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.launch.serve import run_serve as j_run_serve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import apply_backend_arg, run_serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.weights import caches_to_numpy, from_jax_params

TOL = dict(rtol=1e-5, atol=1e-4)
ARCHS = ["stablelm-12b", "llama31-8b", "minitron-8b", "gemma-7b"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _configs(arch, backend, **kw):
    tc = apply_backend_arg(tget(arch).smoke(), backend).replace(**kw)
    jc = jget(arch).smoke().replace(attention_backend=backend, **kw)
    if backend == "socket":
        jc = jc.replace(socket=dataclasses.replace(
            jc.socket, use_score_kernel=True, use_flash_decode=True))
    return jc, tc


def _jax_params(jc, seed=0):
    return pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(seed)))


def _assert_config_matches_jax(arch):
    for full in (True, False):
        jc, tc = jget(arch), tget(arch)
        if not full:
            jc, tc = jc.smoke(), tc.smoke()
        nested = ("pattern", "remainder", "socket", "quest", "serving")
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name) or \
                f.name in nested, f.name
        assert [dataclasses.asdict(s) for s in tc.layer_specs] == \
            [dataclasses.asdict(s) for s in jc.layer_specs]
        assert dataclasses.asdict(tc.socket) == dataclasses.asdict(jc.socket)
        assert dataclasses.asdict(tc.quest) == dataclasses.asdict(jc.quest)
        assert dataclasses.asdict(tc.serving) == \
            dataclasses.asdict(jc.serving)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.padded_vocab() == jc.padded_vocab()
        assert tc.num_layers == jc.num_layers
        assert [dataclasses.asdict(p) for p in tc.cache_plan()] == \
            [dataclasses.asdict(p) for p in jc.cache_plan()]


@pytest.mark.parametrize("arch", ARCHS + ["gemma3-27b"])
def test_configs_match_jax(arch):
    _assert_config_matches_jax(arch)


def test_registry_names_later_slices():
    with pytest.raises(KeyError):
        tget("no-such-arch")


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x22b", 7),
    ("llama4-maverick-400b-a17b", 7), ("jamba-v0.1-52b", 7),
    ("mamba2-780m", 7), ("musicgen-medium", 11), ("internvl2-26b", 11)])
def test_later_archs_name_their_roadmap_item(arch, item):
    """The architectures of ROADMAP.md queue 1 items 7 (Mamba and MoE
    layers) and 11 (the embeddings-input frontends) are registered, their
    configs (full and smoke), sources, parameter counts and cache plans
    equal to the JAX package's; no architecture is left for later."""
    from repro.configs.registry import ARCHITECTURES as JAX_ARCHS
    from repro_torch.configs.registry import ARCHITECTURES, LATER
    assert LATER == {} and set(ARCHITECTURES) == set(JAX_ARCHS)
    assert tget(arch).source == jget(arch).source
    assert (item == 11) == (tget(arch).input_mode == "embeddings")
    _assert_config_matches_jax(arch)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_layers_allclose(activation):
    rng = np.random.default_rng(0)
    jc = jget("stablelm-12b").smoke().replace(mlp_activation=activation)
    tc = tget("stablelm-12b").smoke().replace(mlp_activation=activation)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = {"scale": rng.standard_normal(64).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": _t(scale["scale"])}, _t(x)).numpy(),
        np.asarray(jlayers.rmsnorm(
            {"scale": jnp.asarray(scale["scale"])}, jnp.asarray(x))), **TOL)
    xh = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(5), np.arange(100, 105)]).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(xh), _t(pos), 500_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                                      500_000.0)), **TOL)
    mlp = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jlayers.init_mlp(jc, jax.random.PRNGKey(1))))
    np.testing.assert_allclose(
        tlayers.apply_mlp(tc, {k: _t(v) for k, v in mlp.items()},
                          _t(x)).numpy(),
        np.asarray(jlayers.apply_mlp(jc, mlp, jnp.asarray(x))), **TOL)
    emb = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jlayers.init_embedding(jc, jax.random.PRNGKey(2))))
    temb = {k: _t(v) for k, v in emb.items()}
    toks = rng.integers(0, 256, (2, 5))
    np.testing.assert_allclose(
        tlayers.embed_tokens(tc, temb, _t(toks)).numpy(),
        np.asarray(jlayers.embed_tokens(jc, emb, jnp.asarray(toks))), **TOL)
    np.testing.assert_allclose(
        tlayers.lm_head(tc, temb, _t(x)).numpy(),
        np.asarray(jlayers.lm_head(jc, emb, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_attention_train_chunked_allclose(q_chunk):
    jc, tc = _configs("stablelm-12b", "socket", attn_q_chunk=q_chunk)
    params = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jattn.init_attention(jc, jax.random.PRNGKey(3))))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    tparams = {k: (_t(v) if not isinstance(v, dict)
                   else {"scale": _t(v["scale"])})
               for k, v in params.items()}
    out = tattn.attention_train(tc, tparams, _t(x), _t(pos), "global")
    ref = jattn.attention_train(jc, params, jnp.asarray(x),
                                jnp.asarray(pos), "global")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # sliding-window (local) layers: a 5-token window on both sides
    jl, tl = jc.replace(sliding_window=5), tc.replace(sliding_window=5)
    out = tattn.attention_train(tl, tparams, _t(x), _t(pos), "local")
    ref = jattn.attention_train(jl, params, jnp.asarray(x),
                                jnp.asarray(pos), "local")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="attn_type"):
        tattn.attention_train(tc, tparams, _t(x), _t(pos), "sparse")


def test_weight_bridge_keeps_layouts_and_hash_planes():
    jc, tc = _configs("llama31-8b", "socket")
    tree = jax.tree_util.tree_map(np.asarray, _jax_params(jc))
    params = from_jax_params(tc, tree)
    assert len(params["layers"]) == tc.num_layers
    for g in range(tc.num_groups):
        a = params["layers"][g]["attn"]
        ja = tree["groups"]["slot_0"]["attn"]
        assert tuple(a["wq"].shape) == (64, 4, 16)
        assert tuple(a["wo"].shape) == (4, 16, 64)
        np.testing.assert_array_equal(a["hash_w"].numpy(), ja["hash_w"][g])
        np.testing.assert_array_equal(a["wq"].numpy(), ja["wq"][g])
    own = ttfm.init_model(tc, seed=0)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: t.shape, own)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: t.shape, params))
    for name, leaf in own["layers"][0]["attn"].items():
        assert leaf.shape == params["layers"][0]["attn"][name].shape, name


@pytest.mark.parametrize("backend", ["socket", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_prefill_caches_and_greedy_tokens_match_jax(arch, backend):
    jc, tc = _configs(arch, backend)
    jparams = _jax_params(jc)
    params = from_jax_params(
        tc, jax.tree_util.tree_map(np.asarray, jparams))
    batch, plen, steps = 2, 24, 8
    prompt = np.random.default_rng(5).integers(
        0, tc.vocab_size, (batch, plen)).astype(np.int32)

    jl, jcache = jax.jit(lambda p, b: jtfm.prefill(
        jc, p, b, capacity=plen + steps))(jparams,
                                          {"tokens": jnp.asarray(prompt)})
    tl, tcache = ttfm.prefill(tc, params, {"tokens": _t(prompt).long()},
                              plen + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tn = caches_to_numpy(tc, tcache)
    leaves = {"k", "v"} | ({"bits", "vnorm"} if backend == "socket"
                           else set())
    assert set(tn["groups"]["slot_0"]) == leaves
    for name in leaves:
        a = np.asarray(jcache["groups"]["slot_0"][name])
        b = tn["groups"]["slot_0"][name]
        assert a.shape == b.shape, name
        if name == "bits":
            assert a.dtype == b.dtype == np.uint32
            np.testing.assert_array_equal(b, a)
        elif name == "vnorm":
            np.testing.assert_array_equal(b, a.astype(np.float32))
        else:
            np.testing.assert_allclose(b, a, **TOL)

    jt, _, _ = j_run_serve(jc, batch, plen, steps, seed=0, prompt=prompt)
    tt, _, _ = run_serve(tc, batch, plen, steps, prompt=prompt,
                         params=params, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_step_updates_cache_in_place():
    _, tc = _configs("llama31-8b", "socket")
    params = ttfm.init_model(tc, seed=1)
    toks = torch.randint(0, 256, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    _, caches = ttfm.prefill(tc, params, {"tokens": toks}, 16)
    k_before = caches[0]["k"]
    assert k_before[:, :, 12].abs().sum() == 0
    logits, caches2 = ttfm.decode_step(tc, params, caches, toks[:, :1], 12)
    assert caches2[0]["k"] is k_before
    assert k_before[:, :, 12].abs().sum() > 0
    assert logits.shape == (2, 1, tc.padded_vocab())
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("backend", ["socket", "dense"])
def test_ragged_decode_step_matches_jax(backend):
    """A ``(B,)`` position vector on the contiguous cache: per-request
    row writes, lengths and (socket) top-k budgets."""
    jc, tc = _configs("llama31-8b", backend)
    jparams = _jax_params(jc, seed=2)
    params = from_jax_params(
        tc, jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 256, (2, 40)).astype(np.int32)
    nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    pos = np.array([40, 17], np.int32)
    _, jcache = jtfm.prefill(jc, jparams, {"tokens": jnp.asarray(prompt)},
                             capacity=48)
    jl, jcache = jtfm.decode_step(jc, jparams, jcache, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    _, tcache = ttfm.prefill(tc, params, {"tokens": _t(prompt).long()}, 48)
    tl, tcache = ttfm.decode_step(tc, params, tcache, _t(nxt).long(),
                                  _t(pos).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tn = caches_to_numpy(tc, tcache)
    np.testing.assert_allclose(tn["groups"]["slot_0"]["k"],
                               np.asarray(jcache["groups"]["slot_0"]["k"]),
                               **TOL)


# ------------------------------------------------- Mamba and MoE stacks

STATE_MOE_ARCHS = ["jamba-v0.1-52b", "mamba2-780m", "mixtral-8x22b",
                   "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", STATE_MOE_ARCHS)
def test_state_and_moe_prefill_and_greedy_tokens_match_jax(arch):
    """The four smoke configs (jamba at one group): the weight bridge
    carries the ``mamba`` and ``moe`` subtrees across (the f32 ``A_log``,
    ``dt_bias``, ``D`` and router as f32), prefill logits and every cache
    leaf (Mamba ``ssm``/``conv`` state, attention K/V, SOCKET bits) equal
    JAX's, and the static path's greedy tokens (``run_serve``, its prefill
    through MoE capacity drops at the default factor) equal JAX
    ``run_serve``'s."""
    kw = {"num_groups": 1} if arch == "jamba-v0.1-52b" else {}
    jc, tc = _configs(arch, "socket", **kw)
    jparams = _jax_params(jc)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(tc, tree)
    for i, spec in enumerate(tc.layer_specs):
        lp = params["layers"][i]
        assert ("mamba" in lp) == (spec.kind == "mamba")
        assert ("moe" in lp) == (spec.mlp == "moe")
        for sub in ("mamba", "moe"):
            for name, leaf in lp.get(sub, {}).items():
                j = tree["groups"][f"slot_{i % len(tc.pattern)}"][sub][name]
                np.testing.assert_array_equal(
                    leaf.numpy(), j[i // len(tc.pattern)])
        if "mamba" in lp:
            assert {lp["mamba"][n].dtype for n in ("A_log", "dt_bias", "D")} \
                == {torch.float32}
        if "moe" in lp:
            assert lp["moe"]["router"].dtype == torch.float32
    batch, plen, steps = 2, 24, 6
    prompt = np.random.default_rng(7).integers(
        0, tc.vocab_size, (batch, plen)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, b: jtfm.prefill(
        jc, p, b, capacity=plen + steps))(jparams,
                                          {"tokens": jnp.asarray(prompt)})
    tl, tcache = ttfm.prefill(tc, params, {"tokens": _t(prompt).long()},
                              plen + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tn = caches_to_numpy(tc, tcache)
    jn = jax.tree_util.tree_map(np.asarray, jcache)
    assert jax.tree_util.tree_structure(tn) == \
        jax.tree_util.tree_structure(jn)
    for path, a in jax.tree_util.tree_leaves_with_path(jn):
        b = tn
        for key in path:
            b = b[key.key]
        assert a.shape == b.shape, path
        if a.dtype == np.uint32:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a.astype(np.float32), **TOL)

    jt, _, _ = j_run_serve(jc, batch, plen, steps, seed=0, prompt=prompt)
    tt, _, _ = run_serve(tc, batch, plen, steps, prompt=prompt,
                         params=params, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_static_warmup_leaves_mamba_state_alone():
    """``run_serve``'s warm-up decode step runs on copies of the Mamba
    layers' states: the greedy tokens equal a loop over ``decode_step``
    with no warm-up."""
    _, tc = _configs("mamba2-780m", "socket")
    params = ttfm.init_model(tc, seed=3)
    prompt = torch.randint(0, 256, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    toks, _, _ = run_serve(tc, 2, 20, 5, prompt=prompt, params=params,
                           device="cpu")
    logits, caches = ttfm.prefill(tc, params, {"tokens": prompt}, 25)
    want = [logits[:, -1].argmax(-1)[:, None]]
    for t in range(5):
        logits, caches = ttfm.decode_step(tc, params, caches, want[-1],
                                          20 + t)
        want.append(logits[:, -1].argmax(-1)[:, None])
    assert torch.equal(toks, torch.cat(want, dim=1))
