"""Port parity at the deployment numerics: bf16 parameters and compute,
bf16 SOCKET scores in chunks (``launch/specs.py``'s
``dryrun_model_config``), against the JAX package on the same weights
and inputs.

* The weight bridge carries bf16 leaves bit for bit.
* The paged kernels' wrappers take a bf16 query and Quest's bf16 page
  bounds (the TPU kernels cast them to float32 inside); the plain
  versions give the float32 inputs' output on their bf16 values.
* SOCKET scores at ``score_dtype="bfloat16"``: u rounded to bf16, the
  contraction accumulated in float32, as JAX's
  ``preferred_element_type``.
* ``dryrun_model_config`` and ``SHAPES`` equal to JAX's for every
  registered arch and shape.
* Modules at bf16 (hashing and scores, norms/MLP/embeddings, attention,
  the decode backends and K/V quantization, Mamba and MoE, the model's
  prefill, chunk prefill and decode step, the static and continuous
  launchers), each against the JAX function.

Tolerances.  Bits, selections, routes and quantized payloads are
compared bit for bit (hash signs outside the float32 zero band, as at
float32).  Scores: ``SCORE_TOL`` (rtol 1e-5 / atol 1e-6), the float32
policy, because both sides accumulate in float32.  A bf16 output that
went through a chain of bf16 roundings: :func:`_bf16_close`, two bf16
ulps (2**-6 relative) at the value or at the array's largest magnitude,
whichever is larger: an output summed from products as large as the
array's largest value carries their roundings (Mamba's conv output, one
ulp apart in 40 % of its elements where XLA's bf16 ``silu`` rounds its
sigmoid first, moves the block's output by 0.029 at a value of 0.2 in a
row reaching 4.2).  Logits of a whole model: ``LOGITS_TOL`` (atol
2**-3, four bf16 ulps at |logit| in [4, 8), the smoke models' largest;
measured up to 0.0625 on llama31-8b and 0.066 on llama4).  jamba's 14
Mamba layers carry the roundings further (XLA's bf16 ``silu`` rounds
its sigmoid first; the port's rounds once): its logits within
``STATE_LOGITS_TOL`` (atol 2**-2; measured 0.148), and its cache leaves
no farther from a float32 run of the same weights than
``STATE_F32_RATIO`` (2) times JAX's own bf16 leaves are (measured
1.73, the last Mamba layer's state; JAX's bf16 logits lie 1.57 from the
float32 run's, the port's 0.137 from JAX's).  MoE routes are paired
inside ``ROUTE_BAND`` (below).  Greedy tokens at bf16 may flip on
near-ties, so the model and engine cases compare logits along JAX's
token path (teacher-forced) and require the same argmax wherever JAX's
top-2 margin exceeds twice the logits tolerance.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.core import hashing as jh
from repro.core import socket as jsk
from repro.launch import specs as jspecs
from repro.models import layers as jlayers
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import hashing as th
from repro_torch.core import socket as tsk
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.launch import specs as tspecs
from repro_torch.models import layers as tlayers
from repro_torch.models.weights import from_jax_params

from test_torch_smoke_checks import one_thread

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL = 2 ** -6
LOGITS_TOL = dict(rtol=0.0, atol=2 ** -3)
STATE_LOGITS_TOL = dict(rtol=0.0, atol=2 ** -2)
STATE_F32_RATIO = 2.0
DECODE = tspecs.SHAPES["decode_32k"]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _tb(x):
    """A numpy or JAX array as a torch tensor, bf16 bit for bit."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f(x):
    """float32 numpy of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_close(out, ref, msg="", rtol=BF16_RTOL):
    """Within two bf16 ulps (``rtol``) of the value or of the array's
    largest magnitude (the module docstring's bf16 policy)."""
    out, ref = _f(out), _f(ref)
    np.testing.assert_allclose(
        out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max(initial=0.0)),
        err_msg=msg)


def _words(x):
    """The 16-bit words of a bf16 torch tensor or numpy/JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _dry(arch, backend=None, **kw):
    """(JAX, port) smoke configs at the deployment numerics."""
    jc = jspecs.dryrun_model_config(jget(arch), jspecs.SHAPES["decode_32k"])
    tc = tspecs.dryrun_model_config(tget(arch), DECODE)
    jc, tc = jc.smoke().replace(**kw), tc.smoke().replace(**kw)
    if backend is not None:
        from repro.launch.serve import apply_backend_arg as japply
        from repro_torch.launch.serve import apply_backend_arg
        jc, tc = japply(jc, backend), apply_backend_arg(tc, backend)
    return jc, tc


def _params(jc, tc, seed=0):
    jp = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(seed)))
    return jp, from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))


# ------------------------------------------------------------ the repairs

@pytest.mark.parametrize("arch", ["llama31-8b", "llama4-maverick-400b-a17b"])
def test_weight_bridge_carries_bf16_leaves_bit_for_bit(arch):
    """A ``param_dtype="bfloat16"`` tree crosses as bf16 tensors whose
    16-bit words are the JAX leaves' (float32 islands such as the MoE
    router stay float32 and equal)."""
    jc, tc = _dry(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0))))
    params = from_jax_params(tc, tree)
    jl = jax.tree_util.tree_leaves_with_path(tree["groups"])
    n_bf16 = 0
    for path, leaf in jl:
        keys = [p.key for p in path]
        for g in range(tc.num_groups):
            t = params["layers"][g * len(tc.pattern)
                                 + int(keys[0].split("_")[1])]
            for k in keys[1:]:
                t = t[k]
            if leaf.dtype.name == "bfloat16":
                n_bf16 += 1
                assert t.dtype == torch.bfloat16, keys
                np.testing.assert_array_equal(_words(t), _words(leaf[g]))
            else:
                assert t.numpy().dtype == leaf.dtype, keys
                np.testing.assert_array_equal(t.numpy(), leaf[g])
    assert n_bf16 > 0
    for name in ("table", "head"):
        np.testing.assert_array_equal(_words(params["embed"][name]),
                                      _words(tree["embed"][name]))


def _pool(rng, kv_dtype=torch.bfloat16, nblocks=6, kvh=2, bs=8, hd=16):
    k = torch.from_numpy(rng.standard_normal((nblocks, kvh, bs, hd)).astype(
        np.float32)).to(kv_dtype)
    v = torch.from_numpy(rng.standard_normal((nblocks, kvh, bs, hd)).astype(
        np.float32)).to(kv_dtype)
    return k, v


def test_paged_wrappers_take_a_bf16_query():
    """``_check_pool`` accepts a float32 or bf16 query and refuses any
    other type, ``_check_bounds`` the same for Quest's page bounds; each
    of the four wrappers' plain versions on a bf16 query (Quest's also on
    bf16 bounds) returns float32, equal to its output on the float32
    inputs of the same values (the TPU kernels read q and the bounds as
    float32)."""
    rng = np.random.default_rng(0)
    k, v = _pool(rng)
    b, kvh, g, hd = 2, 2, 2, 16
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    q32 = torch.from_numpy(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).to(torch.bfloat16).float()
    for q in (q32, q32.to(torch.bfloat16)):
        assert pa._check_pool(q, k, v, bt, None, None) == pa.KV_TYPES[
            torch.bfloat16]
    with pytest.raises(TypeError, match="q must be one of"):
        pa._check_pool(q32.half(), k, v, bt, None, None)
    assert pa.Q_TYPES == (torch.float32, torch.bfloat16)
    # Quest's page bounds: a bf16 model's pool holds them in bf16
    kmin = k.float().reshape(6, kvh, 1, 8, hd).amin(3)
    kmax = k.float().reshape(6, kvh, 1, 8, hd).amax(3)
    for dt in pa.Q_TYPES:
        pa._check_bounds(kmin.to(dt), kmax.to(dt), (6, kvh, 1, hd))
    with pytest.raises(TypeError, match="kmin_pages must be one of"):
        pa._check_bounds(kmin.half(), kmax.half(), (6, kvh, 1, hd))

    w = torch.from_numpy(rng.standard_normal((12, 6, hd)).astype(np.float32))
    bits = th.pack_signs(th.hash_keys_signs(w, k.float()))
    vnorm = torch.linalg.vector_norm(v.float(), dim=-1).to(torch.bfloat16)
    u = tsk.soft_hash_query(w, q32)
    length, budget = torch.tensor([20, 13]), torch.tensor([8, 6])
    common = dict(length=length, budget=budget, num_tables=12, num_planes=6,
                  scale=0.25, sink_tokens=2, window_tokens=2)
    kmin, kmax = kmin.bfloat16().float(), kmax.bfloat16().float()
    calls = {
        "socket": lambda q: pa.paged_socket_attend(
            q, k, v, bits, vnorm, u, bt, tau=0.4, **common),
        "hard_lsh": lambda q: pa.paged_hard_lsh_attend(
            q, k, v, bits, vnorm, torch.where(u >= 0, 1.0, -1.0), bt,
            **common),
        "quest": lambda q: pa.paged_quest_attend(
            q, k, v, kmin, kmax, bt, length=length,
            page_budget=torch.tensor([2, 1]), page_size=8, scale=0.25,
            sink_tokens=2, window_tokens=2),
        "ring": lambda q: pa.paged_ring_attend(
            q, k, v, bt, pos=torch.tensor([20, 13]), window=12,
            softcap=0.0, scale=0.25),
    }
    for name, call in calls.items():
        want = call(q32)
        got = call(q32.to(torch.bfloat16))
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    got = pa.paged_quest_attend(
        q32.bfloat16(), k, v, kmin.bfloat16(), kmax.bfloat16(), bt,
        length=length, page_budget=torch.tensor([2, 1]), page_size=8,
        scale=0.25, sink_tokens=2, window_tokens=2)
    torch.testing.assert_close(got, calls["quest"](q32), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [0, 256])
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_socket_scores_match_jax_at_score_dtype(score_dtype, chunk):
    """``soft_scores_factorized`` on 1 x 2 heads x 1024 keys (d 128, L 60,
    P 10), unchunked and in chunks of 256: within SCORE_TOL of JAX's at
    both score dtypes (before the repair the bf16 scores were rounded to
    8 bits before ``exp``: 6.4e-4 of the largest score off), and the
    value-aware top-k of the two equal index for index."""
    rng = np.random.default_rng(0)
    kw = dict(num_planes=10, num_tables=60, tau=0.4, score_chunk=chunk,
              score_dtype=score_dtype)
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    keys = rng.standard_normal((1, 2, 1024, 128)).astype(np.float32)
    vals = rng.standard_normal((1, 2, 1024, 128)).astype(np.float32)
    w = rng.standard_normal((60, 10, 128)).astype(np.float32)
    q = rng.standard_normal((1, 2, 128)).astype(np.float32)
    side = jsk.precompute_key_hashes(jc, jnp.asarray(w), jnp.asarray(keys),
                                     jnp.asarray(vals))
    u = np.asarray(jsk.soft_hash_query(jnp.asarray(w), jnp.asarray(q)))
    js = np.asarray(jsk.soft_scores_factorized(jc, side.bits, jnp.asarray(u)))
    tbits = _tb(np.asarray(side.bits).view(np.int32))
    ts = tsk.soft_scores_factorized(tc, tbits, _tb(u))
    assert ts.dtype == torch.float32 and ts.shape == (1, 2, 1024)
    np.testing.assert_allclose(ts.numpy(), js, **SCORE_TOL)
    vnorm = np.asarray(side.vnorm)
    k = jsk.topk_budget(jc, 1024)
    ji, jm = jsk.value_aware_topk(jc, jnp.asarray(js), jnp.asarray(vnorm),
                                  k=k, length=1024, n_total=1024)
    ti, tm = tsk.value_aware_topk(tc, ts, _tb(vnorm), k=k, length=1024,
                                  n_total=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# ------------------------------------------------------ launch/specs.py

@pytest.mark.parametrize("shape", sorted(jspecs.SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_dryrun_model_config_matches_jax(arch, shape):
    """Every field the two configs share, the nested ``socket``,
    ``quest`` and ``serving`` settings included, is equal; the shape
    specs are equal field for field."""
    assert set(tspecs.SHAPES) == set(jspecs.SHAPES)
    assert dataclasses.asdict(tspecs.SHAPES[shape]) == \
        dataclasses.asdict(jspecs.SHAPES[shape])
    jc = jspecs.dryrun_model_config(jget(arch), jspecs.SHAPES[shape])
    tc = tspecs.dryrun_model_config(tget(arch), tspecs.SHAPES[shape])
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    shared = set(jd) & set(td)
    assert set(td) == set(jd) == shared
    for name in shared:
        assert td[name] == jd[name], name
    assert (td["decode_cp_axes"], td["decode_cp_batch_axes"]) == \
        (jd["decode_cp_axes"], jd["decode_cp_batch_axes"])
    assert (tc.param_dtype, tc.compute_dtype, tc.socket.score_dtype,
            tc.socket.score_chunk) == ("bfloat16", "bfloat16", "bfloat16",
                                       16384)


# ---------------------------------------------- core: hashing and scores

def test_hashing_and_soft_hash_at_bf16():
    """bf16 keys and values: the packed bits equal JAX's (both hash the
    keys cast to float32) outside the float32 zero band, the bf16 value
    norms equal; the soft hash of a bf16 query within the float32 soft
    hash tolerance; bf16 scores of the bits in chunks of 64 within
    SCORE_TOL and the top-k equal."""
    rng = np.random.default_rng(1)
    kw = dict(num_planes=10, num_tables=60, tau=0.4, score_chunk=64,
              score_dtype="bfloat16")
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    keys = bf(rng.standard_normal((2, 2, 256, 64)))
    vals = bf(rng.standard_normal((2, 2, 256, 64)))
    w = rng.standard_normal((60, 10, 64)).astype(np.float32)
    q = bf(rng.standard_normal((2, 2, 64)))
    js = np.asarray(jh.hash_keys_signs(jnp.asarray(w), keys))
    ts = th.hash_keys_signs(_tb(w), _tb(keys)).numpy()
    k64 = _f(keys).astype(np.float64)
    proj = np.einsum("...nd,lpd->...nlp", k64, w.astype(np.float64))
    mag = np.einsum("...nd,lpd->...nlp", np.abs(k64),
                    np.abs(w).astype(np.float64))
    band = np.abs(proj) <= 1e-5 * mag
    np.testing.assert_array_equal(ts[~band], js[~band])
    side = jsk.precompute_key_hashes(jc, jnp.asarray(w), keys, vals)
    tside = tsk.precompute_key_hashes(tc, _tb(w), _tb(keys), _tb(vals))
    assert tside.vnorm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_words(tside.vnorm), _words(side.vnorm))
    jbits = np.asarray(side.bits).view(np.int32)
    same = (tside.bits.numpy() == jbits).all(-1)
    assert same.mean() > 0.99
    ju = np.asarray(jsk.soft_hash_query(jnp.asarray(w), q))
    tu = tsk.soft_hash_query(_tb(w), _tb(q))
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-5, atol=4e-6)
    jsc = np.asarray(jsk.soft_scores_factorized(jc, side.bits,
                                                jnp.asarray(ju)))
    tsc = tsk.soft_scores_factorized(tc, _tb(jbits), _tb(ju))
    np.testing.assert_allclose(tsc.numpy(), jsc, **SCORE_TOL)


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_layers_at_bf16(activation):
    """Norms (float32 inside, bf16 out), rope, the SwiGLU/GeGLU MLP, the
    embedding (its sqrt(d) scale rounded to bf16 first, as JAX rounds it:
    d 48, where sqrt(d) is not a bf16 value) and the head, on bf16
    weights and inputs: bf16 outputs within the bf16 policy of JAX's."""
    kw = dict(mlp_activation=activation, d_model=48, num_heads=3,
              num_kv_heads=3)
    jc, tc = _dry("stablelm-12b", **kw)
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    x = bf(rng.standard_normal((2, 5, 48)))
    scale = rng.standard_normal(48).astype(np.float32)
    out = tlayers.rmsnorm({"scale": _tb(scale)}, _tb(x))
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _bf16_close(out, ref)
    xh = bf(rng.standard_normal((2, 5, 3, 16)))
    pos = np.stack([np.arange(5), np.arange(100, 105)]).astype(np.int32)
    out = tlayers.apply_rope(_tb(xh), _tb(pos), 500_000.0)
    ref = jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 500_000.0)
    _bf16_close(out, ref)
    mlp = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jlayers.init_mlp(jc, jax.random.PRNGKey(1))))
    out = tlayers.apply_mlp(tc, {k: _tb(v) for k, v in mlp.items()}, _tb(x))
    ref = jlayers.apply_mlp(jc, mlp, jnp.asarray(x))
    assert out.dtype == torch.bfloat16
    _bf16_close(out, ref)
    emb = jax.tree_util.tree_map(np.asarray, pm.unbox(
        jlayers.init_embedding(jc, jax.random.PRNGKey(2))))
    temb = {k: _tb(v) for k, v in emb.items()}
    toks = rng.integers(0, 256, (2, 5))
    out = tlayers.embed_tokens(tc, temb, _tb(toks))
    ref = jlayers.embed_tokens(jc, emb, jnp.asarray(toks))
    np.testing.assert_array_equal(_words(out), _words(ref))
    out = tlayers.lm_head(tc, temb, _tb(x))
    ref = jlayers.lm_head(jc, emb, jnp.asarray(x))
    _bf16_close(out, ref)


# ---------------------------------------------------------- attention

def _attn_params(jc, seed):
    from repro.models import attention as jattn
    jp = pm.unbox(jattn.init_attention(jc, jax.random.PRNGKey(seed)))
    return jp, jax.tree_util.tree_map(lambda a: _tb(np.asarray(a)), jp)


def _bf(rng, shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_attention_train_at_bf16(q_chunk):
    """Whole-sequence attention on bf16 q/k/v (the softmax in float32, as
    JAX's), global unchunked and in query chunks of 8 (``attn_q_chunk``),
    and under a 5-token window: bf16 outputs within the bf16 policy."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jc, tc = _dry("llama31-8b", attn_q_chunk=q_chunk)
    jp, tp = _attn_params(jc, 3)
    rng = np.random.default_rng(3)
    x = _bf(rng, (2, 32, 64))
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    for attn_type, window in (("global", 1024), ("local", 5)):
        jcw, tcw = (c.replace(sliding_window=window) for c in (jc, tc))
        out = tattn.attention_train(tcw, tp, _tb(x), _tb(pos), attn_type)
        ref = jax.jit(lambda x, p: jattn.attention_train(
            jcw, jp, x, p, attn_type))(jnp.asarray(x), jnp.asarray(pos))
        assert out.dtype == torch.bfloat16
        _bf16_close(out, ref)


@pytest.mark.parametrize("backend", ["socket", "hard_lsh", "quest",
                                     "dense"])
def test_global_prefill_and_decode_at_bf16(backend):
    """One global layer on the static path: the whole-prompt prefill (the
    ``flash_prefill`` op's plain version on bf16 q/k/v) and the cache it
    builds (bf16 K/V; SOCKET's bits bit for bit, its bf16 value norms
    equal; Quest's page bounds), then three decode steps through the
    backend on the contiguous cache: outputs within the bf16 policy, caches
    within the bf16 policy (bits equal)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jc, tc = _dry("llama31-8b", backend)
    if backend == "socket":
        jc = jc.replace(socket=dataclasses.replace(
            jc.socket, use_score_kernel=True, use_flash_decode=True))
    jp, tp = _attn_params(jc, 4)
    rng = np.random.default_rng(4)
    x = _bf(rng, (2, 40, 64))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jy, jcache = jax.jit(lambda x, p: jattn.attention_prefill(
        jc, jp, x, p, "global", 48))(jnp.asarray(x), jnp.asarray(pos))
    ty, tcache = tattn.attention_prefill(tc, tp, _tb(x), _tb(pos).long(),
                                         "global", 48)
    _bf16_close(ty, jy)

    def caches_close():
        assert set(tcache) == set(jcache)
        for name, leaf in jcache.items():
            t = tcache[name]
            if name == "bits":
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(leaf).view(np.int32))
            else:
                assert t.dtype == getattr(torch, str(leaf.dtype)), name
                _bf16_close(t, leaf, name)
    caches_close()
    jdecode = jax.jit(lambda x, c, p: jattn.attention_decode(
        jc, jp, x, c, p, "global"))
    for step in (40, 41, 42):
        xd = _bf(rng, (2, 1, 64))
        jy, jcache = jdecode(jnp.asarray(xd), jcache, jnp.int32(step))
        ty, tcache = tattn.attention_decode(tc, tp, _tb(xd), tcache, step,
                                            "global")
        _bf16_close(ty, jy)
    caches_close()


@pytest.mark.parametrize("ring_kernel", [False, True])
def test_local_chunk_and_ring_decode_at_bf16(ring_kernel):
    """gemma3's local layer at bf16 on the continuous engine's pool:
    three chunks of 16 against bf16 pages (the last padded), then a ragged
    decode step through the RingView (plain masked softmax, or the ring
    kernel's plain version on a bf16 query) with an idle slot: outputs
    and pages within the bf16 policy."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jc, tc = _dry("gemma3-27b", attn_logit_softcap=30.0,
                  use_ring_kernel=ring_kernel)
    jp, tp = _attn_params(jc, 1)
    rng = np.random.default_rng(8)
    pools = {n: _bf(rng, (12, 2, 8, 16)) for n in ("k", "v")}
    jpool = {n: jnp.asarray(a) for n, a in pools.items()}
    tpool = {n: _tb(a) for n, a in pools.items()}
    bt_row = np.array([3, 9, 5, 1, 0, 0, 0, 0, 0, 0], np.int32)
    jchunk = jax.jit(lambda x, p, c, bt, h, li:
                     jattn.attention_prefill_chunk(jc, jp, x, p, "local", c,
                                                   bt, h, li))
    for history, last in ((0, 15), (16, 15), (32, 9)):
        x = _bf(rng, (1, 16, 64))
        pos = (history + np.arange(16))[None].astype(np.int32)
        jy, jpool = jchunk(jnp.asarray(x), jnp.asarray(pos), jpool,
                           jnp.asarray(bt_row), jnp.int32(history),
                           jnp.asarray([last]))
        ty, tpool = tattn.attention_prefill_chunk(
            tc, tp, _tb(x), _tb(pos).long(), "local", tpool, _tb(bt_row),
            history, last)
        _bf16_close(ty[:, :last + 1], _f(jy)[:, :last + 1])
        for n in ("k", "v"):
            assert tpool[n].dtype == torch.bfloat16
            _bf16_close(tpool[n], jpool[n], n)
    bt = np.stack([bt_row[:8], [7, 2, 11, 4, 0, 0, 0, 0], [0] * 8]).astype(
        np.int32)
    pos = np.array([42, 3, 0], np.int32)
    xd = _bf(rng, (3, 1, 64))
    jy, jpool = jax.jit(lambda x, c, p, b: jattn.attention_decode(
        jc, jp, x, c, p, "local", block_tables=b))(
            jnp.asarray(xd), jpool, jnp.asarray(pos), jnp.asarray(bt))
    ty, tpool = tattn.attention_decode(tc, tp, _tb(xd), tpool,
                                       _tb(pos).long(), "local",
                                       block_tables=_tb(bt))
    _bf16_close(ty[:2], _f(jy)[:2])
    for n in ("k", "v"):
        _bf16_close(tpool[n][1:], _f(jpool[n])[1:], n)


# ------------------------------------------ K/V pages and quantization

@pytest.mark.parametrize("kv_dtype", ["auto", "bf16", "int8", "fp8"])
def test_pool_leaves_and_quantized_rows_at_bf16(kv_dtype):
    """At bf16 compute the pool's leaves carry JAX's dtypes and shapes
    for every backend (``auto`` pages bf16, SOCKET's value norms bf16,
    Quest's bounds float32); int8 and fp8 pages quantize bf16 rows to
    JAX's payloads and scales bit for bit."""
    from repro.models.backends import kvquant as jkv
    from repro.serving import paged as jpaged
    from repro_torch.models.backends import kvquant as tkv
    from repro_torch.serving import paged as tpaged
    for backend in ("socket_fused", "hard_lsh_fused", "quest_fused",
                    "dense"):
        if kv_dtype == "fp8" and backend == "dense":
            continue
        jc, tc = _dry("llama31-8b", backend)
        jc, tc = (c.replace(serving=c.serving.replace(kv_dtype=kv_dtype))
                  for c in (jc, tc))
        jpool = jpaged.init_paged_caches(jc, jc.serving)
        tpool = tpaged.init_paged_caches(tc, tc.serving)
        jlayer = jpool["groups"]["slot_0"]
        for name, leaf in jlayer.items():
            t = tpool[0][name]
            assert tuple(t.shape) == tuple(leaf.shape[1:]), (backend, name)
            want = jnp.dtype(leaf.dtype).name   # bits: the port's int32
            assert str(t.dtype).replace("torch.", "") == \
                want.replace("uint32", "int32"), (backend, name)
        if kv_dtype == "auto":
            assert tpool[0]["k"].dtype == torch.bfloat16
    if kv_dtype in ("int8", "fp8"):
        rng = np.random.default_rng(0)
        scale = np.exp(rng.uniform(np.log(1e-3), np.log(50.0), (512, 1)))
        x = _bf(rng, (512, 128)) * np.asarray(
            jnp.asarray(scale, jnp.bfloat16))
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
        jq, js = jkv.quantize(jnp.asarray(x), kv_dtype)
        tq, ts = tkv.quantize(_tb(x), kv_dtype)
        tq8 = tq.view(torch.uint8) if kv_dtype == "fp8" else tq
        np.testing.assert_array_equal(tq8.numpy().view(np.uint8),
                                      np.asarray(jq).view(np.uint8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------- Mamba and MoE

def test_mamba_at_bf16():
    """Mamba-2 on bf16 weights and inputs, JAX's float32 islands kept
    (``A_log``, ``dt_bias``, ``D``, the scan and the state, the gated
    norm): ``mamba_train``'s bf16 output and float32 state, then five
    ``mamba_decode`` steps, within the bf16 policy of JAX's."""
    from repro.models import mamba as jmb
    from repro_torch.models import mamba as tmb
    jc, tc = _dry("mamba2-780m")
    jp = pm.unbox(jmb.init_mamba(jc, jax.random.PRNGKey(0)))
    tp = {k: _tb(np.asarray(v)) for k, v in jp.items()}
    for name in ("A_log", "dt_bias", "D"):
        assert tp[name].dtype == torch.float32, name
    assert tp["in_proj"].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    x = _bf(rng, (2, 37, jc.d_model))
    jy, jst = jax.jit(lambda p, x: jmb.mamba_train(
        jc, p, x, return_state=True))(jp, jnp.asarray(x[:, :32]))
    jdecode = jax.jit(lambda p, x, st: jmb.mamba_decode(jc, p, x, st))
    ty, tst = tmb.mamba_train(tc, tp, _tb(x[:, :32]), return_state=True)
    assert ty.dtype == torch.bfloat16 and tst["ssm"].dtype == torch.float32
    _bf16_close(ty, jy)
    for i in range(32, 37):
        for name in ("ssm", "conv"):
            assert tst[name].dtype == getattr(torch, str(jst[name].dtype))
            _bf16_close(tst[name], jst[name], name)
        jy, jst = jdecode(jp, jnp.asarray(x[:, i:i + 1]), jst)
        ty, tst = tmb.mamba_decode(tc, tp, _tb(x[:, i:i + 1]), tst)
        _bf16_close(ty, jy)


@pytest.mark.parametrize("dispatch", ["global", "batch"])
def test_moe_at_bf16(dispatch):
    """The MoE FFN on bf16 experts with JAX's float32 router: the expert
    indices equal JAX's (the router's logits in float32 from bf16 inputs),
    the bf16 output within the bf16 policy, dropping (capacity factor 0.6) and
    dropless at decode."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jc, tc = _dry("llama4-maverick-400b-a17b", moe_dispatch=dispatch,
                  capacity_factor=0.6)
    jp = pm.unbox(jmoe.init_moe(jc, jax.random.PRNGKey(0)))
    tp = {k: _tb(np.asarray(v)) for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    jrouter = jax.jit(lambda p, x: jmoe._router(jc, p, x)[0])
    jmoe_fn = jax.jit(lambda p, x: jmoe.apply_moe(jc, p, x)[0])
    for shape in ((3, 16, jc.d_model), (4, 1, jc.d_model)):
        x = _bf(rng, shape)
        ji = jrouter(jp, jnp.asarray(x.reshape(-1, shape[2])))
        ti, _, _ = tmoe._router(tc, tp, _tb(x.reshape(-1, shape[2])))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        jy = jmoe_fn(jp, jnp.asarray(x))
        ty, _ = tmoe.apply_moe(tc, tp, _tb(x))
        assert ty.dtype == torch.bfloat16
        _bf16_close(ty, jy)


# ------------------------------------- the model and the static launcher

def _teacher_check(tl, jl, label, tol=LOGITS_TOL):
    """Logits of one step within ``tol``, and the same argmax wherever
    JAX's top-2 margin exceeds twice the tolerance; returns the rows whose
    JAX margin is a near-tie."""
    t, j = _f(tl).reshape(-1, tl.shape[-1]), _f(jl).reshape(
        -1, jl.shape[-1])
    np.testing.assert_allclose(t, j, err_msg=label, **tol)
    top2 = np.sort(j, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol["atol"]
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear],
                                  err_msg=label)
    return ~clear


def _f32_prefill(jc, jp, prompt, capacity):
    """JAX's prefill caches of the same (bf16-valued) weights at float32."""
    jc32 = jc.replace(param_dtype="float32", compute_dtype="float32")
    jp32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jp)
    return jax.jit(lambda p, b: jtfm.prefill(jc32, p, b, capacity=capacity))(
        jp32, {"tokens": jnp.asarray(prompt)})[1]


MODEL_CASES = [("llama31-8b", b) for b in ("socket", "hard_lsh", "quest",
                                           "dense")] + [
    ("jamba-v0.1-52b", "socket"), ("llama4-maverick-400b-a17b", "socket")]


def _bits_close(tbits, jbits, keys, hash_w, label):
    """Packed SOCKET bits equal to JAX's wherever the key's projection is
    clear of the band its K row's tolerance allows: the two sides' bf16 K
    rows agree within the bf16 policy (2**-6 of the row's largest
    magnitude), which moves a projection by up to 2**-6 max|k| sum|w|.
    keys (G, ..., S, hd) and hash_w (G, L, P, hd)."""
    l, p = hash_w.shape[-3:-1]
    ts, js = (th.unpack_signs(torch.from_numpy(
        np.array(b, copy=True).view(np.int32)), l, p).numpy()
        for b in (tbits, jbits))
    k64, w64 = _f(keys).astype(np.float64), _f(hash_w).astype(np.float64)
    proj = np.einsum("g...nd,glpd->g...nlp", k64, w64)
    reach = np.einsum("g...n,glp->g...nlp", np.abs(k64).max(-1),
                      np.abs(w64).sum(-1))
    band = np.abs(proj) <= BF16_RTOL * reach
    np.testing.assert_array_equal(ts[~band], js[~band], err_msg=label)
    live = np.broadcast_to((np.abs(k64).max(-1) > 0)[..., None, None],
                           band.shape)
    assert band[live].mean() < 0.1, (label, band[live].mean())


# MoE routes at bf16: a token whose router probabilities at the choice
# boundary (the k-th and (k+1)-th largest) lie within ROUTE_BAND (relative
# to the k-th) of each other may go to other experts on the two sides, as
# their bf16 hidden states differ by roundings (jamba's by ~2 % after its
# Mamba layers: a swap at a gap of 6.5 % measured); elsewhere routes are
# equal
ROUTE_BAND = 2 ** -3


@contextlib.contextmanager
def _jax_routes_shared(swapped):
    """While active, JAX's router calls record their expert choices (in
    execution order) and each of the port's router calls pairs, in order,
    with one of them: where the choices differ only at tokens inside
    ROUTE_BAND, the port takes JAX's experts, weighted by its own
    probabilities (the count of such tokens is appended to ``swapped``);
    any other difference raises.  Call ``jax.effects_barrier()`` after a
    JAX call before the port's."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jrouter, trouter = jmoe._router, tmoe._router
    recorded = []

    def record(cfg, params, x2d):
        idx, probs, aux = jrouter(cfg, params, x2d)
        jax.debug.callback(lambda i: recorded.append(np.array(i)), idx,
                           ordered=True)
        return idx, probs, aux

    def shared(cfg, params, x2d):
        idx, probs, aux = trouter(cfg, params, x2d)
        jidx = torch.from_numpy(recorded.pop(0)).to(idx.dtype)
        diff = (torch.sort(idx, -1).values !=
                torch.sort(jidx, -1).values).any(-1)
        if not bool(diff.any()):
            return idx, probs, aux
        full = torch.softmax(x2d.float() @ params["router"].float(), -1)
        k = cfg.num_experts_per_tok
        top = torch.sort(full[diff], -1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        assert bool((gap <= ROUTE_BAND * top[:, k - 1]).all()), gap
        swapped.append((int(diff.sum()),
                        float((gap / top[:, k - 1]).max())))
        p = full.gather(-1, jidx)
        return jidx, p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9), aux

    with mock.patch.object(jmoe, "_router", record), \
            mock.patch.object(tmoe, "_router", shared):
        yield
    assert not recorded, f"{len(recorded)} JAX routings left unpaired"


@pytest.mark.parametrize("arch,backend", MODEL_CASES)
def test_model_prefill_and_decode_at_bf16(arch, backend):
    """The smoke model at ``dryrun_model_config``'s numerics: ``prefill``'s
    bf16 logits within LOGITS_TOL and its caches (K/V and Mamba state in
    the bf16 policy, SOCKET bits outside the bf16 band bit for bit), then
    six ``decode_step``s teacher-forced along JAX's greedy tokens, each
    step's logits within LOGITS_TOL and argmax equal outside near-ties;
    MoE routes paired inside ROUTE_BAND.  For SOCKET on llama31-8b (the
    contiguous kernels' plain versions), the static launcher
    ``run_serve`` too: its greedy tokens equal JAX ``run_serve``'s up to
    the first near-tie of that row."""
    from repro.launch.serve import run_serve as j_run_serve
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.weights import caches_to_numpy
    jc, tc = _dry(arch, backend)
    if backend == "socket":
        jc = jc.replace(socket=dataclasses.replace(
            jc.socket, use_score_kernel=True, use_flash_decode=True))
    jp, tp = _params(jc, tc)
    state = any(s.kind == "mamba" for s in tc.layer_specs)
    tol = STATE_LOGITS_TOL if state else LOGITS_TOL
    batch, plen, steps = 2, 24, 6
    prompt = np.random.default_rng(5).integers(
        0, tc.vocab_size, (batch, plen)).astype(np.int32)
    if state:
        f32 = _f32_prefill(jc, jp, prompt, plen + steps)
    swapped = []
    with _jax_routes_shared(swapped):
        jl, jcache = jax.jit(lambda p, b: jtfm.prefill(
            jc, p, b, capacity=plen + steps))(
                jp, {"tokens": jnp.asarray(prompt)})
        jax.effects_barrier()
        tl, tcache = ttfm.prefill(tc, tp, {"tokens": _tb(prompt).long()},
                                  plen + steps)
        assert tl.dtype == torch.bfloat16
        ties = [_teacher_check(tl, jl, "prefill", tol)]
        tn = caches_to_numpy(tc, tcache)
        for slot, leaves in jcache["groups"].items():
            for name, leaf in leaves.items():
                t = tn["groups"][slot][name]
                label = f"{slot}/{name}"
                if name == "bits":
                    _bits_close(t, leaf, leaves["k"],
                                jp["groups"][slot]["attn"]["hash_w"], slot)
                elif state:
                    ref = _f(f32["groups"][slot][name])
                    port, own = (np.abs(_f(a) - ref).max() for a in (t, leaf))
                    assert port <= STATE_F32_RATIO * own, (label, port, own)
                else:
                    _bf16_close(t, leaf, label)
        jstep = jax.jit(lambda p, c, x, i: jtfm.decode_step(jc, p, c, x, i))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))
        for i in range(steps):
            jl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, None]),
                               jnp.int32(plen + i))
            jax.effects_barrier()
            tl, tcache = ttfm.decode_step(tc, tp, tcache,
                                          _tb(tok[:, None]).long(), plen + i)
            ties.append(_teacher_check(tl, jl, f"step {i}", tol))
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))
    if backend != "socket" or arch != "llama31-8b":
        return
    jt, _, _ = j_run_serve(jc, batch, plen, steps, seed=0, prompt=prompt)
    tt, _, _ = run_serve(tc, batch, plen, steps, prompt=prompt, params=tp,
                         device="cpu")
    jt, tt = np.asarray(jt), tt.numpy()
    for r in range(batch):
        tie = [k for k, t in enumerate(ties) if t[r]]
        upto = (tie[0] if tie else len(ties)) + 1
        np.testing.assert_array_equal(tt[r, :upto], jt[r, :upto])


# ------------------------------- the continuous engine and its launcher

@pytest.mark.parametrize("backend", ["socket_fused", "quest_fused"])
def test_continuous_engine_at_bf16(backend, monkeypatch):
    """Both packages' ``run_continuous`` on llama31-8b's smoke at the
    deployment numerics (bf16 pages; the JAX engine's fused Pallas kernel
    in interpret mode, the port's plain version on a bf16 query): the
    port's engine picks JAX's tokens (teacher-forced along JAX's greedy
    path) and every pick's logits, the chunk prefills' and each live
    decode row's, lie within LOGITS_TOL of JAX's, with the same argmax
    outside near-ties; every request finishes with the same iteration
    and chunk counts."""
    from repro.launch import serve as jserve
    from repro.serving import engine as jengine
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import engine as tengine
    jc, tc = _dry("llama31-8b", backend)
    jlogits, tlogits = [], []

    class Recording(jengine.ContinuousBatchingEngine):
        def _pick(self, logits, keys):
            jax.debug.callback(
                lambda x: jlogits.append(np.array(x, np.float32)),
                logits[:, -1].astype(jnp.float32), ordered=True)
            return super()._pick(logits, keys)

    class TeacherForced(tengine.ContinuousBatchingEngine):
        def _pick(self, logits, reqs=()):
            i = len(tlogits)
            live = [r is not None for r in reqs] if len(reqs) > 1 else [True]
            tlogits.append((_f(logits[:, -1]), live))
            return torch.from_numpy(jlogits[i].argmax(-1))

    args = dict(num_requests=3, rate_rps=1.0, prompt_lens=[9, 26, 44],
                max_new_tokens=5, seed=0, realtime=False)
    monkeypatch.setattr(jengine, "ContinuousBatchingEngine", Recording)
    jreqs, jm, jeng = jserve.run_continuous(jc, **args)
    jax.effects_barrier()
    monkeypatch.setattr(tengine, "ContinuousBatchingEngine", TeacherForced)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jeng.params))
    treqs, tm, _ = tserve.run_continuous(tc, params=tp, device="cpu", **args)
    assert len(tlogits) == len(jlogits) > 2 * len(treqs)
    for i, ((t, live), j) in enumerate(zip(tlogits, jlogits)):
        rows = np.flatnonzero(live)
        _teacher_check(torch.from_numpy(t[rows]), j[rows], f"pick {i}")
    for j, t in zip(jreqs, treqs):
        assert len(t.generated) == 5 and t.generated == j.generated
    assert (tm.decode_iters, tm.prefill_chunks) == (jm.decode_iters,
                                                    jm.prefill_chunks)


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
def test_sample_tokens_on_bf16_logits(top_p):
    """The sampler on a bf16 model's logits (bf16 values: more exact ties
    at a top-p cutoff than float32's) fed JAX's Gumbel noise gives the
    JAX sampler's tokens on the same logits, over 20 draws of each row,
    the padded vocabulary's tail never drawn."""
    from repro.serving import sampling as jsampling
    from repro_torch.serving import sampling
    rng = np.random.default_rng(7)
    logits = np.array(jnp.asarray(
        rng.normal(size=(6, 48)) * 3, jnp.bfloat16))
    logits[:, 40:] = 30.0                       # the padded tail
    keys = jsampling.slot_keys(5, 6)
    for _ in range(20):
        jtok, keys_next = jsampling.sample_tokens(
            jnp.asarray(logits), keys, temperature=0.8, top_p=top_p,
            vocab_size=40)
        use = jax.vmap(jax.random.split)(keys)[:, 1]
        noise = np.stack([np.array(jax.random.gumbel(k, (48,), jnp.float32))
                          for k in use])
        tok = sampling.sample_tokens(_tb(logits), torch.from_numpy(noise),
                                     temperature=0.8, top_p=top_p,
                                     vocab_size=40)
        assert tok.tolist() == np.asarray(jtok).tolist()
        assert int(tok.max()) < 40
        keys = keys_next
