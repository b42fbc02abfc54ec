"""Port parity for the model's training calls: ``attention_train`` (the
``flash_prefill`` op under autograd), ``forward_train`` and
``loss_and_metrics`` with their gradients, against the JAX package's
functions and ``jax.grad`` on the same weights and inputs (numpy-seeded;
the JAX weights carried across with ``from_jax_params``), and
``remat_policy``'s three values against each other.

Tolerances:

* float32: values rtol 1e-5; every gradient leaf within a relative L2
  distance of 1e-4 of JAX's (measured at most 1e-5: another summation
  order in the products and the softmax).
* the autograd function's chunked backward against plain autograd of
  ``flash_prefill_ref``: rtol 1e-5 / atol 1e-6 (the same f32 arithmetic
  in other chunks).
* bf16 (``dryrun_model_config(..., SHAPES["train_4k"])``): the two
  frameworks round to bf16 at other places, so each side's loss and
  gradients are held to a float32 run of the same weights: the port's
  relative L2 distance from it no more than ``BF16_RATIO`` (2) times
  JAX's plus 1e-3, and the two bf16 runs within 0.05 of each other
  (measured 0.019 at most, against bf16's 2**-8 = 0.0039 a rounding).
* ``remat_policy`` ``"full"`` and ``"dots"``: values and gradients equal
  to ``"none"``'s bit for bit (the recomputation repeats the same
  arithmetic).
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.launch import specs as tspecs
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.weights import from_jax_params

B, T = 2, 48
GRAD_RTOL = 1e-4
BF16_RATIO = 2.0


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: smoke widths gain nothing from more, and
    under a parallel runner every worker's pool fights for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32))
        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x), tree)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lab = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lab[0, :5] = -1                                   # padding labels
    return tok, lab


def _key(x):
    """The batch entry of inputs ``x``: token ids, or an embeddings-input
    model's embeddings (floats)."""
    return "tokens" if x.dtype.kind in "iu" else "embeds"


def _jax_loss_grads(jc, jp, tok, lab):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_and_metrics(
            jc, p, {_key(tok): jnp.asarray(tok), "labels": jnp.asarray(lab)}),
        has_aux=True))
    (loss, metrics), grads = fn(jp)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss_grads(tc, tp, tok, lab):
    """The port's loss, metrics and {path: grad} (hash planes excluded:
    never trained)."""
    tracked = []

    def req(t, path=""):
        if isinstance(t, dict):
            return {k: req(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [req(v, f"{path}/{i}") for i, v in enumerate(t)]
        if path.endswith("hash_w"):
            return t
        t = t.detach().clone().requires_grad_()
        tracked.append((path, t))
        return t

    params = req(tp)
    x = torch.from_numpy(tok)
    loss, metrics = ttfm.loss_and_metrics(
        tc, params, {_key(tok): x.long() if _key(tok) == "tokens" else x,
                     "labels": torch.from_numpy(lab).long()})
    grads = torch.autograd.grad(loss, [t for _, t in tracked])
    return float(loss.detach()), {k: float(v.detach()) for k, v in
                                   metrics.items()}, {
        path: g for (path, _), g in zip(tracked, grads)}


def _setup(arch, numerics="f32", **kw):
    jc, tc = jget(arch).smoke().replace(**kw), tget(arch).smoke().replace(
        **kw)
    if numerics == "bf16":
        jc = jspecs.dryrun_model_config(jc, jspecs.SHAPES["train_4k"])
        tc = tspecs.dryrun_model_config(tc, tspecs.SHAPES["train_4k"])
    jp = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))
    return jc, tc, jp


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("window,softcap,q_chunk", [
    (0, 0.0, 0), (0, 0.0, 20), (7, 0.0, 16), (0, 1.5, 0), (5, 2.0, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flash_prefill_function_grads_equal_plain_autograd(window, softcap,
                                                           q_chunk, dtype):
    """The autograd function's chunked backward (GQA, ragged S, query
    chunks that do and do not divide S, windows, softcaps) equals plain
    autograd of ``flash_prefill_ref`` over the whole sequence."""
    rng = np.random.default_rng(3)
    bh, bkv, s, hd = 6, 2, 45, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
                   for shape in ((bh, s, hd), (bkv, s, hd), (bkv, s, hd),
                                 (bh, s, hd)))
    kw = dict(scale=0.7, window=window, softcap=softcap)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fp_ops.flash_prefill(*a, q_chunk=q_chunk, **kw)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashPrefillBackward"
    ga = torch.autograd.grad(out, a, do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = flash_prefill_ref(*b, **kw)
    gb = torch.autograd.grad(ref, b, do)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    for x, y, t in zip(ga, gb, (q, k, v)):
        assert x.dtype == t.dtype and x.shape == t.shape
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_flash_prefill_function_keeps_input_dtypes_at_bf16():
    """bf16 q/k/v: an f32 output, and bf16 gradients within a bf16 ulp
    of plain autograd's in f32 (both round once to bf16; the chunks sum
    in another order)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(
        torch.bfloat16) for shape in ((4, 33, 16), (2, 33, 16), (2, 33, 16)))
    do = torch.from_numpy(rng.standard_normal((4, 33, 16))).float()
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fp_ops.flash_prefill(*a, scale=0.25, q_chunk=8)
    assert out.dtype == torch.float32
    ga = torch.autograd.grad(out, a, do)
    b = [t.float().requires_grad_() for t in (q, k, v)]
    gb = torch.autograd.grad(flash_prefill_ref(*b, scale=0.25), b, do)
    for x, y in zip(ga, gb):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float(), y, rtol=2 ** -8, atol=1e-6)


def test_flash_prefill_without_grad_is_the_plain_op():
    """No input requires grad: no autograd function, the plain op."""
    q = torch.randn(2, 9, 16)
    with torch.no_grad():
        out = fp_ops.flash_prefill(q.requires_grad_(), q, q, scale=0.5)
    assert out.grad_fn is None


@pytest.mark.parametrize("attn_type,softcap,q_chunk", [
    ("global", 0.0, 0), ("local", 0.0, 0), ("global", 1.0, 16),
    ("local", 2.0, 24)])
def test_attention_train_and_grads_match_jax(attn_type, softcap, q_chunk):
    """``attention_train``'s value and its gradient with respect to x,
    wq, wk, wv and wo equal ``jax.grad`` of JAX's ``attention_train``
    (global, a 32-token window over 48 tokens, softcapped scores, JAX's
    query-chunked scan where the chunk divides T)."""
    kw = dict(attn_logit_softcap=softcap, attn_q_chunk=q_chunk)
    jc = jget("llama31-8b").smoke().replace(**kw)
    tc = tget("llama31-8b").smoke().replace(**kw)
    jp = pm.unbox(jattn.init_attention(jc, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    names = ("wq", "wk", "wv", "wo")

    def jfn(x, *ws):
        p = dict(jp, **dict(zip(names, ws)))
        out = jattn.attention_train(jc, p, x, jnp.asarray(pos), attn_type)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(5)), has_aux=True))(
            jnp.asarray(x), *(jp[n] for n in names))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jgrads = [np.array(g) for g in jgrads]
    xs = torch.from_numpy(x).requires_grad_()
    ws = [tp[n].requires_grad_() for n in names]
    out = tattn.attention_train(tc, tp, xs, torch.from_numpy(pos.copy()),
                                attn_type)
    tgrads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                 [xs] + ws)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for name, tg, jg in zip(("x",) + names, tgrads, jgrads):
        assert float(tg.abs().max()) > 0, name
        assert _rel(tg, torch.from_numpy(jg)) < GRAD_RTOL, name


# ---------------------------------------------------------------- model

def _check_grads(tc, tgrads, jgrads, rtol=GRAD_RTOL):
    jtree = from_jax_params(tc, _np(jgrads))
    seen = 0
    for path, jg in _leaves(jtree):
        if path.endswith("hash_w"):
            # never trained: JAX's gradient is zero, the port takes none
            assert float(np.abs(jg.numpy()).max()) == 0.0, path
            continue
        tg = tgrads[path]
        assert tg.shape == jg.shape, path
        assert _rel(tg, jg) < rtol, (path, _rel(tg, jg))
        seen += 1
    assert seen == len(tgrads)


@pytest.mark.parametrize("arch", ["llama31-8b", "gemma3-27b",
                                  "jamba-v0.1-52b"])
def test_loss_and_grads_match_jax(arch):
    """``loss_and_metrics`` (padding labels masked, the MoE aux losses
    averaged over the MoE layers) and the gradient of every parameter at
    float32: llama31-8b, gemma3's local:global layout with its remainder
    layer, jamba's Mamba and MoE layers."""
    jc, tc, jp = _setup(arch)
    tok, lab = _batch(jc.vocab_size)
    jloss, jm, jg = _jax_loss_grads(jc, jp, tok, lab)
    tloss, tm, tg = _port_loss_grads(tc, from_jax_params(tc, _np(jp)), tok,
                                     lab)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    assert tm["tokens"] == B * T - 5
    if arch.startswith("jamba"):
        assert tm["moe_lb_loss"] > 0
    _check_grads(tc, tg, jg)


def test_loss_and_grads_match_jax_at_bf16():
    """llama31-8b at the deployment's training numerics (bf16 weights and
    compute, ``remat_policy="full"``): each side's loss and gradients
    held to a float32 run of the same weights (see the module
    docstring)."""
    jc, tc, jp = _setup("llama31-8b", "bf16")
    assert tc.remat_policy == "full" and tc.param_dtype == "bfloat16"
    tok, lab = _batch(jc.vocab_size, seed=1)
    jloss, _, jg = _jax_loss_grads(jc, jp, tok, lab)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    tloss, _, tg = _port_loss_grads(tc, tp, tok, lab)
    fc = tc.replace(param_dtype="float32", compute_dtype="float32",
                    remat_policy="none")
    floss, _, fg = _port_loss_grads(fc, from_jax_params(fc, _np(jp)), tok,
                                    lab)
    assert abs(tloss - floss) <= BF16_RATIO * abs(jloss - floss) + 1e-3
    jtree = from_jax_params(tc, _np(jg))
    dtypes = {path: t.dtype for path, t in _leaves(tp)}
    for path, jgl in _leaves(jtree):
        if path.endswith("hash_w"):
            continue
        assert tg[path].dtype == dtypes[path], path
        ref = fg[path]
        d_port, d_jax = _rel(tg[path], ref), _rel(jgl, ref)
        assert d_port <= BF16_RATIO * d_jax + 1e-3, (path, d_port, d_jax)
        assert _rel(tg[path], jgl) < 0.05, path


@pytest.mark.parametrize("arch", ["gemma3-27b", "jamba-v0.1-52b"])
def test_remat_policies_equal(arch):
    """``remat_policy`` "full" and "dots" give "none"'s loss and
    gradients bit for bit (gemma3: two rematerialised groups and a plain
    remainder layer; jamba: Mamba and MoE layers inside the groups)."""
    _, tc, jp = _setup(arch)
    tok, lab = _batch(tc.vocab_size, seed=2)
    tp = from_jax_params(tc, _np(jp))
    base = _port_loss_grads(tc, tp, tok, lab)
    for policy in ("full", "dots"):
        loss, metrics, grads = _port_loss_grads(
            tc.replace(remat_policy=policy), tp, tok, lab)
        assert loss == base[0] and metrics == base[1], policy
        for path, g in grads.items():
            assert torch.equal(g, base[2][path]), (policy, path)


def test_remat_recomputes_the_attention_kernel_op():
    """Under "full" the group's forward runs again in the backward: the
    prefill op is called once more per attention layer."""
    _, tc, jp = _setup("llama31-8b")
    tok, lab = _batch(tc.vocab_size)
    tp = from_jax_params(tc, _np(jp))
    calls = []
    real = fp_ops.flash_prefill

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for policy, expect in (("none", 2), ("full", 4)):
        calls.clear()
        with _patched(tattn.fp_ops, "flash_prefill", counting):
            _port_loss_grads(tc.replace(remat_policy=policy), tp, tok, lab)
        assert len(calls) == expect, policy


def test_unknown_remat_policy_raises():
    _, tc, jp = _setup("llama31-8b")
    tok, lab = _batch(tc.vocab_size)
    with pytest.raises(ValueError, match="bogus"):
        _port_loss_grads(tc.replace(remat_policy="bogus"),
                         from_jax_params(tc, _np(jp)), tok, lab)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)

