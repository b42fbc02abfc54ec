"""Port parity for the causal flash-attention prefill: the wrapper's plain
PyTorch version (what a CPU tensor runs) against the JAX package's
Pallas kernel in interpret mode and its jnp oracle on the kernel
harness's cases, GQA and ragged S, and the model's whole-prompt
attention (``attention_train``, softcapped too, ``attention_prefill``
with ``last_index`` and ``paged``), which now goes through it, against
the JAX package on the same numpy inputs.

Tolerances: the harness's flash_prefill policy, atol 1e-5 (bf16 inputs
3e-2: the two frameworks round bf16 products at other places); the model
outputs rtol 1e-5 / atol 1e-4 (float32 projections in another summation
order, values up to ~10), the rings' K/V the same.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_kernels as jk
from repro.configs import get_config as jget
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.kernels.flash_prefill import flash_prefill_ref as j_ref
from repro.kernels.flash_prefill.flash_prefill import flash_prefill_pallas
from repro.models import attention as jattn
from repro.models import param as pm
from repro_torch.configs import get_config as tget
from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.models import attention as tattn

ATOL, BF16_ATOL = 1e-5, 3e-2
TOL = dict(rtol=1e-5, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _harness_cases():
    op = next(o for o in jk.KERNEL_OPS if o.name == "flash_prefill")
    return {c.label: c.kwargs for c in op.cases}


def _inputs(seed, bh, bkv, s, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((bh, s, hd), (bkv, s, hd), (bkv, s, hd))]


@pytest.mark.parametrize("label", ["s512", "s1024", "window-128",
                                   "bf16-window", "non-pow2-seq"])
def test_plain_matches_pallas_and_oracle(label):
    """The harness's five cases (block 128 Pallas, interpret mode), each
    through the wrapper's CPU route whole and query-chunked."""
    kw = _harness_cases()[label]
    bh, s, hd, window = kw["bh"], kw["s"], kw["hd"], kw["window"]
    bf16 = kw["dtype"] == jnp.bfloat16
    arrays = _inputs(s + hd + window, bh, bh, s, hd)
    jx = [jnp.asarray(a, kw["dtype"]) for a in arrays]
    tx = [_t(a).to(torch.bfloat16 if bf16 else torch.float32)
          for a in arrays]
    scale = 1 / np.sqrt(hd)
    pallas = np.asarray(j_flash_prefill(*jx, scale=scale, window=window,
                                        block_q=128, block_k=128))
    oracle = np.asarray(j_ref(*jx, scale=scale, window=window))
    atol = BF16_ATOL if bf16 else ATOL
    before = ops.LAUNCHES
    for q_chunk in (0, 96):
        out = ops.flash_prefill(*tx, scale=scale, window=window,
                                q_chunk=q_chunk)
        assert out.dtype == torch.float32 and out.shape == (bh, s, hd)
        np.testing.assert_allclose(out.numpy(), pallas, rtol=0, atol=atol)
        np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=atol)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("window", [0, 50])
def test_plain_gqa_matches_oracle_on_repeated_kv(window):
    """G = 4: q row ``bh`` reads K/V row ``bh // 4`` (a wrong head order
    would pass at G = 1), against the JAX oracle on K/V repeated to the
    query heads."""
    q, k, v = _inputs(3, 8, 2, 160, 32)
    out = ops.flash_prefill(_t(q), _t(k), _t(v), scale=0.2, window=window,
                            q_chunk=64)
    ref = j_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, 4, 0)),
                jnp.asarray(np.repeat(v, 4, 0)), scale=0.2, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_plain_takes_ragged_s_the_pallas_kernel_refuses():
    """S = 200 is no multiple of 128-row blocks: the Pallas kernel raises;
    the plain version (and the CUDA kernel, whose last tiles are ragged)
    takes it, equal to the oracle."""
    q, k, v = _inputs(4, 2, 2, 200, 64)
    with pytest.raises(ValueError, match="multiple"):
        flash_prefill_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=0.125, block_q=128, block_k=128)
    for window in (0, 77):
        out = flash_prefill_ref(_t(q), _t(k), _t(v), scale=0.125,
                                window=window, q_chunk=64)
        ref = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    scale=0.125, window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


def test_plain_computes_in_f64_for_f64_inputs():
    """f64 inputs stay f64 through the plain version (the float64
    yardstick of the card's layer-by-layer prefill gate), equal to the
    JAX oracle run in float64 on the CPU's numpy values; f32 inputs
    give f32."""
    q, k, v = (a.astype(np.float64) for a in _inputs(9, 8, 2, 70, 32))
    kw = dict(scale=0.3, window=20, q_chunk=32)
    out = flash_prefill_ref(_t(q), _t(k), _t(v), **kw)
    assert out.dtype == torch.float64
    f32 = flash_prefill_ref(_t(q).float(), _t(k).float(), _t(v).float(),
                            **kw)
    assert f32.dtype == torch.float32
    ref = _dense_softmax_f64(q, np.repeat(k, 4, 0), np.repeat(v, 4, 0),
                             0.3, 20)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(f32.numpy(), ref, rtol=0, atol=ATOL)


def _dense_softmax_f64(q, k, v, scale, window):
    """The causal windowed attention in numpy float64, no chunks."""
    s = q.shape[1]
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = (j <= i) & (i - j < window)
    logits = np.where(keep, np.einsum("bqd,bkd->bqk", q, k) * scale, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bqk,bkd->bqd", w / w.sum(-1, keepdims=True), v)


def _attention_params(jc, seed):
    jp = pm.unbox(jattn.init_attention(jc, jax.random.PRNGKey(seed)))
    tp = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jp)
    return jp, tp


@pytest.mark.parametrize("arch,attn_type,q_chunk", [
    ("llama31-8b", "global", 0), ("llama31-8b", "global", 16),
    ("gemma3-27b", "global", 0), ("gemma3-27b", "local", 16)])
def test_attention_train_through_the_op_matches_jax(arch, attn_type,
                                                    q_chunk):
    """The model's whole-prompt attention: projections, the head layout
    of the op's rows (GQA: llama 4 q heads on 2 KV heads smoke) and the
    merge, against the JAX package's XLA path; gemma3's local layers
    pass their 32-token window (T 48 > window)."""
    jc = jget(arch).smoke().replace(attn_q_chunk=q_chunk)
    tc = tget(arch).smoke().replace(attn_q_chunk=q_chunk)
    assert tc.attn_logit_softcap == 0
    jp, tp = _attention_params(jc, 5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48), (2, 48)).astype(np.int32)
    before = ops.LAUNCHES
    out = tattn.attention_train(tc, tp, _t(x), _t(pos).long(), attn_type)
    ref = jattn.attention_train(jc, jp, jnp.asarray(x), jnp.asarray(pos),
                                attn_type)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("attn_type", ["global", "local"])
def test_softcapped_attention_through_the_op_matches_jax(attn_type):
    """A config with ``attn_logit_softcap`` (2.0, small enough to move the
    output) attends through the op too, the cap passed to it, equal to the
    JAX package's capped XLA path and away from the uncapped output."""
    jc = jget("gemma3-27b").smoke().replace(attn_logit_softcap=2.0,
                                            attn_q_chunk=16)
    tc = tget("gemma3-27b").smoke().replace(attn_logit_softcap=2.0,
                                            attn_q_chunk=16)
    jp, tp = _attention_params(jc, 8)
    rng = np.random.default_rng(8)
    x = 3 * rng.standard_normal((2, 48, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48), (2, 48)).astype(np.int32)
    caps = []
    real = ops.flash_prefill

    def spy(*a, **kw):
        caps.append(kw["softcap"])
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_prefill", spy)
        out = tattn.attention_train(tc, tp, _t(x), _t(pos).long(),
                                    attn_type)
    assert caps == [2.0]
    ref = jattn.attention_train(jc, jp, jnp.asarray(x), jnp.asarray(pos),
                                attn_type)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    uncapped = tattn.attention_train(tc.replace(attn_logit_softcap=0.0), tp,
                                     _t(x), _t(pos).long(), attn_type)
    assert np.abs(uncapped.numpy() - np.asarray(ref)).max() > 100 * \
        TOL["atol"]


@pytest.mark.parametrize("attn_type,paged", [
    ("global", False), ("local", False), ("local", True)])
def test_attention_prefill_last_index_and_paged_match_jax(attn_type, paged):
    """``attention_prefill`` of a bucket-padded batch with per-row
    ``last_index`` (gemma3 smoke, window 20 so the paged ring, 3 pages of
    8 = 24 slots, is longer than the window): the output and the cache
    (global: K/V rows; local: the ring built at each row's last real
    token, at ``min(capacity, window)`` or the page-aligned capacity)."""
    jc = jget("gemma3-27b").smoke().replace(sliding_window=20)
    tc = tget("gemma3-27b").smoke().replace(sliding_window=20)
    jp, tp = _attention_params(jc, 6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    li = np.array([39, 26], np.int32)
    jy, jcache = jattn.attention_prefill(
        jc, jp, jnp.asarray(x), jnp.asarray(pos), attn_type, 40,
        last_index=jnp.asarray(li), paged=paged)
    ty, tcache = tattn.attention_prefill(
        tc, tp, _t(x), _t(pos).long(), attn_type, 40,
        last_index=_t(li).long(), paged=paged)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    if attn_type == "local":
        assert tcache["k"].shape[2] == (24 if paged else 20)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_cpu_tensors_never_reach_nvcc(monkeypatch):
    """The CPU route builds nothing: with nvcc and the library loader
    made to fail, the op and the model's prefill attention still run,
    and no launch is counted."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "nvcc_path", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    before = ops.LAUNCHES
    q, k, v = _inputs(7, 4, 2, 33, 16)
    out = ops.flash_prefill(_t(q), _t(k), _t(v), scale=0.25, window=5)
    assert torch.isfinite(out).all()
    tc = tget("gemma3-27b").smoke()
    jc = jget("gemma3-27b").smoke()
    _, tp = _attention_params(jc, 7)
    x = torch.randn(1, 12, 64, generator=torch.Generator().manual_seed(7))
    y = tattn.attention_train(tc, tp, x, torch.arange(12)[None], "local")
    assert torch.isfinite(y).all()
    assert ops.LAUNCHES == before
