"""Port parity for the causal flash-attention prefill: the wrapper's plain
PyTorch version (what a CPU tensor runs) against the JAX package's
Pallas kernel in interpret mode and its jnp oracle on the kernel
harness's cases, GQA and ragged S, and the model's whole-prompt
attention (``attention_train``, softcapped too, ``attention_prefill``
with ``last_index`` and ``paged``), which now goes through it, against
the JAX package on the same numpy inputs.

The CUDA kernel's 3xTF32 arithmetic (its products from TF32 operands,
each f32 value split into a big and a small part) is emulated in torch:
the TF32 rounding, the split's residual, and the whole attention through
it held to ATTN_TOL of the plain op and to F64_RATIO of the plain op's
distance from float64, which one TF32 product alone fails.  (At these
scores the plain op is itself well within ATTN_TOL of float64; at the
full-size model's it is not, and the card holds the kernel to the
float64 version instead: chip_smoke.py.)

Tolerances: the harness's flash_prefill policy, atol 1e-5 (bf16 inputs
3e-2: the two frameworks round bf16 products at other places); the model
outputs rtol 1e-5 / atol 1e-4 (float32 projections in another summation
order, values up to ~10), the rings' K/V the same; the emulation
chip_smoke.py's attention gates, ATTN_TOL rtol 1e-4 / atol 1e-5 and
F64_RATIO 2.
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


# --- the CUDA kernel's 3xTF32 arithmetic, emulated here (the kernel runs
# only on the card).  Gates: every output within ATTN_TOL of the plain
# op, and its largest distance from a float64 version within F64_RATIO
# of the plain op's (chip_smoke.py's tolerances).

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
F64_RATIO = 2.0


def _tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, on the 13 mantissa bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _tf32_mm(a, b, products):
    """``a @ b`` from TF32 operands: 3 products, ``a_small b_big + a_big
    b_small + a_big b_big`` summed small terms first (the kernel's), or
    ``a_big b_big`` alone (1xTF32)."""
    ab, a_small = _split(a)
    bb, b_small = _split(b)
    if products == 1:
        return ab @ bb
    return (a_small @ bb + ab @ b_small) + ab @ bb


def _tf32_prefill(q, k, v, *, scale, window=0, softcap=0.0, products=3):
    """The kernel's function with its arithmetic: S = Q K^T and P V from
    TF32 operands, p = exp(s - max) unnormalized, out = (P V) / sum p."""
    g = q.shape[0] // k.shape[0]
    k, v = (t.float().repeat_interleave(g, 0) for t in (k, v))
    logits = _tf32_mm(q.float(), k.transpose(1, 2), products) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    i = torch.arange(q.shape[1])[:, None]
    j = torch.arange(q.shape[1])[None, :]
    keep = (j <= i) & ((i - j < window) if window > 0 else True)
    logits = torch.where(keep, logits, -1e30)
    p = torch.where(keep, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    return _tf32_mm(p, v, products) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _tol_ratio(out, ref):
    lim = ATTN_TOL["atol"] + ATTN_TOL["rtol"] * ref.abs()
    return ((out.double() - ref).abs() / lim).max().item()


def _gate(out, q, k, v, **kw):
    """The gate's readings: max |out - plain| / (atol + rtol |plain|),
    and max |out - f64| / max |plain - f64|.  It holds when they are
    within 1 and F64_RATIO.  Third, the plain op's own reading from
    float64 in ATTN_TOL units."""
    plain = flash_prefill_ref(q, k, v, **kw).double()
    exact = flash_prefill_ref(q.double(), k.double(), v.double(), **kw)
    f64 = ((out.double() - exact).abs().max() /
           (plain - exact).abs().max()).item()
    return _tol_ratio(out, plain), f64, _tol_ratio(plain, exact)


def _smoke_layer_qkv():
    """q/k/v of llama31-8b's smoke attention (4 query heads on 2 KV heads,
    hd 16) from the JAX package's weights, as the port's whole-prompt
    attention hands them to the op."""
    jc = jget("llama31-8b").smoke()
    tc = tget("llama31-8b").smoke()
    _, tp = _attention_params(jc, 11)
    x = np.random.default_rng(11).standard_normal((2, 256, 64))
    pos = torch.arange(256)[None].expand(2, 256)
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return flash_prefill_ref(q, k, v, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_prefill", spy)
        tattn.attention_train(tc, tp, _t(x.astype(np.float32)), pos,
                              "global")
    (q, k, v, kw), = seen
    return q, k, v, dict(scale=kw["scale"], window=kw["window"],
                         softcap=kw["softcap"])


def _scaled_normal(seed, gain, window=0, softcap=0.0):
    """N(0, 1) q/k/v (BH 8, BKV 2, S 384, hd 128) with q scaled by
    ``gain``: scores of standard deviation ``gain`` rather than N(0,
    1)'s.  Up to 3 the plain op's own float32 error stays within a third
    of ATTN_TOL from float64; from 4 on it nears ATTN_TOL, and on the
    card's llama31-8b layers it is 2.4 to 3 times ATTN_TOL (see
    test_attn_tol_of_the_plain_op_is_float32_noise_at_large_scores)."""
    q, k, v = (_t(a) for a in _inputs(seed, 8, 2, 384, 128))
    return q * gain, k, v, dict(scale=1 / np.sqrt(128), window=window,
                                softcap=softcap)


_SPLIT_CASES = {
    "llama31-8b smoke layer": _smoke_layer_qkv,
    "scores x2": lambda: _scaled_normal(21, 2.0),
    "scores x3": lambda: _scaled_normal(22, 3.0),
    "scores x3, window 100": lambda: _scaled_normal(23, 3.0, window=100),
    "scores x3, softcap 5": lambda: _scaled_normal(24, 3.0, softcap=5.0),
}


def test_tf32_rounding_is_exact_on_bf16_and_rounds_ties_away():
    """Every bf16 value (all 65536 bit patterns) is exact in TF32, so the
    kernel's bf16 inputs need no small part; a tie rounds away from zero,
    as cvt.rna does."""
    bf16 = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    assert torch.equal(_tf32(bf16).view(torch.int32), bf16.view(torch.int32))
    one = 1.0 + 2.0 ** -11                       # halfway between TF32s
    x = torch.tensor([one, -one, one - 2.0 ** -23, 1.0 + 2.0 ** -10])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                 1.0, 1.0 + 2.0 ** -10]


def test_split_keeps_x_to_2_pow_minus_21():
    """big + small recovers x to 2^-21 |x| over 60 decades, both parts
    TF32 (their 13 low mantissa bits zero)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(200_000) *
         10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    big, small = _split(_t(x))
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    resid = np.abs(x.astype(np.float64) - big.double().numpy() -
                   small.double().numpy())
    assert (resid <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("label", list(_SPLIT_CASES))
def test_3xtf32_attention_meets_the_card_gates(label):
    """The 3-product split through the whole attention stays within
    ATTN_TOL of the plain op and within F64_RATIO of its distance from
    float64."""
    q, k, v, kw = _SPLIT_CASES[label]()
    ratio, f64, _ = _gate(_tf32_prefill(q, k, v, **kw), q, k, v, **kw)
    assert ratio <= 1.0 and f64 <= F64_RATIO, (ratio, f64)


@pytest.mark.parametrize("label", list(_SPLIT_CASES))
def test_1xtf32_attention_fails_the_card_gates(label):
    """TF32 alone (big x big) keeps ~3 digits: on the same inputs it is
    far from float64 next to the plain op, so the split is needed."""
    q, k, v, kw = _SPLIT_CASES[label]()
    ratio, f64, _ = _gate(_tf32_prefill(q, k, v, products=1, **kw), q, k, v,
                          **kw)
    assert ratio > 10 and f64 > 10 * F64_RATIO, (ratio, f64)


def test_attn_tol_of_the_plain_op_is_float32_noise_at_large_scores():
    """At scores x8 (seed 22) the plain op's own float32 error is more
    than ATTN_TOL from float64, so the 3-product split, closer to
    float64 than the plain op, still reads more than ATTN_TOL from it:
    within ATTN_TOL of the plain op then asks for the plain op's float32
    score rounding, not for accuracy."""
    q, k, v, kw = _scaled_normal(22, 8.0)
    ratio, f64, plain_ratio = _gate(_tf32_prefill(q, k, v, **kw), q, k, v,
                                    **kw)
    assert plain_ratio > 1.0 and ratio > 1.0 and f64 < 1.0, \
        (plain_ratio, ratio, f64)
