"""Port parity for the fused paged kernels on stored pool pages (bf16,
int8, fp8): their plain PyTorch versions (what a CPU tensor runs) against
the JAX package's Pallas kernels in interpret mode and their jnp oracles,
on the JAX kernel harness's quantized and bf16 cases, mirrored by name
(``tests/test_kernels.py``: the same numpy-seeded fixtures, the same
per-row scale pools); the stored pools the card checks build
(``cases.store_kv``); and the wrappers' handling of scale pools.

Tolerances: selections bit for bit; outputs atol 2e-5 (the harness's
``ParityPolicy`` for these kernels: float32 attention over the same
dequantized values in another summation order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import test_kernels as jk
from repro.kernels.paged_attention.ref import (
    paged_hard_lsh_attend_ref as j_hard_ref,
    paged_quest_attend_ref as j_quest_ref,
    paged_ring_attend_ref as j_ring_ref,
    paged_socket_attend_ref as j_socket_ref)
from repro_torch.kernels.paged_attention import cases as tcases
from repro_torch.kernels.paged_attention import ops as tpa

ATOL = 2e-5
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)

_NP_VIEWS = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
             "bfloat16": (np.int16, torch.bfloat16)}


def _t(x):
    """A JAX or numpy array as a torch tensor of the same dtype (fp8 and
    bf16 through a same-size integer view)."""
    a = np.asarray(x)
    if a.dtype.name in _NP_VIEWS:
        raw, dt = _NP_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(raw).copy()).view(dt)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _case(op_name, label):
    op = next(o for o in jk.KERNEL_OPS if o.name == op_name)
    return next(c for c in op.cases if c.label == label).kwargs


def _tkw(kw):
    return {k: (_t(v) if not isinstance(v, (int, float)) else v)
            for k, v in kw.items()}


def _hold(out, sel, pairs):
    """out/sel (torch) against each (JAX out, JAX sel) pair."""
    for jo, js in pairs:
        if sel is not None:
            np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("label", ["int8-ragged", "fp8-ragged",
                                   "int8-ties-unaligned-tail",
                                   "fp8-unaligned-tables", "bf16-kv"])
def test_socket_plain_matches_pallas_and_oracle(label):
    args, kw, kq = jk._paged_fixture(**_case("paged_attention", label))
    jout, jsel = jk.paged_socket_attend(*args, with_selection=True, **kw)
    rout, rsel = j_socket_ref(*args, top_k=kq, **kw)
    targs, tkw = [_t(a) for a in args], _tkw(kw)
    assert targs[1].dtype in tpa.KV_TYPES
    before = tpa.LAUNCHES
    out, sel = tpa.paged_socket_attend(*targs, with_selection=True, **tkw)
    assert tpa.LAUNCHES == before
    _hold(out, sel, ((jout, jsel), (rout, rsel)))
    # scoring never reads K/V: the selection on f32 pages is the same
    f32 = dict(tkw, k_scale=None, v_scale=None)
    _, sel32 = tpa.paged_socket_attend(targs[0], targs[1].float(),
                                       targs[2].float(), *targs[3:],
                                       with_selection=True, **f32)
    assert torch.equal(sel, sel32)


@pytest.mark.parametrize("label", ["int8-collision-ties", "fp8-ragged",
                                   "bf16-kv"])
def test_hard_lsh_plain_matches_pallas_and_oracle(label):
    args, kw, kq = jk._paged_fixture(**_case("paged_hard_lsh", label))
    q, kp, vp, bits, vn, u, bt = args
    u_signs = jnp.where(u >= 0, 1.0, -1.0).astype(jnp.float32)
    kw = {k: v for k, v in kw.items() if k != "tau"}
    jargs = (q, kp, vp, bits, vn, u_signs, bt)
    jout, jsel = jk.paged_hard_lsh_attend(*jargs, with_selection=True, **kw)
    rout, rsel = j_hard_ref(*jargs, top_k=kq, **kw)
    targs, tkw = [_t(a) for a in jargs], _tkw(kw)
    before = tpa.HARD_LSH_LAUNCHES
    out, sel = tpa.paged_hard_lsh_attend(*targs, with_selection=True, **tkw)
    assert tpa.HARD_LSH_LAUNCHES == before
    _hold(out, sel, ((jout, jsel), (rout, rsel)))
    f32 = dict(tkw, k_scale=None, v_scale=None)
    _, sel32 = tpa.paged_hard_lsh_attend(targs[0], targs[1].float(),
                                         targs[2].float(), *targs[3:],
                                         with_selection=True, **f32)
    assert torch.equal(sel, sel32)


@pytest.mark.parametrize("label", ["int8-ragged", "fp8-page-ties-tail",
                                   "bf16-kv"])
def test_quest_plain_matches_pallas_and_oracle(label):
    args, op_kw, ref_kw = jk._quest_fixture(**_case("paged_quest", label))
    jout, jsel = jk.paged_quest_attend(*args, with_selection=True, **op_kw)
    rout, rsel = j_quest_ref(*args, **ref_kw)
    targs, tkw = [_t(a) for a in args], _tkw(op_kw)
    before = tpa.QUEST_LAUNCHES
    out, sel = tpa.paged_quest_attend(*targs, with_selection=True, **tkw)
    assert tpa.QUEST_LAUNCHES == before
    _hold(out, sel, ((jout, jsel), (rout, rsel)))


@pytest.mark.parametrize("label", ["int8-wrap-mix", "fp8-softcap-tail",
                                   "bf16-kv"])
def test_ring_plain_matches_pallas_and_oracle(label):
    args, kw = jk._ring_fixture(**_case("paged_ring", label))
    jout = jk.paged_ring_attend(*args, **kw)
    rout = j_ring_ref(*args, **kw)
    before = tpa.RING_LAUNCHES
    out = tpa.paged_ring_attend(*[_t(a) for a in args], **_tkw(kw))
    assert tpa.RING_LAUNCHES == before
    _hold(out, None, ((jout, None), (rout, None)))


# --------------------------------------------------- card-check pools

def _build(kind, gen, kv_dtype):
    """A small card case of ``kind`` stored as ``kv_dtype``: (set, kw,
    scales, plain (out, sel))."""
    if kind == "ring":
        (case,), kw = tcases.ring_case(gen, [5, 40, 100], kvh=2, hd=32,
                                       rb=4, bs=16, window=50)
        (case,), scales = tcases.store_kv([case], kv_dtype)
        return case, kw, scales, (tcases.plain_ring(case, kw, scales), None)
    common = dict(nb=12, kvh=2, hd=32, sink=16, window=16)
    if kind == "quest":
        (case,), kw = tcases.quest_case(gen, [30, 170], ps=8, **common)
        (case,), scales = tcases.store_kv([case], kv_dtype, quest=True)
        plain = tpa.paged_quest_attend(*case[:6], length=case[6],
                                       page_budget=case[7],
                                       with_selection=True, **kw, **scales)
        return case, kw, scales, plain
    build = tcases.paged_case if kind == "socket" else tcases.hard_lsh_case
    (case,), kw = build(gen, [30, 170], l=12, p=6, **common)
    (case,), scales = tcases.store_kv([case], kv_dtype)
    fn = (tpa.paged_socket_attend if kind == "socket"
          else tpa.paged_hard_lsh_attend)
    plain = fn(*case[:7], length=case[7], budget=case[8],
               with_selection=True, **kw, **scales)
    return case, kw, scales, plain


def _check(kind, out, sel, case, kw, scales):
    if kind == "ring":
        return tcases.check_ring(out, case, kw, attn_tol=ATTN_TOL,
                                 scales=scales)
    if kind == "quest":
        return tcases.check_quest(out, sel, case, kw, attn_tol=ATTN_TOL,
                                  scales=scales)
    if kind == "socket":
        err, near = tcases.check_paged(out, sel, case, kw, ties=False,
                                       attn_tol=ATTN_TOL,
                                       score_tol=SCORE_TOL, scales=scales)
        assert near == 0
        return err
    return tcases.check_hard_lsh(out, sel, case, kw, attn_tol=ATTN_TOL,
                                 scales=scales)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["socket", "hard_lsh", "quest", "ring"])
def test_card_checks_on_stored_pools(kind, kv_dtype):
    """The card checks on pools stored as ``kv_dtype`` (``store_kv``):
    the plain version passes; an output moved by more than the tolerance
    fails.  Stored pages hold the quantization of the f32 case (a ring's
    dead rows NaN in their scales and fp8 payloads), and Quest's stats
    bound the keys' round trip."""
    gen = torch.Generator().manual_seed(7)
    case, kw, scales, (out, sel) = _build(kind, gen, kv_dtype)
    want = {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert case[1].dtype == case[2].dtype == want
    assert set(scales) == (set() if kv_dtype == "bf16"
                           else {"k_scale", "v_scale"})
    assert _check(kind, out, sel, case, kw, scales) == 0.0
    with pytest.raises(AssertionError):
        _check(kind, out + 1e-3, sel, case, kw, scales)
    if kind == "quest" and scales:
        rt = tcases.kvquant.dequantize(case[1], scales["k_scale"])
        nb, kvh, bs, hd = rt.shape
        live = torch.isfinite(case[3])
        lo = rt.reshape(nb, kvh, bs // 8, 8, hd).amin(dim=3)
        assert torch.equal(case[3][live], lo[live])
    if kind == "ring" and scales:
        dead = torch.isnan(scales["k_scale"])
        assert dead.any() and torch.isnan(scales["v_scale"][dead]).all()


def test_wrappers_refuse_a_lone_scale_pool():
    """A lone scale pool raises ValueError, the JAX wrappers' rule (the
    other wrappers' cases are in the SOCKET, Quest and ring test files)."""
    gen = torch.Generator().manual_seed(3)
    case, kw, scales, _ = _build("hard_lsh", gen, "fp8")
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_hard_lsh_attend(*case[:7], length=case[7], budget=case[8],
                                  v_scale=scales["v_scale"], **kw)
    case, kw, scales, _ = _build("ring", gen, "int8")
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_ring_attend(*case[:4], pos=case[4], **kw,
                              v_scale=scales["v_scale"])
