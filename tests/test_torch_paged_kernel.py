"""Port parity: the fused SOCKET paged-attention kernel's plain PyTorch
version (what a CPU tensor runs) against the JAX package's Pallas kernel
in interpret mode (``with_selection=True``) and its jnp oracle, on the
same numpy inputs; and the socket backend's routing onto it.

Selections must match bitwise (``jax.lax.top_k``'s lowest-index-first
tie order, trash block 0 in padded table entries, budgets above the
valid rows, length 1); outputs agree to ATTN_TOL = rtol 1e-5 / atol
1e-5 (float32 in another summation order).  The CUDA kernel itself is
held to this plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.core import socket as jsk
from repro.kernels.paged_attention import ops as jpa
from repro.kernels.paged_attention.ref import \
    paged_socket_attend_ref as j_ref
from repro_torch.configs import get_config
from repro_torch.core import socket as tsk
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import paged_socket_attend_ref
from repro_torch.models.backends import get_backend

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _case(seed, lengths, *, nb, bs=8, kvh=2, g=2, hd=16, l=12, p=6,
          sink=4, window=4, ties=False, pooled=False):
    """A trash-padded pool (numpy) holding ``lengths`` tokens per request
    on shuffled blocks, with per-request budgets from
    ``dynamic_topk_budget``."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    w = jh.num_words(l, p)
    need = [-(-n // bs) for n in lengths]
    nblocks = 1 + sum(need) + 2
    ids = rng.permutation(np.arange(1, nblocks))
    bt = np.zeros((b, nb), np.int32)
    off = 0
    for i, k in enumerate(need):
        bt[i, :k] = ids[off:off + k]
        off += k
    kp = rng.standard_normal((nblocks, kvh, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((nblocks, kvh, bs, hd)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (nblocks, kvh, bs, w), dtype=np.uint32)
    vnorm = np.array(jnp.asarray(
        rng.random((nblocks, kvh, bs)) * 3, jnp.bfloat16).astype(
            jnp.float32))
    if ties:
        bits[:] = bits[1, 0, 0]
        vnorm[:] = vnorm[1, 0, 0]
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    planes = rng.standard_normal((l, p, hd)).astype(np.float32)
    qs = q.mean(axis=2, keepdims=True) if pooled else q
    u = np.asarray(jsk.soft_hash_query(jnp.asarray(planes),
                                       jnp.asarray(qs)))
    cfg = jsk.SocketConfig(num_planes=p, num_tables=l, tau=0.4,
                           sink_tokens=sink, window_tokens=window, min_k=8,
                           sparsity=4.0)
    length = np.asarray(lengths, np.int32)
    budget = np.asarray(jsk.dynamic_topk_budget(
        cfg, jnp.asarray(length), jsk.topk_budget(cfg, nb * bs)))
    kw = dict(num_tables=l, num_planes=p, tau=0.4, scale=hd ** -0.5,
              sink_tokens=sink, window_tokens=window)
    return (q, kp, vp, bits, vnorm, u, bt), length, budget, kw


def _run_both(arrays, length, budget, kw):
    q, kp, vp, bits, vnorm, u, bt = arrays
    out, sel = tpa.paged_socket_attend(
        _t(q), _t(kp), _t(vp), _t(bits.view(np.int32)),
        _t(vnorm).to(torch.bfloat16), _t(u), _t(bt), length=_t(length),
        budget=_t(budget), with_selection=True, **kw)
    jout, jsel = jpa.paged_socket_attend(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bits),
        jnp.asarray(vnorm, jnp.bfloat16), jnp.asarray(u), jnp.asarray(bt),
        length=jnp.asarray(length), budget=jnp.asarray(budget),
        interpret=True, with_selection=True, **kw)
    return out, sel, np.asarray(jout), np.asarray(jsel)


@pytest.mark.parametrize("case", [
    "ragged", "length_one_and_budget_above_valid", "ties", "pooled",
    "paper_planes"])
def test_plain_matches_pallas_and_oracle(case):
    """Selection bitwise and output within ATTN_TOL against the Pallas
    kernel (interpret mode) and the jnp oracle."""
    kw = {}
    if case == "ragged":
        lengths, nb = [37, 64, 5, 90], 14
    elif case == "length_one_and_budget_above_valid":
        lengths, nb = [1, 9, 3], 4          # budget >= min_k 8 > 1, 3
    elif case == "ties":
        lengths, nb, kw = [70, 41], 10, dict(ties=True)
    elif case == "pooled":
        lengths, nb, kw = [50, 23], 8, dict(pooled=True)
    else:                                   # P=10, L=60: W=20, l_pad=64
        lengths, nb, kw = [40, 77], 12, dict(l=60, p=10, bs=16)
    arrays, length, budget, args = _case(len(lengths) * 7 + nb, lengths,
                                         nb=nb, **kw)
    out, sel, jout, jsel = _run_both(arrays, length, budget, args)
    assert out.shape == jout.shape and sel.shape == jsel.shape
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_allclose(out.numpy(), jout, **ATTN_TOL)
    q, kp, vp, bits, vnorm, u, bt = arrays
    n = bt.shape[1] * kp.shape[2]
    rout, rsel = j_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bits),
        jnp.asarray(vnorm, jnp.bfloat16), jnp.asarray(u), jnp.asarray(bt),
        length=jnp.asarray(length), budget=jnp.asarray(budget),
        top_k=min(n, int(budget.max())), **args)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(rsel))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **ATTN_TOL)
    # the selected count is min(budget, valid rows) exactly
    np.testing.assert_array_equal(
        sel.numpy().sum(-1),
        np.broadcast_to(np.minimum(budget, length)[:, None],
                        sel.shape[:2]))
    # nothing past a request's length (trash rows included) is selected
    past = np.arange(n)[None, None] >= length[:, None, None]
    assert not sel.numpy()[np.broadcast_to(past, sel.shape)].any()


def test_wrapper_layouts_and_cpu_route():
    """5-D queries keep their layout, the wrapper on CPU tensors is the
    plain version exactly and launches nothing, and a lone scale pool
    raises the JAX wrapper's ValueError (scales come in pairs)."""
    arrays, length, budget, kw = _case(3, [30, 12], nb=5)
    q, kp, vp, bits, vnorm, u, bt = arrays
    t = [_t(q), _t(kp), _t(vp), _t(bits.view(np.int32)),
         _t(vnorm).to(torch.bfloat16), _t(u), _t(bt)]
    before = tpa.LAUNCHES
    out5 = tpa.paged_socket_attend(t[0][:, :, :, None], *t[1:],
                                   length=_t(length), budget=_t(budget),
                                   **kw)
    assert out5.shape == (2, 2, 2, 1, 16)
    ref, _ = paged_socket_attend_ref(*t, length=_t(length),
                                     budget=_t(budget),
                                     top_k=int(budget.max()), **kw)
    torch.testing.assert_close(out5[:, :, :, 0], ref, rtol=0, atol=0)
    assert tpa.LAUNCHES == before
    with pytest.raises(ValueError, match="given together"):
        tpa.paged_socket_attend(*t, length=_t(length), budget=_t(budget),
                                k_scale=torch.ones(1), **kw)


def test_fused_gates_fail_fast():
    """The backends report whether they read the pool directly, and the
    config rejects what the fused kernel cannot take (packed bits,
    kvhead/pooled selection, block_size % 8), as the JAX package does."""
    cfg = get_config("llama31-8b").smoke()
    fused = dataclasses.replace(cfg.socket, use_paged_kernel=True)
    cfg.replace(socket=fused).validate()
    socket, dense = get_backend("socket"), get_backend("dense")
    assert socket.supports_paged and not dense.supports_paged
    with pytest.raises(ValueError, match="bits_storage"):
        cfg.replace(socket=dataclasses.replace(
            fused, bits_storage="int8")).validate()
    with pytest.raises(ValueError, match="selection"):
        cfg.replace(socket=dataclasses.replace(
            fused, selection="qhead")).validate()
    with pytest.raises(ValueError, match="block_size % 8"):
        cfg.replace(socket=fused, serving=cfg.serving.replace(
            block_size=12)).cache_plan()


def test_budgets_match_jax_at_main_path():
    """The ragged budgets the fused kernel receives on the continuous
    path (llama31-8b: sink/window 128, sparsity 10, 264 blocks of 16)."""
    kw = dict(sink_tokens=128, window_tokens=128, sparsity=10.0, min_k=16)
    jc, tc = jsk.SocketConfig(**kw), tsk.SocketConfig(**kw)
    length = np.array([1, 200, 1024, 2048, 3072, 4096, 4200], np.int32)
    cap = jsk.topk_budget(jc, 264 * 16)
    assert tsk.topk_budget(tc, 264 * 16) == cap
    np.testing.assert_array_equal(
        tsk.dynamic_topk_budget(tc, _t(length), cap).numpy(),
        np.asarray(jsk.dynamic_topk_budget(jc, jnp.asarray(length), cap)))


@pytest.mark.parametrize("ties", [False, True])
def test_card_check_accepts_plain_and_rejects_faults(ties):
    """The check that holds the CUDA kernel to its plain version on the
    card (``kernels/paged_attention/cases.py``), run here on its own
    CPU inputs: the plain version passes it; one selected row moved, or
    an output off by more than ATTN_TOL, fails it."""
    from repro_torch.kernels.paged_attention import cases
    gen = torch.Generator().manual_seed(3)
    (case,), kw = cases.paged_case(gen, [1, 40, 300, 77], nb=24, kvh=2,
                                   hd=16, l=12, p=6, sink=4, window=4,
                                   ties=ties)
    q, kp, vp, bits, vnorm, u, bt, length, budget = case
    out, sel = tpa.paged_socket_attend(q, kp, vp, bits, vnorm, u, bt,
                                       length=length, budget=budget,
                                       with_selection=True, **kw)
    tol = dict(ties=ties, attn_tol=ATTN_TOL,
               score_tol=dict(rtol=1e-5, atol=1e-6))
    assert cases.check_paged(out, sel, case, kw, **tol) == (0.0, 0)
    moved = sel.clone()
    row = moved[2, 0, :300]
    on, off = torch.nonzero(row).flatten(), torch.nonzero(~row).flatten()
    row[on[len(on) // 2]], row[off[0]] = False, True
    with pytest.raises(AssertionError, match="select"):
        cases.check_paged(out, moved, case, kw, **tol)
    with pytest.raises(AssertionError, match="exceeds"):
        cases.check_paged(out + 1e-3, sel, case, kw, **tol)


def test_card_check_holds_band_swaps_to_the_kernels_selection():
    """Where the kernel swaps rows inside the threshold band (here: a band
    that holds every row), the card check holds its output to the plain
    attention over the kernel's own selection: that output passes, the
    plain version's own output (over the other rows) does not."""
    from repro_torch.kernels.paged_attention import cases
    from repro_torch.kernels.paged_attention.ref import attend_selected
    gen = torch.Generator().manual_seed(5)
    (case,), kw = cases.paged_case(gen, [300, 77], nb=24, kvh=2, hd=16,
                                   l=12, p=6, sink=4, window=4)
    q, kp, vp, bits, vnorm, u, bt, length, budget = case
    out, sel = tpa.paged_socket_attend(q, kp, vp, bits, vnorm, u, bt,
                                       length=length, budget=budget,
                                       with_selection=True, **kw)
    row = sel[0, 1, :300]
    on, off = torch.nonzero(row).flatten(), torch.nonzero(~row).flatten()
    row[on[len(on) // 2]], row[off[0]] = False, True
    swapped = attend_selected(q, kp, vp, bt, sel, scale=kw["scale"])
    tol = dict(ties=False, attn_tol=ATTN_TOL,
               score_tol=dict(rtol=10.0, atol=1e9))
    err, near = cases.check_paged(swapped, sel, case, kw, **tol)
    assert near == 2 and err < 1e-6
    with pytest.raises(AssertionError, match="exceeds"):
        cases.check_paged(out, sel, case, kw, **tol)


# ---- the CUDA kernel's algorithm, pinned on the CPU ------------------------
# ``cases.split_table_scores`` and ``cases.cluster_select`` emulate in plain
# torch how paged_attention.cu scores (two f32 tables a (g, l) over the low
# and high half of the planes) and selects (C ranks, four rounds of 8-bit
# radix digits, tie counts carried across ranks).

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("l,p,gs", [(60, 10, 4), (12, 6, 2), (9, 7, 3),
                                    (60, 10, 1), (5, 1, 2)])
def test_split_table_scores_match_jax(l, p, gs):
    """The kernel's split-table scores against the scores of the JAX fused
    kernel's reference (``socket_score_ref``, the scoring its oracle
    runs), within the score tolerance: T_lo * T_hi = exp(a) * exp(b) in
    place of exp(a + b)."""
    from repro.kernels.socket_score.ref import socket_score_ref as j_score
    from repro_torch.kernels.paged_attention import cases
    rng = np.random.default_rng(l * 31 + p * 7 + gs)
    bh, n, hd = 3, 97, 64
    w = jh.num_words(l, p)
    bits = rng.integers(0, 2 ** 32, (bh, n, w), dtype=np.uint32)
    u = np.asarray(jsk.soft_hash_query(
        jnp.asarray(rng.standard_normal((l, p, hd)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((bh, gs, hd)).astype(np.float32))))
    kw = dict(num_tables=l, num_planes=p, tau=0.4)
    want = np.asarray(j_score(jnp.asarray(bits), jnp.asarray(u), None, **kw))
    got = cases.split_table_scores(_t(bits.view(np.int32)), _t(u), **kw)
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)


def _select_case(seed, ties):
    """Scores, vnorm, ragged lengths (0 and 1 among them) and budgets
    (below, at and above the forced rows and the valid rows) of a
    (B=6, KVH=2, N=48*8) pool; ``ties``: every score equal."""
    rng = np.random.default_rng(seed)
    b, kvh, bs, nb = 6, 2, 8, 48
    n = bs * nb
    # few distinct values, so ties at the threshold are common
    scores = rng.integers(0, 7, (b, kvh, n)).astype(np.float32) / 4
    if ties:
        scores[:] = 0.75
    vnorm = np.array(jnp.asarray(rng.integers(1, 4, (b, kvh, n)),
                                 jnp.bfloat16).astype(jnp.float32))
    length = np.array([0, 1, 77, 200, 383, n], np.int32)
    budget = np.array([5, 3, 60, 13, 150, 384], np.int32)
    rng.shuffle(length)
    return scores, vnorm, length, budget, bs


@pytest.mark.parametrize("ties", [False, True], ids=["ragged", "all-ties"])
@pytest.mark.parametrize("c", range(1, 9))
def test_cluster_select_matches_value_aware_topk(c, ties):
    """The kernel's select with C ranks equals ``value_aware_topk`` (JAX)
    bit for bit, lowest-index-first ties included, over seeds, ragged
    lengths and an all-ties pool; where the threshold's tied rows span
    several ranks, each rank's tie count starts after the ranks before
    it."""
    from repro_torch.kernels.paged_attention import cases
    most = 0
    for seed in range(3):
        scores, vnorm, length, budget, bs = _select_case(seed * 9 + c, ties)
        b, kvh, n = scores.shape
        cfg = jsk.SocketConfig(sink_tokens=4, window_tokens=4)
        idx, mask = jsk.value_aware_topk(
            cfg, jnp.asarray(scores), jnp.asarray(vnorm), k=int(budget.max()),
            length=jnp.asarray(length), n_total=n, budget=jnp.asarray(budget))
        want = np.zeros((b, kvh, n), bool)
        bi, hi, ki = np.nonzero(np.asarray(mask))
        want[bi, hi, np.asarray(idx)[bi, hi, ki]] = True
        pos = np.arange(n)
        ln = length[:, None, None]
        eff = np.where((pos < 4) | (pos >= ln - 4), np.float32(tsk.FLT_MAX),
                       scores * vnorm)
        eff = torch.from_numpy(np.where(pos < ln, eff,
                                        np.float32(tsk.NEG_INF)))
        got = cases.cluster_select(eff, length, budget, bs=bs, c=c)
        np.testing.assert_array_equal(got.numpy(), want)
        most = max(most, cases.tie_ranks(eff, got, length, budget, bs=bs,
                                         c=c))
    if c > 1:
        assert most >= 2, "no case put the threshold's ties on two ranks"


def test_cta_ranges_cover_the_live_blocks():
    """The ranks' ranges tile [0, length) in whole blocks, in order; ranks
    past the live blocks are empty."""
    from repro_torch.kernels.paged_attention import cases
    for length in (0, 1, 15, 16, 17, 1000, 4096):
        for c in range(1, 9):
            rs = cases.cta_ranges(length, 16, c)
            assert rs[0][0] == 0 and rs[-1][1] == length
            assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
            assert all(r0 % 16 == 0 for r0, r1 in rs if r0 < length)
    assert cases.cta_ranges(5, 16, 4) == [(0, 5), (5, 5), (5, 5), (5, 5)]
