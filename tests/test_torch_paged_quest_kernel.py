"""The fused Quest kernel's cluster page select, pinned on the CPU.

``paged_quest.cu`` splits each (request, KV head) over C ranks (rank r
owns the pages of the r-th run of live blocks), scores pages by their
min/max bounds and selects ``page_budget`` pages with the shared
four-round 8-bit radix select, each rank starting its tie count at the
ties of the ranks before it.  ``cases.quest_cluster_select`` emulates that
select in plain torch; here it is held bit for bit to the JAX package's
``repro.baselines.quest.select_tokens`` (its rows) and to the Pallas
kernel ``paged_quest_pallas`` in interpret mode, for every C from 1 to 8,
ragged lengths (0 and 1 among them), pages of 16 and of 8 tokens (two a
block), budgets above a request's live pages, and an all-ties pool whose
selected tied pages lie on several ranks.

Keys and queries are small integers, so every page bound is an exact
small integer in float32 and float64 alike: the JAX package's float32
sums and the port's float64 ones give the same scores, and ties at the
threshold are common.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.baselines import quest as jquest
from repro.kernels.paged_attention.paged_quest import paged_quest_pallas
from repro_torch.kernels.paged_attention import cases

BS, KVH, G, HD, NB = 16, 2, 2, 8, 24
SINK = WINDOW = 16
# sparsity 4: a budget of 6 (ps 16) or 12 (ps 8) pages, above the live
# pages of the short requests; 1.5: 16 or 32 pages, so the selected
# ties of an all-ties pool run past one rank's pages
SPARSITY = {"ragged": 4.0, "all-ties": 1.5}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _pool(seed, ps, ties, lengths=(0, 1, 77, 200, 383, 384)):
    """A trash-padded pool of integer keys holding ``lengths`` tokens a
    request (shuffled) on shuffled blocks: (q, k_pages, v_pages, kmin,
    kmax, block_table, length) as numpy, the stat rows of pages past a
    request's length and of the trash block 0 the pool's +-inf fill."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.asarray(lengths, np.int32))
    b, ppb = len(lengths), BS // ps
    need = [-(-int(n) // BS) for n in lengths]
    nblocks = 1 + sum(need)
    ids = rng.permutation(np.arange(1, nblocks))
    bt = np.zeros((b, NB), np.int32)
    off = 0
    for i, k in enumerate(need):
        bt[i, :k] = ids[off:off + k]
        off += k
    keys = rng.integers(-1, 2, (nblocks, KVH, BS, HD)).astype(np.float32)
    if ties:
        keys[:] = keys[1]
    vals = rng.standard_normal((nblocks, KVH, BS, HD)).astype(np.float32)
    pages = keys.reshape(nblocks, KVH, ppb, ps, HD)
    kmin, kmax = pages.min(axis=3), pages.max(axis=3)
    kmin[0], kmax[0] = np.inf, -np.inf
    for i, n in enumerate(lengths):
        for pg in range(need[i] * ppb):
            if pg * ps >= n:
                kmin[bt[i, pg // ppb], :, pg % ppb] = np.inf
                kmax[bt[i, pg // ppb], :, pg % ppb] = -np.inf
    q = rng.integers(-1, 2, (b, KVH, G, HD)).astype(np.float32)
    return q, keys, vals, kmin, kmax, bt, lengths


def _jax_rows(pool, ps, sparsity):
    """JAX ``select_tokens``' selection as a (B, KVH, N) row mask, and
    its page budget."""
    q, _, _, kmin, kmax, bt, length = pool
    b, n = len(length), NB * BS
    view = lambda s: np.moveaxis(s[bt], 1, 2).reshape(b, KVH, -1, HD)
    cfg = jquest.QuestConfig(page_size=ps, sparsity=sparsity,
                             sink_tokens=SINK, window_tokens=WINDOW,
                             min_pages=4)
    state = jquest.QuestState(kmin=jnp.asarray(view(kmin)),
                              kmax=jnp.asarray(view(kmax)))
    idx, valid = jquest.select_tokens(cfg, state,
                                      jnp.asarray(q[:, :, :, None]),
                                      length=jnp.asarray(length), n=n)
    rows = np.zeros((b, KVH, n), bool)
    bi, hi, ki = np.nonzero(np.asarray(valid))
    rows[bi, hi, np.asarray(idx)[bi, hi, ki]] = True
    return rows, jquest.page_budget(cfg, n // ps, n)


def _page_eff(pool, ps, budget):
    """The port's page scores (float64 sums rounded once) of ``pool``."""
    q, keys, vals, kmin, kmax, bt, length = pool
    case = (_t(q), _t(keys), _t(vals), _t(kmin), _t(kmax), _t(bt),
            _t(length), torch.full((len(length),), budget, dtype=torch.int32))
    kw = dict(page_size=ps, sink_tokens=SINK, window_tokens=WINDOW)
    return cases.quest_page_eff(case, kw)


@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("ps", [16, 8])
@pytest.mark.parametrize("kind", ["ragged", "all-ties"])
def test_quest_cluster_select_matches_select_tokens(kind, ps, c):
    """The kernel's page select with C ranks equals JAX ``select_tokens``
    bit for bit (its rows: the live rows of ``page_budget`` pages, pages
    past length counted and last among ties), over three seeds; the
    ragged pools hold requests whose live pages are fewer than the
    budget, and for C > 1 the all-ties pools put the selected ties on two
    or more ranks."""
    above, spread = False, 0
    for seed in range(3):
        pool = _pool(seed * 17 + c, ps, kind == "all-ties")
        want, budget = _jax_rows(pool, ps, SPARSITY[kind])
        length = pool[-1]
        b = len(length)
        budgets = np.full((b,), budget, np.int32)
        eff = _page_eff(pool, ps, budget)
        got = cases.quest_cluster_select(eff, length, budgets, ps=ps, bs=BS,
                                         c=c)
        np.testing.assert_array_equal(got.numpy(), want)
        n_live = -(-length // ps)
        above |= bool((budgets > n_live).any())
        pages = cases.quest_page_selection(got, ps)
        spread = max(spread, cases.tie_ranks(eff, pages, n_live, budgets,
                                             bs=BS // ps, c=c))
    assert above, "no request had fewer live pages than the budget"
    if kind == "all-ties" and c > 1:
        assert spread >= 2, "no case put the selected ties on two ranks"


@pytest.mark.parametrize("ps", [16, 8])
@pytest.mark.parametrize("kind", ["ragged", "all-ties"])
def test_quest_cluster_select_matches_pallas(kind, ps):
    """The same emulation, at every C, against the rows the Pallas kernel
    ``paged_quest_pallas`` (interpret mode) selects on the same pool."""
    pool = _pool(5, ps, kind == "all-ties")
    q, keys, vals, kmin, kmax, bt, length = pool
    _, budget = _jax_rows(pool, ps, SPARSITY[kind])
    budgets = np.full((len(length),), budget, np.int32)
    _, jsel = paged_quest_pallas(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(vals),
        jnp.asarray(kmin), jnp.asarray(kmax), jnp.asarray(bt),
        jnp.asarray(length), jnp.asarray(budgets), page_size=ps,
        scale=HD ** -0.5, sink_tokens=SINK, window_tokens=WINDOW,
        interpret=True, with_selection=True)
    want = np.asarray(jsel).reshape(len(length), KVH, -1).astype(bool)
    eff = _page_eff(pool, ps, budget)
    for c in range(1, 9):
        got = cases.quest_cluster_select(eff, length, budgets, ps=ps, bs=BS,
                                         c=c)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"C {c}")


def test_quest_page_eff_matches_jax_bounds():
    """The page scores the emulation selects from are JAX's: the bounds
    ``score_pages`` summed over the group, sink and window pages FLT_MAX,
    pages past length -1e30 (exact here: integer bounds)."""
    pool = _pool(3, 8, False)
    q, _, _, kmin, kmax, bt, length = pool
    b = len(length)
    view = lambda s: np.moveaxis(s[bt], 1, 2).reshape(b, KVH, -1, HD)
    state = jquest.QuestState(kmin=jnp.asarray(view(kmin))[:, :, None],
                              kmax=jnp.asarray(view(kmax))[:, :, None])
    scores = np.asarray(jquest.score_pages(state, jnp.asarray(q))).sum(2)
    start = np.arange(scores.shape[-1]) * 8
    ln = length[:, None, None]
    want = np.where((start < SINK) | (start >= ln - WINDOW - 8),
                    np.finfo(np.float32).max, scores)
    want = np.where(start < ln, want, np.float32(-1e30)).astype(np.float32)
    got = _page_eff(pool, 8, 4).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", range(2, 9))
def test_card_tie_case_exercises_the_carried_count(c):
    """``chip_smoke.py``'s Quest case "ties across ranks" (and the card
    test's, the same lengths), under the plain version's selection at
    any C the card may choose: the selected pages tied at the threshold
    lie on two or more ranks, and some tied live page is left out, so
    the count carried from rank to rank decides the selection."""
    import importlib.util
    import os
    from repro_torch.kernels.paged_attention import ops
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kw = dict(smoke.PAGED_CASES["paged_quest"])["ties across ranks"]
    (case,), args = cases.quest_case(torch.Generator().manual_seed(1),
                                     **dict(kw, kvh=2, hd=16))
    _, sel = ops.paged_quest_attend(*case[:6], length=case[6],
                                    page_budget=case[7],
                                    with_selection=True, **args)
    ps, length = args["page_size"], case[6]
    eff = cases.quest_page_eff(case, args)
    pages = cases.quest_page_selection(sel, ps)
    assert cases.tie_ranks(eff, pages, (length + ps - 1) // ps, case[7],
                           bs=16 // ps, c=c) >= 2
    assert cases.ties_cut(eff, pages)
