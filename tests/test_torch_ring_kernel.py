"""The redesigned ring kernel's algorithm, pinned on the CPU.

``paged_ring.cu`` finds a request's live rows in closed form (n_live =
min(pos + 1, window, cap) positions from p0 = pos - n_live + 1, the k-th
in slot (p0 + k) mod cap), splits them into C even shares, stages each
share page by page and folds it with units of their own, then merges the
units and the ranks.  ``cases.ring_live_rows`` and ``cases.ring_share``
are that enumeration and split, and ``cases.ring_cluster_fold`` the
whole computation in plain float32 torch; here the rows are held to
``cases.ring_live`` (the TPU kernel's slot test) exactly, the shares to
a partition of the live rows for C 1-8, and the emulated output to the
JAX package's ``paged_ring_pallas`` in interpret mode within the card's
attention tolerance, on numpy-seeded pools whose dead slots and trash
page hold NaN (the JAX kernel, which masks logits and would carry 0 *
NaN into p . V, reads the pool with those rows zeroed): window = cap and
window < cap, softcap 50, bf16, int8 and fp8 pages with per-row scales,
G 1, 2 and 4, hd 8 and hd 40 (padded lanes), and requests with fewer
live rows than ranks.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.paged_attention.paged_ring import paged_ring_pallas
from repro.models.backends import kvquant as jkvquant
from repro_torch.kernels.paged_attention import cases

# the card's attention tolerance (chip_smoke.ATTN_TOL): float32 online
# softmax in another summation order
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
BS, RB = 8, 16
CAP = BS * RB

_NP_VIEWS = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
             "bfloat16": (np.int16, torch.bfloat16)}


def _t(x):
    """A JAX or numpy array as a torch tensor of the same dtype (fp8 and
    bf16 through a same-size integer view)."""
    a = np.asarray(x)
    if a.dtype.name in _NP_VIEWS:
        raw, dt = _NP_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(raw).copy()).view(dt)
    return torch.from_numpy(a.copy())


# ---- the live rows in closed form ------------------------------------------

@pytest.mark.parametrize("window", [CAP, CAP - 24, 1])
@pytest.mark.parametrize("pos", [0, 1, BS - 1, "window-1", "window", CAP - 1,
                                 CAP, "cap+window-1", 5 * CAP + 7])
def test_live_rows_are_the_tpu_kernels_live_slots(pos, window):
    """The closed form enumerates exactly the slots the TPU kernel keeps,
    each once, in position order: slot (p0 + k) mod cap holds position
    p0 + k."""
    pos = {"window-1": window - 1, "window": window,
           "cap+window-1": CAP + window - 1}.get(pos, pos)
    rows = cases.ring_live_rows(pos, CAP, window)
    n_live = min(pos + 1, window, CAP)
    assert len(rows) == n_live == len(set(rows.tolist()))
    mask = torch.zeros(CAP, dtype=torch.bool)
    mask[rows] = True
    live = cases.ring_live(torch.tensor([pos]), CAP, window)[0]
    assert torch.equal(mask, live)
    # the k-th row holds position p0 + k: its slot's newest position
    p0 = pos - n_live + 1
    ring_pos = pos - torch.remainder(pos - rows, CAP)
    assert torch.equal(ring_pos, p0 + torch.arange(n_live))


@pytest.mark.parametrize("c", range(1, 9))
def test_shares_cover_the_live_rows_once(c):
    """The C ranks' even shares partition [0, n_live), in rank order,
    sizes within one of each other; fewer live rows than ranks leave
    ranks empty."""
    for n_live in (0, 1, c - 1, c, c + 1, 7, 100, 1023, 1024):
        shares = [cases.ring_share(n_live, c, r) for r in range(c)]
        assert shares[0][0] == 0 and shares[-1][1] == n_live
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        sizes = [hi - lo for lo, hi in shares]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        if n_live < c:
            assert sum(s == 0 for s in sizes) == c - n_live


# ---- the cluster fold against the JAX kernel --------------------------------

def _pool(seed, positions, *, kvh, g, hd, window):
    """A ring pool on numpy: each request holds min(RB, pos // BS + 1)
    shuffled blocks as its first ring entries, the rest the trash block
    0 (as in the engine); q, the clean K/V pages (dead rows zero), the
    table, the positions and the dead-row mask (NB, KVH, BS)."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    need = [min(RB, p // BS + 1) for p in positions]
    nblocks = 1 + sum(need)
    ids = 1 + rng.permutation(nblocks - 1)
    bt = np.zeros((b, RB), np.int32)
    off = 0
    for i, k in enumerate(need):
        bt[i, :k] = ids[off:off + k]
        off += k
    kp = rng.standard_normal((nblocks, kvh, BS, hd)).astype(np.float32)
    vp = rng.standard_normal((nblocks, kvh, BS, hd)).astype(np.float32)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    dead = np.ones((nblocks, kvh, BS), bool)
    live = cases.ring_live(torch.from_numpy(pos), CAP, window).numpy()
    for i in range(b):
        for s in np.nonzero(live[i])[0]:
            dead[bt[i, s // BS], :, s % BS] = False
    kp[dead], vp[dead] = 0.0, 0.0
    return q, kp, vp, bt, pos, dead


FOLD_CASES = {
    # label: (positions, kvh, g, hd, window, softcap, kv_dtype, c)
    "NaN dead slots, C 3": ([5, 40, 200, 29, 1000], 2, 2, 16, CAP, 0.0,
                            None, 3),
    "window < cap, partial pages, C 5": ([103, 250, 77, 1000], 2, 2, 16,
                                         CAP - 24, 0.0, None, 5),
    "softcap 50, C 2": ([300, 1, 129], 2, 2, 16, CAP, 50.0, None, 2),
    "bf16 pages, C 4": ([300, 17, 1000], 2, 2, 16, CAP - 24, 0.0, "bf16",
                        4),
    "int8 pages with scales, C 4": ([300, 17, 1000, 64], 2, 2, 16, CAP - 24,
                                    0.0, "int8", 4),
    "fp8 pages with scales, C 3": ([300, 17, 1000, 64], 2, 2, 16, CAP, 0.0,
                                   "fp8", 3),
    "G 1, C 2": ([90, 700], 2, 1, 16, CAP, 0.0, None, 2),
    "G 4, C 8": ([90, 700, 3], 2, 4, 16, CAP - 24, 0.0, None, 8),
    "hd 8, C 1": ([90, 700, 3], 2, 2, 8, CAP, 0.0, "int8", 1),
    "hd 40 (padded lanes), C 3": ([90, 700, 3], 2, 2, 40, CAP - 24, 0.0,
                                  None, 3),
    "pos < C (empty ranks), C 8": ([0, 2, 5], 2, 2, 16, CAP, 0.0, None, 8),
}


@pytest.mark.parametrize("label", list(FOLD_CASES))
def test_cluster_fold_matches_pallas(label):
    positions, kvh, g, hd, window, softcap, kv_dtype, c = FOLD_CASES[label]
    q, kp, vp, bt, pos, dead = _pool(len(label), positions, kvh=kvh, g=g,
                                     hd=hd, window=window)
    kw = dict(window=window, softcap=softcap, scale=hd ** -0.5)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    jscales, tscales = {}, None
    if kv_dtype == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    elif kv_dtype is not None:
        (jk, ks), (jv, vs) = (jkvquant.quantize(jk, kv_dtype),
                              jkvquant.quantize(jv, kv_dtype))
        jscales = dict(k_scale=ks, v_scale=vs)
        tscales = {k: _t(v) for k, v in jscales.items()}
    want = np.asarray(paged_ring_pallas(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos),
        interpret=True, **kw, **jscales))
    # the port's pool: the same stored pages, dead rows poisoned (NaN
    # values, and NaN scales with NaN or -128 payloads when quantized)
    tk, tv = _t(jk), _t(jv)
    dead_t = torch.from_numpy(dead)
    for pages in (tk, tv):
        if pages.dtype == torch.float8_e4m3fn:
            pages.view(torch.uint8)[dead_t] = 0x7F
        elif pages.dtype == torch.int8:
            pages[dead_t] = -128
        else:
            pages[dead_t] = float("nan")
    if tscales:
        for sc in tscales.values():
            sc[dead_t] = float("nan")
    case = (_t(q), tk, tv, _t(bt), _t(pos))
    geo = cases.ring_geometry(hd, g, tk.element_size())
    out = cases.ring_cluster_fold(case, kw, c=c, stage_rows=geo["stage_rows"],
                                  units=geo["units"], scales=tscales)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("stage_rows,units", [(8, 3), (5, 2), (13, 1),
                                              (64, 64)])
def test_cluster_fold_ignores_the_staging_geometry(stage_rows, units):
    """Stage boundaries and the units' split move only the summation
    order: any geometry gives the plain version's output within the
    tolerance, stages cutting pages and pages cutting stages alike."""
    q, kp, vp, bt, pos, dead = _pool(7, [5, 40, 200, 29, 1000], kvh=2, g=2,
                                     hd=16, window=CAP - 24)
    kw = dict(window=CAP - 24, softcap=0.0, scale=0.25)
    kp[dead], vp[dead] = np.nan, np.nan
    case = tuple(_t(x) for x in (q, kp, vp, bt, pos))
    out = cases.ring_cluster_fold(case, kw, c=3, stage_rows=stage_rows,
                                  units=units)
    ref = cases.plain_ring(case, kw)
    torch.testing.assert_close(out, ref, **ATTN_TOL)


# ---- the card cases' plan checks --------------------------------------------

def _plan(c, *, hd=16, g=2, tsize=4):
    geo = cases.ring_geometry(hd, g, tsize)
    return dict(cluster=c, smem_bytes=1, clusters_at_once=1, stages=3,
                stage_rows=geo["stage_rows"], lanes_per_row=geo["lanes"],
                heads_per_unit=geo["heads"], row_elems=geo["row_elems"])


def _card_case(positions, window=CAP):
    gen = torch.Generator().manual_seed(0)
    (case,), kw = cases.ring_case(gen, positions, kvh=2, g=2, hd=16, bs=BS,
                                  rb=RB, window=window)
    return case, kw


@pytest.mark.parametrize("label", ["B 1", "B 2"])
def test_plan_note_requires_a_cluster_for_few_requests(label):
    case, kw = _card_case([300, 500][:int(label[-1])])
    assert "C 3" in cases.ring_plan_note(_plan(3), case, kw, label)
    with pytest.raises(AssertionError, match="one rank"):
        cases.ring_plan_note(_plan(1), case, kw, label)


def test_plan_note_requires_empty_ranks_and_partial_pages():
    case, kw = _card_case([0, 2])
    assert "4 empty ranks" in cases.ring_plan_note(_plan(4), case, kw,
                                                   "pos < C")
    case, kw = _card_case([300, 500])
    with pytest.raises(AssertionError, match="no rank's share is empty"):
        cases.ring_plan_note(_plan(2), case, kw, "pos < C")
    # window CAP - 24 from positions 1003 (p0 900, slot 4) and 499 (p0
    # 396, slot 12): both start inside a page; 399 (p0 296, slot 40)
    # does not
    case, kw = _card_case([1003, 499], window=CAP - 24)
    assert "2 windows from inside a page" in cases.ring_plan_note(
        _plan(2), case, kw, "window 1000, partial first page")
    case, kw = _card_case([1003, 399], window=CAP - 24)
    with pytest.raises(AssertionError, match="page boundary"):
        cases.ring_plan_note(_plan(2), case, kw,
                             "window 1000, partial first page")


def test_plan_note_holds_the_plan_to_the_folds_geometry():
    case, kw = _card_case([300, 500])
    for key, value in (("lanes_per_row", 32), ("row_elems", 256),
                       ("stage_rows", 1)):
        with pytest.raises(AssertionError, match="geometry"):
            cases.ring_plan_note(dict(_plan(2), **{key: value}), case, kw,
                                 "B 2")


def test_rows_pad_to_the_lanes_width():
    """A row takes 8 f32 or 16 narrower elements a lane over a power of
    two of lanes: hd 80 pads to 128 (16 f32 lanes, 8 int8 ones); hd 128,
    64 and 256 are unpadded; hd 8 int8 pads to one lane of 16."""
    geo = cases.ring_geometry
    assert (geo(80, 2, 4)["row_elems"], geo(80, 2, 4)["lanes"]) == (128, 16)
    assert (geo(80, 2, 1)["row_elems"], geo(80, 2, 1)["lanes"]) == (128, 8)
    for hd, tsize in ((128, 4), (64, 1), (256, 2), (256, 4)):
        assert geo(hd, 2, tsize)["row_elems"] == hd
    assert geo(8, 2, 1)["row_elems"] == 16
    case, kw = _card_case([300, 500])
    with pytest.raises(AssertionError, match="not padded"):
        cases.ring_plan_note(_plan(2), case, kw, "hd 80, padded rows")
