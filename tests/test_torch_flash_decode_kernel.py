"""The flash-decode kernel's algorithm, pinned on the CPU.

``flash_decode.cu`` splits each (batch, KV head) row's K entries into C
even shares, one a rank of a thread-block cluster, stages each share
``stage_rows`` rows at a time and folds it with units of their own (an
online softmax each, masked rows skipped), then merges the units and the
ranks.  ``cases.decode_share`` is that split and
``cases.decode_cluster_fold`` the whole computation in plain float32
torch; here the shares are held to a partition of [0, K) for C 1-8
(K < C included), and the emulated output to the JAX package's
``flash_decode_pallas`` in interpret mode within the card's attention
tolerance, on numpy-seeded inputs: G 1, 2, 4, 5 and 6, hd 16, 64, 160 and
256, bf16 and f16 K/V, fully masked rows (which return 0), a single kept
row, and empty ranks.  The card cases' plan checks and the wrapper's
limits are pinned too.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.flash_decode import ops as jfd
from repro_torch.kernels.flash_decode import cases, ops

# the card's attention tolerance (chip_smoke.ATTN_TOL): float32 online
# softmax in another summation order
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
_TSIZE = {None: 4, "bf16": 2, "f16": 2}


# ---- the ranks' shares ------------------------------------------------------

@pytest.mark.parametrize("c", range(1, 9))
def test_shares_cover_k_once(c):
    """The C ranks' even shares partition [0, K) in rank order, sizes
    within one of each other; K < C leaves C - K ranks empty."""
    for k in (1, 3, 7, 823, 5000):
        shares = [cases.decode_share(k, c, r) for r in range(c)]
        assert shares[0][0] == 0 and shares[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        sizes = [hi - lo for lo, hi in shares]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        covered = np.zeros(k, int)
        for lo, hi in shares:
            covered[lo:hi] += 1
        assert (covered == 1).all()
        if k < c:
            assert sum(s == 0 for s in sizes) == c - k


# ---- the cluster fold against the JAX kernel --------------------------------

def _inputs(seed, bh, k, g, hd, *, keep=0.8, dead_rows=(), single=()):
    """numpy q, k, v (f32) and mask: ``dead_rows`` keep no row,
    ``single`` rows keep only their row k // 2."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, hd)).astype(np.float32)
    kk = rng.standard_normal((bh, k, hd)).astype(np.float32)
    vv = rng.standard_normal((bh, k, hd)).astype(np.float32)
    mask = rng.random((bh, k)) < keep
    for r in dead_rows:
        mask[r] = False
    for r in single:
        mask[r] = False
        mask[r, k // 2] = True
    return q, kk, vv, mask


def _kv(x, kv):
    """numpy K or V as the JAX array and the torch tensor of one dtype."""
    if kv == "bf16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
        return j, t
    if kv == "f16":
        h = x.astype(np.float16)
        return jnp.asarray(h), torch.from_numpy(h.copy())
    return jnp.asarray(x), torch.from_numpy(x.copy())


FOLD_CASES = {
    # label: (bh, k, g, hd, kv dtype, c, dead rows, single-kept rows)
    "G 1, C 3": (3, 90, 1, 16, None, 3, (1,), ()),
    "G 2, C 2": (3, 77, 2, 16, None, 2, (), ()),
    "G 4, C 8": (2, 103, 4, 16, None, 8, (0,), ()),
    "G 5 (llama4), C 4": (2, 60, 5, 16, None, 4, (), ()),
    "G 6 (mixtral), C 5": (2, 61, 6, 16, None, 5, (1,), ()),
    "hd 64, C 3": (2, 70, 2, 64, None, 3, (), ()),
    "hd 160 (padded lanes), C 6": (2, 50, 4, 160, None, 6, (), ()),
    "hd 256, G 1, C 7": (2, 45, 1, 256, None, 7, (), ()),
    "bf16 K/V, C 4": (3, 80, 4, 64, "bf16", 4, (2,), ()),
    "f16 K/V, C 2": (3, 80, 2, 128, "f16", 2, (0,), ()),
    "fully masked rows, C 1": (3, 40, 4, 16, None, 1, (0, 1, 2), ()),
    "a single kept row, C 8": (3, 50, 4, 16, None, 8, (), (0, 2)),
    "K < C (empty ranks), C 8": (3, 3, 4, 16, None, 8, (1,), ()),
    "K 1, C 2": (2, 1, 2, 16, None, 2, (), ()),
}


@pytest.mark.parametrize("label", list(FOLD_CASES))
def test_cluster_fold_matches_pallas(label):
    bh, k, g, hd, kv, c, dead, single = FOLD_CASES[label]
    q, kk, vv, mask = _inputs(len(label), bh, k, g, hd, dead_rows=dead,
                              single=single)
    scale = hd ** -0.5
    (jk, tk), (jv, tv) = _kv(kk, kv), _kv(vv, kv)
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jk, jv,
                                       jnp.asarray(mask), scale=scale,
                                       interpret=True))
    geo = cases.decode_geometry(hd, g, _TSIZE[kv])
    out = cases.decode_cluster_fold(
        torch.from_numpy(q), tk, tv, torch.from_numpy(mask), scale=scale,
        c=c, stage_rows=geo["stage_rows"], units=geo["units"])
    assert out.shape == (bh, g, hd) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), want, **ATTN_TOL)
    for r in dead:                        # a fully masked row returns 0
        assert not out[r].any()


@pytest.mark.parametrize("stage_rows,units", [(8, 3), (5, 2), (13, 1),
                                              (64, 64)])
def test_cluster_fold_ignores_the_staging_geometry(stage_rows, units):
    """Stage boundaries and the units' split move only the summation
    order: any geometry gives the plain version's output within the
    tolerance."""
    q, kk, vv, mask = _inputs(7, 3, 203, 4, 16, dead_rows=(2,))
    t = [torch.from_numpy(x) for x in (q, kk, vv, mask)]
    out = cases.decode_cluster_fold(*t, scale=0.25, c=3,
                                    stage_rows=stage_rows, units=units)
    ref = ops.flash_decode(*t, scale=0.25)         # the CPU: plain version
    torch.testing.assert_close(out, ref, **ATTN_TOL)


# ---- the fold's geometry and the card cases' plan checks --------------------

def test_geometry_of_the_main_shapes():
    """f32 hd 128 G 4: 16 lanes a row, two heads a unit, 16 units a head
    group, stages of 32 rows (about 32 KB of K and V); a share of the
    main path's ~103 rows spans four stages.  hd 160 takes 32 lanes with
    the row unpadded in shared memory; 2-byte rows take 16 elements a
    lane; G 6 makes three head groups."""
    geo = cases.decode_geometry(128, 4, 4)
    assert (geo["lanes"], geo["heads"], geo["units"], geo["stage_rows"]) == \
        (16, 2, 16, 32)
    assert -(-cases.decode_share(823, 8, 0)[1] // geo["stage_rows"]) >= 3
    geo = cases.decode_geometry(160, 4, 4)
    assert (geo["lanes"], geo["stride"]) == (32, 640)
    assert cases.decode_geometry(128, 4, 2)["lanes"] == 8
    assert cases.decode_geometry(6, 4, 2)["stride"] == 16    # padded to 16 B
    assert cases.decode_geometry(128, 6, 4)["units"] == 32 // 3
    assert cases.decode_geometry(256, 1, 4)["heads"] == 1


def _plan(label, c, fit=132):
    kw = dict(cases.CARD_CASES)[label]
    tsize = torch.tensor([], dtype=kw["dtype"]).element_size()
    geo = cases.decode_geometry(kw["hd"], kw["g"], tsize)
    return dict(cluster=c, smem_bytes=1, clusters_at_once=fit, stages=4,
                stage_rows=geo["stage_rows"], lanes_per_row=geo["lanes"],
                heads_per_unit=geo["heads"], units=geo["units"],
                row_stride=geo["stride"]), kw


@pytest.mark.parametrize("label,good,bad", [
    ("main path", (8, 30), (1, 132)),
    ("B 1", (8, 15), (1, 132)),
    ("K < C", (8, 15), (2, 60)),
    ("BH 256, K 64", (1, 132), (2, 256)),
    ("hd 36 bf16, padded rows", (4, 30), None),
])
def test_plan_note_requires_what_the_label_names(label, good, bad):
    plan, kw = _plan(label, *good)
    assert f"C {good[0]}" in cases.plan_note(plan, label, **kw)
    if bad is None:                       # hd 40: 80-byte rows, unpadded
        geo = cases.decode_geometry(40, 4, 2)
        plan = dict(plan, row_stride=geo["stride"],
                    stage_rows=geo["stage_rows"])
        kw = dict(kw, hd=40)
    else:
        plan, kw = _plan(label, *bad)
    with pytest.raises(AssertionError, match="does not exercise"):
        cases.plan_note(plan, label, **kw)


def test_plan_note_holds_the_plan_to_the_folds_geometry():
    plan, kw = _plan("mixtral G 6", 8)
    assert "3" in cases.plan_note(plan, "mixtral G 6", **kw)
    for key, value in (("lanes_per_row", 32), ("units", 16),
                       ("stage_rows", 1), ("heads_per_unit", 1),
                       ("row_stride", 0)):
        with pytest.raises(AssertionError, match="geometry"):
            cases.plan_note(dict(plan, **{key: value}), "mixtral G 6", **kw)


# ---- the wrapper ------------------------------------------------------------

@pytest.mark.parametrize("hd,g,match", [(257, 4, "head dim 1..256"),
                                        (128, 33, "1..32 query heads")])
def test_launch_names_the_kernels_limits(hd, g, match):
    """Above the kernel's limits the launch raises before it reaches the
    card, naming the limit."""
    q = torch.zeros((2, g, hd))
    kv = torch.zeros((2, 5, hd))
    with pytest.raises(ValueError, match=match):
        ops.launch_flash_decode(q, kv, kv, torch.ones((2, 5), dtype=bool),
                                scale=0.1)


def test_launch_refuses_mixed_kv_dtypes():
    q = torch.zeros((2, 4, 16))
    with pytest.raises(TypeError, match="share a dtype"):
        ops.launch_flash_decode(q, torch.zeros((2, 5, 16)),
                                torch.zeros((2, 5, 16), dtype=torch.float16),
                                torch.ones((2, 5), dtype=bool), scale=0.1)
