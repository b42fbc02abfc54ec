"""The flash-decode kernel's card cases and its algorithm in plain torch.

``CARD_CASES`` are the shapes ``chip_smoke.py`` and the card tests hold
``flash_decode.cu`` to its plain version on; :func:`plan_note` checks
that a case's launch plan (``ops.flash_decode_plan``) exercises what its
label names.  :func:`decode_share`, :func:`decode_geometry` and
:func:`decode_cluster_fold` are the kernel's computation (a row's K
entries split into C even shares, each staged ``stage_rows`` at a time
and folded by units of their own, then the units' and the ranks'
merges) in plain float32 torch, which the CPU tests hold to the JAX
package's Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["CARD_CASES", "card_case", "decode_share", "decode_geometry",
           "decode_cluster_fold", "plan_note"]

THREADS = 512             # threads a CTA (paged_common.cuh's kThreads)
STAGE_BYTES = 32 * 1024   # K and V rows of a stage, about (kStageBytes)
ROWS_A_UNIT = 2           # rows a unit folds at once (kRowsAUnit)

# (label, shape): the static path's shape first (llama31-8b, batch 2, KVH
# 8, G 4, budget 823), then the other configs' head shapes and the edges.
# ``dead_row``: a row whose mask is all false (its output must be 0).
CARD_CASES = [
    ("main path", dict(bh=16, k=823, g=4, hd=128, dtype=torch.float32)),
    ("stablelm hd=160", dict(bh=16, k=823, g=4, hd=160,
                             dtype=torch.float32)),
    ("ragged K, dead row", dict(bh=5, k=77, g=4, hd=128,
                                dtype=torch.float32, dead_row=2)),
    ("K < block, bf16 K/V", dict(bh=3, k=9, g=2, hd=64,
                                 dtype=torch.bfloat16, dead_row=0)),
    # batch 1: 8 rows, split over more ranks
    ("B 1", dict(bh=8, k=823, g=4, hd=128, dtype=torch.float32)),
    # gemma-7b's static path (batch 2, 4112 rows): 16 KV heads of hd 256,
    # one query head each, budget 412
    ("gemma-7b hd 256, G 1", dict(bh=32, k=412, g=1, hd=256,
                                  dtype=torch.float32)),
    # mixtral 8x22b: 48 query heads over 8 KV heads
    ("mixtral G 6", dict(bh=16, k=823, g=6, hd=128, dtype=torch.float32)),
    ("K < C", dict(bh=1, k=3, g=4, hd=128, dtype=torch.float32)),
    ("f16 K/V", dict(bh=16, k=823, g=4, hd=128, dtype=torch.float16,
                     dead_row=5)),
    ("BH 256, K 64", dict(bh=256, k=64, g=4, hd=128, dtype=torch.float32)),
    # 72-byte rows: copied 8 bytes at a time into rows padded to 80
    ("hd 36 bf16, padded rows", dict(bh=4, k=300, g=4, hd=36,
                                     dtype=torch.bfloat16, dead_row=1)),
    # musicgen-medium's static path (batch 4 x 24 heads of hd 64, MHA, a
    # 1532-row cache, budget 256): one head a unit, 8 lanes a row
    ("musicgen hd 64, G 1", dict(bh=96, k=256, g=1, hd=64,
                                 dtype=torch.float32)),
]


def card_case(gen: torch.Generator, *, bh: int, k: int, g: int, hd: int,
              dtype: torch.dtype, dead_row=None):
    """q (f32), k and v (``dtype``) and a mask keeping ~90 % of the rows
    on ``gen``'s device; row ``dead_row`` keeps none."""
    dev = gen.device
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    kk = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    vv = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    mask = torch.rand((bh, k), generator=gen, device=dev) < 0.9
    if dead_row is not None:
        mask[dead_row] = False
    return q, kk, vv, mask


def decode_share(k: int, c: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s even share ``[k_lo, k_hi)`` of a row's ``k``
    entries over C ranks."""
    return k * rank // c, k * (rank + 1) // c


def decode_geometry(hd: int, g: int, tsize: int) -> dict:
    """The fold's shape ``flash_decode.cu``'s plan gives: ``elems`` a lane
    holds of a row (8 f32, 16 of the 2-byte types), ``lanes`` a row (the
    least power of two holding hd), ``heads`` a unit (2 for G >= 2, else
    1), ``units`` a head group (512 / lanes over the groups), the row's
    ``stride`` in shared memory (hd * tsize bytes padded to 16) and
    ``stage_rows`` (a multiple of the rows the units fold at once, two a
    unit, about 32 KB of K and V rows)."""
    elems = 8 if tsize == 4 else 16
    lanes = 1
    while elems * lanes < hd:
        lanes *= 2
    heads = 2 if g >= 2 else 1
    units = (THREADS // lanes) // (-(-g // heads))
    stride = -(-hd * tsize // 16) * 16
    at_once = ROWS_A_UNIT * units
    return dict(elems=elems, lanes=lanes, heads=heads, units=units,
                stride=stride,
                stage_rows=at_once * max(1, STAGE_BYTES //
                                         (2 * at_once * stride)))


def decode_cluster_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, *, scale: float, c: int,
                        stage_rows: int, units: int) -> torch.Tensor:
    """``flash_decode.cu``'s output as its C ranks compute it, in
    float32: rank r takes its even share of the K entries
    (:func:`decode_share`), staged ``stage_rows`` at a time from the
    share's start; row r of a stage goes to unit r mod ``units``, each
    unit an online softmax of its own (logit q.k * scale; a masked row
    skipped; the sums rescaled when the max grows); the units merge, then
    the ranks (m -1e30, l 0 where a share is empty or wholly masked), and
    the output is acc / max(l, 1e-30).  q (BH, G, hd); k/v (BH, K, hd);
    mask (BH, K) bool -> f32 (BH, G, hd)."""
    bh, g, hd = q.shape
    kk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    neg = torch.tensor(-1e30)
    ranks = []
    for rank in range(c):
        k_lo, k_hi = decode_share(kk, c, rank)
        m = neg.expand(units, bh, g).clone()
        l = torch.zeros((units, bh, g))
        acc = torch.zeros((units, bh, g, hd))
        for t in range(k_lo, k_hi):
            u = (t - k_lo) % stage_rows % units
            s = torch.einsum("bgd,bd->bg", qf, kf[:, t]) * scale
            keep = mask[:, t, None].expand(bh, g)
            mn = torch.where(keep, torch.maximum(m[u], s), m[u])
            alpha = torch.exp(m[u] - mn)
            p = torch.where(keep, torch.exp(s - mn), 0.0)
            l[u] = l[u] * alpha + p
            acc[u] = acc[u] * alpha[..., None] + p[..., None] * \
                vf[:, t, None, :]
            m[u] = mn
        mx = m.max(0).values
        w = torch.exp(m - mx)
        ranks.append((mx, (l * w).sum(0), (acc * w[..., None]).sum(0)))
    mx = torch.stack([r[0] for r in ranks]).max(0).values
    ll = torch.zeros((bh, g))
    aa = torch.zeros((bh, g, hd))
    for mr, lr, ar in ranks:
        e = torch.exp(mr - mx)
        ll = ll + lr * e
        aa = aa + ar * e[..., None]
    return aa / torch.clamp(ll, min=1e-30)[..., None]


def plan_note(plan: dict, label: str, *, bh: int, k: int, g: int, hd: int,
              dtype: torch.dtype, **_) -> str:
    """The plan ``ops.flash_decode_plan`` gave for a card case, as a log
    note; raises AssertionError where it does not exercise what the
    case's label names: a cluster split (C >= 2) on the main path and at
    B 1, empty ranks (C > K) at "K < C", one rank or several waves at
    "BH 256, K 64", one head a unit at G 1 (and at musicgen's hd 64 lanes
    that hold the row exactly), three head groups at G 6, 16
    elements a lane on 2-byte K/V, lanes past hd at hd 160, rows padded
    in shared memory at "hd 36 bf16, padded rows"; and the fold's lanes,
    heads a unit, units, stage rows and row stride as
    :func:`decode_geometry` has them."""
    tsize = torch.tensor([], dtype=dtype).element_size()
    geo = decode_geometry(hd, g, tsize)
    c = plan["cluster"]
    if (plan["lanes_per_row"], plan["heads_per_unit"], plan["units"],
            plan["stage_rows"], plan["row_stride"]) != (
                geo["lanes"], geo["heads"], geo["units"], geo["stage_rows"],
                geo["stride"]):
        raise AssertionError(f"flash_decode [{label}]: plan {plan} is not "
                             f"the fold's geometry {geo}")
    waves = -(-bh // max(plan["clusters_at_once"], 1))
    share = -(-k // c)
    note = (f"C {c} ({plan['clusters_at_once']} clusters at once, {waves} "
            f"wave{'s' if waves > 1 else ''}), {plan['smem_bytes']} B a CTA, "
            f"{plan['stages']} stages of {plan['stage_rows']} rows, "
            f"<= {share} rows a rank, {plan['lanes_per_row']} lanes a row, "
            f"{plan['heads_per_unit']} heads a unit, {plan['units']} units "
            f"a head group, rows of {plan['row_stride']} B")
    wants = {
        "main path": c >= 2,
        "B 1": c >= 2,
        "K < C": c > k,
        "BH 256, K 64": c == 1 or waves > 1,
        "gemma-7b hd 256, G 1": plan["heads_per_unit"] == 1,
        "musicgen hd 64, G 1": plan["heads_per_unit"] == 1 and
        plan["lanes_per_row"] * geo["elems"] == hd,
        "mixtral G 6": -(-g // plan["heads_per_unit"]) == 3,
        "f16 K/V": plan["lanes_per_row"] * 16 == hd,
        "K < block, bf16 K/V": plan["lanes_per_row"] * 16 == hd,
        "stablelm hd=160": plan["lanes_per_row"] * geo["elems"] > hd,
        "hd 36 bf16, padded rows": plan["row_stride"] > hd * tsize,
    }
    if not wants.get(label, True):
        raise AssertionError(f"flash_decode [{label}]: the plan does not "
                             f"exercise the case: {note}")
    return note
