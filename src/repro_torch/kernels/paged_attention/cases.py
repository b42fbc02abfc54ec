"""Inputs for the fused paged kernels, and the checks that hold each to
its plain version, shared by ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``).

SOCKET (:func:`paged_case`, :func:`check_paged`): the count of selected
rows exactly ``min(budget, length)`` per (request, head), the selection
equal to the plain version's — bit for bit where all scores tie exactly,
elsewhere except at rows whose plain effective score lies within
``score_tol`` of the threshold (the kernel forms each term as
exp(a) * exp(b) from its split tables, a few ulps from exp(a + b), and
sums in another order) — and the output within ``attn_tol`` of the plain
version's; where rows inside that band were swapped, of the plain
attention over the kernel's own selection (``ref.attend_selected``).

Hard LSH (:func:`hard_lsh_case`, :func:`check_hard_lsh`): collision
counts are exact, so the selection must equal the plain version's bit
for bit, with ``min(budget, length)`` rows.

Quest (:func:`quest_case`, :func:`check_quest`): page bounds are summed
in float64 on both sides, so the selection must equal the plain version's
bit for bit; exactly ``page_budget`` pages are selected per (request,
head) — pages past ``length`` included — and the selected rows are the
live rows of those pages (not ``min(budget, length)``).

Ring (:func:`ring_case`, :func:`check_ring`): every dead slot (never
written, or out of the window) and the trash page hold NaN, which the
kernel must skip; the plain version, which masks logits and would carry
0 · NaN into p · V, runs on the pool with the NaN rows zeroed.  The
output within ``attn_tol``.

Stored pools (:func:`store_kv`): any case's K/V pages as bf16, or as
int8 / fp8 rows with per-row scale pools (``serving.kv_dtype``'s
quantization), shared by every set of the case.  Each check takes the
scale pools as ``scales`` and holds the kernel to the plain version on
the same stored pages; Quest's page stats become those of the keys'
quantization round trip (``quest.stats_from_quantized``), and a ring's
dead rows hold NaN in their scales and fp8 payloads too.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.baselines import quest as quest_mod
from repro_torch.core import hashing, socket as sk
from repro_torch.kernels.paged_attention.ref import (
    attend_selected, paged_hard_lsh_attend_ref, paged_quest_attend_ref,
    paged_ring_attend_ref, paged_socket_attend_ref)
from repro_torch.kernels.socket_score.ref import (socket_score_ref,
                                                  split_table_scores)
from repro_torch.models.backends import kvquant
from repro_torch.models.backends.base import gather_block_leaf

__all__ = ["paged_case", "plain_eff", "check_paged", "hard_lsh_case",
           "plain_hard_eff", "check_hard_lsh", "quest_case", "check_quest",
           "RING_CASES", "RING_TIMED", "ring_live", "ring_case",
           "plain_ring", "check_ring", "ring_live_rows", "ring_share",
           "ring_geometry", "ring_cluster_fold", "ring_plan_note",
           "store_kv", "sort_key", "split_table_scores",
           "cta_ranges", "cluster_select", "tie_ranks", "quest_page_eff",
           "quest_cluster_select", "quest_page_selection", "ties_cut"]


def store_kv(sets, kv_dtype: str, *, quest: bool = False):
    """``sets`` (of any case builder here: K/V pages at positions 1 and 2,
    one pool shared by every set) with the K/V pages stored as
    ``kv_dtype``: ``"bf16"`` (a cast), or ``"int8"`` / ``"fp8"``
    (:func:`kvquant.quantize` per row).  Returns ``(sets, scales)``, the
    scale pools as ``dict(k_scale=..., v_scale=...)`` (empty for bf16).

    Rows holding NaN (a ring's dead slots, the trash page) are quantized
    as zeros and then get NaN scales, and NaN (fp8) or -128 (int8)
    payloads: the kernels must skip them.  ``quest``: positions 3 and 4
    are the kmin/kmax stats, recomputed from the keys' quantization round
    trip (unwritten ±inf stat rows kept)."""
    kp, vp = sets[0][1], sets[0][2]
    scales = {}
    if kv_dtype == "bf16":
        kq, vq = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    else:
        out = []
        for x in (kp, vp):
            nan = torch.isnan(x).any(-1)
            q, sc = kvquant.quantize(torch.nan_to_num(x, nan=0.0), kv_dtype)
            sc[nan] = float("nan")
            if kv_dtype == "fp8":
                q.view(torch.uint8)[nan] = 0x7F           # e4m3fn NaN
            else:
                q[nan] = -128
            out.append((q, sc))
        (kq, ks), (vq, vs) = out
        scales = dict(k_scale=ks, v_scale=vs)
    stats = None
    if quest and scales:
        kmin, kmax = sets[0][3], sets[0][4]
        nblocks, kvh, ppb, hd = kmin.shape
        rt = kvquant.dequantize(kq, scales["k_scale"]).reshape(
            nblocks, kvh, ppb, -1, hd)
        stats = (torch.where(torch.isinf(kmin), kmin, rt.amin(dim=3)),
                 torch.where(torch.isinf(kmax), kmax, rt.amax(dim=3)))
    new = []
    for st in sets:
        st = list(st)
        st[1], st[2] = kq, vq
        if stats is not None:
            st[3], st[4] = stats
        new.append(tuple(st))
    return new, scales


def paged_case(gen: torch.Generator, lengths: Sequence[int], *, nb: int,
               kvh: int = 8, g: int = 4, hd: int = 128, l: int = 60,
               p: int = 10, bs: int = 16, sink: int = 128, window: int = 128,
               ties: bool = False, pooled: bool = False,
               sparsity: float = 10.0, copies: int = 1
               ) -> Tuple[List, dict]:
    """Pool, block tables and queries on ``gen``'s device; budgets from
    ``dynamic_topk_budget`` at ``sparsity``.  Returns ``(sets, kw)``: each
    set is the positional arguments ``(q, k_pages, v_pages, bits, vnorm,
    u, block_table, length, budget)``, ``kw`` the keyword ones.

    ``copies`` sets share one pool, each set's requests on blocks of
    their own (so rotating through the sets reads fresh memory); tables
    are trash-padded (block 0) past each request's blocks.  ``ties``:
    every bits and vnorm row identical, so all scored rows tie exactly.
    ``pooled``: one query hash per KV head (GS 1, of the group's mean
    query), as pooled selection hashes."""
    dev = gen.device
    b, w = len(lengths), hashing.num_words(l, p)
    need = [-(-n // bs) for n in lengths]
    nblocks = 1 + copies * sum(need)
    ids = (torch.randperm(nblocks - 1, generator=gen, device=dev) + 1
           ).to(torch.int32)
    k_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    v_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    bits = torch.randint(-2 ** 31, 2 ** 31, (nblocks, kvh, bs, w),
                         generator=gen, device=dev, dtype=torch.int32)
    vnorm = (torch.rand((nblocks, kvh, bs), generator=gen, device=dev) * 4
             ).to(torch.bfloat16)
    if ties:
        bits[:] = bits[1, 0, 0]
        vnorm[:] = vnorm[1, 0, 0]
    planes = torch.randn((l, p, hd), generator=gen, device=dev)
    scfg = sk.SocketConfig(num_planes=p, num_tables=l, tau=0.4,
                           sink_tokens=sink, window_tokens=window,
                           sparsity=sparsity)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    budget = sk.dynamic_topk_budget(scfg, length,
                                    sk.topk_budget(scfg, nb * bs)).to(dev)
    sets, off = [], 0
    for _ in range(copies):
        bt = torch.zeros((b, nb), dtype=torch.int32, device=dev)
        for i, k in enumerate(need):
            bt[i, :k] = ids[off:off + k]
            off += k
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
        u = sk.soft_hash_query(planes, q.mean(dim=2, keepdim=True)
                               if pooled else q)          # (B, KVH, GS, L, P)
        sets.append((q, k_pages, v_pages, bits, vnorm, u, bt, length,
                     budget))
    kw = dict(num_tables=l, num_planes=p, tau=0.4, scale=hd ** -0.5,
              sink_tokens=sink, window_tokens=window)
    return sets, kw


def plain_eff(case, kw) -> torch.Tensor:
    """The plain version's effective scores ``(B, KVH, nb*bs)`` over the
    logical view: forced sink/window rows FLT_MAX, rows past length
    -1e30."""
    q, _, _, bits, vnorm, u, bt, length, _ = case
    b, kvh = q.shape[:2]
    lb = gather_block_leaf(bits, bt)
    n = lb.shape[2]
    s = socket_score_ref(lb.reshape(b * kvh, n, -1),
                         u.reshape(b * kvh, *u.shape[2:]), None,
                         num_tables=kw["num_tables"],
                         num_planes=kw["num_planes"], tau=kw["tau"])
    eff = s.reshape(b, kvh, n) * gather_block_leaf(vnorm, bt).float()
    pos = torch.arange(n, device=q.device)
    ln = length.long()[:, None, None]
    forced = (pos < kw["sink_tokens"]) | (pos >= ln - kw["window_tokens"])
    eff = torch.where(forced, sk.FLT_MAX, eff)
    return torch.where(pos < ln, eff, sk.NEG_INF)


def check_paged(out: torch.Tensor, sel: torch.Tensor, case, kw, *,
                ties: bool, attn_tol: dict, score_tol: dict,
                scales=None) -> Tuple[float, int]:
    """Hold the kernel's ``(out, sel)`` on ``case`` (its K/V pages'
    ``scales`` as :func:`store_kv` gives them) to the plain version (see
    the module docstring): the selection first, then the output, against
    the plain attention over the kernel's selection where rows inside the
    threshold band were swapped.  Raises AssertionError on a mismatch.
    Returns (max |out error|, selected rows that differ inside the
    threshold band)."""
    q, kp, vp, bits, vnorm, u, bt, length, budget = case
    n = bt.shape[1] * bits.shape[2]
    ref, ref_sel = paged_socket_attend_ref(
        q, kp, vp, bits, vnorm, u, bt, length=length, budget=budget,
        top_k=min(n, int(budget.max())), **kw, **(scales or {}))
    sel = sel.reshape(*sel.shape[:2], -1).bool()
    want = torch.minimum(budget.long(), length.long())[:, None]
    if not torch.equal(sel.sum(-1), want.expand(-1, sel.shape[1])):
        raise AssertionError("paged_attention: selected-row counts differ "
                             "from min(budget, length)")
    diff = sel != ref_sel
    near = int(diff.sum().item())
    if near:
        if ties:
            raise AssertionError("paged_attention: tied scores must select "
                                 "bit for bit")
        eff = plain_eff(case, kw)
        k = (budget.long() - 1).clamp(max=n - 1).reshape(-1, 1, 1)
        thr = torch.sort(eff, dim=-1, descending=True).values.gather(
            -1, k.expand(-1, eff.shape[1], 1))
        close = (eff - thr).abs() <= score_tol["atol"] + \
            score_tol["rtol"] * thr.abs()
        if (diff & ~close).any():
            raise AssertionError("paged_attention: selection differs beyond "
                                 "the threshold band")
        # rows swapped inside the band: the output is held to the plain
        # attention over the kernel's own selection
        ref = attend_selected(q, kp, vp, bt, sel, scale=kw["scale"],
                              **(scales or {}))
    return _check_out("paged_attention", out, ref, attn_tol), near


def _check_out(name: str, out: torch.Tensor, ref: torch.Tensor,
               attn_tol: dict) -> float:
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out.double() - ref.double()).abs()
    lim = attn_tol["atol"] + attn_tol["rtol"] * ref.double().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: max |err| {err.max().item():.3e} exceeds "
            f"atol {attn_tol['atol']} + rtol {attn_tol['rtol']} * |ref|")
    return float(err.max().item())


def hard_lsh_case(gen: torch.Generator, lengths: Sequence[int], *, nb: int,
                  near: float = 0.25, **kw) -> Tuple[List, dict]:
    """:func:`paged_case`'s pool with the query hash replaced by its ±1
    plane signs ``u_signs`` and, unless ``ties``, a ``near`` share of
    each request's rows re-hashed to agree with its first query head's
    sign pattern in a random half of the tables (random bits collide in
    a table with probability 2^-P: without them nearly every score would
    be 0).  Returns ``(sets, kw)`` like :func:`paged_case`, without
    ``tau``."""
    sets, args = paged_case(gen, lengths, nb=nb, **kw)
    dev = gen.device
    l, p = args["num_tables"], args["num_planes"]
    out = []
    for q, k_pages, v_pages, bits, vnorm, u, bt, length, budget in sets:
        u_signs = torch.where(u >= 0, 1.0, -1.0)
        if not kw.get("ties", False):
            bs = bits.shape[2]
            for i, n in enumerate(lengths):
                t = torch.nonzero(torch.rand((n,), generator=gen,
                                             device=dev) < near).flatten()
                if not len(t):
                    continue
                pattern = u[i, :, 0] >= 0                  # (KVH, L, P)
                rand = torch.rand((len(t), *pattern.shape), generator=gen,
                                  device=dev) < 0.5
                keep = torch.rand((len(t), pattern.shape[0], l, 1),
                                  generator=gen, device=dev) < 0.5
                signs = torch.where(keep, pattern[None], rand)
                blk = bt[i].long()[t // bs]
                bits[blk, :, t % bs] = hashing.pack_signs(signs)
        out.append((q, k_pages, v_pages, bits, vnorm, u_signs, bt, length,
                    budget))
    del args["tau"]
    return out, args


def plain_hard_eff(case, kw) -> torch.Tensor:
    """The plain version's effective scores ``count * vnorm`` of the rows
    the kernel scores (live, neither sink nor window), flattened."""
    from repro_torch.models.backends.hard_lsh import _hard_collision_scores
    q, _, _, bits, vnorm, u_signs, bt, length, _ = case
    cfg = sk.SocketConfig(num_planes=kw["num_planes"],
                          num_tables=kw["num_tables"])
    counts = _hard_collision_scores(cfg, gather_block_leaf(bits, bt),
                                    u_signs).sum(dim=2)
    eff = counts * gather_block_leaf(vnorm, bt).float()
    pos = torch.arange(eff.shape[-1], device=q.device)
    ln = length.long()[:, None, None]
    scored = (pos >= kw["sink_tokens"]) & (pos < ln - kw["window_tokens"])
    return eff[scored.expand_as(eff)]


def check_hard_lsh(out: torch.Tensor, sel: torch.Tensor, case, kw, *,
                   attn_tol: dict, scales=None) -> float:
    """Hold the hard-LSH kernel's ``(out, sel)`` on ``case`` (with its
    ``scales``) to the plain version: selection bit for bit with
    ``min(budget, length)`` rows per (request, head), output within
    ``attn_tol``.  Returns max |out error|; raises AssertionError on a
    mismatch."""
    q, kp, vp, bits, vnorm, u_signs, bt, length, budget = case
    n = bt.shape[1] * bits.shape[2]
    ref, ref_sel = paged_hard_lsh_attend_ref(
        q, kp, vp, bits, vnorm, u_signs, bt, length=length, budget=budget,
        top_k=min(n, int(budget.max())), **kw, **(scales or {}))
    err = _check_out("paged_hard_lsh", out, ref, attn_tol)
    sel = sel.reshape(*sel.shape[:2], -1).bool()
    want = torch.minimum(budget.long(), length.long())[:, None]
    if not torch.equal(sel.sum(-1), want.expand(-1, sel.shape[1])):
        raise AssertionError("paged_hard_lsh: selected-row counts differ "
                             "from min(budget, length)")
    if not torch.equal(sel, ref_sel):
        raise AssertionError("paged_hard_lsh: selection differs from the "
                             "plain version's (it must select bit for bit)")
    return err


def quest_case(gen: torch.Generator, lengths: Sequence[int], *, nb: int,
               kvh: int = 8, g: int = 4, hd: int = 128, bs: int = 16,
               ps: int = 16, sink: int = 128, window: int = 128,
               sparsity: float = 10.0, min_pages: int = 4,
               ties: bool = False, copies: int = 1) -> Tuple[List, dict]:
    """Pool, per-page kmin/kmax stats, block tables and queries on
    ``gen``'s device.  Each set is ``(q, k_pages, v_pages, kmin, kmax,
    block_table, length, page_budget)``; ``kw`` the keyword arguments of
    :func:`ops.paged_quest_attend`.  The stats are the min/max over each
    page's rows; stat rows of pages past a request's length, and of the
    trash block 0, hold the pool's +-inf fill, as unwritten pages do in
    the engine.  ``ties``: every block's keys identical, so all scored
    pages tie exactly.  ``page_budget`` is the static
    ``quest.page_budget`` of the table's capacity; ``copies`` as in
    :func:`paged_case`."""
    dev = gen.device
    b, ppb = len(lengths), bs // ps
    need = [-(-n // bs) for n in lengths]
    nblocks = 1 + copies * sum(need)
    ids = (torch.randperm(nblocks - 1, generator=gen, device=dev) + 1
           ).to(torch.int32)
    k_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    v_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    if ties:
        k_pages[:] = k_pages[1]
    pages = k_pages.reshape(nblocks, kvh, ppb, ps, hd)
    kmin, kmax = pages.amin(dim=3), pages.amax(dim=3)
    kmin[0], kmax[0] = float("inf"), float("-inf")
    qcfg = quest_mod.QuestConfig(page_size=ps, sparsity=sparsity,
                                 sink_tokens=sink, window_tokens=window,
                                 min_pages=min_pages)
    n = nb * bs
    budget = quest_mod.page_budget(qcfg, n // ps, n)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sets, off = [], 0
    for _ in range(copies):
        bt = torch.zeros((b, nb), dtype=torch.int32, device=dev)
        for i, k in enumerate(need):
            bt[i, :k] = ids[off:off + k]
            off += k
            dead = torch.arange(k * ppb, device=dev)
            dead = dead[dead * ps >= lengths[i]]
            blk = bt[i].long()[dead // ppb]
            kmin[blk, :, dead % ppb] = float("inf")
            kmax[blk, :, dead % ppb] = float("-inf")
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
        sets.append((q, k_pages, v_pages, kmin, kmax, bt, length,
                     torch.full((b,), budget, dtype=torch.int32,
                                device=dev)))
    kw = dict(page_size=ps, scale=hd ** -0.5, sink_tokens=sink,
              window_tokens=window)
    return sets, kw


def check_quest(out: torch.Tensor, sel: torch.Tensor, case, kw, *,
                attn_tol: dict, scales=None) -> float:
    """Hold the Quest kernel's ``(out, sel)`` on ``case`` (with its
    ``scales``) to the plain version: exactly ``page_budget`` pages a
    (request, head) and their live rows selected, the selection bit for
    bit, the output within ``attn_tol``.  Returns max |out error|; raises
    AssertionError on a mismatch."""
    q, kp, vp, kmin, kmax, bt, length, budget = case
    ps = kw["page_size"]
    ref, ref_sel = paged_quest_attend_ref(
        q, kp, vp, kmin, kmax, bt, length=length, page_budget=budget, **kw,
        **(scales or {}))
    err = _check_out("paged_quest", out, ref, attn_tol)
    sel = sel.reshape(*sel.shape[:2], -1).bool()
    # page_budget pages, live rows within them (never min(budget, length))
    eff = quest_page_eff(case, kw)
    top = torch.sort(eff, dim=-1, descending=True, stable=True).indices
    kp_max = int(budget.max())
    chosen = top[..., :kp_max] * ps                     # page starts
    chosen = torch.where(torch.arange(kp_max, device=q.device)
                         < budget.long()[:, None, None], chosen, -1)
    if not bool(((chosen >= 0).sum(-1) == budget.long()[:, None]).all()):
        raise AssertionError("paged_quest: plain version did not take "
                             "page_budget pages")
    live = (length.long()[:, None, None] - chosen).clamp(0, ps)
    live = torch.where(chosen >= 0, live, 0).sum(-1)
    if not torch.equal(sel.sum(-1), live):
        raise AssertionError("paged_quest: selected-row counts differ from "
                             "the live rows of page_budget pages")
    if not torch.equal(sel, ref_sel):
        raise AssertionError("paged_quest: selection differs from the plain "
                             "version's (it must select bit for bit)")
    return err


# ---- the SOCKET kernel's algorithm in plain torch ---------------------
# (paged_attention.cu: the per-rank 8-bit-digit select; its split-table
# scoring is socket_score/ref.py's split_table_scores, shared with
# socket_score.cu; the CPU tests hold these to the JAX package)

def sort_key(eff: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving f32 -> uint32 map, as int64."""
    u = eff.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def cta_ranges(length: int, bs: int, c: int) -> List[Tuple[int, int]]:
    """The token range ``[r0, r1)`` of each of the C ranks of a request:
    rank r owns the r-th run of ceil(blocks / C) of its live blocks."""
    used = -(-max(length, 0) // bs)
    per = -(-used // c)
    return [(min(length, r * per * bs), min(length, (r + 1) * per * bs))
            for r in range(c)]


def cluster_select(eff: torch.Tensor, length, budget, *, bs: int,
                   c: int, floor=-5e29) -> torch.Tensor:
    """The selection ``(B, KVH, N)`` bool of ``eff`` (the plain effective
    scores, rows past length -1e30) as C ranks find it: four rounds of
    8-bit digits, each a histogram per rank of the keys matching the
    prefix so far, summed over the ranks with the rows past length
    counted once; then rank r counts its ties from the keys equal to the
    threshold in ranks < r (the last round's bins).  A selected row also
    scores above ``floor`` (SOCKET's -5e29; None: no floor, as Quest)."""
    b, kvh, n = eff.shape
    keys = sort_key(eff)
    k_inv = int(sort_key(torch.tensor([sk.NEG_INF]))[0])
    sel = torch.zeros((b, kvh, n), dtype=torch.bool)
    for i in range(b):
        ln, bud = int(length[i]), int(budget[i])
        ranges = cta_ranges(ln, bs, c)
        for h in range(kvh):
            ranks = [keys[i, h, r0:r1] for r0, r1 in ranges]
            prefix, above, hists = 0, 0, None
            for rnd in (3, 2, 1, 0):
                shift = 8 * rnd
                hi_mask = 0 if rnd == 3 else (0xFFFFFFFF << (shift + 8)) \
                    & 0xFFFFFFFF
                hists = []
                for kr in ranks:
                    m = kr[((kr ^ prefix) & hi_mask) == 0]
                    hists.append(torch.bincount((m >> shift) & 0xFF,
                                                minlength=256))
                tot = sum(hists)
                if (k_inv ^ prefix) & hi_mask == 0:
                    tot[(k_inv >> shift) & 0xFF] += n - ln
                digit, gt = 0, above + int(tot[1:].sum())
                run = above
                for d in range(255, -1, -1):
                    if run + int(tot[d]) >= bud:
                        digit, gt = d, run
                        break
                    run += int(tot[d])
                prefix |= digit << shift
                above = gt
            thr, ties_needed = prefix, bud - above
            seen = 0
            for (r0, r1), kr, hist in zip(ranges, ranks, hists):
                eq = kr == thr
                rank_eq = seen + torch.cumsum(eq.long(), 0) - eq.long()
                take = (kr > thr) | (eq & (rank_eq < ties_needed))
                if floor is not None:
                    take &= eff[i, h, r0:r1] > floor
                sel[i, h, r0:r1] = take
                seen += int(hist[thr & 0xFF])
    return sel


def tie_ranks(eff: torch.Tensor, sel: torch.Tensor, length, budget, *,
              bs: int, c: int) -> int:
    """The most ranks over which one (request, head)'s selected rows that
    tie at the threshold lie (2 or more: the tie count crosses ranks)."""
    most = 0
    b, kvh, n = eff.shape
    keys = sort_key(eff)
    for i in range(b):
        ranges = cta_ranges(int(length[i]), bs, c)
        for h in range(kvh):
            chosen = keys[i, h][sel[i, h]]
            if not len(chosen):
                continue
            thr = chosen.min()
            tied = sel[i, h] & (keys[i, h] == thr)
            most = max(most, sum(bool(tied[r0:r1].any())
                                 for r0, r1 in ranges))
    return most


def ties_cut(eff: torch.Tensor, sel: torch.Tensor) -> bool:
    """Whether some (request, head) left a live entry (score above -5e29)
    that ties its threshold unselected: the tie count, not the key,
    decided there."""
    keys = sort_key(eff)
    for i in range(eff.shape[0]):
        for h in range(eff.shape[1]):
            chosen = keys[i, h][sel[i, h]]
            if len(chosen):
                tied = (keys[i, h] == chosen.min()) & ~sel[i, h]
                if bool((tied & (eff[i, h] > -5e29)).any()):
                    return True
    return False


# ---- the Quest kernel's select in plain torch -------------------------
# (paged_quest.cu: cluster_select on page scores, ranks in page units)

def quest_page_eff(case, kw) -> torch.Tensor:
    """The plain version's page scores ``(B, KVH, nb * ppb)`` of a
    :func:`quest_case` set: float64 bounds rounded once, sink and window
    pages FLT_MAX, pages past length -1e30."""
    q, _, _, kmin, kmax, bt, length, _ = case
    state = quest_mod.QuestState(kmin=gather_block_leaf(kmin, bt),
                                 kmax=gather_block_leaf(kmax, bt))
    qcfg = quest_mod.QuestConfig(page_size=kw["page_size"],
                                 sink_tokens=kw["sink_tokens"],
                                 window_tokens=kw["window_tokens"])
    return quest_mod.group_page_scores(qcfg, state, q[:, :, :, None], length)


def quest_page_selection(sel: torch.Tensor, ps: int) -> torch.Tensor:
    """A selected-rows mask ``(B, KVH, N)`` as its selected pages ``(B,
    KVH, N / ps)``: pages with a selected row (the live ones)."""
    return sel.reshape(*sel.shape[:2], -1, ps).any(-1)


def quest_cluster_select(eff: torch.Tensor, length, budget, *, ps: int,
                         bs: int, c: int) -> torch.Tensor:
    """Quest's selected rows ``(B, KVH, n_pages * ps)`` as the kernel's C
    ranks find them from the page scores ``eff`` ``(B, KVH, n_pages)``:
    :func:`cluster_select` with ranks in page units (rank r owns the pages
    of the r-th run of live blocks, bs / ps pages a block), the live page
    count as the length (pages past it are counted, never read, and come
    last among ties) and no floor; then each selected page's rows before
    ``length``."""
    length = torch.as_tensor(length).long()
    n_live = (length + ps - 1) // ps
    pages = cluster_select(eff, n_live, budget, bs=bs // ps, c=c,
                           floor=None)
    rows = pages.repeat_interleave(ps, dim=-1)
    pos = torch.arange(rows.shape[-1], device=rows.device)
    return rows & (pos < length.to(rows.device)[:, None, None])


# The ring kernel's card cases (chip_smoke.py and the card tests): the
# gemma3 continuous shapes first (8 requests, KVH 16, G 2, hd 128, 16-token
# blocks, 64 ring blocks, window 1024; positions unwrapped and wrapped),
# then the edges.
RING_CASES = [
    ("main path, gemma3 continuous",
     dict(positions=[700, 1023, 2080, 3103, 4127, 4200, 6175, 6200])),
    ("softcap 50", dict(positions=[300, 1500, 2047, 5000], softcap=50.0)),
    ("window 1000 < cap", dict(positions=[999, 1000, 1030, 4321],
                               window=1000)),
    ("pos < block_size", dict(positions=[0, 1, 7, 15])),
    ("G 4, KVH 8", dict(positions=[100, 1024, 3333], kvh=8, g=4)),
    # few requests: the planner splits each (request, head) over C >= 2
    # ranks (B 2 is also timed)
    ("B 1", dict(positions=[5000])),
    ("B 2", dict(positions=[3000, 7000])),
    # a request whose live rows are fewer than the ranks: empty ranks
    ("pos < C", dict(positions=[0, 2])),
    ("hd 256, G 1", dict(positions=[300, 1500, 2047, 5000], hd=256, g=1)),
    ("hd 64", dict(positions=[100, 1024, 3333, 6001], hd=64)),
    # rows padded in shared memory (80 of 128 elements), copied in pieces
    # that do not divide the block's threads
    ("hd 80, padded rows", dict(positions=[100, 1024, 3333, 6001], hd=80)),
    # every window starts inside a page
    ("window 1000, partial first page",
     dict(positions=[1003, 2050, 3333, 4444], window=1000)),
]
# the ring cases timed besides their checks
RING_TIMED = ("main path", "B 2")


def ring_live(pos: torch.Tensor, cap: int, window: int) -> torch.Tensor:
    """(B, cap) bool: ring slot ``s`` of each request holds a live row —
    its position ``pos - ((pos - s) mod cap)`` is >= 0 and in the
    window."""
    back = torch.remainder(pos.long()[:, None] -
                           torch.arange(cap, device=pos.device), cap)
    return (pos.long()[:, None] - back >= 0) & (back < window)


def ring_case(gen: torch.Generator, positions: Sequence[int], *,
              kvh: int = 16, g: int = 2, hd: int = 128, bs: int = 16,
              rb: int = 64, window: int = 1024, softcap: float = 0.0,
              copies: int = 1) -> Tuple[List, dict]:
    """Ring pool, shuffled ring tables and queries on ``gen``'s device.
    Each set is ``(q, k_pages, v_pages, block_table, pos)`` with
    ``block_table`` the ``(B, rb)`` ring slice; ``kw`` the keyword
    arguments of :func:`ops.paged_ring_attend`.  A request at position
    ``p`` holds ``min(rb, p // bs + 1)`` blocks of shuffled ids, its
    first ring entries; the rest are the trash page (block 0), as in the
    engine.  Dead slots and the trash page hold NaN.  ``copies`` as in
    :func:`paged_case`."""
    dev = gen.device
    b, cap = len(positions), rb * bs
    need = [min(rb, p // bs + 1) for p in positions]
    nblocks = 1 + copies * sum(need)
    ids = (torch.randperm(nblocks - 1, generator=gen, device=dev) + 1
           ).to(torch.int32)
    k_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    v_pages = torch.randn((nblocks, kvh, bs, hd), generator=gen, device=dev)
    k_pages[0] = v_pages[0] = float("nan")
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    dead = ~ring_live(pos, cap, window)                     # (B, cap)
    sets, off = [], 0
    for _ in range(copies):
        bt = torch.zeros((b, rb), dtype=torch.int32, device=dev)
        for i, k in enumerate(need):
            bt[i, :k] = ids[off:off + k]        # the rest: trash
            off += k
            s = dead[i].nonzero(as_tuple=True)[0]
            blk = bt[i].long()[s // bs]
            k_pages[blk, :, s % bs] = float("nan")
            v_pages[blk, :, s % bs] = float("nan")
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
        sets.append((q, k_pages, v_pages, bt, pos))
    kw = dict(window=window, softcap=softcap, scale=hd ** -0.5)
    return sets, kw


def plain_ring(case, kw, scales=None) -> torch.Tensor:
    """The plain version's output on ``case`` (its K/V pages dequantized
    with ``scales`` when given), its NaN (dead) rows zeroed."""
    q, kp, vp, bt, pos = case
    if scales:
        kp = kvquant.dequantize(kp, scales["k_scale"])
        vp = kvquant.dequantize(vp, scales["v_scale"])
    return paged_ring_attend_ref(q, kp.float().nan_to_num(0.0),
                                 vp.float().nan_to_num(0.0), bt, pos=pos,
                                 **kw)


def check_ring(out: torch.Tensor, case, kw, *, attn_tol: dict,
               scales=None) -> float:
    """Hold the ring kernel's ``out`` on ``case`` (with its ``scales``) to
    :func:`plain_ring`.  Returns max |out error|; raises AssertionError on
    a mismatch."""
    ref = plain_ring(case, kw, scales)
    if not torch.isfinite(ref).all():
        raise AssertionError("paged_ring: a live row of the case is NaN")
    return _check_out("paged_ring", out, ref, attn_tol)


# ---- the ring kernel's algorithm in plain torch -----------------------
# (paged_ring.cu: the live rows in closed form, the ranks' even shares,
# staged rows folded by units of their own, the units' and the ranks'
# merges; the CPU tests hold these to ring_live and to the JAX package)

def ring_live_rows(pos: int, cap: int, window: int) -> torch.Tensor:
    """The ring slots of a request at position ``pos`` that hold live
    rows, in position order: n_live = min(pos + 1, window, cap) of them
    from p0 = pos - n_live + 1, the k-th in slot (p0 + k) mod cap."""
    n_live = max(0, min(pos + 1, window, cap))
    p0 = pos - n_live + 1
    return (p0 + torch.arange(n_live)) % cap


def ring_share(n_live: int, c: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s even share ``[k_lo, k_hi)`` of a request's
    ``n_live`` live rows over C ranks."""
    return n_live * rank // c, n_live * (rank + 1) // c


def ring_geometry(hd: int, g: int, tsize: int) -> dict:
    """The fold's shape ``paged_ring.cu``'s plan gives: ``elems`` a lane
    holds of a row (8 f32, 16 of the narrower types), ``lanes`` a row
    (the least power of two holding hd), ``heads`` a unit (2 for G >= 2,
    else 1), ``units`` a head group (512 / lanes over the groups) and
    ``stage_rows`` (a multiple of the rows the units fold at once, two a
    unit, about 32 KB of K and V rows padded to elems * lanes elements of
    ``tsize`` bytes) and ``row_elems`` (elems * lanes, the padded row)."""
    elems = 8 if tsize == 4 else 16
    lanes = 1
    while elems * lanes < hd:
        lanes *= 2
    heads = 2 if g >= 2 else 1
    units = (512 // lanes) // (-(-g // heads))
    at_once, stride = 2 * units, elems * lanes * tsize
    return dict(elems=elems, lanes=lanes, heads=heads, units=units,
                stage_rows=at_once * max(1, 32 * 1024 //
                                         (2 * at_once * stride)),
                row_elems=elems * lanes)


def ring_cluster_fold(case, kw, *, c: int, stage_rows: int, units: int,
                      scales=None) -> torch.Tensor:
    """``paged_ring.cu``'s output on ``case`` as its C ranks compute it,
    in float32: rank r takes its even share of the live rows
    (:func:`ring_share`), counted as slots from the start of the share's
    first page and staged ``stage_rows`` at a time (stage boundaries at
    multiples of ``stage_rows``, the first and last pages partial); row
    r of a stage goes to unit (r - first live row) mod ``units``, each
    unit an online softmax of its own (logit q.k times the row's K scale
    and ``scale``, capped, max, exp; the V scale folded into p); the
    units merge, then the ranks (m -1e30, l 0 where a share is empty).
    Dead rows are never read."""
    q, kp, vp, bt, pos = case
    b, kvh, g, hd = q.shape
    bs, rb = kp.shape[2], bt.shape[1]
    cap, window, softcap = rb * bs, kw["window"], kw["softcap"]
    ks_pool = scales["k_scale"] if scales else None
    vs_pool = scales["v_scale"] if scales else None
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32)
    neg = torch.tensor(-1e30)
    for i in range(b):
        p = int(pos[i])
        n_live = max(0, min(p + 1, window, cap))
        ranks = []
        for rank in range(c):
            k_lo, k_hi = ring_share(n_live, c, rank)
            m = neg.expand(units, kvh, g).clone()
            l = torch.zeros((units, kvh, g))
            acc = torch.zeros((units, kvh, g, hd))
            if k_hi > k_lo:
                sf = (p - n_live + 1 + k_lo) % cap
                pg0, off0 = divmod(sf, bs)
                t_end = off0 + k_hi - k_lo
                for q0 in range(off0 // stage_rows, -(-t_end // stage_rows)):
                    t0 = q0 * stage_rows
                    r_lo, r_hi = max(off0 - t0, 0), min(t_end - t0,
                                                        stage_rows)
                    for r in range(r_lo, r_hi):
                        u = (r - r_lo) % units
                        pg, o = divmod(t0 + r, bs)
                        blk = int(bt[i, (pg0 + pg) % rb])
                        k = kp[blk, :, o].float()                 # (KVH, hd)
                        v = vp[blk, :, o].float()
                        ks = ks_pool[blk, :, o] if scales else 1.0
                        vs = vs_pool[blk, :, o] if scales else 1.0
                        s = torch.einsum("hgd,hd->hg", q[i].float(), k)
                        s = s * (ks * torch.ones(kvh))[:, None] * kw["scale"]
                        if softcap > 0:
                            s = softcap * torch.tanh(s / softcap)
                        mn = torch.maximum(m[u], s)
                        alpha, pr = torch.exp(m[u] - mn), torch.exp(s - mn)
                        l[u] = l[u] * alpha + pr
                        m[u] = mn
                        pv = pr * (vs * torch.ones(kvh))[:, None]
                        acc[u] = acc[u] * alpha[..., None] + \
                            pv[..., None] * v[:, None, :]
            mx = m.max(0).values
            w = torch.exp(m - mx)
            ranks.append((mx, (l * w).sum(0), (acc * w[..., None]).sum(0)))
        mx = torch.stack([r[0] for r in ranks]).max(0).values
        ll = torch.zeros((kvh, g))
        aa = torch.zeros((kvh, g, hd))
        for mr, lr, ar in ranks:
            e = torch.exp(mr - mx)
            ll = ll + lr * e
            aa = aa + ar * e[..., None]
        out[i] = aa / torch.clamp(ll, min=1e-30)[..., None]
    return out


def ring_plan_note(plan: dict, case, kw, label: str) -> str:
    """The plan ``ops.paged_ring_plan`` gave for a ring card case, and
    that the case exercises what its label names: C >= 2 at "B 1" and "B
    2", empty ranks at "pos < C", a first page partial at "window 1000,
    partial first page", padded rows at "hd 80, padded rows", and the
    fold's lanes, heads a unit, stage rows and padded row as
    :func:`ring_geometry` has them."""
    q, kp, _, bt, pos = case
    bs = kp.shape[2]
    cap = bt.shape[1] * bs
    c = plan["cluster"]
    geo = ring_geometry(q.shape[-1], q.shape[2], kp.element_size())
    if (plan["lanes_per_row"], plan["heads_per_unit"], plan["stage_rows"],
            plan["row_elems"]) != (geo["lanes"], geo["heads"],
                                   geo["stage_rows"], geo["row_elems"]):
        raise AssertionError(f"paged_ring [{label}]: plan {plan} is not the "
                             f"fold's geometry {geo}")
    lives = [max(0, min(p + 1, kw["window"], cap)) for p in pos.tolist()]
    empty = sum(ring_share(n, c, r)[0] == ring_share(n, c, r)[1]
                for n in lives for r in range(c))
    partial = sum((p - n + 1) % cap % bs != 0
                  for p, n in zip(pos.tolist(), lives))
    note = (f"C {c} ({plan['clusters_at_once']} clusters at once), "
            f"{plan['smem_bytes']} B a CTA, {plan['stages']} stages of "
            f"{plan['stage_rows']} rows, {plan['lanes_per_row']} lanes a "
            f"row, {plan['heads_per_unit']} heads a unit, rows of "
            f"{plan['row_elems']}; {empty} empty ranks, {partial} windows "
            f"from inside a page")
    if label in ("B 1", "B 2") and c < 2:
        raise AssertionError(f"paged_ring [{label}]: planned on one rank a "
                             "(request, head), not a cluster")
    if label == "pos < C" and not empty:
        raise AssertionError("paged_ring [pos < C]: no rank's share is "
                             "empty")
    if label.startswith("hd 80") and plan["row_elems"] == q.shape[-1]:
        raise AssertionError("paged_ring [hd 80]: the rows are not padded")
    if label.startswith("window 1000, partial") and partial < len(lives):
        raise AssertionError("paged_ring: a window of the partial-page "
                             "case starts on a page boundary")
    return note
