"""Inputs for the fused paged kernel, and the check that holds it to its
plain version, shared by ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``).

The check: the output within ``attn_tol`` of the plain version's, the
count of selected rows exactly ``min(budget, length)`` per (request,
head), and the selection equal to the plain version's — bit for bit
where all scores tie exactly, elsewhere except at rows whose plain
effective score lies within ``score_tol`` of the threshold (the kernel
sums the same fp32 terms in another order).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core import hashing, socket as sk
from repro_torch.kernels.paged_attention.ref import paged_socket_attend_ref
from repro_torch.kernels.socket_score.ref import socket_score_ref
from repro_torch.models.backends.base import gather_block_leaf

__all__ = ["paged_case", "plain_eff", "check_paged"]


def paged_case(gen: torch.Generator, lengths: Sequence[int], *, nb: int,
               kvh: int = 8, g: int = 4, hd: int = 128, l: int = 60,
               p: int = 10, bs: int = 16, sink: int = 128, window: int = 128,
               ties: bool = False, copies: int = 1) -> Tuple[List, dict]:
    """Pool, block tables and queries on ``gen``'s device; budgets from
    ``dynamic_topk_budget`` (sparsity 10).  Returns ``(sets, kw)``: each
    set is the positional arguments ``(q, k_pages, v_pages, bits, vnorm,
    u, block_table, length, budget)``, ``kw`` the keyword ones.

    ``copies`` sets share one pool, each set's requests on blocks of
    their own (so rotating through the sets reads fresh memory); tables
    are trash-padded (block 0) past each request's blocks.  ``ties``:
    every bits and vnorm row identical, so all scored rows tie exactly."""
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
                           sink_tokens=sink, window_tokens=window)
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
        u = sk.soft_hash_query(planes, q)                # (B, KVH, G, L, P)
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
                ties: bool, attn_tol: dict, score_tol: dict
                ) -> Tuple[float, int]:
    """Hold the kernel's ``(out, sel)`` on ``case`` to the plain version
    (see the module docstring); raises AssertionError on a mismatch.
    Returns (max |out error|, selected rows that differ inside the
    threshold band)."""
    q, kp, vp, bits, vnorm, u, bt, length, budget = case
    n = bt.shape[1] * bits.shape[2]
    ref, ref_sel = paged_socket_attend_ref(
        q, kp, vp, bits, vnorm, u, bt, length=length, budget=budget,
        top_k=min(n, int(budget.max())), **kw)
    if not torch.isfinite(out).all():
        raise AssertionError("paged_attention: non-finite kernel output")
    err = (out.double() - ref.double()).abs()
    lim = attn_tol["atol"] + attn_tol["rtol"] * ref.double().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"paged_attention: max |err| {err.max().item():.3e} exceeds "
            f"atol {attn_tol['atol']} + rtol {attn_tol['rtol']} * |ref|")
    sel = sel.reshape(*sel.shape[:2], -1).bool()
    want = torch.minimum(budget.long(), length.long())[:, None]
    if not torch.equal(sel.sum(-1), want.expand(-1, sel.shape[1])):
        raise AssertionError("paged_attention: selected-row counts differ "
                             "from min(budget, length)")
    diff = sel != ref_sel
    if not diff.any():
        return float(err.max().item()), 0
    if ties:
        raise AssertionError("paged_attention: tied scores must select bit "
                             "for bit")
    eff = plain_eff(case, kw)
    k = (budget.long() - 1).clamp(max=n - 1).reshape(-1, 1, 1)
    thr = torch.sort(eff, dim=-1, descending=True).values.gather(
        -1, k.expand(-1, eff.shape[1], 1))
    close = (eff - thr).abs() <= score_tol["atol"] + \
        score_tol["rtol"] * thr.abs()
    if (diff & ~close).any():
        raise AssertionError("paged_attention: selection differs beyond the "
                             "threshold band")
    return float(err.max().item()), int(diff.sum().item())
