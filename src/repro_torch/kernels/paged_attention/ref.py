"""Plain PyTorch versions of the fused paged-attention kernels.

:func:`paged_socket_attend_ref` mirrors
``repro.kernels.paged_attention.ref.paged_socket_attend_ref``:
it materializes the logical per-request views that the kernel never
builds, then runs the unfused composition the kernel replaces —
factorized soft-collision scoring (:func:`socket_score_ref`) →
:func:`value_aware_topk` (sink/window forcing, ragged lengths, dynamic
budgets, lowest-index-first ties) → gather of the selected rows → masked
softmax attention (:func:`flash_decode_ref`).

It returns the attention output and the selected-token mask, so a test
can hold the kernel's *selection* to this one bit for bit and its output
to a float tolerance (the kernel folds rows in logical order, this
version in selection-rank order).

:func:`paged_hard_lsh_attend_ref` swaps the soft score for the hard-LSH
backend's collision counts, and :func:`paged_quest_attend_ref` runs
Quest's page selection (:func:`repro_torch.baselines.quest.select_tokens`)
in place of scoring and top-k; both mirror their JAX namesakes.
:func:`paged_ring_attend_ref` is the sliding-window decode over a
request's circular page list (no selection: every in-window row).

K/V pages may be float32, bf16, int8 or ``float8_e4m3fn``.  Given the
per-row scale pools ``k_scale``/``v_scale`` ``(NB, KVH, bs)``, every
version reads the logical view dequantized, ``q.float() * s`` (the JAX
oracles' ``_logical_kv``); without them, ``float(q)``.  Scoring never
reads K/V, so SOCKET's and hard LSH's selections do not depend on the
storage dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.baselines import quest as quest_mod
from repro_torch.core import socket as sk
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.socket_score.ref import socket_score_ref
from repro_torch.models.backends.base import gather_block_leaf
from repro_torch.models.backends.kvquant import dequantize

__all__ = ["paged_socket_attend_ref", "paged_hard_lsh_attend_ref",
           "paged_quest_attend_ref", "paged_ring_attend_ref",
           "attend_selected"]


def _logical_kv(pages: torch.Tensor, scale_pages, bt: torch.Tensor
                ) -> torch.Tensor:
    """The logical K/V view ``(B, KVH, nb*bs, hd)`` in float32,
    dequantized when per-row scales are given."""
    x = gather_block_leaf(pages, bt)
    if scale_pages is None:
        return x.float()
    return dequantize(x, gather_block_leaf(scale_pages, bt))


def paged_socket_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, bits_pages: torch.Tensor,
                            vnorm_pages: torch.Tensor, u: torch.Tensor,
                            block_table: torch.Tensor, *, length, budget,
                            num_tables: int, num_planes: int, tau: float,
                            scale: float, sink_tokens: int,
                            window_tokens: int, top_k: int, k_scale=None,
                            v_scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same shapes as :func:`ops.paged_socket_attend` plus ``top_k``, the
    static selection cap (any value >= max(budget)).

    Returns ``(out f32 (B, KVH, G, hd), selected bool (B, KVH, N))`` with
    ``N = nb * block_size``.
    """
    if q.ndim == 5:
        q = q[:, :, :, 0]
    b, kvh, g, hd = q.shape
    bits = gather_block_leaf(bits_pages, block_table)        # (B,KVH,N,W)
    vnorm = gather_block_leaf(vnorm_pages, block_table).float()
    kc = _logical_kv(k_pages, k_scale, block_table)
    vc = _logical_kv(v_pages, v_scale, block_table)
    n = bits.shape[2]

    gs = u.shape[2]
    scores = socket_score_ref(
        bits.reshape(b * kvh, n, -1), u.reshape(b * kvh, gs, *u.shape[3:]),
        None, num_tables=num_tables, num_planes=num_planes, tau=tau)
    scores = scores.reshape(b, kvh, n)

    cfg = sk.SocketConfig(num_planes=num_planes, num_tables=num_tables,
                          tau=tau, sink_tokens=sink_tokens,
                          window_tokens=window_tokens)
    return _select_attend(cfg, q, kc, vc, scores, vnorm, length=length,
                          budget=budget, top_k=top_k, scale=scale)


def _select_attend(cfg, q, kc, vc, scores, vnorm, *, length, budget,
                   top_k, scale):
    """value_aware_topk over ``scores * vnorm`` ``(B, KVH, N)``, then
    attention over the selected rows of the logical K/V views."""
    b, kvh, g, hd = q.shape
    n = scores.shape[-1]
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).expand(b)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=q.device).expand(b)
    idx, mask = sk.value_aware_topk(cfg, scores, vnorm, k=top_k,
                                    length=length, n_total=n, budget=budget)
    return _attend_rows(q, kc, vc, idx, mask, scale=scale)


def _attend_rows(q, kc, vc, idx, mask, *, scale):
    """Masked attention of q ``(B, KVH, G, hd)`` over rows ``idx`` ``(B,
    KVH, K)`` of the logical views; returns (out, selected row mask)."""
    b, kvh, g, hd = q.shape
    k = idx.shape[-1]
    rows = idx[..., None].expand(*idx.shape, hd)
    k_sel = torch.gather(kc, 2, rows)
    v_sel = torch.gather(vc, 2, rows)
    out = flash_decode_ref(q.reshape(b * kvh, g, hd),
                           k_sel.reshape(b * kvh, k, hd),
                           v_sel.reshape(b * kvh, k, hd),
                           mask.reshape(b * kvh, k), scale=scale)
    selected = torch.zeros((b, kvh, kc.shape[2]), dtype=torch.bool,
                           device=q.device)
    selected.scatter_(2, idx, mask)
    return out.reshape(b, kvh, g, hd), selected


def attend_selected(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    selected: torch.Tensor, *, scale: float, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """The plain attention of q ``(B, KVH, G, hd)`` over the rows that the
    bool ``selected`` ``(B, KVH, nb*bs)`` marks in the logical K/V views
    (dequantized when scale pools are given); f32 ``(B, KVH, G, hd)``."""
    kc = _logical_kv(k_pages, k_scale, block_table)
    vc = _logical_kv(v_pages, v_scale, block_table)
    count = selected.sum(-1, keepdim=True)
    k = max(int(count.max()), 1)
    idx = torch.sort(selected.int(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    mask = torch.arange(k, device=q.device) < count
    return _attend_rows(q, kc, vc, idx, mask, scale=scale)[0]


def paged_hard_lsh_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, bits_pages: torch.Tensor,
                              vnorm_pages: torch.Tensor, u_signs: torch.Tensor,
                              block_table: torch.Tensor, *, length, budget,
                              num_tables: int, num_planes: int, scale: float,
                              sink_tokens: int, window_tokens: int, top_k: int,
                              k_scale=None, v_scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same shapes as :func:`ops.paged_hard_lsh_attend` plus ``top_k``:
    the socket composition with the soft score replaced by the backend's
    hard collision counts (``u_signs`` f32 ±1 ``(B, KVH, G, L, P)``)."""
    from repro_torch.models.backends.hard_lsh import _hard_collision_scores
    if q.ndim == 5:
        q = q[:, :, :, 0]
    bits = gather_block_leaf(bits_pages, block_table)        # (B,KVH,N,W)
    vnorm = gather_block_leaf(vnorm_pages, block_table).float()
    kc = _logical_kv(k_pages, k_scale, block_table)
    vc = _logical_kv(v_pages, v_scale, block_table)
    cfg = sk.SocketConfig(num_planes=num_planes, num_tables=num_tables,
                          tau=1.0, sink_tokens=sink_tokens,
                          window_tokens=window_tokens)
    scores = _hard_collision_scores(cfg, bits, u_signs).sum(dim=2)
    return _select_attend(cfg, q, kc, vc, scores, vnorm, length=length,
                          budget=budget, top_k=top_k, scale=scale)


def paged_quest_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, kmin_pages: torch.Tensor,
                           kmax_pages: torch.Tensor,
                           block_table: torch.Tensor, *, length, page_budget,
                           page_size: int, scale: float, sink_tokens: int,
                           window_tokens: int, k_scale=None, v_scale=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same arguments as :func:`ops.paged_quest_attend`: the logical
    kmin/kmax views through ``select_tokens`` (``page_budget`` pages;
    a ``(B,)`` budget takes its largest and masks each request's pages
    past its own), then masked attention over the selected rows.  Where
    the JAX oracle takes ``sparsity``/``min_pages``, this one takes the
    budget they give (``quest.page_budget``), as the kernel does."""
    if q.ndim == 4:
        q = q[:, :, :, None]                          # (B,KVH,G,1,hd)
    b = q.shape[0]
    kc = _logical_kv(k_pages, k_scale, block_table)   # (B,KVH,N,hd)
    vc = _logical_kv(v_pages, v_scale, block_table)
    state = quest_mod.QuestState(
        kmin=gather_block_leaf(kmin_pages, block_table),
        kmax=gather_block_leaf(kmax_pages, block_table))
    n = kc.shape[2]
    qcfg = quest_mod.QuestConfig(page_size=page_size,
                                 sink_tokens=sink_tokens,
                                 window_tokens=window_tokens)
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).expand(b)
    if isinstance(page_budget, int):     # no host sync: CUDA-graph safe
        idx, mask = quest_mod.select_tokens(qcfg, state, q, length=length,
                                            n=n, k_pages=page_budget)
    else:
        budget = torch.as_tensor(page_budget, device=q.device).expand(b)
        idx, mask = quest_mod.select_tokens(qcfg, state, q, length=length,
                                            n=n, k_pages=int(budget.max()))
        rank = torch.arange(idx.shape[-1], device=q.device) // page_size
        mask = mask & (rank < budget[:, None, None])
    return _attend_rows(q[:, :, :, 0], kc, vc, idx, mask, scale=scale)


def paged_ring_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor, *,
                          pos, window: int, softcap: float, scale: float,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of :func:`ops.paged_ring_attend`, mirroring
    ``repro.kernels.paged_attention.ref.paged_ring_attend_ref``: gather
    the circular page list (``block_table`` is the ring slice, ``(B,
    ring_blocks)``), then logits·scale → softcap → window mask → softmax.

    Slot ``s`` of the ring holds position ``pos - ((pos - s) mod cap)``
    (a non-negative modulo); slots before position 0 or out of the window
    (``pos - ring_pos >= window``) are masked.  Returns f32 (B, KVH, G,
    hd)."""
    if q.ndim == 5:
        q = q[:, :, :, 0]
    b = q.shape[0]
    kc = _logical_kv(k_pages, k_scale, block_table)    # (B,KVH,cap,hd)
    vc = _logical_kv(v_pages, v_scale, block_table)
    cap = kc.shape[2]
    pos = torch.as_tensor(pos, device=q.device).long().expand(b)
    sl = torch.arange(cap, device=q.device)
    ring_pos = pos[:, None] - torch.remainder(pos[:, None] - sl, cap)
    valid = (ring_pos >= 0) & (pos[:, None] - ring_pos < window)
    s = torch.einsum("bhgd,bhnd->bhgn", q.float(), kc) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    return torch.einsum("bhgn,bhnd->bhgd", torch.softmax(s, dim=-1), vc)
