"""Quest-style page-level selection (Tang et al., ICML 2024).

Port of ``repro.baselines.quest``.  At prefill, each page (contiguous
block of ``page_size`` tokens) stores the element-wise min and max of its
keys.  At decode, a page's upper bound on the query-key inner product is

    ub(page) = sum_d max(q_d * min_d, q_d * max_d)

and the top pages by upper bound are attended densely.

One difference by design: a page bound is accumulated in float64 from
the float32 terms and rounded to float32 once (for the group-summed
score of :func:`select_tokens`, once after the group sum too), where the
JAX package sums in float32.  The fused CUDA kernel does the same, so
its page scores round to this version's float32 in whatever order either
sums (unless a float64 sum lies within its own rounding error of a
float32 rounding boundary), and its page selection equals
:func:`select_tokens` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import socket as sk

__all__ = ["QuestConfig", "QuestState", "build", "score_pages",
           "token_scores", "page_budget", "select_tokens", "attend"]


@dataclasses.dataclass(frozen=True)
class QuestConfig:
    page_size: int = 16
    sparsity: float = 10.0
    sink_tokens: int = 128
    window_tokens: int = 128
    min_pages: int = 4


@dataclasses.dataclass
class QuestState:
    kmin: torch.Tensor   # (..., n_pages, d)
    kmax: torch.Tensor   # (..., n_pages, d)


def build(cfg: QuestConfig, rng, keys: torch.Tensor,
          values: torch.Tensor) -> QuestState:
    """Page min/max of ``keys`` ``(..., n, d)``; a ragged last page is
    padded with +inf (min) / -inf (max).  ``rng`` and ``values`` are
    unused (the JAX signature shared by every baseline)."""
    del rng, values
    *lead, n, d = keys.shape
    ps = cfg.page_size
    n_pages = (n + ps - 1) // ps
    pad = n_pages * ps - n
    pad_cfg = (0, 0, 0, pad)
    kmin_src = torch.nn.functional.pad(keys, pad_cfg, value=float("inf"))
    kmax_src = torch.nn.functional.pad(keys, pad_cfg, value=float("-inf"))
    kmin = kmin_src.reshape(*lead, n_pages, ps, d).amin(dim=-2)
    kmax = kmax_src.reshape(*lead, n_pages, ps, d).amax(dim=-2)
    return QuestState(kmin=kmin, kmax=kmax)


def _bound_terms(state: QuestState, q: torch.Tensor) -> torch.Tensor:
    """float32 terms ``max(q_d * kmin_d, q_d * kmax_d)`` ``(..., n_pages,
    d)`` for query ``(..., d)``."""
    qf = q.float()[..., None, :]
    return torch.maximum(qf * state.kmin.float(), qf * state.kmax.float())


def score_pages(state: QuestState, q: torch.Tensor) -> torch.Tensor:
    """Upper-bound page scores ``(..., n_pages)`` for query ``(..., d)``
    (float64 accumulation, one rounding to float32)."""
    return _bound_terms(state, q).double().sum(-1).float()


def token_scores(state: QuestState, cfg: QuestConfig, q: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Page scores broadcast back to token granularity (every token
    inherits its page's upper bound)."""
    ps = score_pages(state, q)                      # (..., n_pages)
    return torch.repeat_interleave(ps, cfg.page_size, dim=-1)[..., :n]


def page_budget(cfg: QuestConfig, n_pages: int, n: int) -> int:
    """Static page-selection budget for a token capacity of ``n`` (shared
    by :func:`select_tokens` and the fused kernel's caller)."""
    budget_tokens = max(cfg.min_pages * cfg.page_size,
                        int(np.ceil(n / cfg.sparsity)))
    return min(n_pages, max(cfg.min_pages, budget_tokens // cfg.page_size))


def group_page_scores(cfg: QuestConfig, state: QuestState, q: torch.Tensor,
                      length) -> torch.Tensor:
    """Effective page scores ``(B, KVH, n_pages)`` f32 of query ``q``
    ``(B, KVH, G, 1, hd)`` against stats ``(B, KVH, n_pages, hd)``: the
    bound summed over the group (float64, rounded once), sink and window
    pages forced to FLT_MAX, pages at or past ``length`` -1e30."""
    ps = cfg.page_size
    n_pages = state.kmin.shape[-2]
    state_g = QuestState(kmin=state.kmin[..., None, :, :],
                         kmax=state.kmax[..., None, :, :])
    terms = _bound_terms(state_g, q[..., 0, :])      # (B,KVH,G,n_pages,d)
    scores = terms.double().sum(dim=(-1, 2)).float()  # (B,KVH,n_pages)
    dev = scores.device
    length = sk.per_batch(torch.as_tensor(length, device=dev), 3)
    page_start = torch.arange(n_pages, device=dev) * ps
    valid = page_start < length
    forced = (page_start < cfg.sink_tokens) | (
        page_start >= length - cfg.window_tokens - ps)
    eff = torch.where(forced, sk.FLT_MAX, scores)
    return torch.where(valid, eff, sk.NEG_INF)


def select_tokens(cfg: QuestConfig, state: QuestState, q: torch.Tensor, *,
                  length, n: int, k_pages: Optional[int] = None):
    """Top-page selection expanded to token indices for one decode step.

    q: (B,KVH,G,1,hd); ``length`` int or per-request ``(B,)`` tensor;
    ``n``: token capacity of the cache the indices address; ``k_pages``:
    pages to take (default :func:`page_budget`).  Sink-prefix and
    trailing-window pages are forced in; pages past ``length`` score
    -1e30 but stay selectable, as ``jax.lax.top_k`` takes ``k_pages``
    pages regardless, and their rows are masked afterwards.  Ties keep
    the lowest page first.  Returns (idx ``(B,KVH,k_pages*ps)`` int64,
    validity mask of the same shape).
    """
    b, kvh = q.shape[:2]
    ps = cfg.page_size
    if k_pages is None:
        k_pages = page_budget(cfg, state.kmin.shape[-2], n)
    eff = group_page_scores(cfg, state, q, length)
    top_pages = torch.sort(eff, dim=-1, descending=True,
                           stable=True).indices[..., :k_pages]
    offs = torch.arange(ps, device=eff.device)
    idx = (top_pages[..., None] * ps + offs).reshape(b, kvh, k_pages * ps)
    idx = torch.clamp(idx, max=n - 1)
    length = sk.per_batch(torch.as_tensor(length, device=eff.device), 3)
    return idx, idx < length


def attend(cfg: QuestConfig, state: QuestState, q: torch.Tensor,
           k_cache: torch.Tensor, v_cache: torch.Tensor, *, length,
           scale: float) -> torch.Tensor:
    """Decode attention over the top pages (q: (B,KVH,G,1,hd))."""
    idx, sel_mask = select_tokens(cfg, state, q, length=length,
                                  n=k_cache.shape[2])
    rows = idx[..., None].expand(*idx.shape, k_cache.shape[-1])
    k_sel = torch.gather(k_cache, 2, rows)
    v_sel = torch.gather(v_cache, 2, rows)
    return sk.sparse_attention_over_subset(q, k_sel, v_sel, sel_mask,
                                           scale=scale)
