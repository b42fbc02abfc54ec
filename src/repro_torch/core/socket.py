"""SOCKET: soft collision kernel estimation for sparse attention, in PyTorch.

Port of ``repro.core.socket`` (Algorithms 1-3 of the paper):

* :func:`precompute_key_hashes`   — Algorithm 1 (prefill-time index build).
* :func:`soft_hash_query`         — Algorithm 2 (query soft hashing).
* :func:`soft_scores_factorized`  — the factorized form of eq. (3).
* :func:`value_aware_topk`        — Algorithm 3 selection (value-norm
  weighted, with sink + local-window union).
* :func:`sparse_attention_over_subset` — exact softmax attention over the
  selected subset.
* :func:`socket_attend`           — the full decode-time composition.

Shapes keep the JAX package's layouts: caches ``(B, KVH, S, ...)``,
queries ``(B, KVH, G, qlen, hd)`` with ``G`` the GQA group size.

Top-k ties: ``jax.lax.top_k`` keeps the lowest index first among equal
values and ``torch.topk`` does not, so :func:`value_aware_topk` takes the
first ``k`` of a *stable* descending sort.  Forced sink/window rows all
score ``FLT_MAX``, so ties happen on every step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import hashing

__all__ = [
    "NEG_INF",
    "SocketConfig",
    "SocketCache",
    "topk_budget",
    "dynamic_topk_budget",
    "precompute_key_hashes",
    "soft_hash_query",
    "log_normalizer",
    "soft_scores_factorized",
    "per_batch",
    "value_aware_topk",
    "sparse_attention_over_subset",
    "socket_attend",
]

NEG_INF = -1e30
FLT_MAX = float(np.finfo(np.float32).max)

Length = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SocketConfig:
    """Hyper-parameters of the SOCKET scorer (paper Table 13 defaults)."""

    num_planes: int = 10          # P
    num_tables: int = 60          # L
    tau: float = 0.5              # soft-hash temperature
    sparsity: float = 10.0        # N / k  (k = budget)
    sink_tokens: int = 128        # always-attended prefix tokens
    window_tokens: int = 128      # always-attended local window
    min_k: int = 16               # floor for the top-k budget
    selection: str = "kvhead"     # "kvhead" | "pooled" | "qhead"
    bits_storage: str = "packed"  # "packed" (int32 words) | "int8" (±1)
    score_dtype: str = "float32"
    score_chunk: int = 0          # keys per scoring chunk (0 = unchunked)


class SocketCache(NamedTuple):
    """Per-layer SOCKET side-cache living next to the KV cache.

    ``bits``  — int32 ``(B, KVH, S, W)`` packed sign bits (or int8
                ``(B, KVH, S, L*P)`` ±1 planes when ``bits_storage='int8'``).
    ``vnorm`` — bf16 ``(B, KVH, S)`` value L2 norms.
    """

    bits: torch.Tensor
    vnorm: torch.Tensor


def topk_budget(cfg: SocketConfig, n: int) -> int:
    """Selection budget k for a context of length n, floored at the forced
    sink+window count so the recency window is never evicted."""
    forced = min(n, cfg.sink_tokens + cfg.window_tokens)
    k = max(cfg.min_k, forced, int(np.ceil(n / cfg.sparsity)))
    return min(k, n)


def dynamic_topk_budget(cfg: SocketConfig, length: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """Per-request budget for a ragged batch: ``ceil(len/sparsity)`` with
    the same ``min_k`` and forced sink+window floors as
    :func:`topk_budget`, clamped to the static selection size ``cap``."""
    length = torch.as_tensor(length, dtype=torch.int32)
    forced = torch.clamp(length, max=cfg.sink_tokens + cfg.window_tokens)
    k = torch.maximum(
        torch.ceil(length.float() / cfg.sparsity).to(torch.int32), forced)
    return torch.clamp(k, cfg.min_k, cap)


# ---------------------------------------------------------------------------
# Algorithm 1 — prefill
# ---------------------------------------------------------------------------

def precompute_key_hashes(cfg: SocketConfig, w: torch.Tensor,
                          keys: torch.Tensor,
                          values: torch.Tensor) -> SocketCache:
    """Build the SOCKET side-cache for keys/values ``(B, KVH, S, d)``
    with hyperplanes ``w`` ``(L, P, d)``."""
    signs = hashing.hash_keys_signs(w, keys)          # (B,KVH,S,L,P) bool
    if cfg.bits_storage == "packed":
        bits = hashing.pack_signs(signs)              # (B,KVH,S,W) int32
    elif cfg.bits_storage == "int8":
        bits = (signs.to(torch.int8) * 2 - 1).reshape(
            *signs.shape[:-2], cfg.num_tables * cfg.num_planes)
    else:
        raise ValueError(cfg.bits_storage)
    vnorm = torch.linalg.vector_norm(values.float(), dim=-1)
    return SocketCache(bits=bits, vnorm=vnorm.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Algorithm 2 — query soft hashing
# ---------------------------------------------------------------------------

def soft_hash_query(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``u^(l) = tanh(W^(l) q) / sqrt(d)``: w ``(L, P, d)``, q ``(..., d)``
    -> ``(..., L, P)`` float32."""
    l, p, d = w.shape
    proj = q.float() @ w.float().reshape(l * p, d).T
    u = torch.tanh(proj) / math.sqrt(d)
    return u.reshape(*q.shape[:-1], l, p)


def log_normalizer(u: torch.Tensor, tau: float) -> torch.Tensor:
    """``log Z^(l) = sum_i log(2 cosh(u_i / tau))`` in the stable form
    ``|x| + log1p(exp(-2|x|))``."""
    ax = torch.abs(u / tau)
    return torch.sum(ax + torch.log1p(torch.exp(-2.0 * ax)), dim=-1)


# ---------------------------------------------------------------------------
# Scoring — eq. (3), factorized form
# ---------------------------------------------------------------------------

def _score_block(cfg: SocketConfig, bits: torch.Tensor, u: torch.Tensor,
                 logz: torch.Tensor) -> torch.Tensor:
    l, p = cfg.num_tables, cfg.num_planes
    sdt = getattr(torch, cfg.score_dtype)
    if cfg.bits_storage == "packed":
        signs = hashing.unpack_signs(bits, l, p, dtype=sdt)
    else:
        signs = bits.reshape(*bits.shape[:-1], l, p).to(sdt)
    logits = torch.einsum("...nlp,...lp->...nl", signs,
                          u.to(sdt)).float() / cfg.tau
    z = torch.exp(logits - logz[..., None, :])        # (..., N, L)
    return torch.sum(z, dim=-1)


def soft_scores_factorized(cfg: SocketConfig, bits: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
    """``score_j = sum_l exp( (S_j^(l) . u^(l)) / tau - logZ^(l) )``.

    bits: packed int32 ``(..., N, W)`` or int8 ``(..., N, L*P)``;
    u: ``(..., L, P)``.  Returns ``(..., N)`` float32.  When
    ``cfg.score_chunk`` divides N, keys are scored chunk by chunk so the
    unpacked-sign buffer stays bounded (scores are per-key independent).
    """
    logz = log_normalizer(u, cfg.tau)                 # (..., L)
    n = bits.shape[-2]
    c = cfg.score_chunk
    if c and n > c and n % c == 0:
        return torch.cat([_score_block(cfg, bits[..., i:i + c, :], u, logz)
                          for i in range(0, n, c)], dim=-1)
    return _score_block(cfg, bits, u, logz)


# ---------------------------------------------------------------------------
# Algorithm 3 — value-aware top-k selection + exact attention on the subset
# ---------------------------------------------------------------------------

def per_batch(x: Length, ndim: int) -> Length:
    """Reshape a ``(B,)`` per-request tensor so it broadcasts against a
    ``(B, ..., N)`` tensor of rank ``ndim``; scalars pass through."""
    if isinstance(x, torch.Tensor) and x.ndim == 1:
        return x.reshape(x.shape[0], *([1] * (ndim - 1)))
    return x


def value_aware_topk(cfg: SocketConfig, scores: torch.Tensor,
                     vnorm: torch.Tensor, *, k: int, length: Length,
                     n_total: int, budget: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the k keys with largest ``score * ||v||``.

    Sink tokens (prefix) and the trailing local window are forced in at
    ``FLT_MAX``; slots at or past ``length`` are masked to ``NEG_INF``.
    ``length`` is an int or a ``(B,)`` tensor; ``budget`` an optional
    ``(B,)`` per-request budget <= k.  Ties keep the lowest index first,
    as ``jax.lax.top_k`` does.

    Returns (indices ``(..., k)`` int64, validity mask ``(..., k)`` bool).
    """
    pos = torch.arange(n_total, device=scores.device)
    length = per_batch(length, scores.ndim)
    valid = pos < length
    eff = scores.float() * vnorm.float()
    forced = (pos < cfg.sink_tokens) | (pos >= length - cfg.window_tokens)
    eff = torch.where(forced, FLT_MAX, eff)
    eff = torch.where(valid, eff, NEG_INF)
    top_vals, top_idx = torch.sort(eff, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    mask = top_vals > NEG_INF / 2
    if budget is not None:
        budget = per_batch(torch.as_tensor(budget, device=scores.device),
                           scores.ndim)
        mask = mask & (torch.arange(k, device=scores.device) < budget)
    return top_idx, mask


def sparse_attention_over_subset(q: torch.Tensor, k_sel: torch.Tensor,
                                 v_sel: torch.Tensor, sel_mask: torch.Tensor,
                                 *, scale: float) -> torch.Tensor:
    """Exact softmax attention restricted to the selected subset.

    q ``(B, KVH, G, T, hd)``; k_sel/v_sel ``(B, KVH, K, hd)``; sel_mask
    ``(B, KVH, K)`` -> ``(B, KVH, G, T, hd)``.
    """
    logits = torch.einsum("bhgtd,bhkd->bhgtk", q.float(),
                          k_sel.float()) * scale
    logits = torch.where(sel_mask[:, :, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgtk,bhkd->bhgtd", w, v_sel.float())
    return out.to(q.dtype)


def _take_rows(a: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``take_along_axis(a, idx[..., None], dim)`` for a trailing feature
    axis: ``a`` ``(..., N, hd)``, ``idx`` ``(..., K)``."""
    shape = list(torch.broadcast_shapes(a.shape[:dim], idx.shape[:dim]))
    a = a.expand(*shape, *a.shape[dim:])
    return torch.gather(a, dim, idx[..., None].expand(
        *shape, idx.shape[-1], a.shape[-1]))


def socket_attend(cfg: SocketConfig, w_hash: torch.Tensor, q: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  side: SocketCache, *, length: Length,
                  scale: Optional[float] = None, use_kernel: bool = False,
                  budget: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full SOCKET decode attention (Algorithms 2+3) for one query step.

    q ``(B, KVH, G, 1, hd)``; k_cache/v_cache ``(B, KVH, N, hd)``; side
    bits ``(B, KVH, N, ·)`` and vnorm.  ``use_kernel`` routes scoring
    through ``kernels.socket_score`` (kvhead/pooled selection only).
    Returns ``(B, KVH, G, 1, hd)``.
    """
    hd = q.shape[-1]
    n = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    kq = topk_budget(cfg, n)

    if cfg.selection == "pooled":
        u = soft_hash_query(w_hash, torch.mean(q[..., 0, :], dim=2))
    else:
        u = soft_hash_query(w_hash, q[..., 0, :])      # (B,KVH,G,L,P)

    if use_kernel:
        if cfg.selection not in ("kvhead", "pooled"):
            raise NotImplementedError(
                "the scoring kernel group-sums scores (kvhead selection); "
                "use the plain path for per-q-head selection")
        from repro_torch.kernels.socket_score import ops as score_ops
        u_k = u[:, :, None] if cfg.selection == "pooled" else u
        scores = score_ops.socket_score(
            side.bits, u_k, vnorm=None, num_tables=cfg.num_tables,
            num_planes=cfg.num_planes, tau=cfg.tau)    # (B,KVH,N) G-summed
    elif cfg.selection == "pooled":
        scores = soft_scores_factorized(cfg, side.bits, u)
    else:
        scores = soft_scores_factorized(cfg, side.bits[:, :, None], u)
        if cfg.selection == "kvhead":
            scores = torch.sum(scores, dim=2)          # (B,KVH,N)
        elif cfg.selection != "qhead":
            raise ValueError(cfg.selection)

    vnorm = side.vnorm.float()
    if cfg.selection in ("kvhead", "pooled"):
        idx, sel_mask = value_aware_topk(
            cfg, scores, vnorm, k=kq, length=length, n_total=n,
            budget=budget)
        k_sel = _take_rows(k_cache, idx, 2)
        v_sel = _take_rows(v_cache, idx, 2)
        return sparse_attention_over_subset(q, k_sel, v_sel, sel_mask,
                                            scale=scale)

    # per-q-head route
    idx, sel_mask = value_aware_topk(
        cfg, scores, vnorm[:, :, None], k=kq, length=length, n_total=n,
        budget=budget)
    k_sel = _take_rows(k_cache[:, :, None], idx, 3)
    v_sel = _take_rows(v_cache[:, :, None], idx, 3)
    logits = torch.einsum("bhgtd,bhgkd->bhgtk", q.float(),
                          k_sel.float()) * scale
    logits = torch.where(sel_mask[:, :, :, None, :], logits, NEG_INF)
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgtk,bhgkd->bhgtd", wts, v_sel.float())
    return out.to(q.dtype)
