"""Oracle scorers: exact q.k scores and dense attention references.

Port of ``repro.baselines.oracle``.  The exact top-k reads the full keys
(what SOCKET avoids) and is the ground-truth ranking of the recall
figures; :func:`dense_attention` is also the ``dense`` decode backend's
attention (``models/backends/dense.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import socket as sk

__all__ = ["OracleState", "build", "score", "dense_attention"]


@dataclasses.dataclass
class OracleState:
    keys: torch.Tensor  # (..., N, d)


def build(cfg, rng, keys: torch.Tensor, values: torch.Tensor) -> OracleState:
    del cfg, rng, values
    return OracleState(keys=keys)


def score(state: OracleState, q: torch.Tensor) -> torch.Tensor:
    """Exact inner products ``(..., N)`` for query ``(..., d)``."""
    return torch.einsum("...nd,...d->...n", state.keys.float(), q.float())


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, length=None) -> torch.Tensor:
    """Full softmax attention.  q (B,KVH,G,T,hd); k/v (B,KVH,N,hd);
    ``length`` an int or a ``(B,)`` tensor of per-request lengths."""
    logits = torch.einsum("bhgtd,bhnd->bhgtn", q.float(), k.float()) * scale
    if length is not None:
        n = k.shape[2]
        length = sk.per_batch(length, logits.ndim)
        logits = torch.where(torch.arange(n, device=q.device) < length,
                             logits, sk.NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgtn,bhnd->bhgtd", w, v.float())
    return out.to(q.dtype)
