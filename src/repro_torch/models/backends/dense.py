"""Dense decode backend (full attention; baseline / reference).

Every step reads the whole K/V context, dequantized under int8 pages
(``serving.kv_dtype='fp8'`` is refused for dense by the config).
``dense_attention`` is the port's own copy of
``repro.baselines.oracle.dense_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.core import socket as sk
from repro_torch.models.backends import base
from repro_torch.models.backends.base import KVView

__all__ = ["DenseBackend", "dense_attention"]


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


class DenseBackend(base.DecodeBackend):
    name = "dense"

    def cache_spec(self, cfg):
        return base.kv_leaf_specs(cfg)

    def prefill_build(self, cfg, params, cache, kc, vc):
        del params
        return base.write_prefill_kv(cfg, cache, kc, vc)

    def append(self, cfg, params, view: KVView, kc, vc, pos):
        del params
        base.write_token_kv(cfg, view, pos, kc[:, :, 0], vc[:, :, 0])

    def attend(self, cfg, params, q, view: KVView, *, length, scale):
        del params
        return dense_attention(q, base.dequant_leaf(cfg, view, "k"),
                               base.dequant_leaf(cfg, view, "v"),
                               scale=scale, length=length)
