"""Dense decode backend (full attention; baseline / reference).

Every step reads the whole K/V context, dequantized under int8 pages
(``serving.kv_dtype='fp8'`` is refused for dense by the config), through
the oracle baseline's ``dense_attention``.  Under an active mesh whose
axes ``cfg.decode_cp_axes`` names, each rank holds its block of a
contiguous cache and attends its valid rows by plain softmax partials,
merged over the ranks (``distributed/context_parallel.py``).
"""

from __future__ import annotations

import torch

from repro_torch.baselines import oracle
from repro_torch.core import socket as sk
from repro_torch.distributed import context_parallel as cp
from repro_torch.models.backends import base
from repro_torch.models.backends.base import KVView

__all__ = ["DenseBackend"]


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
        fr = cp.frame(cfg, view) if isinstance(view, base.ContiguousView) \
            else None
        if fr is not None:
            k = base.dequant_leaf(cfg, view, "k")
            pos = fr.lo + torch.arange(fr.n_l, device=k.device)
            valid = torch.broadcast_to(
                pos < sk.per_batch(fr.local(length), 3), (fr.b_l, 1, fr.n_l))
            m, l, o = cp.partials(fr.local(q), k,
                                  base.dequant_leaf(cfg, view, "v"), valid,
                                  scale)
            return fr.merge(m, l, o, q.dtype)
        return oracle.dense_attention(q, base.dequant_leaf(cfg, view, "k"),
                               base.dequant_leaf(cfg, view, "v"),
                               scale=scale, length=length)
