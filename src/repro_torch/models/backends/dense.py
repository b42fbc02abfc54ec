"""Dense decode backend (full attention; baseline / reference).

Every step reads the whole K/V context, dequantized under int8 pages
(``serving.kv_dtype='fp8'`` is refused for dense by the config), through
the oracle baseline's ``dense_attention``.
"""

from __future__ import annotations

from repro_torch.baselines import oracle
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
        return oracle.dense_attention(q, base.dequant_leaf(cfg, view, "k"),
                               base.dequant_leaf(cfg, view, "v"),
                               scale=scale, length=length)
