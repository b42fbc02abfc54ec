"""Decode-backend registry.

Every global-attention decode backend is one module implementing the
:class:`~repro_torch.models.backends.base.DecodeBackend` interface and
registered here under its ``cfg.attention_backend`` name: ``socket``,
``hard_lsh``, ``quest`` and ``dense``.  :func:`layer_cache_handler`
resolves one layer of the per-layer cache plan to its pool-side handler.
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.backends.base import (
    ContiguousView, DecodeBackend, KVView, LayerCacheHandler, LayerCacheSpec,
    LeafSpec, PagedKVCacheHandler, PagedView, RingView, dequant_leaf,
    effective_keys, gather_block_leaf, gather_kv_rows, kv_leaf_specs,
    kv_quant_mode, kv_scales_of, quantize_kv, ring_write_chunk,
    ring_write_page, subset_attention, write_chunk_blocks, write_chunk_rows,
    write_prefill_kv, write_token_kv)
from repro_torch.models.backends.dense import DenseBackend
from repro_torch.models.backends.hard_lsh import HardLSHBackend
from repro_torch.models.backends.quest import QuestBackend
from repro_torch.models.backends.ring import RingCacheHandler
from repro_torch.models.backends.socket import SocketBackend, socket_config_of
from repro_torch.models.backends.state import StateCacheHandler

__all__ = ["DecodeBackend", "KVView", "ContiguousView", "PagedView",
           "RingView", "LeafSpec", "LayerCacheSpec", "LayerCacheHandler",
           "PagedKVCacheHandler", "RingCacheHandler", "StateCacheHandler",
           "layer_cache_handler",
           "layer_cache_spec", "kv_quant_mode", "kv_leaf_specs",
           "kv_scales_of", "effective_keys", "quantize_kv",
           "write_prefill_kv", "write_token_kv", "gather_kv_rows",
           "dequant_leaf", "gather_block_leaf", "write_chunk_blocks",
           "write_chunk_rows", "ring_write_page", "ring_write_chunk",
           "subset_attention", "register", "get_backend",
           "registered_backends", "socket_config_of"]

_REGISTRY: Dict[str, DecodeBackend] = {}


def register(cls):
    """Class decorator: instantiate and register a backend by its name."""
    assert cls.name, cls
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> DecodeBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown attention backend {name!r}; registered: "
            f"{registered_backends()}") from None


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


for _cls in (SocketBackend, HardLSHBackend, QuestBackend, DenseBackend):
    register(_cls)
del _cls


def layer_cache_handler(cfg, spec) -> LayerCacheHandler:
    """Resolve one :class:`~repro_torch.configs.base.LayerSpec` to its
    pool-side cache handler — the device half of ``cfg.cache_plan()``:
    global attention layers get the decode backend's paged-KV layout,
    sliding-window layers a bounded circular page ring, Mamba layers
    per-slot state rows."""
    if spec.kind != "attn":
        return StateCacheHandler()
    if spec.attn_type == "local":
        return RingCacheHandler()
    return PagedKVCacheHandler(get_backend(cfg.attention_backend))


def layer_cache_spec(cfg, spec) -> LayerCacheSpec:
    """Resolved declarative cache layout for one layer."""
    return layer_cache_handler(cfg, spec).spec(cfg)
