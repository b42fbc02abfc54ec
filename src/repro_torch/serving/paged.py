"""Device-side paged cache pool, organised by the per-layer cache plan.

Port of ``repro.serving.paged`` for all-global layouts.  Every layer's
plan is ``paged`` (global attention): each leaf of the decode backend's
``cache_spec`` is re-homed with the batch axis replaced by the physical
block axis and the capacity axis by the block size::

    k / v : (num_blocks, KVH, block_size, hd)
    bits  : (num_blocks, KVH, block_size, W)   (SOCKET hash bits, int32)
    vnorm : (num_blocks, KVH, block_size)      (SOCKET value norms, bf16)

The pool is a list of per-layer leaf dicts (the layout of the static
path's caches); one block id addresses the same page in every layer.
It is updated **in place** by every engine step.

Paged-capable backends (``DecodeBackend.supports_paged``) consume the
pool directly through ``PagedView``; for the rest (dense) the engine
falls back to the gather/scatter round trip below.  Ring and state
layers (and the per-layer cache handlers that tell them apart), the
legacy whole-prompt ``write_prefill``, ``keep_state_rows``, the prefix
cache's ``clone_block``, and the byte accounting the serving benchmark
reads (``pool_block_bytes``, ``gather_footprint``) come with later
slices.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig, ServingSettings
from repro_torch.models import backends as bk

__all__ = ["init_paged_caches", "gather_views", "scatter_token"]


def init_paged_caches(cfg: ModelConfig, serving: ServingSettings,
                      device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Pool initialized to each leaf's fill value: one leaf dict per
    layer at batch=num_blocks, capacity=block_size.  Raises for layouts
    that are not all-global (``cfg.cache_plan()``)."""
    serving.validate()
    cfg.cache_plan()
    backend = bk.get_backend(cfg.attention_backend)
    dtype = getattr(torch, cfg.compute_dtype)
    return [backend.init_cache(cfg, serving.num_blocks, cfg.num_kv_heads,
                               serving.block_size, dtype, device)
            for _ in cfg.layer_specs]


def gather_views(cfg: ModelConfig, pages, bt: torch.Tensor):
    """Materialize the ragged batch's contiguous cache views (the dense
    fallback): full logical views of every layer.  bt: (B,
    max_blocks_per_seq) physical block ids (trash-padded)."""
    del cfg
    return [{name: bk.gather_block_leaf(p, bt) for name, p in layer.items()}
            for layer in pages]


def scatter_token(cfg: ModelConfig, pages, views, bt: torch.Tensor,
                  pos: torch.Tensor):
    """Write the row each slot's decode step updated in the contiguous
    views (token ``pos[b]``, view row ``pos // granularity``) back into
    physical page ``bt[b, pos // block_size]``, in place; returns the
    pool.  Inactive slots point at the trash block."""
    bs = cfg.serving.block_size
    spec = bk.get_backend(cfg.attention_backend).cache_spec(cfg)
    bt, pos = bt.long(), pos.long()
    bidx = torch.arange(bt.shape[0], device=bt.device)
    blk = bt[bidx, pos // bs]
    for layer, view in zip(pages, views):
        for name, p in layer.items():
            gran = spec[name].granularity
            row = view[name][bidx, :, pos // gran]      # (B, KVH, *rest)
            p[blk, :, (pos % bs) // gran] = row.to(p.dtype)
    return pages
