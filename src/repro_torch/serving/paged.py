"""Device-side paged cache pool, organised by the per-layer cache plan.

Port of ``repro.serving.paged``.  Each layer of the stack resolves to one
cache handler (:func:`repro_torch.models.backends.layer_cache_handler`,
mirroring ``cfg.cache_plan()``):

* **paged** (global attention) — every leaf of the decode backend's
  ``cache_spec`` re-homed with the batch axis replaced by the physical
  block axis and the capacity axis by the block size::

      k / v             : (num_blocks, KVH, block_size, hd)
      k_scale / v_scale : (num_blocks, KVH, block_size)  (int8/fp8 only)
      bits              : (num_blocks, KVH, block_size, W)  (int32)
      vnorm             : (num_blocks, KVH, block_size)     (bf16)

  K/V at ``serving.kv_dtype``'s storage dtype (the compute dtype, bf16,
  int8 or ``float8_e4m3fn``); the scale leaves are float32.

* **ring** (sliding-window attention) — ``k``/``v`` pages of the same
  geometry, addressed circularly through the first ``ring_blocks``
  block-table entries, so per-slot block demand is bounded by the
  window.

The pool is a list of per-layer leaf dicts (the layout of the static
path's caches); one block id addresses the same page in every layer, so
the host allocator hands out one id list per request for the whole
stack — ring layers simply recycle the list's head.  The pool is updated
**in place** by every engine step.

Paged-capable backends (``DecodeBackend.supports_paged``) consume the
pool directly through ``PagedView``/``RingView``; for the rest (dense)
the engine falls back to the gather/scatter round trip below, which is
window-bounded for ring layers.  The legacy whole-prompt prefill writes
its fresh caches in with :func:`write_prefill`.  State (Mamba) layers
and ``keep_state_rows`` come with ROADMAP.md queue 1 item 7; the prefix
cache's ``clone_block`` with item 8; the byte accounting the serving
benchmark reads (``pool_block_bytes``, ``gather_footprint``) with item
10.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig, ServingSettings
from repro_torch.models import backends as bk
from repro_torch.models import transformer as tfm

__all__ = ["init_paged_caches", "gather_views", "scatter_token",
           "write_prefill"]


def init_paged_caches(cfg: ModelConfig, serving: ServingSettings,
                      device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Pool initialized to each leaf's fill value: one leaf dict per
    layer at batch=num_blocks, capacity=block_size (``pool=serving``
    layout: ring layers get full block_size-row pages), each leaf at its
    storage dtype (zero K/V payloads and zero scale rows, the trash page
    included).  Raises for layers the cache plan cannot place
    (``cfg.cache_plan()``)."""
    serving.validate()
    cfg.cache_plan()
    return tfm.init_decode_caches(cfg, serving.num_blocks,
                                  serving.block_size, device=device,
                                  pool=serving)


def gather_views(cfg: ModelConfig, pages, bt: torch.Tensor):
    """Materialize the ragged batch's contiguous cache views (the dense
    fallback): full logical views of paged layers, window-bounded rings
    of ring layers.  bt: (B, max_blocks_per_seq) physical block ids
    (trash-padded)."""
    return [bk.layer_cache_handler(cfg, spec).gather(cfg, layer, bt)
            for spec, layer in zip(cfg.layer_specs, pages)]


def scatter_token(cfg: ModelConfig, pages, views, bt: torch.Tensor,
                  pos: torch.Tensor):
    """Write what a decode step updated in the contiguous views back into
    the pool, in place: the one new row of paged layers, the one ring row
    (with the page-opening scrub) of ring layers.  Inactive slots point
    at the trash block.  Returns the pool."""
    for spec, layer, view in zip(cfg.layer_specs, pages, views):
        bk.layer_cache_handler(cfg, spec).scatter(cfg, layer, view, bt, pos)
    return pages


def write_prefill(cfg: ModelConfig, pages, caches, bt_row: torch.Tensor,
                  slot: int):
    """Scatter a freshly prefilled (batch=1, capacity=bucket) per-layer
    cache list into the pool, in place.  ``bt_row``: block ids sized
    ``max(bucket / block_size, ring_blocks)``; entries past the request's
    real block count point at the trash page.  ``slot``: the request's
    decode slot (for per-slot state rows).  Returns the pool."""
    for spec, layer, cache in zip(cfg.layer_specs, pages, caches):
        bk.layer_cache_handler(cfg, spec).write_prefill(cfg, layer, cache,
                                                        bt_row, slot)
    return pages
