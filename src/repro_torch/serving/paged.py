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
its fresh caches in with :func:`write_prefill`; the prefix cache un-shares
a page with :func:`clone_block`.  :func:`cache_kind_counts` counts the
layers of each kind (the trace's ``trace_start`` metadata).  State
(Mamba) layers and ``keep_state_rows`` come with ROADMAP.md queue 1 item
7; the byte accounting the serving benchmark reads
(``pool_block_bytes``, ``gather_footprint``) with item 10.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig, ServingSettings
from repro_torch.models import backends as bk
from repro_torch.models import transformer as tfm

__all__ = ["init_paged_caches", "gather_views", "scatter_token",
           "write_prefill", "clone_block", "raw_view", "cache_kind_counts"]


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


def raw_view(leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` as bytes where it is fp8 (the CPU build has no fp8
    ``index_put_``, ``fill_`` or ``==``); other dtypes as they are."""
    if leaf.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return leaf.view(torch.uint8)
    return leaf


def clone_block(cfg: ModelConfig, pages, src: int, dst: int,
                keep_tokens: int):
    """Copy-on-write clone: duplicate physical page ``src`` into ``dst``
    across every **paged**-kind leaf of every layer (K/V, their int8/fp8
    ``k_scale``/``v_scale`` rows, SOCKET's ``bits`` and ``vnorm``), keeping
    only the rows of the first ``keep_tokens`` tokens and resetting the
    rest to the leaf's fill value, in place.  The scrub is what makes
    sharing safe: a shared tail page's rows past the matched prefix hold
    the *donor's* tokens (or its generated continuation), and the pool
    never scrubs device memory on free, so without it stale rows would
    leak into the clone's owner.

    Ring leaves pass through (the prefix cache is off for plans that have
    any).  Leaves with ``granularity > 1`` (Quest's per-page bounds)
    cannot keep a partial page soundly, so this raises, before it writes
    anything, where one is present — the cache policy page-aligns matches
    for such plans, making the CoW path unreachable.  Returns the pool."""
    todo = []
    for spec, layer in zip(cfg.layer_specs, pages):
        h = bk.layer_cache_handler(cfg, spec)
        if h.kind != "paged":
            continue
        leaves = h.spec(cfg).leaves
        for name in layer:
            if leaves[name].granularity != 1:
                raise ValueError(
                    f"CoW clone of page-granular leaf {name!r} is unsound "
                    "(partial-page stats would cover scrubbed rows); the "
                    "prefix cache must page-align matches for this plan")
        todo += [(layer[name], leaves[name].fill) for name in layer]
    for leaf, fill in todo:
        raw = raw_view(leaf)
        page = raw[src].clone()                   # (KVH, rows, *suffix)
        page[:, keep_tokens:] = raw_view(torch.full((), fill,
                                                    dtype=leaf.dtype))
        raw[dst] = page
    return pages


def cache_kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Layer count per cache kind (``paged``/``ring``/``state``) under the
    per-layer plan (``cfg.cache_plan()``), as the JAX package counts
    them."""
    counts = {"paged": 0, "ring": 0, "state": 0}
    for spec in cfg.layer_specs:
        counts[cfg.plan_for(spec).kind] += 1
    return counts
