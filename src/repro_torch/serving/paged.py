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

* **state** (Mamba/SSD) — conv tail + recurrent state as one row per
  decode slot (``(max_batch, ...)``), no block table at all.

The pool is a list of per-layer leaf dicts (the layout of the static
path's caches); one block id addresses the same page in every layer, so
the host allocator hands out one id list per request for the whole
stack — ring layers simply recycle the list's head.  The pool is updated
**in place** by every engine step.

Paged-capable backends (``DecodeBackend.supports_paged``) consume the
pool directly through ``PagedView``/``RingView``; for the rest (dense)
the engine falls back to the gather/scatter round trip below, which is
window-bounded for ring layers (state rows need no view at all).  The
legacy whole-prompt prefill writes its fresh caches in with
:func:`write_prefill`; the prefix cache un-shares a page with
:func:`clone_block`; :func:`keep_state_rows` keeps idle decode slots'
state rows across a step that moves every row.  :func:`cache_kind_counts`
counts the layers of each kind (the trace's ``trace_start`` metadata),
and :func:`kv_row_bytes`, :func:`pool_block_bytes` and
:func:`gather_footprint` are the byte accounting the serving benchmark
reads (each equal to the JAX package's).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServingSettings
from repro_torch.models import backends as bk
from repro_torch.models import transformer as tfm

__all__ = ["init_paged_caches", "gather_views", "scatter_token",
           "write_prefill", "keep_state_rows", "state_leaves", "clone_block",
           "raw_view", "cache_kind_counts",
           "kv_row_bytes", "pool_block_bytes", "gather_footprint"]


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
    of ring layers, the per-slot state rows themselves of state layers.
    bt: (B, max_blocks_per_seq) physical block ids
    (trash-padded)."""
    return [bk.layer_cache_handler(cfg, spec).gather(cfg, layer, bt)
            for spec, layer in zip(cfg.layer_specs, pages)]


def scatter_token(cfg: ModelConfig, pages, views, bt: torch.Tensor,
                  pos: torch.Tensor):
    """Write what a decode step updated in the contiguous views back into
    the pool, in place: the one new row of paged layers, the one ring row
    (with the page-opening scrub) of ring layers; state layers' rows were
    moved on in place.  Inactive slots point at the trash block.  Returns
    the pool."""
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


def state_leaves(cfg: ModelConfig, pages) -> List[torch.Tensor]:
    """Every leaf of the pool's state (Mamba) layers: ``(max_batch, ...)``
    rows, one per decode slot."""
    return [leaf for spec, layer in zip(cfg.layer_specs, pages)
            if cfg.plan_for(spec).kind == "state" for leaf in layer.values()]


@contextlib.contextmanager
def keep_state_rows(cfg: ModelConfig, pages, slots: Sequence[int]):
    """Keep the decode slots ``slots``' **state** rows across the step run
    in the body: the ragged decode step moves every Mamba slot row on
    (masked attention slots write the trash page, but state rows have no
    trash row to absorb the garbage).  Under chunked prefill a slot's
    state must survive the decode iterations run *between* its chunks, so
    the rows of the slots holding no runnable request are saved on entry
    and put back on exit, in place; paged and ring leaves are left alone
    (their idle slots' writes land in the trash page).  The JAX package's
    ``keep_state_rows`` selects the same rows from the step's input and
    output pools."""
    leaves = state_leaves(cfg, pages) if len(slots) else []
    if leaves:
        idx = torch.tensor(list(slots), device=leaves[0].device)
        saved = [(leaf, leaf[idx]) for leaf in leaves]
    yield
    for leaf, rows in (saved if leaves else ()):
        leaf[idx] = rows


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

    Ring and state leaves pass through (the prefix cache is off for plans
    that have any).  Leaves with ``granularity > 1`` (Quest's per-page bounds)
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


# -------------------------------------------------------------- accounting

def _leaf_row_bytes(s, cdt: torch.dtype) -> float:
    """Bytes one *token* of leaf ``s`` occupies (suffix width x storage
    itemsize, amortized over the leaf's sequence granularity)."""
    width = int(np.prod(s.suffix, dtype=np.int64)) if s.suffix else 1
    return width * s.leaf_dtype(cdt).itemsize / s.granularity


def kv_row_bytes(cfg: ModelConfig, names=("k", "v", "k_scale",
                                          "v_scale")) -> int:
    """Per-token K/V storage bytes across one KV head set: the
    dtype-sized payload plus the float32 per-row scale leaves when the
    pages are stored as int8/fp8."""
    spec = bk.kv_leaf_specs(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    return int(cfg.num_kv_heads * sum(
        _leaf_row_bytes(spec[nm], cdt) for nm in names if nm in spec))


def pool_block_bytes(cfg: ModelConfig) -> Dict[str, int]:
    """Bytes one physical pool block occupies, per layer kind and in
    total per block id (a block id addresses the same page in every
    paged and ring layer): every leaf of the resolved cache spec at its
    own storage dtype (int8/fp8 K/V pages, float32 scale rows, uint32
    hash words, page-granular stats), so the pool's capacity follows
    ``cfg.serving.kv_dtype``."""
    sv = cfg.serving
    cdt = getattr(torch, cfg.compute_dtype)
    counts = cache_kind_counts(cfg)
    out = {"paged": 0, "ring": 0}
    for spec_l in cfg.layer_specs:
        kind = cfg.plan_for(spec_l).kind
        if kind == "state":
            continue
        leaves = bk.layer_cache_spec(cfg, spec_l).leaves
        out[kind] += int(cfg.num_kv_heads * sv.block_size * sum(
            _leaf_row_bytes(s, cdt) for s in leaves.values()))
    out["per_block_id"] = out["paged"] + out["ring"]
    out["num_paged_layers"] = counts["paged"]
    out["num_ring_layers"] = counts["ring"]
    return out


def gather_footprint(cfg: ModelConfig) -> Dict[str, int]:
    """Per-decode-step gathered bytes for the whole stack, full-view vs
    paged, by layer kind (what the serving benchmark reports).

    ``full_view_bytes_per_step``: every global-attention cache leaf
    materialized at ``(max_batch, KVH, max_context, ...)`` plus
    context-length K/V views for the window layers, what a plan-less
    pager would move.  ``paged_bytes_per_step``: global layers move
    their metadata leaves plus the backend's ``selected_rows`` K/V rows
    (0 with the fused paged kernel), window layers their bounded ring
    views (``window_bytes_per_step``; 0 with the ring kernel), Mamba
    layers nothing (``state_bytes_per_step`` reports the per-slot state
    size a decode step reads and writes regardless: no gather, no growth
    with context).
    """
    sv = cfg.serving
    b, n = sv.max_batch, sv.max_context
    kvh = cfg.num_kv_heads
    cdt = getattr(torch, cfg.compute_dtype)
    counts = cache_kind_counts(cfg)

    full = paged = window = 0
    selected = 0
    fused = False
    if counts["paged"]:
        backend = bk.get_backend(cfg.attention_backend)
        spec = backend.cache_spec(cfg)

        def leaf_bytes(s):
            width = int(np.prod(s.suffix, dtype=np.int64)) if s.suffix \
                else 1
            return b * kvh * s.rows(n) * width * s.leaf_dtype(cdt).itemsize

        full_l = sum(leaf_bytes(s) for s in spec.values())
        # the K/V storage leaves (payload and scale rows) are gathered on
        # demand; the metadata leaves stream in full
        kv_names = [nm for nm in ("k", "v", "k_scale", "v_scale")
                    if nm in spec]
        kv_bytes = sum(leaf_bytes(spec[nm]) for nm in kv_names)
        selected = backend.selected_rows(cfg, n)
        row_b = kvh * sum(_leaf_row_bytes(spec[nm], cdt)
                          for nm in kv_names)
        paged_l = (full_l - kv_bytes) + int(b * selected * row_b)
        fused = backend.supports_paged and backend.fused_paged(cfg)
        if fused:
            paged_l = 0
        if not backend.supports_paged:
            paged_l = full_l
        full += full_l * counts["paged"]
        paged += paged_l * counts["paged"]
    ring_fused = False
    if counts["ring"]:
        ring_rows = cfg.ring_geometry()[1]
        row_b = kv_row_bytes(cfg)
        ring_l = b * ring_rows * row_b
        full_l = b * n * row_b
        ring_fused = bool(cfg.use_ring_kernel)
        # the ring kernel streams the circular page list itself: no
        # gather materializes the bounded window view
        window = 0 if ring_fused else ring_l * counts["ring"]
        full += full_l * counts["ring"]
        paged += window
    state = 0
    if counts["state"]:
        di, hd, st = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state
        conv_dim = di + 2 * st
        state_l = b * (cfg.ssm_heads * hd * st * 4 +
                       (cfg.ssm_conv_width - 1) * conv_dim * cdt.itemsize)
        state = state_l * counts["state"]

    return {
        "full_view_bytes_per_step": int(full),
        "paged_bytes_per_step": int(paged),
        "window_bytes_per_step": int(window),
        "state_bytes_per_step": int(state),
        "selected_rows": int(selected),
        "fused_paged_kernel": bool(fused),
        "fused_ring_kernel": bool(ring_fused),
        "num_paged_layers": counts["paged"],
        "num_ring_layers": counts["ring"],
        "num_state_layers": counts["state"],
    }
