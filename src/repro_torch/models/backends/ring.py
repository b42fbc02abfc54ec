"""Ring-buffer cache handler for sliding-window ("local") attention layers.

Port of ``repro.models.backends.ring``.  Sliding-window layers only ever
attend the last ``window`` tokens, so their pages need not accumulate
with context: the request block table's first ``ring_blocks =
ceil(window / block_size)`` entries are reused as a **circular page
list** (logical token ``t`` -> entry ``(t // block_size) % ring_blocks``,
row ``t % block_size``) and old pages are recycled in place.  Per-slot
block demand is bounded by ``ring_blocks`` regardless of context length.

Decode-side reads and writes go through
:class:`~repro_torch.models.backends.base.RingView`
(``models/attention.py``); this handler owns the pool-side half: the
legacy whole-prompt prefill's scatter (the base class's block-for-block
one: the prefill ring is already in flat ring layout, slot ``s`` the
newest prompt position ``p ≡ s (mod capacity)``, so each ring block goes
to exactly one page of ``bt_row[:ring_blocks]``), the bounded contiguous
ring views of the dense fallback, and the write-back of decode-updated
ring rows.
Both write paths **scrub at page-opening writes** (see
:func:`~repro_torch.models.backends.base.ring_write_page`; the prefill
scatter writes every row of every page it touches): recycled pool blocks
carry the previous owner's data and are never zeroed otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.models.backends import base

__all__ = ["RingCacheHandler"]


class RingCacheHandler(base.LayerCacheHandler):
    kind = "ring"

    def spec(self, cfg) -> base.LayerCacheSpec:
        return base.LayerCacheSpec(kind="ring",
                                   leaves=base.kv_leaf_specs(cfg),
                                   ring_blocks=cfg.ring_geometry()[0])

    def gather(self, cfg, pages, bt):
        """Bounded contiguous ring views ``(B, KVH, ring_blocks *
        block_size, hd)`` — window-sized, never context-sized."""
        rb = cfg.ring_geometry()[0]
        return {name: base.gather_block_leaf(p, bt[:, :rb])
                for name, p in pages.items()}

    def scatter(self, cfg, pages, views, bt, pos):
        """Write each slot's ring row of token ``pos[b]`` (view row ``pos
        % rows``) back into its circular page, with the page-opening
        scrub, in place."""
        bs = cfg.serving.block_size
        rb, rows = cfg.ring_geometry()
        bt, pos = bt.long(), pos.long()
        bidx = torch.arange(bt.shape[0], device=bt.device)
        blk = bt[bidx, (pos // bs) % rb]
        for name, p in pages.items():
            val = base._take(views[name], (bidx, slice(None), pos % rows))
            base.ring_write_page(p, blk, pos, val, block_size=bs,
                                 ring_blocks=rb, window=cfg.sliding_window)
        return pages
