"""O(1)-state cache handler for Mamba/SSD layers.

Port of ``repro.models.backends.state``.  Mamba layers decode from a
fixed-size recurrent state (conv tail + SSD state): there is nothing
sequence-shaped to page, so on the continuous engine their "cache" is one
row per decode slot (batch axis ``serving.max_batch``) and they consume
**zero** pool blocks.  The decode step moves every slot row on each
iteration (the engine puts idle slots' rows back:
``serving.paged.keep_state_rows``); a prefill overwrites its slot's row
whole at admission, which also scrubs the previous occupant's state.

Preemption-resume is exact by recomputation: re-prefilling the prompt
reproduces the SSD state at its last token (bucket or chunk padding is
kept out of the state by ``last_index`` in
:func:`repro_torch.models.mamba.mamba_train`), and the recorded tokens
then replay through the decode step that produced them.
"""

from __future__ import annotations

from repro_torch.models.backends import base

__all__ = ["StateCacheHandler"]


class StateCacheHandler(base.LayerCacheHandler):
    kind = "state"

    def spec(self, cfg) -> base.LayerCacheSpec:
        # no leaves: state shapes come from mamba.init_mamba_cache (they
        # are not (batch, KVH, rows, ...)-shaped LeafSpec leaves)
        return base.LayerCacheSpec(kind="state", leaves={})

    def write_prefill(self, cfg, pages, cache, bt_row, slot):
        """The batch-1 prefill's state into the slot's rows, in place."""
        for name, p in pages.items():
            p[slot] = cache[name][0].to(p.dtype)
        return pages

    def gather(self, cfg, pages, bt):
        """The slot rows themselves (no block table at all): the decode
        step moves them on in place."""
        return dict(pages)

    def scatter(self, cfg, pages, views, bt, pos):
        """Nothing to write back: the views are the pool's rows."""
        return pages
