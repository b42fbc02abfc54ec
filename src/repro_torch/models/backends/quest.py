"""Quest decode backend (page min/max metadata + page top-k).

Port of ``repro.models.backends.quest``.  The metadata leaves are
**page-granular** (``granularity = cfg.quest.page_size`` rows in the
cache spec): in the serving engine's pool each physical block carries
``block_size / page_size`` min/max rows, so Quest's page table IS the
block pool.  ``page_size`` must divide ``ServingSettings.block_size``.

Paged-capable: page scoring reads only the small kmin/kmax leaves; K/V
are gathered only for the selected pages.  With
``cfg.quest.use_paged_kernel`` a PagedView decode runs as ONE fused CUDA
pass (``kernels/paged_attention.paged_quest_attend``).

A probe shadow step (``probe.capturing()``) takes the plain route and
records :func:`~repro_torch.models.backends.probe.selection_stats` (the
budget is page-granular and folded into the selection mask, so the
reported budget is the static selection width); the plain page
selection is the fused kernel's bit for bit.  The byte accounting the
serving benchmark reads (``selected_rows``, ``fused_paged``) comes with
a later slice (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.baselines import quest as quest_mod
from repro_torch.models.backends import base
from repro_torch.models.backends import probe as bprobe
from repro_torch.models.backends.base import KVView, LeafSpec

__all__ = ["QuestBackend"]


class QuestBackend(base.DecodeBackend):
    name = "quest"
    supports_paged = True

    @staticmethod
    def quest_config(cfg) -> quest_mod.QuestConfig:
        """Page geometry from ``cfg.quest``; budget, sink and window shared
        with the SOCKET settings."""
        return quest_mod.QuestConfig(
            page_size=cfg.quest.page_size, sparsity=cfg.socket.sparsity,
            sink_tokens=cfg.socket.sink_tokens,
            window_tokens=cfg.socket.window_tokens,
            min_pages=cfg.quest.min_pages)

    # ---- layout ---------------------------------------------------------
    def cache_spec(self, cfg):
        ps = cfg.quest.page_size
        if cfg.serving.block_size % ps:
            raise ValueError(
                f"quest page_size {ps} must divide serving block_size "
                f"{cfg.serving.block_size} (one block = whole pages)")
        hd = cfg.head_dim
        spec = base.kv_leaf_specs(cfg)
        spec["kmin"] = LeafSpec(suffix=(hd,), granularity=ps,
                                fill=float("inf"))
        spec["kmax"] = LeafSpec(suffix=(hd,), granularity=ps,
                                fill=float("-inf"))
        return spec

    # ---- ops ------------------------------------------------------------
    def prefill_build(self, cfg, params, cache, kc, vc):
        del params
        cache = base.write_prefill_kv(cfg, cache, kc, vc)
        # page stats from the keys the attend phase will read back
        state = quest_mod.build(self.quest_config(cfg), None,
                                base.effective_keys(cfg, kc), vc)
        n_pages_t = state.kmin.shape[2]
        cache["kmin"][:, :, :n_pages_t] = state.kmin.to(cache["kmin"].dtype)
        cache["kmax"][:, :, :n_pages_t] = state.kmax.to(cache["kmax"].dtype)
        return cache

    def append(self, cfg, params, view: KVView, kc, vc, pos):
        del params
        base.write_token_kv(cfg, view, pos, kc[:, :, 0], vc[:, :, 0])
        knew = base.effective_keys(cfg, kc)[:, :, 0]     # (B, KVH, hd)
        # A token opening a fresh page must *reset* the stats, not merge:
        # in the serving pool a decode-growth block may be a reused page
        # still carrying the previous owner's min/max (BlockPool never
        # scrubs device memory).  Page starts coincide with block starts
        # (page_size | block_size), so resetting at pos % page_size == 0
        # covers every first write into a page.
        first = torch.as_tensor(pos, device=knew.device) % \
            cfg.quest.page_size == 0
        if first.ndim:
            first = first[:, None, None]                 # (B,1,1) ragged
        view.rmw_token("kmin", pos, lambda old: torch.where(
            first, knew.to(old.dtype), torch.minimum(old, knew.to(old.dtype))))
        view.rmw_token("kmax", pos, lambda old: torch.where(
            first, knew.to(old.dtype), torch.maximum(old, knew.to(old.dtype))))

    def _attend_fused(self, cfg, params, q, view, *, length, scale):
        """Fused paged path: one CUDA pass over the block table."""
        del params
        qcfg = self.quest_config(cfg)
        if view.block_size % 8:
            raise NotImplementedError(
                f"fused paged kernel needs block_size % 8 == 0, got "
                f"{view.block_size}")
        n = view.n_tokens
        kp = quest_mod.page_budget(qcfg, n // qcfg.page_size, n)
        from repro_torch.kernels.paged_attention import ops as pa_ops
        out = pa_ops.paged_quest_attend(
            q, view.arrays["k"], view.arrays["v"], view.arrays["kmin"],
            view.arrays["kmax"], view.block_table, length=length,
            page_budget=kp, page_size=qcfg.page_size, scale=scale,
            sink_tokens=qcfg.sink_tokens, window_tokens=qcfg.window_tokens,
            k_scale=base.kv_scales_of(view.arrays, "k"),
            v_scale=base.kv_scales_of(view.arrays, "v"))
        return out.to(q.dtype)

    def attend(self, cfg, params, q, view: KVView, *, length, scale):
        if cfg.quest.use_paged_kernel and isinstance(view, base.PagedView) \
                and not bprobe.capturing():
            return self._attend_fused(cfg, params, q, view, length=length,
                                      scale=scale)
        del params
        qcfg = self.quest_config(cfg)
        state = quest_mod.QuestState(kmin=view.leaf("kmin"),
                                     kmax=view.leaf("kmax"))
        idx, sel_mask = quest_mod.select_tokens(
            qcfg, state, q, length=length, n=view.n_tokens)
        if bprobe.capturing():
            bprobe.emit(bprobe.selection_stats(
                qcfg, q, base.dequant_leaf(cfg, view, "k"), None,
                idx, sel_mask, length=length, budget=None,
                static_k=idx.shape[-1], scale=scale))
        k_sel, v_sel = base.gather_kv_rows(cfg, view, idx)
        return base.subset_attention(cfg, q, k_sel, v_sel, sel_mask,
                                     scale=scale)
