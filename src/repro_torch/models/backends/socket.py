"""SOCKET decode backend (the paper's technique, Algorithms 1-3).

Port of ``repro.models.backends.socket``.  Cache leaves: K/V plus the
side-cache of packed hash bits (int32 words with the uint32 bit pattern)
and bf16 value norms.  ``attend`` soft-hashes the query, scores every
cached key — through the CUDA ``socket_score`` kernel when
``cfg.socket.use_score_kernel`` is set — runs value-aware top-k, and
attends exactly over the selected subset (the CUDA ``flash_decode``
kernel when ``cfg.socket.use_flash_decode``).

Paged-capable: scoring reads only the bits/vnorm leaves and K/V are
touched only at the selected rows, so the serving engine hands it the
pool.  With ``cfg.socket.use_paged_kernel`` a PagedView attend runs as
ONE fused CUDA pass (``kernels/paged_attention``) over the pool and the
block table; contiguous callers keep the socket_score + flash_decode
pair.

The selection probe and the context-parallel route come with later
slices.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core import socket as sk
from repro_torch.models.backends import base
from repro_torch.models.backends.base import KVView, LeafSpec

__all__ = ["SocketBackend", "socket_config_of"]


def socket_config_of(cfg) -> sk.SocketConfig:
    """Map the model config's SocketSettings to the scorer's config."""
    s = cfg.socket
    return sk.SocketConfig(
        num_planes=s.num_planes, num_tables=s.num_tables, tau=s.tau,
        sparsity=s.sparsity, sink_tokens=s.sink_tokens,
        window_tokens=s.window_tokens, min_k=s.min_k,
        bits_storage=s.bits_storage, score_chunk=s.score_chunk,
        score_dtype=s.score_dtype, selection=s.selection)


class SocketBackend(base.DecodeBackend):
    name = "socket"
    supports_paged = True

    def cache_spec(self, cfg):
        scfg = socket_config_of(cfg)
        spec = base.kv_leaf_specs(cfg)
        if scfg.bits_storage == "packed":
            w = hashing.num_words(scfg.num_tables, scfg.num_planes)
            spec["bits"] = LeafSpec(suffix=(w,), dtype=torch.int32)
        else:
            spec["bits"] = LeafSpec(
                suffix=(scfg.num_tables * scfg.num_planes,), dtype=torch.int8)
        spec["vnorm"] = LeafSpec(suffix=(), dtype=torch.bfloat16)
        return spec

    def prefill_build(self, cfg, params, cache, kc, vc):
        t = kc.shape[2]
        cache = base.write_prefill_kv(cfg, cache, kc, vc)
        side = sk.precompute_key_hashes(socket_config_of(cfg),
                                        params["hash_w"], kc, vc)
        cache["bits"][:, :, :t] = side.bits
        cache["vnorm"][:, :, :t] = side.vnorm
        return cache

    def append(self, cfg, params, view: KVView, kc, vc, pos):
        base.write_token_kv(cfg, view, pos, kc[:, :, 0], vc[:, :, 0])
        side = sk.precompute_key_hashes(socket_config_of(cfg),
                                        params["hash_w"], kc, vc)
        view.write_token("bits", pos, side.bits[:, :, 0])
        view.write_token("vnorm", pos, side.vnorm[:, :, 0])

    def _budget(self, cfg, length, n):
        """Ragged per-request top-k budget (None for a scalar length)."""
        if not (isinstance(length, torch.Tensor) and length.ndim == 1):
            return None
        scfg = socket_config_of(cfg)
        return sk.dynamic_topk_budget(scfg, length, sk.topk_budget(scfg, n))

    @staticmethod
    def _soft_hash(scfg, params, q):
        """pooled hashes the group-mean query once per KV head
        ((B,KVH,L,P)), else each q head ((B,KVH,G,L,P))."""
        if scfg.selection == "pooled":
            return sk.soft_hash_query(params["hash_w"],
                                      torch.mean(q[..., 0, :], dim=2))
        return sk.soft_hash_query(params["hash_w"], q[..., 0, :])

    def _scores(self, cfg, params, q, view: KVView):
        scfg = socket_config_of(cfg)
        u = self._soft_hash(scfg, params, q)
        bits = view.leaf("bits")
        if cfg.socket.use_score_kernel:
            if scfg.selection not in ("kvhead", "pooled"):
                raise NotImplementedError(
                    "the scoring kernel group-sums scores (kvhead "
                    "selection); use the plain path for per-q-head "
                    "selection")
            from repro_torch.kernels.socket_score import ops as score_ops
            u_k = u[:, :, None] if scfg.selection == "pooled" else u
            return score_ops.socket_score(
                bits, u_k, vnorm=None, num_tables=scfg.num_tables,
                num_planes=scfg.num_planes, tau=scfg.tau)  # (B,KVH,N) G-sum
        if scfg.selection == "pooled":
            return sk.soft_scores_factorized(scfg, bits, u)   # (B,KVH,N)
        scores = sk.soft_scores_factorized(scfg, bits[:, :, None], u)
        if scfg.selection == "kvhead":
            scores = torch.sum(scores, dim=2)                 # (B,KVH,N)
        return scores

    def _attend_fused(self, cfg, params, q, view, *, length, scale, budget):
        """Fused paged path: one CUDA pass over the block table."""
        scfg = socket_config_of(cfg)
        if scfg.bits_storage != "packed":
            raise NotImplementedError(
                "the fused paged kernel streams packed hash words; "
                "bits_storage='int8' must use the unfused paged path")
        if scfg.selection not in ("kvhead", "pooled"):
            raise NotImplementedError(
                "the fused paged kernel group-sums scores (kvhead/pooled "
                "selection); per-q-head selection has no fused path")
        if view.block_size % 8:
            raise NotImplementedError(
                f"fused paged kernel needs block_size % 8 == 0, got "
                f"{view.block_size}")
        u = self._soft_hash(scfg, params, q)
        if scfg.selection == "pooled":
            u = u[:, :, None]                       # (B,KVH,1,L,P)
        if budget is None:
            budget = torch.full((q.shape[0],),
                                sk.topk_budget(scfg, view.n_tokens),
                                dtype=torch.int32, device=q.device)
        from repro_torch.kernels.paged_attention import ops as pa_ops
        out = pa_ops.paged_socket_attend(
            q, view.arrays["k"], view.arrays["v"], view.arrays["bits"],
            view.arrays["vnorm"], u, view.block_table, length=length,
            budget=budget, num_tables=scfg.num_tables,
            num_planes=scfg.num_planes, tau=scfg.tau, scale=scale,
            sink_tokens=scfg.sink_tokens, window_tokens=scfg.window_tokens,
            k_scale=base.kv_scales_of(view.arrays, "k"),
            v_scale=base.kv_scales_of(view.arrays, "v"))
        return out.to(q.dtype)

    def attend(self, cfg, params, q, view: KVView, *, length, scale):
        scfg = socket_config_of(cfg)
        if scfg.selection not in ("kvhead", "pooled", "qhead"):
            raise ValueError(scfg.selection)
        n = view.n_tokens
        budget = self._budget(cfg, length, n)
        if cfg.socket.use_paged_kernel and isinstance(view, base.PagedView):
            return self._attend_fused(cfg, params, q, view, length=length,
                                      scale=scale, budget=budget)
        scores = self._scores(cfg, params, q, view)
        vnorm = view.leaf("vnorm").float()
        kq = sk.topk_budget(scfg, n)
        if scfg.selection in ("kvhead", "pooled"):
            idx, sel_mask = sk.value_aware_topk(
                scfg, scores, vnorm, k=kq, length=length, n_total=n,
                budget=budget)
            k_sel, v_sel = base.gather_kv_rows(cfg, view, idx)
            return base.subset_attention(cfg, q, k_sel, v_sel, sel_mask,
                                         scale=scale)
        # per-q-head selection: gather per (kvh, g); no shared-KV gather,
        # so no flash_decode layout
        idx, sel_mask = sk.value_aware_topk(
            scfg, scores, vnorm[:, :, None], k=kq, length=length,
            n_total=n, budget=budget)
        k_sel, v_sel = base.gather_kv_rows(cfg, view, idx)  # (B,KVH,G,K,hd)
        logits = torch.einsum("bhgtd,bhgkd->bhgtk", q.float(),
                              k_sel.float()) * scale
        logits = torch.where(sel_mask[:, :, :, None, :], logits, sk.NEG_INF)
        wts = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgtk,bhgkd->bhgtd", wts, v_sel.float())
        return out.to(q.dtype)
