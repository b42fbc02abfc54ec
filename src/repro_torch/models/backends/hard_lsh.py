"""Hard-LSH decode backend (the tau -> 0 ablation of SOCKET).

Port of ``repro.models.backends.hard_lsh``.  Shares SOCKET's cache layout
(packed sign bits + value norms), budgets and value-aware top-k, but
scores by *hard* collision counting: a key scores the number of tables
whose every plane sign agrees with the query's.  Paged-capable for the
same reason SOCKET is: scoring reads only the bits leaf, K/V only at the
selected rows.

With ``cfg.socket.use_paged_kernel`` (the same gate as SOCKET: the
backends share the cache layout and every other eligibility rule) a
PagedView decode runs as ONE fused CUDA pass
(``kernels/paged_attention.paged_hard_lsh_attend``).

A probe shadow step (``probe.capturing()``) takes the plain route and
records :func:`~repro_torch.models.backends.probe.selection_stats`; the
plain selection is the fused kernel's bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core import socket as sk
from repro_torch.models.backends import base
from repro_torch.models.backends import probe as bprobe
from repro_torch.models.backends.socket import SocketBackend, socket_config_of

__all__ = ["HardLSHBackend"]


def _hard_collision_scores(scfg: sk.SocketConfig, bits: torch.Tensor,
                           u_signs: torch.Tensor) -> torch.Tensor:
    """Hard collision counts from the same packed bits.

    bits (B,KVH,N,W); u_signs (B,KVH,G,L,P) ±1.  Returns (B,KVH,G,N) f32.
    """
    l, p = scfg.num_tables, scfg.num_planes
    k_signs = hashing.unpack_signs(bits, l, p)           # (B,KVH,N,L,P)
    agree = torch.einsum("bknlp,bkglp->bkgnl", k_signs, u_signs.float())
    return torch.sum((agree >= p).float(), dim=-1)


def _query_signs(params, q: torch.Tensor) -> torch.Tensor:
    """±1 plane signs ``(B,KVH,G,L,P)`` of the query's soft hash."""
    u = sk.soft_hash_query(params["hash_w"], q[..., 0, :])
    return torch.where(u >= 0, 1.0, -1.0)


class HardLSHBackend(SocketBackend):
    name = "hard_lsh"
    supports_paged = True

    def _attend_fused(self, cfg, params, q, view, *, length, scale, budget):
        """Fused paged path: one CUDA pass over the block table."""
        scfg = socket_config_of(cfg)
        if scfg.bits_storage != "packed":
            raise NotImplementedError(
                "the fused paged kernel streams packed hash words; "
                "bits_storage='int8' must use the unfused paged path")
        if view.block_size % 8:
            raise NotImplementedError(
                f"fused paged kernel needs block_size % 8 == 0, got "
                f"{view.block_size}")
        if budget is None:
            budget = torch.full((q.shape[0],),
                                sk.topk_budget(scfg, view.n_tokens),
                                dtype=torch.int32, device=q.device)
        from repro_torch.kernels.paged_attention import ops as pa_ops
        out = pa_ops.paged_hard_lsh_attend(
            q, view.arrays["k"], view.arrays["v"], view.arrays["bits"],
            view.arrays["vnorm"], _query_signs(params, q), view.block_table,
            length=length, budget=budget, num_tables=scfg.num_tables,
            num_planes=scfg.num_planes, scale=scale,
            sink_tokens=scfg.sink_tokens, window_tokens=scfg.window_tokens,
            k_scale=base.kv_scales_of(view.arrays, "k"),
            v_scale=base.kv_scales_of(view.arrays, "v"))
        return out.to(q.dtype)

    def attend(self, cfg, params, q, view, *, length, scale):
        scfg = socket_config_of(cfg)
        n = view.n_tokens
        budget = self._budget(cfg, length, n)
        if cfg.socket.use_paged_kernel and isinstance(view, base.PagedView) \
                and not bprobe.capturing():
            return self._attend_fused(cfg, params, q, view, length=length,
                                      scale=scale, budget=budget)
        scores = _hard_collision_scores(scfg, view.leaf("bits"),
                                        _query_signs(params, q))
        scores = torch.sum(scores, dim=2)                # sum over group
        kq = sk.topk_budget(scfg, n)
        vnorm = view.leaf("vnorm").float()
        idx, sel_mask = sk.value_aware_topk(
            scfg, scores, vnorm, k=kq, length=length, n_total=n,
            budget=budget)
        if bprobe.capturing():
            bprobe.emit(bprobe.selection_stats(
                scfg, q, base.dequant_leaf(cfg, view, "k"), vnorm,
                idx, sel_mask, length=length, budget=budget,
                static_k=kq, scale=scale))
        k_sel, v_sel = base.gather_kv_rows(cfg, view, idx)
        return base.subset_attention(cfg, q, k_sel, v_sel, sel_mask,
                                     scale=scale)
