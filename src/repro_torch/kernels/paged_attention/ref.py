"""Plain PyTorch version of the fused SOCKET paged-attention kernel.

Mirrors ``repro.kernels.paged_attention.ref.paged_socket_attend_ref``:
it materializes the logical per-request views that the kernel never
builds, then runs the unfused composition the kernel replaces —
factorized soft-collision scoring (:func:`socket_score_ref`) →
:func:`value_aware_topk` (sink/window forcing, ragged lengths, dynamic
budgets, lowest-index-first ties) → gather of the selected rows → masked
softmax attention (:func:`flash_decode_ref`).

It returns the attention output and the selected-token mask, so a test
can hold the kernel's *selection* to this one bit for bit and its output
to a float tolerance (the kernel folds rows in logical order, this
version in selection-rank order).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import socket as sk
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.socket_score.ref import socket_score_ref
from repro_torch.models.backends.base import gather_block_leaf

__all__ = ["paged_socket_attend_ref"]


def paged_socket_attend_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, bits_pages: torch.Tensor,
                            vnorm_pages: torch.Tensor, u: torch.Tensor,
                            block_table: torch.Tensor, *, length, budget,
                            num_tables: int, num_planes: int, tau: float,
                            scale: float, sink_tokens: int,
                            window_tokens: int, top_k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same shapes as :func:`ops.paged_socket_attend` plus ``top_k``, the
    static selection cap (any value >= max(budget)).

    Returns ``(out f32 (B, KVH, G, hd), selected bool (B, KVH, N))`` with
    ``N = nb * block_size``.
    """
    if q.ndim == 5:
        q = q[:, :, :, 0]
    b, kvh, g, hd = q.shape
    bits = gather_block_leaf(bits_pages, block_table)        # (B,KVH,N,W)
    vnorm = gather_block_leaf(vnorm_pages, block_table).float()
    kc = gather_block_leaf(k_pages, block_table)
    vc = gather_block_leaf(v_pages, block_table)
    n = bits.shape[2]

    gs = u.shape[2]
    scores = socket_score_ref(
        bits.reshape(b * kvh, n, -1), u.reshape(b * kvh, gs, *u.shape[3:]),
        None, num_tables=num_tables, num_planes=num_planes, tau=tau)
    scores = scores.reshape(b, kvh, n)

    cfg = sk.SocketConfig(num_planes=num_planes, num_tables=num_tables,
                          tau=tau, sink_tokens=sink_tokens,
                          window_tokens=window_tokens)
    dev = q.device
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=dev).expand(b)
    budget = torch.as_tensor(budget, dtype=torch.int32,
                             device=dev).expand(b)
    idx, mask = sk.value_aware_topk(cfg, scores, vnorm, k=top_k,
                                    length=length, n_total=n, budget=budget)

    rows = idx[..., None].expand(*idx.shape, hd)
    k_sel = torch.gather(kc, 2, rows)
    v_sel = torch.gather(vc, 2, rows)
    out = flash_decode_ref(q.reshape(b * kvh, g, hd),
                           k_sel.reshape(b * kvh, top_k, hd),
                           v_sel.reshape(b * kvh, top_k, hd),
                           mask.reshape(b * kvh, top_k), scale=scale)
    selected = torch.zeros((b, kvh, n), dtype=torch.bool, device=dev)
    selected.scatter_(2, idx, mask)
    return out.reshape(b, kvh, g, hd), selected
