"""Plain PyTorch version of the SOCKET scoring kernel.

Computes exactly what ``socket_score.cu`` (and the TPU kernel it
replaces) computes, shape for shape:

    scores[bh, n] = vnorm[bh, n] * sum_g sum_l exp( (S . u)/tau - logZ )

Inputs:
  bits  : int32 (BH, N, W) packed sign words (hashing.pack_signs),
          or int8 (BH, N, L*P) ±1 plane bytes
  u     : f32   (BH, G, L, P) query soft-hash (socket.soft_hash_query)
  vnorm : f32   (BH, N) value norms, or None for unweighted scores
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashing, socket


def socket_score_ref(bits: torch.Tensor, u: torch.Tensor,
                     vnorm: Optional[torch.Tensor], *, num_tables: int,
                     num_planes: int, tau: float) -> torch.Tensor:
    """Returns f32 (BH, N) group-summed, value-weighted scores."""
    if bits.dtype == torch.int8:
        signs = bits.float().reshape(*bits.shape[:-1], num_tables,
                                     num_planes)
    else:
        signs = hashing.unpack_signs(bits, num_tables, num_planes)
    logits = torch.einsum("bnlp,bglp->bgnl", signs, u.float()) / tau
    logz = socket.log_normalizer(u.float(), tau)                 # (BH,G,L)
    z = torch.exp(logits - logz[:, :, None, :])                  # (BH,G,N,L)
    # tables first, then the group (the TPU kernel's order): each key's
    # sum then runs the same code path, so keys with equal bits tie exactly
    scores = z.sum(dim=3).sum(dim=1)                             # (BH,N)
    if vnorm is not None:
        scores = scores * vnorm.float()
    return scores
