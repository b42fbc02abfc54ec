"""Plain PyTorch version of the flash-decode kernel: masked softmax
attention of G query heads against K gathered key/value rows (one KV head).

It follows the *kernel* (``flash_decode.cu`` here, and the TPU kernel it
replaces), not ``repro.kernels.flash_decode.ref``: masked rows get zero
weight and the output is ``acc / max(l, 1e-30)``, so a row whose mask is
all false returns 0 (a plain softmax would return the mean of V).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q (BH, G, hd); k/v (BH, K, hd); mask (BH, K) bool -> f32 (BH, G, hd)."""
    logits = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) * scale
    valid = mask[:, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bgk,bkd->bgd", p, v.float())
    return acc / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
