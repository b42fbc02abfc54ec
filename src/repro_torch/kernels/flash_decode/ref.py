"""Plain PyTorch version of the flash-decode kernel: masked softmax
attention of G query heads against K gathered key/value rows (one KV head).

It follows the *kernel* (``flash_decode.cu`` here, and the TPU kernel it
replaces), not ``repro.kernels.flash_decode.ref``: masked rows get zero
weight and the output is ``acc / max(l, 1e-30)``, so a row whose mask is
all false returns 0 (a plain softmax would return the mean of V).  With
``partials`` it also returns the kernel's softmax partials: the row max
``m`` of the scaled logits (-1e30 where no row is kept) and the
normalizer ``l`` (0 there).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, *, scale: float,
                     partials: bool = False):
    """q (BH, G, hd); k/v (BH, K, hd); mask (BH, K) bool -> f32 (BH, G, hd),
    or with ``partials`` (that, m (BH, G), l (BH, G)) f32."""
    logits = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) * scale
    valid = mask[:, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bgk,bkd->bgd", p, v.float())
    l = p.sum(-1, keepdim=True)
    out = acc / torch.clamp(l, min=1e-30)
    if partials:
        return out, m[..., 0], l[..., 0]
    return out
