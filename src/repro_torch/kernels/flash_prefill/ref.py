"""Plain PyTorch version of the causal flash-attention prefill kernel.

Mirrors ``repro.kernels.flash_prefill.ref``: a dense masked softmax, with
a key kept by query ``i`` when ``j <= i`` and, if ``window > 0``,
``i - j < window``; masked logits are the finite ``-1e30`` of the TPU
kernel.  Three additions, each the TPU kernel's function where that is
defined: ``softcap > 0`` caps the scaled scores first, ``softcap *
tanh(s / softcap)`` (the model's ``attn_logit_softcap``), K/V may have
fewer rows than q (GQA, ``G = BH / BKV``, row ``bh`` reads K/V row
``bh // G``), and ``q_chunk > 0`` walks the queries in chunks of that
many rows, each against only the keys some query of the chunk can keep,
so the live logits are ``(BH, q_chunk, keys)`` instead of ``(BH, S, S)``
(17 GB at llama31-8b's prefill of 8192 tokens).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      q_chunk: int = 0) -> torch.Tensor:
    """q (BH, S, hd); k/v (BKV, S, hd) -> f32 (BH, S, hd), causal;
    ``window > 0`` = sliding window; ``softcap > 0`` caps the scores.
    Computes in f32 (f64 for f64 inputs, an error yardstick)."""
    bh, s, hd = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(ct).reshape(bkv, g, s, hd)
    kf, vf = k.to(ct), v.to(ct)
    step = q_chunk if 0 < q_chunk < s else max(s, 1)
    out = []
    for i0 in range(0, s, step):
        i1 = min(i0 + step, s)
        lo = max(0, i0 - window + 1) if window > 0 else 0
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        ki = torch.arange(lo, i1, device=q.device)[None, :]
        mask = ki <= qi
        if window > 0:
            mask &= (qi - ki) < window
        qc = qg[:, :, i0:i1].reshape(bkv, g * (i1 - i0), hd)
        logits = (qc @ kf[:, lo:i1].transpose(1, 2)).reshape(
            bkv, g, i1 - i0, i1 - lo) * scale
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out.append((w.reshape(bkv, g * (i1 - i0), i1 - lo) @ vf[:, lo:i1])
                   .reshape(bkv, g, i1 - i0, hd))
    if not out:
        return torch.zeros((bh, s, hd), dtype=ct, device=q.device)
    return torch.cat(out, dim=2).reshape(bh, s, hd)
