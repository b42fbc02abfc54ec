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

:func:`flash_prefill_ref_backward` is the training backward of the
prefill op (``ops.flash_prefill`` under autograd): the plain version's
gradient, recomputed one query chunk at a time.  The JAX package has no
backward kernel to port: its ``attention_train`` is XLA einsums
differentiated by ``jax.grad``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _attend_chunk(qc: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  i0: int, lo: int, *, scale: float, window: int,
                  softcap: float) -> torch.Tensor:
    """Queries ``i0 ..`` of ``qc`` (BKV, G, cq, hd) against keys ``lo ..``
    of ``kc``/``vc`` (BKV, keys, hd), causal (and windowed) -> (BKV, G,
    cq, hd), in the inputs' dtype."""
    bkv, g, cq, hd = qc.shape
    nk = kc.shape[1]
    qi = torch.arange(i0, i0 + cq, device=qc.device)[:, None]
    ki = torch.arange(lo, lo + nk, device=qc.device)[None, :]
    mask = ki <= qi
    if window > 0:
        mask &= (qi - ki) < window
    logits = (qc.reshape(bkv, g * cq, hd) @ kc.transpose(1, 2)).reshape(
        bkv, g, cq, nk) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    return (w.reshape(bkv, g * cq, nk) @ vc).reshape(bkv, g, cq, hd)


def _chunks(s: int, q_chunk: int, window: int):
    """(i0, i1, lo): each query chunk and the first key any of its
    queries keeps."""
    step = q_chunk if 0 < q_chunk < s else max(s, 1)
    for i0 in range(0, s, step):
        yield (i0, min(i0 + step, s),
               max(0, i0 - window + 1) if window > 0 else 0)


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
    out = [_attend_chunk(qg[:, :, i0:i1], kf[:, lo:i1], vf[:, lo:i1], i0, lo,
                         scale=scale, window=window, softcap=softcap)
           for i0, i1, lo in _chunks(s, q_chunk, window)]
    if not out:
        return torch.zeros((bh, s, hd), dtype=ct, device=q.device)
    return torch.cat(out, dim=2).reshape(bh, s, hd)


def flash_prefill_ref_backward(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, dout: torch.Tensor, *,
                               scale: float, window: int = 0,
                               softcap: float = 0.0, q_chunk: int = 1024):
    """The gradient of :func:`flash_prefill_ref` with respect to q, k and
    v for the output gradient ``dout`` (BH, S, hd), in the inputs' dtypes.

    The forward is recomputed one query chunk at a time and
    differentiated by autograd, so no more than ``(BH, q_chunk, keys)``
    logits are live: the backward never holds all ``(S, S)`` of them.
    The chunks' key gradients are summed in f32 and cast once, as the
    JAX package's ``jax.grad`` of its f32 attention casts them once."""
    bh, s, hd = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.detach().to(ct).reshape(bkv, g, s, hd)
    kf, vf = k.detach().to(ct), v.detach().to(ct)
    dog = dout.to(ct).reshape(bkv, g, s, hd)
    dq = torch.empty_like(qg)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0, i1, lo in _chunks(s, q_chunk, window):
        with torch.enable_grad():
            qc = qg[:, :, i0:i1].detach().requires_grad_()
            kc = kf[:, lo:i1].detach().requires_grad_()
            vc = vf[:, lo:i1].detach().requires_grad_()
            oc = _attend_chunk(qc, kc, vc, i0, lo, scale=scale,
                               window=window, softcap=softcap)
            gq, gk, gv = torch.autograd.grad(oc, (qc, kc, vc),
                                             dog[:, :, i0:i1])
        dq[:, :, i0:i1] = gq
        dk[:, lo:i1] += gk
        dv[:, lo:i1] += gv
    return (dq.reshape(bh, s, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
