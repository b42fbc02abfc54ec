"""Triton kernel: flash decode over the SOCKET-selected KV subset.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode/flash_decode.py``
(``_decode_kernel``, launched by ``flash_decode_pallas``): one decode step
of GQA attention for the G query heads of one KV head against the K
gathered rows (the top-k ∪ sink ∪ window selection), with a validity
mask, an online softmax in fp32 ``m, l, acc``, and output
``acc / max(l, 1e-30)`` (a fully masked row gives 0).  It is the paper's
"Flash Decode Triton backend".

What bounds it on this card: bytes.  Each selected row is read once as
K and once as V (at the main path, BH=16 rows of K=823 x hd=128 fp32:
13.5 MB, ~4 us at 3.35 TB/s) against 4·BH·G·K·hd = 27 MFLOP (~0.4 us).
With G=4 query rows per KV head there is no matrix-unit-sized product.

What the design does about it: split-K.  The TPU kernel walks K in
order on one core; here BH is only 16, so one program per (b, kvh) would
leave most of the 132 SMs idle.  Programs are (bh, split): each split
streams ``blocks_per_split`` blocks of ``BLOCK_K`` rows, keeps its own
fp32 (m, l, acc) and writes them to a small scratch; a second kernel
combines the splits per bh with the usual max-rescale.  The query block
is padded to 16 rows (``tl.dot``'s least M) and head_dim to a power of
two with a mask, so stablelm's head_dim 160 runs too.  Dots run in
full fp32 (``input_precision="ieee"``), matching the reference.

``triton`` is imported by :func:`compile_kernels`, at the first launch,
never when this module is imported: the kernel functions below are plain
Python until then, and their ``tl`` global is bound on that first call.
Triton caches the compiled kernels under ``build/repro_torch/triton``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from repro_torch.kernels.build import BUILD_DIR

tl = None   # triton.language, bound by compile_kernels()

_COMPILED: Optional[Tuple[object, object]] = None


def _split_kernel(q_ptr, k_ptr, v_ptr, mask_ptr, m_ptr, l_ptr, acc_ptr,
                  K, scale, blocks_per_split, num_splits,
                  stride_qb, stride_qg, stride_kb, stride_kk,
                  stride_vb, stride_vk, stride_mb,
                  G: "tl.constexpr", HD: "tl.constexpr",
                  G_PAD: "tl.constexpr", HD_PAD: "tl.constexpr",
                  BLOCK_K: "tl.constexpr"):
    bh = tl.program_id(0)
    sp = tl.program_id(1)
    offs_g = tl.arange(0, G_PAD)
    offs_d = tl.arange(0, HD_PAD)
    gmask = offs_g < G
    dmask = offs_d < HD
    q = tl.load(q_ptr + bh * stride_qb + offs_g[:, None] * stride_qg +
                offs_d[None, :], mask=gmask[:, None] & dmask[None, :],
                other=0.0).to(tl.float32)
    m_i = tl.full([G_PAD], -1e30, tl.float32)
    l_i = tl.zeros([G_PAD], tl.float32)
    acc = tl.zeros([G_PAD, HD_PAD], tl.float32)
    k0 = sp * blocks_per_split * BLOCK_K
    for i in range(0, blocks_per_split):
        offs_k = k0 + i * BLOCK_K + tl.arange(0, BLOCK_K)
        kin = offs_k < K
        valid = tl.load(mask_ptr + bh * stride_mb + offs_k, mask=kin,
                        other=0) != 0
        tile = kin[:, None] & dmask[None, :]
        kt = tl.load(k_ptr + bh * stride_kb + offs_k[:, None] * stride_kk +
                     offs_d[None, :], mask=tile, other=0.0).to(tl.float32)
        s = tl.dot(q, tl.trans(kt), input_precision="ieee") * scale
        s = tl.where(valid[None, :], s, -1e30)            # (G_PAD, BLOCK_K)
        m_new = tl.maximum(m_i, tl.max(s, axis=1))
        alpha = tl.exp(m_i - m_new)
        p = tl.exp(s - m_new[:, None])
        p = tl.where(valid[None, :], p, 0.0)
        l_i = l_i * alpha + tl.sum(p, axis=1)
        vt = tl.load(v_ptr + bh * stride_vb + offs_k[:, None] * stride_vk +
                     offs_d[None, :], mask=tile, other=0.0).to(tl.float32)
        acc = acc * alpha[:, None] + tl.dot(p, vt, input_precision="ieee")
        m_i = m_new
    row = (bh * num_splits + sp) * G + offs_g
    tl.store(m_ptr + row, m_i, mask=gmask)
    tl.store(l_ptr + row, l_i, mask=gmask)
    tl.store(acc_ptr + row[:, None] * HD + offs_d[None, :], acc,
             mask=gmask[:, None] & dmask[None, :])


def _combine_kernel(m_ptr, l_ptr, acc_ptr, out_ptr, num_splits,
                    G: "tl.constexpr", HD: "tl.constexpr",
                    G_PAD: "tl.constexpr", HD_PAD: "tl.constexpr"):
    bh = tl.program_id(0)
    offs_g = tl.arange(0, G_PAD)
    offs_d = tl.arange(0, HD_PAD)
    gmask = offs_g < G
    omask = gmask[:, None] & (offs_d[None, :] < HD)
    m_tot = tl.full([G_PAD], -1e30, tl.float32)
    for s in range(0, num_splits):
        m_s = tl.load(m_ptr + (bh * num_splits + s) * G + offs_g,
                      mask=gmask, other=-1e30)
        m_tot = tl.maximum(m_tot, m_s)
    l_tot = tl.zeros([G_PAD], tl.float32)
    acc = tl.zeros([G_PAD, HD_PAD], tl.float32)
    for s in range(0, num_splits):
        row = (bh * num_splits + s) * G + offs_g
        w = tl.exp(tl.load(m_ptr + row, mask=gmask, other=-1e30) - m_tot)
        l_tot += w * tl.load(l_ptr + row, mask=gmask, other=0.0)
        acc += w[:, None] * tl.load(acc_ptr + row[:, None] * HD +
                                    offs_d[None, :], mask=omask, other=0.0)
    out = acc / tl.maximum(l_tot, 1e-30)[:, None]
    tl.store(out_ptr + bh * G * HD + offs_g[:, None] * HD + offs_d[None, :],
             out, mask=omask)


def compile_kernels():
    """Import triton and wrap the kernels with ``triton.jit`` (once).
    Triton's compile cache goes to the checkout's build directory unless
    ``TRITON_CACHE_DIR`` is set."""
    global tl, _COMPILED
    if _COMPILED is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        import triton
        import triton.language
        tl = triton.language
        _COMPILED = (triton.jit(_split_kernel), triton.jit(_combine_kernel))
    return _COMPILED
