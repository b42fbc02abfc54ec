"""Public wrapper of the flash-decode kernel, accepting the model's
``(B, KVH, ...)`` layout or the flat ``(BH, ...)`` one.

On CPU tensors it runs the plain version (:mod:`.ref`); on CUDA tensors
it launches the Triton kernel pair of :mod:`.flash_decode` (split-K +
combine, counted as one launch in ``LAUNCHES``) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode import flash_decode as fd_kernel
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "launch_flash_decode", "split_plan", "LAUNCHES",
           "BLOCK_K"]

LAUNCHES = 0
BLOCK_K = 32
# split-K aims for this many programs: two waves of the H100's 132 SMs
TARGET_PROGRAMS = 264
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def split_plan(bh: int, k: int, block_k: int = BLOCK_K):
    """(num_splits, blocks_per_split) for ``bh`` rows of ``k`` keys."""
    n_blocks = max(1, -(-k // block_k))
    splits = min(n_blocks, max(1, -(-TARGET_PROGRAMS // max(bh, 1))))
    per = -(-n_blocks // splits)
    return -(-n_blocks // per), per


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Launch the Triton kernels on flat CUDA tensors: q (BH, G, hd);
    k/v (BH, K, hd); mask (BH, K) bool -> f32 (BH, G, hd)."""
    global LAUNCHES
    bh, g, hd = q.shape
    kk = k.shape[1]
    if k.shape != (bh, kk, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if mask.shape != (bh, kk) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {(bh, kk)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _FLOATS:
            raise TypeError(f"{name} dtype {t.dtype} not in {_FLOATS}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("q, k, v and mask must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask_u8 = mask.contiguous().view(torch.uint8)
    out = torch.empty((bh, g, hd), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out
    splits, per = split_plan(bh, kk)
    m_part = torch.empty((bh, splits, g), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((bh, splits, g, hd), dtype=torch.float32,
                           device=q.device)
    split_kernel, combine_kernel = fd_kernel.compile_kernels()
    g_pad, hd_pad = max(16, _pow2(g)), max(16, _pow2(hd))
    with torch.cuda.device(q.device):
        split_kernel[(bh, splits)](
            q, k, v, mask_u8, m_part, l_part, acc_part,
            kk, float(scale), per, splits,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), mask_u8.stride(0),
            G=g, HD=hd, G_PAD=g_pad, HD_PAD=hd_pad, BLOCK_K=BLOCK_K,
            num_warps=4)
        combine_kernel[(bh,)](
            m_part, l_part, acc_part, out, splits,
            G=g, HD=hd, G_PAD=g_pad, HD_PAD=hd_pad, num_warps=4)
    LAUNCHES += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Sparse decode attention.

    q (B, KVH, G, 1, hd) or (BH, G, hd); k/v (B, KVH, K, hd) or
    (BH, K, hd); mask (B, KVH, K) / (BH, K).  Returns the output in q's
    layout: (B, KVH, G, 1, hd) in q's dtype, or f32 (BH, G, hd).
    """
    orig5 = q.ndim == 5
    if orig5:
        b, kvh, g, t, hd = q.shape
        if t != 1:
            raise ValueError(f"flash_decode takes one query step, got T={t}")
        q2 = q.reshape(b * kvh, g, hd)
        k2 = k.reshape(b * kvh, *k.shape[2:])
        v2 = v.reshape(b * kvh, *v.shape[2:])
        m2 = mask.reshape(b * kvh, mask.shape[-1])
    else:
        q2, k2, v2, m2 = q, k, v, mask
    if q2.is_cuda:
        out = launch_flash_decode(q2, k2, v2, m2, scale=scale)
    else:
        out = flash_decode_ref(q2, k2, v2, m2, scale=scale)
    if orig5:
        out = out.reshape(b, kvh, g, 1, hd).to(q.dtype)
    return out
