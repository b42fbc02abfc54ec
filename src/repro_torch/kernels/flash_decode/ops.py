"""Public wrapper of the flash-decode kernel, accepting the model's
``(B, KVH, ...)`` layout or the flat ``(BH, ...)`` one.

On CPU tensors it runs the plain version (:mod:`.ref`); on CUDA tensors
it launches the CUDA kernel ``flash_decode.cu`` (built on first use by
:mod:`repro_torch.kernels.build`; one launch a call, counted in
``LAUNCHES``) or raises.  :func:`flash_decode_plan` reports the shape a
launch takes (C, clusters at once, shared memory, stages).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "launch_flash_decode", "flash_decode_plan",
           "LAUNCHES", "SOURCE", "MAX_HEAD_DIM", "MAX_HEADS"]

SOURCE = Path(__file__).with_name("flash_decode.cu")
LAUNCHES = 0
MAX_HEAD_DIM = 256        # a row in at most 32 lanes of 32 B (kMaxLanes)
MAX_HEADS = 32            # query heads a (batch, KV head) row (kMaxHeads)
# the kernel's element type codes (DType in flash_decode.cu)
_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_launch.argtypes = [p, i, p, p, p, p] + [i] * 5 + \
            [ctypes.c_float, p]
        lib.flash_decode_launch.restype = i
        lib.flash_decode_plan.argtypes = [i] * 5 + [p]
        lib.flash_decode_plan.restype = i
        lib.flash_decode_error_string.argtypes = [i]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_decode_plan(q: torch.Tensor, k: torch.Tensor) -> dict:
    """How ``flash_decode.cu`` launches on q (BH, G, hd) and k (BH, K, hd)
    (CUDA only): ``cluster``, the C ranks a row is split over (the largest
    C <= 8 whose BH clusters the card holds at once, else the fewest waves
    times K / C); ``clusters_at_once`` at that C; ``smem_bytes`` a CTA;
    ``stages``, the K/V stages of its ring, and ``stage_rows`` a stage;
    ``lanes_per_row``, the lanes that hold a row in the fold,
    ``heads_per_unit``, the query heads each of its units holds,
    ``units``, the units of a head group, and ``row_stride``, the bytes
    a staged row takes (hd's padded to 16: rows that 16-byte copies do
    not fit are copied a piece at a time)."""
    bh, g, hd = q.shape
    lib = _library()
    info = (ctypes.c_int * 9)()
    with torch.cuda.device(q.device):
        err = lib.flash_decode_plan(_TYPES[k.dtype], bh, k.shape[1], g, hd,
                                    info)
    if err != 0:
        raise RuntimeError("flash_decode plan failed: " +
                           lib.flash_decode_error_string(err).decode())
    return dict(zip(("cluster", "smem_bytes", "clusters_at_once", "stages",
                     "stage_rows", "lanes_per_row", "heads_per_unit",
                     "units", "row_stride"), info))


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on flat CUDA tensors: q (BH, G, hd);
    k/v (BH, K, hd) of one dtype; mask (BH, K) bool -> f32 (BH, G, hd)."""
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
        if t.dtype not in _TYPES:
            raise TypeError(f"{name} dtype {t.dtype} not in "
                            f"{tuple(_TYPES)}")
    if v.dtype != k.dtype:
        raise TypeError(f"k and v must share a dtype, got {k.dtype} and "
                        f"{v.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_decode takes head dim 1..{MAX_HEAD_DIM}, "
                         f"got {hd}")
    if not 1 <= g <= MAX_HEADS:
        raise ValueError(f"flash_decode takes 1..{MAX_HEADS} query heads a "
                         f"KV head, got {g}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("q, k, v and mask must be on one device")
    q, k, v, mask = q.contiguous(), k.contiguous(), v.contiguous(), \
        mask.contiguous()
    out = torch.empty((bh, g, hd), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out
    lib = _library()
    dev = q.device
    with torch.cuda.device(dev):
        err = lib.flash_decode_launch(
            q.data_ptr(), _TYPES[q.dtype], k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(), _TYPES[k.dtype], bh, kk, g, hd,
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: " +
                           lib.flash_decode_error_string(err).decode())
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
