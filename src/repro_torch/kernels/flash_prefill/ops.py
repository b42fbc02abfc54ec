"""Public wrapper of the causal flash-attention prefill kernel.

On CPU tensors it runs the plain version (:mod:`.ref`, query-chunked by
``q_chunk``); on CUDA tensors it launches the CUDA kernel
(``flash_prefill.cu``, built on first use by
:mod:`repro_torch.kernels.build`) or raises.  ``LAUNCHES`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

__all__ = ["flash_prefill", "launch_flash_prefill", "LAUNCHES", "SOURCE",
           "HEAD_DIMS"]

SOURCE = Path(__file__).with_name("flash_prefill.cu")
LAUNCHES = 0
# the head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64                    # the smallest query tile of any head dim


def _library() -> ctypes.CDLL:
    lib = build.load_library(SOURCE)
    fn = lib.flash_prefill_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_prefill_error_string.argtypes = [ctypes.c_int]
    lib.flash_prefill_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel: q (BH, S, hd); k/v (BKV, S, hd), one dtype
    (f32 or bf16), BH a multiple of BKV -> f32 (BH, S, hd)."""
    global LAUNCHES
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (BH, S, hd) and two "
                         "equal (BKV, S, hd)")
    bh, s, hd = q.shape
    bkv = k.shape[0]
    if k.shape[1:] != (s, hd) or bkv == 0 or bh % bkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same S and hd, BH a multiple "
                         "of BKV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of {tuple(_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k and v must be on one CUDA device")
    if -(-s // BLOCK_Q) > 65535 or bh > 2 ** 31 - 1:
        raise ValueError(f"S={s}, BH={bh} exceed the kernel's grid")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((bh, s, hd), dtype=torch.float32, device=q.device)
    if s == 0 or bh == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], bh, bkv, s, hd, float(scale), int(window),
            float(softcap), stream)
    if err != 0:
        raise RuntimeError("flash_prefill kernel launch failed: " +
                           lib.flash_prefill_error_string(err).decode())
    LAUNCHES += 1
    return out


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, window: int = 0, softcap: float = 0.0,
                  q_chunk: int = 0) -> torch.Tensor:
    """Causal attention over a whole prompt.  q (BH, S, hd); k/v (BKV, S,
    hd) -> f32 (BH, S, hd); ``window > 0`` keeps only the last ``window``
    keys of each query; ``softcap > 0`` caps the scaled scores at
    ``softcap * tanh(s / softcap)``.  ``q_chunk`` bounds the plain
    version's logits (CPU tensors); the kernel ignores it."""
    if q.is_cuda:
        return launch_flash_prefill(q, k, v, scale=scale, window=window,
                                    softcap=softcap)
    return flash_prefill_ref(q, k, v, scale=scale, window=window,
                             softcap=softcap, q_chunk=q_chunk)
