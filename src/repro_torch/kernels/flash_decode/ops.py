"""Public wrapper of the flash-decode kernel, accepting the model's
``(B, KVH, ...)`` layout or the flat ``(BH, ...)`` one.

On CPU tensors it runs the plain version (:mod:`.ref`); on plain CUDA
tensors it launches the CUDA kernel ``flash_decode.cu`` (built on first
use by :mod:`repro_torch.kernels.build`; one launch a call, counted in
``LAUNCHES``) or raises; on any other device, or under a dispatch mode
(:func:`~repro_torch.kernels.build.dispatch_free`), it calls the
operator ``repro_torch::flash_decode``, whose CUDA implementation is the
same launch and whose fake implementation (``meta`` and fake tensors:
the dry run) only checks shapes; its FLOP
formula (:func:`flash_decode_flops`) counts the bound's operations with
every row of the mask kept.  :func:`flash_decode_plan` reports the shape a
launch takes (C, clusters at once, shared memory, stages).

``partials=True`` also returns the kernel's softmax partials, each query
head's row max ``m`` and normalizer ``l`` (f32; a head with no kept row
gives m -1e30 and l 0), written by the same launch's epilogue into an
``(BH, G, 2)`` tensor: what a context-parallel rank merges with the
other ranks' (``distributed/context_parallel.py::merge_partials``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "launch_flash_decode", "flash_decode_plan",
           "flash_decode_flops",
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
        lib.flash_decode_launch.argtypes = [p, i, p, p, p, p, p] + \
            [i] * 5 + [ctypes.c_float, p]
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


def _ctypes_launch(q, k, v, mask, out, scale, ml=None) -> None:
    """One launch of the kernel into ``out`` (and ``ml`` where given: the
    C call)."""
    bh, g, hd = q.shape
    lib = _library()
    dev = q.device
    with torch.cuda.device(dev):
        err = lib.flash_decode_launch(
            q.data_ptr(), _TYPES[q.dtype], k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), out.data_ptr(),
            None if ml is None else ml.data_ptr(), _TYPES[k.dtype], bh,
            k.shape[1], g, hd, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: " +
                           lib.flash_decode_error_string(err).decode())


def _cuda_op(q, k, v, mask, out, scale, ml=None) -> None:
    """``repro_torch::flash_decode`` on CUDA tensors: build (on first
    use), launch, count the launch."""
    global LAUNCHES
    _ctypes_launch(q, k, v, mask, out, scale, ml)
    LAUNCHES += 1


def _fake_op(q, k, v, mask, out, scale, ml=None) -> None:
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")


def flash_decode_flops(bh: int, k: int, g: int, hd: int) -> int:
    """The bound's operations with all ``k`` rows kept: q.k, p.v and the
    softmax's four a (row, head)."""
    return bh * k * g * (4 * hd + 4)


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_decode(Tensor q, Tensor k, Tensor v, Tensor mask, "
            "Tensor(a!) out, float scale, Tensor(b!)? ml=None) -> ()")
_OPS.impl("flash_decode", _cuda_op, "CUDA")
torch.library.register_fake("repro_torch::flash_decode", _fake_op, lib=_OPS)

# the wrapper's call under a fake run or a counting mode (``_cuda_op`` on
# plain CUDA tensors: ``build.dispatch_free``)
_OP = torch.ops.repro_torch.flash_decode


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _flop_formula(q, k, *args, out_shape=None, **kw) -> int:
    return flash_decode_flops(q[0], k[1], q[1], q[2])


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, *, scale: float,
                        partials: bool = False):
    """Launch the CUDA kernel through the operator on flat CUDA tensors:
    q (BH, G, hd); k/v (BH, K, hd) of one dtype; mask (BH, K) bool -> f32
    (BH, G, hd), or with ``partials`` (that, ml f32 (BH, G, 2): each
    head's (m, l))."""
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
    ml = torch.empty((bh, g, 2), dtype=torch.float32, device=q.device) \
        if partials else None
    if bh:
        (_cuda_op if build.dispatch_free(q) else _OP)(q, k, v, mask, out,
                                                      float(scale), ml)
    return (out, ml) if partials else out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, *, scale: float,
                 partials: bool = False):
    """Sparse decode attention.

    q (B, KVH, G, 1, hd) or (BH, G, hd); k/v (B, KVH, K, hd) or
    (BH, K, hd); mask (B, KVH, K) / (BH, K).  Returns the output in q's
    layout: (B, KVH, G, 1, hd) in q's dtype, or f32 (BH, G, hd).  With
    ``partials``: (the output in f32, m, l), m and l f32 (B, KVH, G, 1, 1)
    or (BH, G), the softmax partials of the module docstring.
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
    if q2.device.type != "cpu":
        got = launch_flash_decode(q2, k2, v2, m2, scale=scale,
                                  partials=partials)
        if partials:
            got = (got[0], got[1][..., 0], got[1][..., 1])
    else:
        got = flash_decode_ref(q2, k2, v2, m2, scale=scale,
                               partials=partials)
    if not partials:
        return got.reshape(b, kvh, g, 1, hd).to(q.dtype) if orig5 else got
    out, m, l = got
    if orig5:
        out = out.reshape(b, kvh, g, 1, hd)
        m, l = m.reshape(b, kvh, g, 1, 1), l.reshape(b, kvh, g, 1, 1)
    return out, m, l
