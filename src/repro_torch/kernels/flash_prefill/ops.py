"""Public wrapper of the causal flash-attention prefill kernel.

On CPU tensors it runs the plain version (:mod:`.ref`, query-chunked by
``q_chunk``); on plain CUDA tensors it launches the CUDA kernel
(``flash_prefill.cu``, built on first use by
:mod:`repro_torch.kernels.build`) or raises; on any other device, or
under a dispatch mode (:func:`~repro_torch.kernels.build.dispatch_free`),
it calls the operator ``repro_torch::flash_prefill``, whose CUDA
implementation is the same launch and whose fake implementation
(``meta`` and fake tensors: the dry run) only checks shapes; its FLOP
formula (:func:`flash_prefill_flops`) counts the bound's operations, 4 x
hd a kept (query, key) pair.  ``LAUNCHES`` counts kernel launches, so a
run can show that it went through the kernel.

Under autograd (an input that requires grad, grad mode on) the op is the
:class:`FlashPrefill` function: its forward is the same kernel (or plain
version), and its backward the plain version's gradient, recomputed one
query chunk at a time (:func:`.ref.flash_prefill_ref_backward`; a
hand-written backward kernel is ROADMAP.md queue 2 work).  The CUDA
launch goes through ``ctypes``, so without the function autograd would
see a tensor with no history, and every projection before the kernel
would get no gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_ref,
                                                   flash_prefill_ref_backward)

__all__ = ["flash_prefill", "launch_flash_prefill", "FlashPrefill",
           "flash_prefill_flops",
           "LAUNCHES", "SOURCE", "HEAD_DIMS", "BACKWARD_Q_CHUNK"]

SOURCE = Path(__file__).with_name("flash_prefill.cu")
LAUNCHES = 0
# the head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64                    # the smallest query tile of any head dim
# the backward's query chunk where the caller's q_chunk is 0: (BH, 1024,
# S) f32 logits, 0.5 GB at llama31-8b's 32 heads and 4096 tokens
BACKWARD_Q_CHUNK = 1024


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
    """``t`` contiguous and, on the card, 16-byte aligned (the kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.device.type != "cuda" or t.data_ptr() % 16 == 0 \
        else t.clone()


def _ctypes_launch(q, k, v, out, scale, window, softcap) -> None:
    """One launch of the kernel into ``out`` (the C call)."""
    bh, s, hd = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], bh, k.shape[0], s, hd, float(scale),
            int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError("flash_prefill kernel launch failed: " +
                           lib.flash_prefill_error_string(err).decode())


def _cuda_op(q, k, v, out, scale, window, softcap) -> None:
    """``repro_torch::flash_prefill`` on CUDA tensors: build (on first
    use), launch, count the launch."""
    global LAUNCHES
    _ctypes_launch(q, k, v, out, scale, window, softcap)
    LAUNCHES += 1


def _fake_op(q, k, v, out, scale, window, softcap) -> None:
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")


def flash_prefill_flops(bh: int, s: int, hd: int, window: int = 0) -> int:
    """The bound's operations: 4 x hd (q.k and p.v) for each kept (query,
    key) pair of the causal (or windowed) function."""
    if not window or window >= s:
        keys = s * (s + 1) // 2
    else:
        keys = window * (window + 1) // 2 + (s - window) * window
    return 4 * hd * bh * keys


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_prefill(Tensor q, Tensor k, Tensor v, Tensor(a!) out, "
            "float scale, int window, float softcap) -> ()")
_OPS.impl("flash_prefill", _cuda_op, "CUDA")
torch.library.register_fake("repro_torch::flash_prefill", _fake_op,
                            lib=_OPS)

# the wrapper's call under a fake run or a counting mode (``_cuda_op`` on
# plain CUDA tensors: ``build.dispatch_free``)
_OP = torch.ops.repro_torch.flash_prefill


@register_flop_formula(torch.ops.repro_torch.flash_prefill)
def _flop_formula(q, k, v, out, scale, window, *args, out_shape=None,
                  **kw) -> int:
    return flash_prefill_flops(q[0], q[1], q[2], window)


def launch_flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel through the operator: q (BH, S, hd); k/v
    (BKV, S, hd), one dtype (f32 or bf16), BH a multiple of BKV -> f32
    (BH, S, hd)."""
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
    if not (q.device == k.device == v.device) or q.device.type == "cpu":
        raise ValueError("q, k and v must be on one CUDA device")
    if -(-s // BLOCK_Q) > 65535 or bh > 2 ** 31 - 1:
        raise ValueError(f"S={s}, BH={bh} exceed the kernel's grid")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((bh, s, hd), dtype=torch.float32, device=q.device)
    if s == 0 or bh == 0:
        return out
    (_cuda_op if build.dispatch_free(q) else _OP)(
        q, k, v, out, float(scale), int(window), float(softcap))
    return out


def _forward(q, k, v, scale, window, softcap, q_chunk):
    if q.device.type != "cpu":
        return launch_flash_prefill(q, k, v, scale=scale, window=window,
                                    softcap=softcap)
    return flash_prefill_ref(q, k, v, scale=scale, window=window,
                             softcap=softcap, q_chunk=q_chunk)


class FlashPrefill(torch.autograd.Function):
    """The prefill op with a gradient: forward as :func:`flash_prefill`,
    backward the plain version's gradient in query chunks of ``q_chunk``
    (``BACKWARD_Q_CHUNK`` where it is 0), the grads of q/k/v in their
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, softcap, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, window=window, softcap=softcap,
                        q_chunk=q_chunk or BACKWARD_Q_CHUNK)
        return _forward(q, k, v, scale, window, softcap, q_chunk)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return flash_prefill_ref_backward(q, k, v, dout, **ctx.args) + \
            (None,) * 4


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, window: int = 0, softcap: float = 0.0,
                  q_chunk: int = 0) -> torch.Tensor:
    """Causal attention over a whole prompt.  q (BH, S, hd); k/v (BKV, S,
    hd) -> f32 (BH, S, hd); ``window > 0`` keeps only the last ``window``
    keys of each query; ``softcap > 0`` caps the scaled scores at
    ``softcap * tanh(s / softcap)``.  ``q_chunk`` bounds the plain
    version's logits (CPU tensors) and the backward's; the kernel
    ignores it.  Differentiable through :class:`FlashPrefill` where an
    input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashPrefill.apply(q, k, v, scale, window, softcap, q_chunk)
    return _forward(q, k, v, scale, window, softcap, q_chunk)
