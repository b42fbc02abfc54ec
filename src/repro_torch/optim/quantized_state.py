"""Blockwise-quantized optimizer moments (8-bit Adam states).

Port of ``repro.optim.quantized_state``.  Blocks of ``BLOCK`` values run
along the last axis only, so ``q`` keeps the parameter's rank and
leading shape; each block stores int8 codes and one float32 scale (its
largest magnitude over 127).  The second moment spans many orders of
magnitude inside a block, so values are companded first: ``m`` through
a cube root (``power=3``), ``v`` through a sixth root (``power=6``).

The arithmetic is the JAX package's, in float32, step for step.  The
companding root is the library's float32 ``pow``: XLA's on the CPU is
the C library's ``powf``, torch's is its own vectorised one, and the two
round about 2 % of roots an ulp apart (``tests/test_torch_optim.py``
measures it), which moves a code by one where the quotient lies on a
rounding edge.  Expanding the codes back raises to the integer power
with JAX's ``integer_pow`` products, ``x * (x * x)`` and ``(x * x) *
((x * x) * (x * x))``, so that half is bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# Block size 16: the JAX package's, chosen to divide every sharded
# last-dim chunk of its meshes; one f32 scale per 16 int8 values.
BLOCK = 16

__all__ = ["quantize", "dequantize", "qzeros_like", "BLOCK", "padded_dim"]


def padded_dim(d: int) -> int:
    blk = min(BLOCK, max(d, 1))
    nb = (d + blk - 1) // blk
    return nb * blk


def _blocks(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Pad the last dim to a BLOCK multiple; return (x_padded, nb, blk)."""
    if x.ndim == 0:
        x = x[None]
    d = x.shape[-1]
    blk = min(BLOCK, max(d, 1))
    nb = (d + blk - 1) // blk
    pad = nb * blk - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, nb, blk


def qzeros_like(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    shape = tuple(x.shape) if x.ndim else (1,)
    d = shape[-1]
    blk = min(BLOCK, max(d, 1))
    nb = (d + blk - 1) // blk
    return {"q": torch.zeros(shape[:-1] + (nb * blk,), dtype=torch.int8,
                             device=x.device),
            "scale": torch.zeros(shape[:-1] + (nb,), dtype=torch.float32,
                                 device=x.device)}


def _integer_pow(x: torch.Tensor, power: int) -> torch.Tensor:
    """``x ** power`` as JAX's ``lax.integer_pow`` multiplies it out
    (square and multiply, low bit first)."""
    acc = None
    while power > 0:
        if power & 1:
            acc = x if acc is None else acc * x
        power >>= 1
        if power:
            x = x * x
    return acc


def quantize(x: torch.Tensor, power: int = 1) -> Dict[str, torch.Tensor]:
    xp, nb, blk = _blocks(x.to(torch.float32))
    g = xp.reshape(*xp.shape[:-1], nb, blk)
    if power != 1:
        g = torch.sign(g) * torch.abs(g) ** (1.0 / power)
    scale = torch.amax(torch.abs(g), dim=-1) / 127.0           # (..., nb)
    scale_safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(g / scale_safe[..., None]), -127, 127)
    return {"q": q.to(torch.int8).reshape(xp.shape),
            "scale": scale.to(torch.float32)}


def dequantize(qs: Dict[str, torch.Tensor], shape: Tuple[int, ...],
               power: int = 1) -> torch.Tensor:
    shape = tuple(shape)
    d = shape[-1] if shape else 1
    nb = qs["scale"].shape[-1]
    blk = qs["q"].shape[-1] // nb
    g = qs["q"].to(torch.float32).reshape(*qs["q"].shape[:-1], nb, blk)
    g = g * qs["scale"][..., None]
    if power != 1:
        g = torch.sign(g) * _integer_pow(torch.abs(g), power)
    out = g.reshape(*qs["q"].shape[:-1], nb * blk)[..., :d]
    return out.reshape(shape)
