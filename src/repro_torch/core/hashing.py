"""SimHash (signed-random-projection) machinery for SOCKET, in PyTorch.

Port of ``repro.core.hashing`` (Algorithm 1 of the paper): every key is
projected by ``L`` tables of ``P`` Gaussian hyperplanes and reduced to its
sign pattern.  Two encodings, as in the JAX package:

* ``signs``  — boolean ``(..., N, L, P)``,
* ``packed`` — ``(..., N, W)`` bit-packed words, ``W = num_words(L, P)``.

The packed words are stored as **int32 with the uint32 bit pattern** of
the JAX package's words: PyTorch has no right shift for ``torch.uint32``
on the CPU, and ``(w >> b) & 1`` is exact for every bit under an
arithmetic shift.  Compare with the JAX words through
``int32.view(uint32)``.

Hyperplanes are drawn from an explicit ``torch.Generator``
(:func:`make_hash_params`); the numbers differ from ``jax.random``'s for
the same seed, so the tests hand JAX's draw to the port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["num_words", "make_hash_params", "hash_keys_signs",
           "signs_to_bucket_ids", "pack_signs", "unpack_signs",
           "hypercube_corners"]


def num_words(num_tables: int, num_planes: int) -> int:
    """32-bit words storing one token's hash bits, rounded up so that
    ``W*32`` is a multiple of ``P`` (the JAX package's layout: 20 words,
    640 bits, for the paper's P=10, L=60)."""
    w = (num_tables * num_planes + 31) // 32
    while (w * 32) % num_planes:
        w += 1
    return w


def make_hash_params(gen: torch.Generator, d: int, num_planes: int,
                     num_tables: int, dtype=torch.float32) -> torch.Tensor:
    """Gaussian hyperplanes ``W`` ``(L, P, d)`` drawn in float32 from
    ``gen`` on its device, then cast to ``dtype``.  Data-agnostic: the
    index build is one draw, no calibration pass (paper fig. 3a)."""
    w = torch.randn((num_tables, num_planes, d), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.to(dtype)


def hash_keys_signs(w: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 line 6: ``sign(W^(l) k_j)`` for every key and table.

    w: ``(L, P, d)`` hyperplanes; keys: ``(..., N, d)``.
    Returns boolean ``(..., N, L, P)``, True where the projection is >= 0.
    """
    l, p, d = w.shape
    proj = keys.float() @ w.float().reshape(l * p, d).T     # (..., N, L*P)
    return (proj >= 0.0).reshape(*proj.shape[:-1], l, p)


def signs_to_bucket_ids(signs: torch.Tensor) -> torch.Tensor:
    """Per-table sign patterns ``(..., L, P)`` as int32 bucket ids in
    ``[0, 2**P)``: bit i of the id is plane i's sign (LSB = plane 0)."""
    p = signs.shape[-1]
    if p > 31:
        raise ValueError(f"P={p} too large for int32 bucket ids")
    weights = torch.tensor((1 << np.arange(p)).astype(np.int32),
                           device=signs.device)
    return (signs.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Pack boolean ``(..., N, L, P)`` into int32 ``(..., N, W)``.

    Flat bit ``l*P + p`` (table-major, plane-minor, zero-padded to
    ``W*32``) is bit ``b`` of word ``w`` where ``w*32 + b`` is the flat
    index — the layout of ``repro.core.hashing.pack_signs``.
    """
    *lead, n, l, p = signs.shape
    w = num_words(l, p)
    flat = signs.reshape(*lead, n, l * p).to(torch.int64)
    pad = w * 32 - l * p
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=signs.device)
    words = (flat.reshape(*lead, n, w, 32) << shifts).sum(-1)  # [0, 2^32)
    # reinterpret as the int32 with the same 32 bits
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_signs(packed: torch.Tensor, num_tables: int, num_planes: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_signs`, returning ±1 values
    ``(..., N, L, P)`` in ``dtype``."""
    *lead, n, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(*lead, n, w * 32)[..., : num_tables * num_planes]
    signs = flat.to(dtype) * 2.0 - 1.0
    return signs.reshape(*lead, n, num_tables, num_planes)


def hypercube_corners(num_planes: int) -> np.ndarray:
    """All ``R = 2**P`` corners ``c_r`` in ``{-1, +1}^P`` as float32
    ``(R, P)`` (bit i of r = plane i).  Only the paper-literal scoring
    form (:func:`repro_torch.core.socket.bucket_probs_explicit`) and the
    tests use them; the production path never builds the corner set."""
    ids = np.arange(1 << num_planes)[:, None]
    bits = (ids >> np.arange(num_planes)[None, :]) & 1
    return (bits * 2 - 1).astype(np.float32)
