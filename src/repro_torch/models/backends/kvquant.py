"""K/V pool-page quantization helpers (bf16 / int8 / fp8 storage).

Port of ``repro.models.backends.kvquant``.  SOCKET's selection never
reads the full-precision K/V rows (scoring runs on packed hash bits and
value norms), so the pool's K/V leaves can be stored quantized and
dequantized only where rows are attended.

* **Resolution** — ``cfg.serving.kv_dtype`` names the storage mode:
  ``"auto"`` keeps the compute dtype, ``"bf16"`` is a plain bfloat16
  cast with no scales, ``"int8"`` / ``"fp8"`` store quantized rows with
  per-row scales.  Paged and ring K/V follow the knob; per-slot state
  rows never quantize.
* **Scheme** — symmetric per-row absmax: one float32 scale per (token
  row, KV head), ``scale = absmax / QMAX`` (127 for int8, 448 for
  ``torch.float8_e4m3fn``), kept in a ``k_scale`` / ``v_scale`` leaf
  beside K/V.  Every write path touches only its own rows.
* **Round trip** — :func:`quantize` is the one producer transform,
  :func:`dequantize` the one consumer transform (``q.float() * scale``,
  one rounding); the fused CUDA kernels read each row as
  ``float(q) * scale[row]``, the same product.

The order of operations is the JAX package's — ``absmax / qmax``, then
``where(scale > 0, scale, 1)``, then ``x / safe`` (a division, never a
multiply by the reciprocal) — so scales and payloads equal it bit for
bit: ``x / safe`` can reach 448.00003 (fp8) or 127.0000076 (int8) and
rounds back to the grid's maximum only because both sides divide the
same way.  Zero rows store ``scale = 0`` and zero payloads, so the
pool's zero fill round-trips exactly.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["KV_DTYPES", "QUANTIZED_KV_DTYPES", "is_quantized",
           "storage_dtype", "scale_dtype", "quantize", "dequantize",
           "resolve_kv_dtype"]

# serving.kv_dtype vocabulary (validated in ModelConfig.validate)
KV_DTYPES = ("auto", "bf16", "int8", "fp8")
QUANTIZED_KV_DTYPES = ("int8", "fp8")

# symmetric quantization grid ceilings
_QMAX = {"int8": 127.0, "fp8": 448.0}     # fp8 = float8_e4m3fn max normal

SCALE_DTYPE = torch.float32


def is_quantized(kv_dtype: str) -> bool:
    """True when ``kv_dtype`` stores scaled integer/fp8 rows (and the
    cache therefore carries ``k_scale``/``v_scale`` leaves)."""
    return kv_dtype in QUANTIZED_KV_DTYPES


def storage_dtype(kv_dtype: str,
                  compute_dtype: Union[str, torch.dtype, None]
                  ) -> torch.dtype:
    """The K/V leaf storage dtype for one resolved ``kv_dtype``
    (``compute_dtype`` — a torch dtype or its name — for ``"auto"``)."""
    if kv_dtype == "auto":
        if isinstance(compute_dtype, str):
            return getattr(torch, compute_dtype)
        return compute_dtype
    if kv_dtype == "bf16":
        return torch.bfloat16
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(
        f"unknown kv_dtype {kv_dtype!r}; expected one of {KV_DTYPES}")


def scale_dtype() -> torch.dtype:
    """Per-row scale leaf dtype (full precision: scales are metadata,
    like the SOCKET vnorm side-cache, never quantized)."""
    return SCALE_DTYPE


def resolve_kv_dtype(kv_dtype: str, kind: str) -> str:
    """Resolve the serving-level knob for one cache-plan layer kind:
    paged and ring K/V follow the knob, per-slot state rows never
    quantize."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown serving.kv_dtype {kv_dtype!r}; expected one of "
            f"{KV_DTYPES}")
    if kind == "state":
        return "auto"
    return kv_dtype


def quantize(x: torch.Tensor, kv_dtype: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``(..., hd)`` rows symmetrically per row.

    Returns ``(q, scale)``: ``q`` shaped like ``x`` in the storage dtype
    and ``scale`` ``(...,)`` float32, with ``dequantize(q, scale) ~= x``.
    Zero rows round-trip exactly.
    """
    qmax = _QMAX[kv_dtype]
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = absmax / qmax
    safe = torch.where(scale > 0, scale, 1.0)[..., None]
    scaled = xf / safe
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(torch.float8_e4m3fn)
    return q, scale.to(SCALE_DTYPE)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``(..., hd) x (...,) -> (..., hd)``
    float32 rows."""
    return q.float() * scale[..., None].float()
