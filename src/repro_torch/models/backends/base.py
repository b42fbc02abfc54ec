"""DecodeBackend protocol + KVView abstraction for sparse decode attention.

Port of the contiguous half of ``repro.models.backends.base``.  A decode
backend owns one global-attention layer's cache layout and the operations
the model needs:

* ``cache_spec(cfg)``    — declarative leaf layout (:class:`LeafSpec`).
* ``prefill_build(...)`` — write the prompt's K/V rows + backend metadata
                           into a freshly allocated contiguous cache.
* ``append(...)``        — write one new token through a :class:`KVView`
                           at position ``pos``.
* ``attend(...)``        — decode attention for one query step.

Unlike the JAX package, writes update the cache tensors **in place**
(``KVView.arrays`` holds the very tensors of the caller's cache): a K/V
cache is gigabytes at long context, and a functional copy per step
would double it.

The paged views, the ring view, quantized leaves and the serving
engine's cache handlers come with the continuous-engine slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import socket as sk

__all__ = ["LeafSpec", "KVView", "ContiguousView", "DecodeBackend",
           "kv_leaf_specs", "write_prefill_kv", "write_token_kv",
           "gather_kv_rows", "subset_attention"]

Pos = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Layout of one cache leaf along ``(batch, KVH, seq_rows, *suffix)``.

    ``granularity`` is tokens per sequence row; ``dtype is None`` means
    "use the cache compute dtype"; ``fill`` is the init value.
    """

    suffix: Tuple[int, ...] = ()
    dtype: Optional[torch.dtype] = None
    granularity: int = 1
    fill: float = 0.0

    def rows(self, capacity: int) -> int:
        return -(-capacity // self.granularity)

    def leaf_dtype(self, cache_dtype: torch.dtype) -> torch.dtype:
        return cache_dtype if self.dtype is None else self.dtype


def kv_leaf_specs(cfg) -> Dict[str, LeafSpec]:
    """The K/V leaves every backend stores, at the compute dtype (the JAX
    package's ``serving.kv_dtype="auto"``; quantized pages come with the
    quantized-pages slice)."""
    hd = cfg.head_dim
    return {"k": LeafSpec(suffix=(hd,)), "v": LeafSpec(suffix=(hd,))}


# --------------------------------------------------------------------- views

class KVView:
    """Uniform read/write interface over one layer's decode cache.

    ``arrays`` maps leaf name -> tensor.  Writes modify those tensors in
    place.
    """

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 spec: Dict[str, LeafSpec]):
        self.arrays = arrays
        self.spec = spec

    @property
    def n_tokens(self) -> int:
        raise NotImplementedError

    def leaf(self, name: str) -> torch.Tensor:
        raise NotImplementedError

    def gather_rows(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        raise NotImplementedError


class ContiguousView(KVView):
    """Each leaf is ``(B, KVH, rows, *suffix)``."""

    @property
    def n_tokens(self) -> int:
        return self.arrays["k"].shape[2] * self.spec["k"].granularity

    def leaf(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    def gather_rows(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        """Rows at indices ``idx`` ``(B, KVH, *sel)`` ->
        ``(B, KVH, *sel, *suffix)``."""
        assert self.spec[name].granularity == 1, name
        a = self.arrays[name]
        b, kvh = a.shape[:2]
        bidx = torch.arange(b, device=a.device).reshape(
            b, *([1] * (idx.ndim - 1)))
        hidx = torch.arange(kvh, device=a.device).reshape(
            1, kvh, *([1] * (idx.ndim - 2)))
        return a[bidx, hidx, idx]

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        """Set the row of token ``pos`` (an int, or a ``(B,)`` tensor of
        per-request positions) to ``value`` ``(B, KVH, *suffix)``, in
        place."""
        a = self.arrays[name]
        gran = self.spec[name].granularity
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            bidx = torch.arange(a.shape[0], device=a.device)
            a[bidx, :, pos.to(a.device) // gran] = value.to(a.dtype)
        else:
            a[:, :, int(pos) // gran] = value.to(a.dtype)


# ------------------------------------------------------------------ helpers

def write_prefill_kv(cfg, cache: Dict[str, torch.Tensor], kc: torch.Tensor,
                     vc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write the prompt K/V ``(B, KVH, T, hd)`` into rows [0, T), in
    place."""
    del cfg
    t = kc.shape[2]
    cache["k"][:, :, :t] = kc.to(cache["k"].dtype)
    cache["v"][:, :, :t] = vc.to(cache["v"].dtype)
    return cache


def write_token_kv(cfg, view: KVView, pos: Pos, kc: torch.Tensor,
                   vc: torch.Tensor) -> None:
    """Append-side K/V write of one token ``(B, KVH, hd)`` through a view."""
    del cfg
    view.write_token("k", pos, kc)
    view.write_token("v", pos, vc)


def gather_kv_rows(cfg, view: KVView, idx: torch.Tensor):
    """Gather the selected K/V rows: ``(k_sel, v_sel)``."""
    del cfg
    return view.gather_rows("k", idx), view.gather_rows("v", idx)


def subset_attention(cfg, q: torch.Tensor, k_sel: torch.Tensor,
                     v_sel: torch.Tensor, sel_mask: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """Exact attention over a gathered subset, routed through the
    ``flash_decode`` kernel when ``cfg.socket.use_flash_decode`` is set
    and the layout is the shared-KV one."""
    if cfg.socket.use_flash_decode and k_sel.ndim == 4:
        from repro_torch.kernels.flash_decode import ops as fd_ops
        return fd_ops.flash_decode(q, k_sel, v_sel, sel_mask, scale=scale)
    return sk.sparse_attention_over_subset(q, k_sel, v_sel, sel_mask,
                                           scale=scale)


# ------------------------------------------------------------------ backend

class DecodeBackend:
    """One decode-attention backend (see module docstring)."""

    name: str = ""

    def cache_spec(self, cfg) -> Dict[str, LeafSpec]:
        raise NotImplementedError

    def init_cache(self, cfg, batch: int, kv_heads: int, capacity: int,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
        """Allocate one layer's contiguous cache from the spec."""
        return {name: torch.full(
                    (batch, kv_heads, s.rows(capacity), *s.suffix), s.fill,
                    dtype=s.leaf_dtype(dtype), device=device)
                for name, s in self.cache_spec(cfg).items()}

    def prefill_build(self, cfg, params, cache: Dict[str, torch.Tensor],
                      kc: torch.Tensor, vc: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def append(self, cfg, params, view: KVView, kc: torch.Tensor,
               vc: torch.Tensor, pos: Pos) -> None:
        raise NotImplementedError

    def attend(self, cfg, params, q: torch.Tensor, view: KVView, *,
               length, scale: float) -> torch.Tensor:
        raise NotImplementedError
