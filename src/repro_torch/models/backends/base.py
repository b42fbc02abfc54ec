"""DecodeBackend protocol + KVView abstraction for sparse decode attention.

Port of ``repro.models.backends.base`` for global-attention layers.  A decode
backend owns one global-attention layer's cache layout and the operations
the model needs:

* ``cache_spec(cfg)``    — declarative leaf layout (:class:`LeafSpec`).
* ``prefill_build(...)`` — write the prompt's K/V rows + backend metadata
                           into a freshly allocated contiguous cache.
* ``append(...)``        — write one new token through a :class:`KVView`
                           at position ``pos`` (``write_token``, or
                           ``rmw_token`` for Quest's page min/max).
* ``attend(...)``        — decode attention for one query step.

Two views realize the interface: :class:`ContiguousView` over the
static path's ``(B, KVH, N, ...)`` cache, and :class:`PagedView` over the
continuous engine's page pool ``(num_blocks, KVH, block_size, ...)`` plus
a per-request block table.  A backend whose ``attend`` reads K/V only
through ``gather_rows`` is **paged-capable** (``supports_paged``).

Unlike the JAX package, writes update the cache and pool tensors **in
place** (``KVView.arrays`` holds the very tensors of the caller's cache
or pool): a K/V pool is gigabytes at long context, and a functional copy
per step would double it.

The ring view, quantized leaves and the per-layer cache handlers of
ring and state layers come with later slices (ROADMAP.md queue 1 items
5 and 7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import socket as sk

__all__ = ["LeafSpec", "KVView", "ContiguousView", "PagedView",
           "DecodeBackend", "kv_leaf_specs", "kv_scales_of",
           "effective_keys", "write_prefill_kv", "write_token_kv",
           "gather_kv_rows",
           "subset_attention", "gather_block_leaf", "write_chunk_blocks",
           "write_chunk_rows"]

Pos = Union[int, torch.Tensor]


def gather_block_leaf(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Materialize a paged leaf's logical view through a block table:
    ``(NB, KVH, rows_pb, *rest), (B, nb) -> (B, KVH, nb*rows_pb, *rest)``
    (a copy).  Shared by :meth:`PagedView.leaf`, the engine's dense
    fallback, chunked-prefill attention and the paged kernel's plain
    version."""
    b, nb = bt.shape
    g = pages[bt.long()]                   # (B, nb, KVH, rows_pb, *rest)
    g = g.movedim(2, 1)                    # (B, KVH, nb, rows_pb, *rest)
    return g.reshape(b, pages.shape[1], nb * pages.shape[2],
                     *pages.shape[3:])


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


def kv_scales_of(arrays: Dict[str, torch.Tensor], name: str):
    """The scale leaf paired with K/V leaf ``name`` (None when the cache
    is unquantized, which in the port is always)."""
    return arrays.get(name + "_scale")


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

    def rmw_token(self, name: str, pos: Pos, fn) -> None:
        """Read-modify-write the row covering token ``pos`` (Quest
        min/max): ``row <- fn(row)``, ``row`` ``(B, KVH, *suffix)``, in
        place."""
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

    def rmw_token(self, name: str, pos: Pos, fn) -> None:
        a = self.arrays[name]
        gran = self.spec[name].granularity
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            bidx = torch.arange(a.shape[0], device=a.device)
            row = pos.to(a.device) // gran
            a[bidx, :, row] = fn(a[bidx, :, row]).to(a.dtype)
        else:
            row = int(pos) // gran
            a[:, :, row] = fn(a[:, :, row]).to(a.dtype)


class PagedView(KVView):
    """Serving-engine layout: each leaf is ``(num_blocks, KVH,
    block_size / granularity, *suffix)`` plus a per-request block table
    ``(B, blocks_per_seq)`` of physical block ids (trash-padded).

    Logical token ``t`` of request ``b`` lives in physical block
    ``block_table[b, t // block_size]`` at row ``(t % block_size) //
    granularity``.  ``leaf()`` materializes the full logical view (cheap
    for metadata leaves, what paged-capable backends avoid for K/V);
    ``gather_rows`` translates selected logical indices through the table
    and touches only those rows.  Writes land in the pool in place.
    """

    def __init__(self, arrays, spec, block_table: torch.Tensor,
                 block_size: int):
        super().__init__(arrays, spec)
        self.block_table = block_table
        self.block_size = block_size

    @property
    def n_tokens(self) -> int:
        return self.block_table.shape[1] * self.block_size

    def leaf(self, name: str) -> torch.Tensor:
        return gather_block_leaf(self.arrays[name], self.block_table)

    def gather_rows(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        assert self.spec[name].granularity == 1, name
        pages = self.arrays[name]
        bt = self.block_table.long()
        b, kvh = bt.shape[0], pages.shape[1]
        bidx = torch.arange(b, device=bt.device).reshape(
            b, *([1] * (idx.ndim - 1)))
        hidx = torch.arange(kvh, device=bt.device).reshape(
            1, kvh, *([1] * (idx.ndim - 2)))
        blk = bt[bidx, idx // self.block_size]
        return pages[blk, hidx, idx % self.block_size]

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        """Set the row of token ``pos`` (an int or a ``(B,)`` tensor) of
        every request to ``value`` ``(B, KVH, *suffix)``, in the pool in
        place.  Inactive slots point at the trash block; their duplicate
        writes there are never read unmasked."""
        pages = self.arrays[name]
        blk, row = self._addr(name, pos)
        pages[blk, :, row] = value.to(pages.dtype)

    def _addr(self, name: str, pos: Pos):
        """Physical block and row of token ``pos`` of every request."""
        bt = self.block_table.long()
        b = bt.shape[0]
        pos = torch.as_tensor(pos, device=bt.device).long().expand(b)
        blk = bt[torch.arange(b, device=bt.device), pos // self.block_size]
        return blk, (pos % self.block_size) // self.spec[name].granularity

    def rmw_token(self, name: str, pos: Pos, fn) -> None:
        pages = self.arrays[name]
        blk, row = self._addr(name, pos)
        pages[blk, :, row] = fn(pages[blk, :, row]).to(pages.dtype)


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


def effective_keys(cfg, kc: torch.Tensor) -> torch.Tensor:
    """The key values the attend phase will read back: ``kc`` itself
    under unquantized pages (the only kind the port stores yet).  Quest's
    kmin/kmax page stats are computed from this, so under quantized
    pages they would bound the dequantized keys
    (``quest.stats_from_quantized``); that round trip comes with the
    quantized-pages slice and raises here until then."""
    if cfg.serving.kv_dtype != "auto" and cfg.quest.stats_from_quantized:
        raise NotImplementedError(
            f"kv_dtype={cfg.serving.kv_dtype!r}: the quantization round "
            "trip of the page stats comes with the quantized-pages slice "
            "(ROADMAP.md queue 1 item 5)")
    return kc


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
    """One decode-attention backend (see module docstring).

    Subclasses set ``name`` (registry key) and ``supports_paged`` (True
    iff ``attend`` reads K/V only via ``gather_rows``, so the serving
    engine hands it the pool and never materializes contiguous views).
    """

    name: str = ""
    supports_paged: bool = False

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


# ------------------------------------------------------------ pool writes

def write_chunk_blocks(pages: torch.Tensor, leaf: torch.Tensor,
                       bt_row: torch.Tensor, block0: int) -> None:
    """Scatter one prefill chunk's batch=1 cache leaf ``(1, KVH, rows,
    *rest)`` into pool pages at block-table offset ``block0`` (the chunk's
    first logical block), in place.  ``bt_row`` must be padded so
    ``block0 + rows / rows_per_block`` never exceeds its length."""
    kvh, rows = leaf.shape[1], leaf.shape[2]
    rows_pb = pages.shape[2]
    nb = rows // rows_pb
    blocks = leaf[0].reshape(kvh, nb, rows_pb, *leaf.shape[3:])
    blocks = blocks.movedim(1, 0)            # (nb, KVH, rows_pb, *rest)
    ids = bt_row[int(block0):int(block0) + nb].long()
    pages[ids] = blocks.to(pages.dtype)


def write_chunk_rows(pages: torch.Tensor, leaf: torch.Tensor,
                     bt_row: torch.Tensor, history: int,
                     last_index: int) -> None:
    """Row-granular variant of :func:`write_chunk_blocks`, in place: chunk
    token ``i`` lands at logical position ``history + i``, i.e. row
    ``(history + i) % rows_per_block`` of block ``bt_row[(history + i) //
    rows_per_block]``.  Rows past ``last_index`` (final-chunk padding) go
    to the trash page.  Granularity-1 leaves only."""
    rows = leaf.shape[2]
    rows_pb = pages.shape[2]
    i = torch.arange(rows, device=pages.device)
    ti = int(history) + i
    blk = torch.where(i <= int(last_index), bt_row.long()[ti // rows_pb],
                      torch.zeros_like(ti))
    vals = leaf[0].movedim(1, 0)             # (rows, KVH, *rest)
    pages[blk, :, ti % rows_pb] = vals.to(pages.dtype)
