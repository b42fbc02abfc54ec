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

Three views realize the interface: :class:`ContiguousView` over the
static path's ``(B, KVH, N, ...)`` cache, :class:`PagedView` over the
continuous engine's page pool ``(num_blocks, KVH, block_size, ...)`` plus
a per-request block table, and :class:`RingView`, the sliding-window
layers' circular page list over the same pool.  A backend whose
``attend`` reads K/V only through ``gather_rows`` is **paged-capable**
(``supports_paged``).

The pool side of the per-layer cache plan is a :class:`LayerCacheHandler`
per layer: :class:`PagedKVCacheHandler` for global layers here,
``RingCacheHandler`` (``backends/ring.py``) for sliding-window ones.

Unlike the JAX package, writes update the cache and pool tensors **in
place** (``KVView.arrays`` holds the very tensors of the caller's cache
or pool): a K/V pool is gigabytes at long context, and a functional copy
per step would double it.

K/V leaves are stored at ``serving.kv_dtype`` (:func:`kv_leaf_specs`):
the compute dtype, a bf16 cast, or int8/fp8 rows with float32 per-row
``k_scale``/``v_scale`` leaves (:mod:`.kvquant`).  Rows are quantized on
write (:func:`write_prefill_kv`, :func:`write_token_kv`) and dequantized
where they are read (:func:`gather_kv_rows` for the selected rows,
:func:`dequant_leaf` for a whole view).  The CPU build of torch has no
fp8 ``masked_fill_``, ``gather`` or ``scatter_``, so every pool and cache
read and write here moves fp8 payloads through a same-size ``uint8``
view (bitwise on every device; byte 0 is +0.0).

The state (Mamba) handler comes with ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import socket as sk
from repro_torch.models.backends import kvquant

__all__ = ["LeafSpec", "LayerCacheSpec", "KVView", "ContiguousView",
           "PagedView", "RingView", "DecodeBackend", "LayerCacheHandler",
           "PagedKVCacheHandler", "kv_quant_mode", "kv_leaf_specs",
           "kv_scales_of", "effective_keys", "write_prefill_kv",
           "quantize_kv", "write_token_kv", "gather_kv_rows",
           "dequant_leaf", "subset_attention", "subset_partials",
           "cp_subset_attend", "gather_block_leaf",
           "write_chunk_blocks", "write_chunk_rows", "ring_write_page",
           "ring_write_chunk"]

Pos = Union[int, torch.Tensor]


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for fp8 its same-size ``uint8`` view (shares the
    storage): fp8 payloads are moved, scrubbed and gathered as bytes — the
    CPU build has no fp8 ``masked_fill_``, ``gather`` or ``scatter_``, and
    a byte copy is bitwise on every device (byte 0 is +0.0)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _put(a: torch.Tensor, index, value: torch.Tensor) -> None:
    """``a[index] = value`` in place, ``value`` cast to ``a``'s dtype (fp8
    through the byte views)."""
    _raw(a)[index] = _raw(value.to(a.dtype))


def _take(a: torch.Tensor, index) -> torch.Tensor:
    """``a[index]`` (fp8 through the byte view)."""
    return _raw(a)[index].view(a.dtype)


def gather_block_leaf(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Materialize a paged leaf's logical view through a block table:
    ``(NB, KVH, rows_pb, *rest), (B, nb) -> (B, KVH, nb*rows_pb, *rest)``
    (a copy).  Shared by :meth:`PagedView.leaf`, the engine's dense
    fallback, chunked-prefill attention and the paged kernel's plain
    version."""
    b, nb = bt.shape
    g = _take(pages, bt.long())            # (B, nb, KVH, rows_pb, *rest)
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


@dataclasses.dataclass(frozen=True)
class LayerCacheSpec:
    """One layer's resolved cache layout on the serving engine's pool.

    * ``kind == "paged"`` — leaves live in pool pages addressed linearly
      through the request block table (global-attention backends).
    * ``kind == "ring"`` — K/V pages addressed circularly through the
      first ``ring_blocks`` block-table entries (sliding-window layers).
    * ``kind == "state"`` — no leaves: Mamba state rows, one per decode
      slot (``backends.state``).
    """

    kind: str
    leaves: Dict[str, LeafSpec]
    ring_blocks: int = 0


def kv_quant_mode(cfg) -> str:
    """The K/V storage mode of attention layers, paged and ring alike
    (``serving.kv_dtype``)."""
    return cfg.serving.kv_dtype


def kv_leaf_specs(cfg) -> Dict[str, LeafSpec]:
    """The K/V leaves every backend stores.

    Under ``serving.kv_dtype`` ``"int8"``/``"fp8"`` the k/v leaves hold
    quantized rows and a float32 per-row scale leaf rides along
    (``k_scale``/``v_scale``: empty suffix, granularity 1, the way the
    SOCKET vnorm side-cache rides along).  ``"bf16"`` is a plain storage
    cast (no scales); ``"auto"`` keeps the compute dtype.
    """
    hd = cfg.head_dim
    kvd = kv_quant_mode(cfg)
    if kvd == "auto":
        return {"k": LeafSpec(suffix=(hd,)), "v": LeafSpec(suffix=(hd,))}
    sdt = kvquant.storage_dtype(kvd, None)
    spec = {"k": LeafSpec(suffix=(hd,), dtype=sdt),
            "v": LeafSpec(suffix=(hd,), dtype=sdt)}
    if kvquant.is_quantized(kvd):
        spec["k_scale"] = LeafSpec(suffix=(), dtype=kvquant.scale_dtype())
        spec["v_scale"] = LeafSpec(suffix=(), dtype=kvquant.scale_dtype())
    return spec


def kv_scales_of(arrays: Dict[str, torch.Tensor], name: str):
    """The scale leaf paired with K/V leaf ``name`` (None when the cache
    is unquantized)."""
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
    """Each leaf is ``(B, KVH, rows, *suffix)``.

    ``shard`` (a :class:`~repro_torch.distributed.context_parallel
    .CacheShard`): under context-parallel decode the leaves hold only this
    rank's block of the cache, and :meth:`write_token` and
    :meth:`rmw_token` write only the rows this rank owns (global token
    positions in, whole-batch values in)."""

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 spec: Dict[str, LeafSpec], shard=None):
        super().__init__(arrays, spec)
        self.shard = shard

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
        return _take(a, (bidx, hidx, idx))

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        """Set the row of token ``pos`` (an int, or a ``(B,)`` tensor of
        per-request positions) to ``value`` ``(B, KVH, *suffix)``, in
        place."""
        a = self.arrays[name]
        gran = self.spec[name].granularity
        if self.shard is not None:
            self._write_owned(a, gran, pos, value)
        elif isinstance(pos, torch.Tensor) and pos.ndim == 1:
            bidx = torch.arange(a.shape[0], device=a.device)
            _put(a, (bidx, slice(None), pos.to(a.device) // gran), value)
        else:
            _put(a, (slice(None), slice(None), int(pos) // gran), value)

    def _write_owned(self, a: torch.Tensor, gran: int, pos: Pos,
                     value: torch.Tensor) -> None:
        """:meth:`write_token` on this rank's block: its batch rows of
        ``value``, at the rows it holds (token ``t0`` is its first)."""
        bl = a.shape[0]
        b0 = self.shard.batch_index * bl
        value = value[b0:b0 + bl]
        t0 = self.shard.seq_index * a.shape[2] * gran
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            p = pos[b0:b0 + bl].to(a.device) - t0
            own = (p >= 0) & (p < a.shape[2] * gran)
            bidx = torch.arange(bl, device=a.device)[own]
            _put(a, (bidx, slice(None), p[own] // gran), value[own])
        elif 0 <= int(pos) - t0 < a.shape[2] * gran:
            _put(a, (slice(None), slice(None), (int(pos) - t0) // gran),
                 value)

    def rmw_token(self, name: str, pos: Pos, fn) -> None:
        a = self.arrays[name]
        gran = self.spec[name].granularity
        if self.shard is not None:
            self._rmw_owned(a, gran, pos, fn)
        elif isinstance(pos, torch.Tensor) and pos.ndim == 1:
            bidx = torch.arange(a.shape[0], device=a.device)
            row = pos.to(a.device) // gran
            a[bidx, :, row] = fn(a[bidx, :, row]).to(a.dtype)
        else:
            row = int(pos) // gran
            a[:, :, row] = fn(a[:, :, row]).to(a.dtype)

    def _rmw_owned(self, a: torch.Tensor, gran: int, pos: Pos, fn) -> None:
        """:meth:`rmw_token` on this rank's block: ``fn`` sees whole-batch
        rows (this rank's rows where it holds them, zeros elsewhere), and
        only the rows it holds are written, at their local rows."""
        bl = a.shape[0]
        b0 = self.shard.batch_index * bl
        t0 = self.shard.seq_index * a.shape[2] * gran
        p = torch.as_tensor(pos, device=a.device).long().expand(
            bl * self.shard.batch_shards)[b0:b0 + bl] - t0
        own = (p >= 0) & (p < a.shape[2] * gran)
        bidx = torch.arange(bl, device=a.device)[own]
        row = p[own] // gran
        whole = a.new_zeros((bl * self.shard.batch_shards, *a.shape[1:2],
                             *a.shape[3:]))
        whole[b0 + bidx] = a[bidx, :, row]
        a[bidx, :, row] = fn(whole)[b0 + bidx].to(a.dtype)


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
        return _take(pages, (blk, hidx, idx % self.block_size))

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        """Set the row of token ``pos`` (an int or a ``(B,)`` tensor) of
        every request to ``value`` ``(B, KVH, *suffix)``, in the pool in
        place.  Inactive slots point at the trash block; their duplicate
        writes there are never read unmasked."""
        blk, row = self._addr(name, pos)
        _put(self.arrays[name], (blk, slice(None), row), value)

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


def ring_write_page(pages: torch.Tensor, blk: torch.Tensor, pos: Pos,
                    value: torch.Tensor, *, block_size: int,
                    ring_blocks: int, window: int) -> torch.Tensor:
    """Write token ``pos``'s ``value`` (B, KVH, *suffix) into its circular
    page ``blk`` (B,) at row ``pos % block_size``, in place, **scrubbing
    rows that cannot hold in-window tokens at page-opening writes** (row
    0):

    * first pass over the ring (``pos < ring capacity``): the page is a
      freshly allocated pool block still carrying its previous owner's
      data, and no row past the one written can be valid yet — zero it
      all;
    * later passes: rows ``[1, capacity - window]`` hold positions that
      fell out of the window the moment this page reopened — zero that
      dead band, keep the still-live window rows.

    Ring validity masking already excludes every scrubbed row from
    attention; the scrub keeps pool contents a pure function of the live
    requests.  Active slots hold disjoint blocks; only trash-page writes
    alias (the last one wins, as in the JAX package).  Returns
    ``pages``."""
    b = blk.shape[0]
    blk = blk.long()
    pos = torch.as_tensor(pos, device=blk.device).long().expand(b)
    cap = ring_blocks * block_size
    row = pos % block_size
    raw = _raw(pages)
    page = raw[blk]                        # (B, KVH, block_size, *suffix)
    r = torch.arange(block_size, device=blk.device)
    scrub = (row == 0)[:, None] & (r[None] >= 1) & (
        (r[None] <= cap - window) | (pos < cap)[:, None])     # (B, bs)
    page.masked_fill_(scrub.reshape(b, 1, block_size,
                                    *([1] * (page.ndim - 3))), 0)
    page[torch.arange(b, device=blk.device), :, row] = _raw(
        value.to(pages.dtype))
    raw[blk] = page
    return pages


def ring_write_chunk(pages: torch.Tensor, vals: torch.Tensor,
                     bt_row: torch.Tensor, history: int, last_index: int, *,
                     block_size: int, ring_blocks: int,
                     window: int) -> torch.Tensor:
    """The pool after :func:`ring_write_page` wrote chunk tokens ``j = 0
    .. C-1`` (positions ``history + j``, values ``vals`` ``(1, KVH, C,
    *suffix)``) one after the other, batch 1, in place: real rows (``j
    <= last_index``) to ring entry ``(pos // block_size) % ring_blocks``
    of ``bt_row``, padded rows to the trash page (block 0), each
    page-opening write scrubbing as that function does.

    One pass instead of C: each (page, row) ends with the last event
    that touched it — a token's write, or a later page-opening scrub —
    so the result is bit for bit that of the sequential loop."""
    c = vals.shape[2]
    dev = pages.device
    cap = ring_blocks * block_size
    j = torch.arange(c, device=dev)
    pos = int(history) + j
    row = pos % block_size
    # virtual page of each token: its ring entry, or ring_blocks (trash)
    vpage = torch.where(j <= int(last_index), (pos // block_size) %
                        ring_blocks, ring_blocks)
    r = torch.arange(block_size, device=dev)
    scrub = (row == 0)[:, None] & (r[None] >= 1) & (
        (r[None] <= cap - window) | (pos < cap)[:, None])     # (C, bs)
    # last event per (vpage, row): 2j + 1 for a write, 2j for a scrub
    nkey = (ring_blocks + 1) * block_size
    last = torch.full((nkey,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(
        0, (vpage[:, None] * block_size + r[None]).flatten(),
        torch.where(scrub, 2 * j[:, None], -1).flatten(), reduce="amax")
    last.scatter_reduce_(0, vpage * block_size + row, 2 * j + 1,
                         reduce="amax")
    # the pages the chunk touches, from host integers (no device sync):
    # the real rows' ring entries, and the trash page under padding
    first, end = int(history), int(history) + int(last_index)
    touched = sorted({b % ring_blocks for b in range(
        first // block_size, end // block_size + 1)})
    if int(last_index) + 1 < c:
        touched.append(ring_blocks)
    touched = torch.tensor(touched, device=dev)
    blk = torch.cat([bt_row[:ring_blocks].long(),
                     torch.zeros(1, dtype=torch.long, device=dev)])[touched]
    last = last.reshape(ring_blocks + 1, block_size)[touched]   # (P, bs)
    raw = _raw(pages)
    page = raw[blk]                             # (P, KVH, bs, *suffix)
    src = _raw(vals[0].to(pages.dtype)).movedim(1, 0)[
        (last // 2).clamp(min=0)]                          # (P,bs,KVH,...)
    src = src.movedim(2, 1)                                # (P,KVH,bs,...)
    shape = (*last.shape[:1], 1, block_size, *([1] * (page.ndim - 3)))
    wrote = (last >= 0) & (last % 2 == 1)
    scrubbed = (last >= 0) & (last % 2 == 0)
    page = torch.where(wrote.reshape(shape), src, page)
    page.masked_fill_(scrubbed.reshape(shape), 0)
    raw[blk] = page
    return pages


class RingView(PagedView):
    """Sliding-window ring over pool pages: the first ``ring_blocks``
    block-table entries form a circular page list — logical token ``t``
    lives at entry ``(t // block_size) % ring_blocks``, row ``t %
    block_size`` (so flat ring slot ``t % (ring_blocks * block_size)``).
    Old pages are recycled in place; per-slot block demand never exceeds
    ``ring_blocks``.

    ``leaf()`` materializes the *bounded* ring view (``ring_blocks *
    block_size`` rows — window-sized, never context-sized).  ``window``
    drives the page-opening scrub of :func:`ring_write_page`.
    """

    def __init__(self, arrays, spec, block_table: torch.Tensor,
                 block_size: int, ring_blocks: int, window: int):
        super().__init__(arrays, spec, block_table, block_size)
        self.ring_blocks = ring_blocks
        self.window = window

    @property
    def n_tokens(self) -> int:
        return self.ring_blocks * self.block_size

    def leaf(self, name: str) -> torch.Tensor:
        return gather_block_leaf(self.arrays[name],
                                 self.block_table[:, :self.ring_blocks])

    def _addr(self, name: str, pos: Pos):
        assert self.spec[name].granularity == 1, name
        bt = self.block_table.long()
        b = bt.shape[0]
        pos = torch.as_tensor(pos, device=bt.device).long().expand(b)
        blk = bt[torch.arange(b, device=bt.device),
                 (pos // self.block_size) % self.ring_blocks]
        return blk, pos % self.block_size

    def gather_rows(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        pages = self.arrays[name]
        bt = self.block_table.long()
        b, kvh = bt.shape[0], pages.shape[1]
        bidx = torch.arange(b, device=bt.device).reshape(
            b, *([1] * (idx.ndim - 1)))
        hidx = torch.arange(kvh, device=bt.device).reshape(
            1, kvh, *([1] * (idx.ndim - 2)))
        blk = bt[bidx, (idx // self.block_size) % self.ring_blocks]
        return _take(pages, (blk, hidx, idx % self.block_size))

    def write_token(self, name: str, pos: Pos, value: torch.Tensor) -> None:
        """Write token ``pos``'s row with the page-opening scrub (see
        :func:`ring_write_page`), in the pool in place."""
        blk, _ = self._addr(name, pos)
        ring_write_page(self.arrays[name], blk, pos, value,
                        block_size=self.block_size,
                        ring_blocks=self.ring_blocks, window=self.window)


# ------------------------------------------------------------------ helpers

def quantize_kv(cfg, kc: torch.Tensor, vc: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The K/V rows ``(..., hd)`` as the cache stores them: ``{"k", "v"}``
    at the storage dtype, plus ``k_scale``/``v_scale`` under int8/fp8."""
    kvd = kv_quant_mode(cfg)
    if kvquant.is_quantized(kvd):
        kq, ks = kvquant.quantize(kc, kvd)
        vq, vs = kvquant.quantize(vc, kvd)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    if kvd == "bf16":
        return {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16)}
    return {"k": kc, "v": vc}


def write_prefill_kv(cfg, cache: Dict[str, torch.Tensor], kc: torch.Tensor,
                     vc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write the prompt K/V ``(B, KVH, T, hd)`` into rows [0, T), in
    place, quantizing on write when the cache carries scale leaves."""
    t = kc.shape[2]
    for name, val in quantize_kv(cfg, kc, vc).items():
        _put(cache[name], (slice(None), slice(None), slice(0, t)), val)
    return cache


def effective_keys(cfg, kc: torch.Tensor) -> torch.Tensor:
    """The key values the attend phase will read back: the quantization
    round trip of ``kc`` under int8/fp8 storage, ``kc`` itself otherwise.
    Quest's kmin/kmax page stats are computed from this
    (``quest.stats_from_quantized``), so the per-page bounds cover the
    dequantized keys and the upper-bound score stays sound."""
    kvd = kv_quant_mode(cfg)
    if kvquant.is_quantized(kvd) and cfg.quest.stats_from_quantized:
        return kvquant.dequantize(*kvquant.quantize(kc, kvd))
    return kc


def write_token_kv(cfg, view: KVView, pos: Pos, kc: torch.Tensor,
                   vc: torch.Tensor) -> None:
    """Append-side K/V write of one token ``(B, KVH, hd)`` through a view,
    quantizing on write when the cache carries scale leaves."""
    for name, val in quantize_kv(cfg, kc, vc).items():
        view.write_token(name, pos, val)


def gather_kv_rows(cfg, view: KVView, idx: torch.Tensor):
    """The unfused paths' K/V read: gather the selected rows and
    dequantize only those.  Returns ``(k_sel, v_sel)``: float32 under
    int8/fp8, the storage dtype otherwise."""
    k_sel = view.gather_rows("k", idx)
    v_sel = view.gather_rows("v", idx)
    if kvquant.is_quantized(kv_quant_mode(cfg)):
        k_sel = kvquant.dequantize(k_sel, view.gather_rows("k_scale", idx))
        v_sel = kvquant.dequantize(v_sel, view.gather_rows("v_scale", idx))
    return k_sel, v_sel


def dequant_leaf(cfg, view: KVView, name: str) -> torch.Tensor:
    """Full logical K/V leaf ``name``, dequantized when the cache carries
    scale leaves (the dense backend and the plain ring route; the fused
    kernels never take it)."""
    a = view.leaf(name)
    if name in ("k", "v") and kvquant.is_quantized(kv_quant_mode(cfg)):
        return kvquant.dequantize(a, view.leaf(name + "_scale"))
    return a


def subset_partials(cfg, q: torch.Tensor, k_sel: torch.Tensor,
                    v_sel: torch.Tensor, sel_mask: torch.Tensor, *,
                    scale: float):
    """:func:`subset_attention`'s softmax partials ``(m, l, o)`` f32 (the
    ``flash_decode`` kernel's, with its partials, where
    ``cfg.socket.use_flash_decode``; else the plain ones): what a
    context-parallel rank merges with the others'."""
    if cfg.socket.use_flash_decode:
        from repro_torch.kernels.flash_decode import ops as fd_ops
        o, m, l = fd_ops.flash_decode(q, k_sel, v_sel, sel_mask,
                                      scale=scale, partials=True)
        return m, l, o
    from repro_torch.distributed.context_parallel import partials
    return partials(q, k_sel, v_sel, sel_mask, scale)


def cp_subset_attend(cfg, fr, q: torch.Tensor, view: KVView,
                     idx: torch.Tensor, sel_mask: torch.Tensor, *,
                     scale: float, dtype) -> torch.Tensor:
    """Context-parallel attention over a global selection ``idx`` /
    ``sel_mask`` ``(B_l, KVH, K)`` of this rank's batch rows (``q``
    ``(B_l, KVH, G, 1, hd)``): the rows this rank holds in its block
    ``view`` (the rest masked, :meth:`Frame.owned`), their partials
    (:func:`subset_partials`), merged over the ranks (``fr``: a
    :class:`~repro_torch.distributed.context_parallel.Frame`).  Returns
    the whole batch's output in ``dtype``."""
    loc, own = fr.owned(idx, sel_mask)
    k_sel, v_sel = gather_kv_rows(cfg, view, loc)
    m, l, o = subset_partials(cfg, q, k_sel, v_sel, own, scale=scale)
    return fr.merge(m, l, o, dtype)


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

    def cache_axes(self, cfg, seq_axis: str) -> Dict[str, Tuple]:
        """Logical sharding axes mirroring :meth:`init_cache`."""
        return {name: ("cache_batch", "cache_heads", seq_axis) +
                (None,) * len(s.suffix)
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

    # ---- accounting -----------------------------------------------------
    def selected_rows(self, cfg, n: int) -> int:
        """Static K/V rows gathered per step at capacity ``n`` (for the
        memory-traffic accounting in :func:`repro_torch.serving.paged
        .gather_footprint`)."""
        return n

    def fused_paged(self, cfg) -> bool:
        """True when this backend's PagedView attend runs as one fused
        kernel over the pool: no gathers and no materialized views, so
        the gather-footprint accounting reports 0."""
        return False


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
    _put(pages, ids, blocks)


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
    _put(pages, (blk, slice(None), ti % rows_pb), vals)


# --------------------------------------------------------- cache handlers

class LayerCacheHandler:
    """Pool-side operations for ONE layer of the per-layer cache plan.

    The serving engine's pool helpers (:mod:`repro_torch.serving.paged`)
    resolve each layer to a handler (``layer_cache_handler``) and
    dispatch through this interface; every method works on one layer's
    leaf dict (name -> tensor) and writes the pool in place.

    * ``spec``    — declarative :class:`LayerCacheSpec`.
    * ``gather``  — materialize the contiguous per-slot views the
                    unmodified (non-paged) decode path consumes.
    * ``scatter`` — write the row(s) a decode step updated in those views
                    back into the pool.
    * ``write_prefill`` — scatter a fresh batch=1 whole-prompt prefill
                    cache (the legacy bucketed prefill) into the pool
                    pages of ``bt_row``; ``slot`` (the request's decode
                    slot) receives per-slot state rows (Mamba layers'
                    handler).  Paged layers' leaves and
                    ring layers' page-aligned rings (``ring_blocks *
                    block_size`` rows, already in flat ring layout) both
                    scatter block for block.
    """

    kind: str = ""

    def spec(self, cfg) -> LayerCacheSpec:
        raise NotImplementedError

    def write_prefill(self, cfg, pages: Dict[str, torch.Tensor],
                      cache: Dict[str, torch.Tensor], bt_row: torch.Tensor,
                      slot: int) -> Dict[str, torch.Tensor]:
        """Every leaf (K/V, their scales under int8/fp8, the backend's
        metadata) block for block into the pages of ``bt_row`` (block ids,
        trash-padded: entries past the request's allocated blocks absorb
        rows it cannot reach), in place."""
        for name, p in pages.items():
            write_chunk_blocks(p, cache[name], bt_row, 0)
        return pages

    def gather(self, cfg, pages: Dict[str, torch.Tensor],
               bt: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def scatter(self, cfg, pages: Dict[str, torch.Tensor],
                views: Dict[str, torch.Tensor], bt: torch.Tensor,
                pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class PagedKVCacheHandler(LayerCacheHandler):
    """Global-attention layers: the decode backend's ``cache_spec`` leaves
    in pool pages, the block table consumed linearly."""

    kind = "paged"

    def __init__(self, backend: DecodeBackend):
        self.backend = backend

    def spec(self, cfg) -> LayerCacheSpec:
        return LayerCacheSpec(kind="paged",
                              leaves=self.backend.cache_spec(cfg))

    def gather(self, cfg, pages, bt):
        return {name: gather_block_leaf(p, bt) for name, p in pages.items()}

    def scatter(self, cfg, pages, views, bt, pos):
        """Write the row each slot updated at token ``pos[b]`` (view row
        ``pos // granularity``) into physical page ``bt[b, pos //
        block_size]``, in place.  Inactive slots point at the trash block;
        duplicate trash writes are benign."""
        bs = cfg.serving.block_size
        spec = self.backend.cache_spec(cfg)
        bt, pos = bt.long(), pos.long()
        bidx = torch.arange(bt.shape[0], device=bt.device)
        blk = bt[bidx, pos // bs]
        for name, p in pages.items():
            gran = spec[name].granularity
            row = _take(views[name], (bidx, slice(None), pos // gran))
            _put(p, (blk, slice(None), (pos % bs) // gran), row)
        return pages
