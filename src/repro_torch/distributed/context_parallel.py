"""Context-parallel decode: sequence-sharded KV + distributed merge.

Port of ``repro.distributed.context_parallel`` (the SOCKET route), and
the routes of the other backends (below).  For ``long_500k`` (batch
1, a 524288-token cache) the KV cache and the SOCKET side-cache shard
their *sequence* axis over ranks, one process a rank, each holding only
its rows ``[lo, lo + n_l)`` of every global layer's contiguous cache.  One
decode-attention step on a rank:

  1. score its local keys (packed bits -> soft-collision scores; the
     ``socket_score`` kernel when ``use_score_kernel``);
  2. local value-aware top-k_local, ``k_local = max(min_k, ceil(k /
     shards))`` with ``k = topk_budget`` of the *global* length;
  3. exact attention over the local selection with *unnormalised*
     online-softmax partials (m_i, l_i, o_i);
  4. the merge over the ranks' process group: one ``all_reduce`` MAX and
     two SUMs,
        m* = max m_i;  l* = Σ l_i e^{m_i - m*};  o* = Σ o_i e^{m_i - m*}/l*

Communication a step is shards x G x (hd + 2) floats, whatever the
context length.  Sink and window forcing use global positions, so only
the rank holding the prefix forces sinks and only the rank holding
``length`` forces the trailing window.  Masked logits are ``-1e30`` and
``l`` is floored at ``1e-30``, so a rank with no valid row gives ``w = 0``
in the merge, never NaN.  As in the JAX package the route ignores the
ragged budget and the selection probe, and ``selection="qhead"`` sums
scores over the group (kvhead selection).

Under gloo (every rank on ``cuda:0``) the all-reduces and the gathers
of CUDA tensors go card to card through the ranks' mailboxes
(``distributed/collectives.py``'s :func:`comm_route`); NCCL moves them
on the device.

**The other backends** (``dense``, ``hard_lsh``, ``quest``), where the
JAX package hands the sharded arrays to XLA's partitioner, so their
result is the global route's; each rank computes it from its block
(:class:`Frame`, built by :func:`frame`):

* ``hard_lsh``: a rank scores its rows (hard collision counts summed over
  the group) and computes their value-aware values at global positions
  (``core/socket.py::value_aware_scores``); the ``(B, KVH, N / shards)``
  f32 blocks are gathered into ``(B, KVH, N)`` (:meth:`Frame.gather`)
  and every rank runs the global route's stable sort and budget mask
  (``top_of_scores``);
* ``quest``: a rank scores its own pages at global page starts
  (``baselines/quest.py::group_page_scores``), the page scores are
  gathered and every rank runs the global page top-k and expansion
  (``select_pages``);

so the selection is the global route's bit for bit (each value reads
its own row, and one sort runs on the same values), for a scalar or a
ragged ``(B,)`` length and a per-request budget alike.  A rank then
attends the selected rows it holds (:meth:`Frame.owned`: the rest
masked) through ``flash_decode`` with its softmax partials where
``use_flash_decode`` (else :func:`partials`), and the ranks' partials
are merged (:meth:`Frame.merge`: :func:`merge_partials`).  ``dense``:
:func:`partials` over a rank's valid rows, then the same merge.  Quest
needs ``page_size`` to divide a rank's rows (:meth:`CacheShard.rows`
raises otherwise); the JAX partitioner has no such limit.

Hybrid models decode under the same mesh: only their global layers are
sharded; local rings, Mamba states and MoE layers are computed whole on
every rank, each rank running the whole prefill.

:func:`context_parallel_socket_attend_ref` is the plain single-process
version: the whole cache, the shards looped in order, the merge in closed
form; the tests and ``chip_smoke.py`` hold the route to it, and the model
path never calls it.

:func:`cache_shard` is this rank's block of a global layer's cache under
an active mesh and ``cfg.decode_cp_axes`` (``models/attention.py``
allocates, writes and views only that block); :func:`gather_cache`
rebuilds the whole cache on every rank (the ragged-length fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import socket as sk
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import all_gather as _all_gather
from repro_torch.distributed.collectives import all_reduce as _all_reduce
from repro_torch.distributed.collectives import comm_route

__all__ = ["context_parallel_socket_attend",
           "context_parallel_socket_attend_ref", "merge_partials",
           "merge_partials_ref", "local_scores", "local_select",
           "local_partials", "partials", "local_budget", "shard_lo",
           "comm_route", "cp_mesh", "Frame", "frame", "CacheShard",
           "cache_shard", "gather_cache", "MASKED_LOGIT", "L_FLOOR"]

MASKED_LOGIT = -1e30     # a masked logit (JAX's constant), never -inf
L_FLOOR = 1e-30          # the softmax normalizer's floor


# ----------------------------------------------------------------- merges

def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   group) -> torch.Tensor:
    """Merge per-rank online-softmax partials over ``group``.

    m: (..., 1) row max; l: (..., 1) normalizer; o: (..., hd) value
    accumulation already divided by the local l (re-multiplied here).
    One ``all_reduce`` MAX and two SUMs (2·G·(hd+2) floats a step).
    """
    m_star = _all_reduce(m, dist.ReduceOp.MAX, group)
    w = l * torch.exp(m - m_star)
    l_star = _all_reduce(w, dist.ReduceOp.SUM, group)
    o_star = _all_reduce(o * w, dist.ReduceOp.SUM, group)
    return o_star / torch.clamp(l_star, min=L_FLOOR)


def merge_partials_ref(parts) -> torch.Tensor:
    """The merge of :func:`merge_partials` in closed form over a list of
    ``(m, l, o)`` partials, summed in list order."""
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    l_star = torch.zeros_like(m_star)
    o_star = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = l * torch.exp(m - m_star)
        l_star = l_star + w
        o_star = o_star + o * w
    return o_star / torch.clamp(l_star, min=L_FLOOR)


# ------------------------------------------------------------ local steps

def shard_lo(mesh, seq_axes: Sequence[str], n_l: int) -> int:
    """The global index of this rank's first row: its row-major index
    along ``seq_axes`` (in that order) times its row count."""
    return mesh.index(seq_axes) * n_l


def local_budget(cfg: sk.SocketConfig, n: int, shards: int) -> int:
    """``k_local = max(min_k, ceil(k / shards))`` with ``k`` the budget of
    the global length ``n``."""
    return max(cfg.min_k, -(-sk.topk_budget(cfg, n) // shards))


def local_scores(cfg: sk.SocketConfig, w_hash: torch.Tensor,
                 q: torch.Tensor, bits: torch.Tensor, *,
                 use_score_kernel: bool = False) -> torch.Tensor:
    """Scores ``(B, KVH, Nl)`` of a rank's keys: pooled hashes the group
    mean query once, else every q head's scores are summed over the group
    (kvhead selection; ``qhead`` too, as the JAX package does here)."""
    if cfg.selection == "pooled":
        u = sk.soft_hash_query(w_hash, torch.mean(q[..., 0, :], dim=2))
    else:
        u = sk.soft_hash_query(w_hash, q[..., 0, :])   # (B,KVH,G,L,P)
    if use_score_kernel:
        from repro_torch.kernels.socket_score import ops as score_ops
        u_k = u[:, :, None] if cfg.selection == "pooled" else u
        return score_ops.socket_score(
            bits, u_k, vnorm=None, num_tables=cfg.num_tables,
            num_planes=cfg.num_planes, tau=cfg.tau)    # (B,KVH,Nl) G-sum
    if cfg.selection == "pooled":
        return sk.soft_scores_factorized(cfg, bits, u)
    return torch.sum(sk.soft_scores_factorized(cfg, bits[:, :, None], u),
                     dim=2)


def local_select(cfg: sk.SocketConfig, scores: torch.Tensor,
                 vnorm: torch.Tensor, lo: int, global_length,
                 k_budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's value-aware top-``k_budget`` over its rows (global
    positions ``lo + j``): sinks and the trailing window forced in at
    FLT_MAX, rows at or past ``global_length`` masked.  Ties keep the
    lowest index first, as ``jax.lax.top_k``.  Returns (idx, sel_mask)
    ``(B, KVH, k_budget)``; raises where ``k_budget`` exceeds the rows,
    as ``jax.lax.top_k`` does."""
    n_loc = scores.shape[-1]
    if k_budget > n_loc:
        raise ValueError(f"k_local {k_budget} exceeds the shard's {n_loc} "
                         "rows (top_k needs k <= the shard's rows)")
    eff = sk.value_aware_scores(cfg, scores, vnorm,
                                length=int(global_length), lo=lo)
    return sk.top_of_scores(eff, k=k_budget)


def local_partials(q: torch.Tensor, k_loc: torch.Tensor,
                   v_loc: torch.Tensor, idx: torch.Tensor,
                   sel_mask: torch.Tensor, scale: float):
    """Partial attention over a rank's selection: q (B,KVH,G,1,hd),
    k/v (B,KVH,Nl,hd), idx/sel_mask (B,KVH,K).  Returns (m, l, o):
    (B,KVH,G,1,1), (B,KVH,G,1,1), (B,KVH,G,1,hd) float32."""
    rows = idx[..., None].expand(*idx.shape, k_loc.shape[-1])
    return partials(q, torch.gather(k_loc, 2, rows),
                    torch.gather(v_loc, 2, rows), sel_mask, scale)


def partials(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
             keep: torch.Tensor, scale: float):
    """Plain partial attention of q (B,KVH,G,1,hd) over rows k/v
    (B,KVH,K,hd), those where ``keep`` (B|1, KVH|1, K) holds.  Returns
    (m, l, o) as :func:`local_partials`."""
    keep = keep[:, :, None, None, :]
    logits = torch.einsum("bhgtd,bhkd->bhgtk", q.float(),
                          k_sel.float()) * scale
    logits = torch.where(keep, logits, MASKED_LOGIT)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(logits - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgtk,bhkd->bhgtd", p, v_sel.float())
    return m, l, o / torch.clamp(l, min=L_FLOOR)


def _local_attend(cfg, w_hash, q, k_loc, v_loc, bits, vnorm, lo,
                  global_length, k_budget, scale, use_score_kernel):
    """Score + top-k + partial attention over one shard's keys."""
    scores = local_scores(cfg, w_hash, q, bits,
                          use_score_kernel=use_score_kernel)
    idx, sel_mask = local_select(cfg, scores, vnorm, lo, global_length,
                                 k_budget)
    return local_partials(q, k_loc, v_loc, idx, sel_mask, scale)


# ------------------------------------------------------------ entry points

def _axes_of(mesh, seq_axes, batch_axes):
    seq_axes = tuple(a for a in seq_axes if a in mesh.shape)
    batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
    if not seq_axes:
        raise ValueError(f"no context-parallel axis of {seq_axes} in the "
                         f"mesh's {tuple(mesh.shape)}")
    if set(seq_axes) & set(batch_axes):
        raise ValueError(f"mesh axes {sorted(set(seq_axes) & set(batch_axes))}"
                         " shard both the sequence and the batch")
    return seq_axes, batch_axes


def context_parallel_socket_attend(
        cfg: sk.SocketConfig, mesh, seq_axes: Tuple[str, ...],
        w_hash: torch.Tensor, q: torch.Tensor, k_cache: torch.Tensor,
        v_cache: torch.Tensor, bits: torch.Tensor, vnorm: torch.Tensor,
        *, length, scale: float, batch_axes: Tuple[str, ...] = (),
        use_score_kernel: bool = False) -> torch.Tensor:
    """SOCKET decode attention with the cache's sequence axis sharded
    over ``seq_axes`` (e.g. ("data",), ("model",) or ("data", "model")),
    and the batch axis optionally over ``batch_axes``; called by every
    rank of ``mesh`` together.

    ``q`` (B, KVH, G, 1, hd) is replicated (the whole batch); ``k_cache``
    / ``v_cache`` (B_l, KVH, N_l, hd), ``bits`` (B_l, KVH, N_l, W) and
    ``vnorm`` (B_l, KVH, N_l) are this rank's block: batch rows
    ``[b_lo, b_lo + B_l)`` by its index along ``batch_axes``, cache rows
    ``[lo, lo + N_l)`` by its index along ``seq_axes``.  ``length`` is the
    scalar global length.  Returns the whole batch's output, replicated.
    """
    seq_axes, batch_axes = _axes_of(mesh, seq_axes, batch_axes)
    shards = mesh.extent(seq_axes)
    n_l = k_cache.shape[2]
    k_local = local_budget(cfg, n_l * shards, shards)
    b_l = k_cache.shape[0]
    if q.shape[0] != b_l * mesh.extent(batch_axes):
        raise ValueError(f"q's batch {q.shape[0]} vs {b_l} rows on each of "
                         f"{mesh.extent(batch_axes)} batch shards")
    b_lo = mesh.index(batch_axes) * b_l
    q_l = q[b_lo:b_lo + b_l]
    m, l, o = _local_attend(cfg, w_hash, q_l, k_cache.to(q.dtype),
                            v_cache.to(q.dtype), bits, vnorm,
                            shard_lo(mesh, seq_axes, n_l), length, k_local,
                            scale, use_score_kernel)
    out = merge_partials(m, l, o, mesh.group(seq_axes)).to(q.dtype)
    return _all_gather(out, mesh, batch_axes, 0)


def context_parallel_socket_attend_ref(
        cfg: sk.SocketConfig, shards: int, w_hash: torch.Tensor,
        q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        bits: torch.Tensor, vnorm: torch.Tensor, *, length, scale: float,
        use_score_kernel: bool = False) -> torch.Tensor:
    """The plain single-process version of
    :func:`context_parallel_socket_attend`: the whole cache (B, KVH, N,
    ·), cut into ``shards`` blocks of N / shards rows, each attended as
    its rank would, in order, and merged in closed form."""
    n = k_cache.shape[2]
    if n % shards:
        raise ValueError(f"{n} cache rows do not split into {shards} shards")
    n_l = n // shards
    k_local = local_budget(cfg, n, shards)
    k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    parts = []
    for i in range(shards):
        rows = slice(i * n_l, (i + 1) * n_l)
        parts.append(_local_attend(
            cfg, w_hash, q, k_cache[:, :, rows], v_cache[:, :, rows],
            bits[:, :, rows], vnorm[:, :, rows], i * n_l, length, k_local,
            scale, use_score_kernel))
    return merge_partials_ref(parts).to(q.dtype)


# -------------------------------------------------------------- the model

def cp_mesh(cfg):
    """The active mesh when ``cfg.decode_cp_axes`` names one of its axes,
    else None."""
    if not cfg.decode_cp_axes:
        return None
    mesh = shd.current_mesh()
    if mesh is None or not any(a in mesh.shape for a in cfg.decode_cp_axes):
        return None
    return mesh


@dataclasses.dataclass(frozen=True)
class Frame:
    """One global layer's decode step on this rank under a CP mesh: the
    mesh, its CP and batch axes, and this rank's block of the cache,
    ``n_l`` rows (global rows ``[lo, lo + n_l)`` of ``n``) of ``b_l``
    batch rows (``[b_lo, b_lo + b_l)`` of the whole batch)."""

    mesh: object
    seq_axes: Tuple[str, ...]
    batch_axes: Tuple[str, ...]
    n_l: int
    b_l: int

    @property
    def n(self) -> int:
        return self.n_l * self.mesh.extent(self.seq_axes)

    @property
    def lo(self) -> int:
        return shard_lo(self.mesh, self.seq_axes, self.n_l)

    def local(self, x):
        """This rank's batch rows of a whole-batch tensor (the query, a
        ``(B,)`` length); a scalar passes through."""
        if isinstance(x, torch.Tensor) and x.ndim:
            b_lo = self.mesh.index(self.batch_axes) * self.b_l
            return x[b_lo:b_lo + self.b_l]
        return x

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The ranks' ``(B_l, KVH, ·)`` blocks of per-row (or per-page)
        values put together along the last axis in rank order (one
        ``all_gather`` over the CP axes), bit for bit."""
        return _all_gather(block, self.mesh, self.seq_axes, block.ndim - 1)

    def owned(self, idx: torch.Tensor, sel_mask: torch.Tensor):
        """The selection's global rows ``idx`` that this rank holds: (their
        local rows, 0 where it does not hold them; the mask of those it
        holds and the selection keeps)."""
        loc = idx - self.lo
        own = sel_mask & (loc >= 0) & (loc < self.n_l)
        return torch.where(own, loc, 0), own

    def merge(self, m, l, o, dtype) -> torch.Tensor:
        """The ranks' partials merged (:func:`merge_partials`), then the
        whole batch gathered over the batch axes."""
        out = merge_partials(m, l, o, self.mesh.group(self.seq_axes))
        return _all_gather(out.to(dtype), self.mesh, self.batch_axes, 0)


def frame(cfg, view) -> Optional[Frame]:
    """This rank's :class:`Frame` for a global layer's contiguous
    ``view`` (a ``ContiguousView`` of its block) under an active mesh
    whose axes ``cfg.decode_cp_axes`` names; else None."""
    mesh = cp_mesh(cfg)
    if mesh is None:
        return None
    seq, batch = _axes_of(mesh, cfg.decode_cp_axes,
                          cfg.decode_cp_batch_axes)
    k = view.arrays["k"]
    return Frame(mesh, seq, batch, k.shape[2], k.shape[0])


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """This rank's block of a global layer's contiguous cache: its index
    along the CP axes (of ``seq_shards``) and along the batch axes (of
    ``batch_shards``)."""

    seq_shards: int
    seq_index: int
    batch_shards: int = 1
    batch_index: int = 0

    def rows(self, capacity: int, page: int = 1) -> int:
        """A rank's cache rows; raises unless they are whole pages of
        ``page`` rows (Quest's ``page_size``: a page's bounds on one
        rank)."""
        if capacity % self.seq_shards:
            raise ValueError(f"capacity {capacity} does not split into "
                             f"{self.seq_shards} context-parallel shards")
        rows = capacity // self.seq_shards
        if rows % page:
            raise ValueError(f"quest page_size {page} does not divide a "
                             f"rank's {rows} cache rows (capacity "
                             f"{capacity} over {self.seq_shards} "
                             "context-parallel shards)")
        return rows

    def batch_rows(self, batch: int) -> int:
        if batch % self.batch_shards:
            raise ValueError(f"batch {batch} does not split into "
                             f"{self.batch_shards} batch shards")
        return batch // self.batch_shards

    def take(self, x: torch.Tensor, capacity: int) -> torch.Tensor:
        """This rank's block of a whole-batch ``(B, KVH, T, ...)`` prompt
        tensor: its batch rows and cache rows ``[lo, lo + rows)`` (fewer,
        or none, where the prompt ends first)."""
        rows, bl = self.rows(capacity), self.batch_rows(x.shape[0])
        lo, b0 = self.seq_index * rows, self.batch_index * bl
        return x[b0:b0 + bl, :, lo:lo + rows]


def cache_shard(cfg) -> Optional[CacheShard]:
    """This rank's :class:`CacheShard` under an active mesh whose axes
    ``cfg.decode_cp_axes`` names; else None."""
    mesh = cp_mesh(cfg)
    if mesh is None:
        return None
    seq, batch = _axes_of(mesh, cfg.decode_cp_axes,
                          cfg.decode_cp_batch_axes)
    return CacheShard(mesh.extent(seq), mesh.index(seq),
                      mesh.extent(batch), mesh.index(batch))


def gather_cache(mesh, seq_axes, batch_axes,
                 arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every leaf's whole ``(B, KVH, N, ...)`` tensor from the ranks'
    blocks (collective), bit for bit."""
    seq_axes, batch_axes = _axes_of(mesh, seq_axes, batch_axes)
    out = {}
    for name in sorted(arrays):
        a = _all_gather(arrays[name], mesh, seq_axes, 2)
        out[name] = _all_gather(a, mesh, batch_axes, 0)
    return out
