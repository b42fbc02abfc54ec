"""GQA attention with pluggable sparse decode backends.

Port of ``repro.models.attention`` for global and sliding-window (local)
attention layers.

Training/prefill over a whole prompt: causal attention through
``kernels/flash_prefill`` (the JAX package names its Pallas
``flash_prefill`` kernel as this attention's TPU fast path): the CUDA
kernel on the card, its plain version, query-chunked by
``cfg.attn_q_chunk``, on CPU tensors.  Local layers pass the sliding
window to it, and ``cfg.attn_logit_softcap`` its score cap.  The
prefix-extension chunks of the chunked prefill attend with the plain
masked softmax of :func:`_attn_chunk` (the TPU kernel computes no such
chunk either).

Decode: global layers own no backend logic; every decode backend is one
module in :mod:`repro_torch.models.backends`, reached through a
:class:`~repro_torch.models.backends.ContiguousView` over the layer's
``(B, KVH, N, ...)`` cache, or a
:class:`~repro_torch.models.backends.PagedView` over the continuous
engine's page pool when block tables are given.  The view writes the new
token's row in place.

Chunked prefill (:func:`attention_prefill_chunk`): one prompt chunk
writes its K/V and backend metadata straight into the pool, then
attends causally over the request's logical view.  Local layers attend
over the pre-write ring plus the in-chunk K/V under the window mask,
then write the chunk's real rows into the ring.

Local layers decode from a ring of ``window`` slots: a contiguous
``(B, KVH, cap, hd)`` ring on the static path, and on the continuous
engine the circular page list of a
:class:`~repro_torch.models.backends.RingView` — attended with a plain
masked softmax, or with ``cfg.use_ring_kernel`` by the fused CUDA ring
kernel (``kernels/paged_attention/paged_ring.cu``) straight from the
pool.  The continuous engine's legacy whole-prompt prefill builds the
ring at the pool's page-aligned capacity (``attention_prefill(...,
paged=True)``), at each prompt's last real token.

K/V are stored at ``serving.kv_dtype`` everywhere (static caches, pool
pages and rings): int8/fp8 rows are quantized on write with per-row
scales and dequantized where they are read — the chunk prefill attends
over the dequantized pool rows, its own just-committed rows included, as
the JAX package does; the fused kernels dequantize in-register.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.models import backends
from repro_torch.models.layers import (apply_rope, init_rmsnorm, normal,
                                       rmsnorm, softcap)

__all__ = ["init_attention", "attention_train", "attention_prefill",
           "attention_prefill_chunk", "attention_decode",
           "init_attention_cache"]

NEG_INF = -1e30


def _window(cfg: ModelConfig, attn_type: str) -> Optional[int]:
    """The sliding window of a layer (None for global attention)."""
    if attn_type not in ("global", "local"):
        raise ValueError(f"unknown attn_type {attn_type!r}")
    return cfg.sliding_window if attn_type == "local" else None


# ------------------------------------------------------------------ init

def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    s = 1.0 / math.sqrt(d)
    params = {
        "wq": normal(gen, (d, h, hd), s, cfg.param_dtype),
        "wk": normal(gen, (d, kv, hd), s, cfg.param_dtype),
        "wv": normal(gen, (d, kv, hd), s, cfg.param_dtype),
        "wo": normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd),
                     cfg.param_dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = init_rmsnorm(hd, gen.device)
        params["k_norm"] = init_rmsnorm(hd, gen.device)
    # SOCKET hyperplanes (Algorithm 1): data-agnostic, never trained.
    sset = cfg.socket
    params["hash_w"] = normal(gen, (sset.num_tables, sset.num_planes, hd),
                              1.0, "float32")
    return params


# ------------------------------------------------------------- projections

def _project_qkv(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, T, d) -> q (B, T, H, hd), k/v (B, T, KV, hd)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = x.to(cdt)
    b, t, d = x.shape

    def proj(w):
        return (x @ w.to(cdt).reshape(d, -1)).reshape(b, t, w.shape[1],
                                                     w.shape[2])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _merge_heads(cfg: ModelConfig, params: Dict, ctx: torch.Tensor
                 ) -> torch.Tensor:
    """ctx (B, T, H, hd) -> (B, T, d)."""
    cdt = getattr(torch, cfg.compute_dtype)
    b, t, h, hd = ctx.shape
    return ctx.to(cdt).reshape(b, t, h * hd) @ \
        params["wo"].to(cdt).reshape(h * hd, -1)


# ------------------------------------------------------------------ train

def _attn_chunk(cfg: ModelConfig, qg: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, q_offset: int, scale: float,
                window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of a block of queries against the full K/V, within
    ``window`` tokens when one is given (local layers), as a plain masked
    softmax with the config's logit softcap: the prefix-extension chunks
    of :func:`attention_prefill_chunk`.

    qg (B, cq, KV, G, hd); k/v (B, S, KV, hd) -> (B, cq, KV, G, hd).
    """
    b, cq, kv, g, hd = qg.shape
    s = k.shape[1]
    q = qg.float().permute(0, 2, 3, 1, 4).reshape(b, kv, g * cq, hd)
    kt = k.float().permute(0, 2, 3, 1)                  # (B, KV, hd, S)
    logits = (q @ kt).reshape(b, kv, g, cq, s) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    ti = q_offset + torch.arange(cq, device=qg.device)[:, None]
    si = torch.arange(s, device=qg.device)[None, :]
    mask = si <= ti
    if window is not None:
        mask &= (ti - si) < window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).reshape(b, kv, g * cq, s)
    ctx = w @ v.float().permute(0, 2, 1, 3)             # (B, KV, G*cq, hd)
    return ctx.reshape(b, kv, g, cq, hd).permute(0, 3, 1, 2, 4)


def _attend_prompt(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, dtype: torch.dtype,
                   window: Optional[int]) -> torch.Tensor:
    """Causal (sliding-window when ``window`` is given) attention over a
    whole prompt's projected q (B, T, H, hd) and k/v (B, T, KV, hd).

    Heads are flattened to the kernel's rows, q to ``b*H + h`` and k/v to
    ``b*KV + kv``; with ``h = kv*G + g`` (the grouped order of
    ``q.reshape(b, t, kv, g, hd)``) q row ``bh`` reads k/v row ``bh //
    G``.  ``flash_prefill`` launches the CUDA kernel for CUDA tensors and
    runs its plain version, in query chunks of ``cfg.attn_q_chunk``, for
    CPU ones."""
    b, t, h, hd = q.shape

    def rows(x):
        return x.permute(0, 2, 1, 3).reshape(-1, t, hd)

    ctx = fp_ops.flash_prefill(rows(q), rows(k), rows(v),
                               scale=1.0 / math.sqrt(cfg.head_dim),
                               window=window or 0,
                               softcap=cfg.attn_logit_softcap,
                               q_chunk=cfg.attn_q_chunk)
    return ctx.reshape(b, h, t, hd).transpose(1, 2).to(dtype)


def attention_train(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                    positions: torch.Tensor, attn_type: str) -> torch.Tensor:
    """Dense causal (optionally sliding-window) attention.  x: (B, T, d);
    positions: (B, T)."""
    window = _window(cfg, attn_type)
    q, k, v = _project_qkv(cfg, params, x, positions)
    return _merge_heads(cfg, params,
                        _attend_prompt(cfg, q, k, v, x.dtype, window))


# ------------------------------------------------------------------ cache

def init_attention_cache(cfg: ModelConfig, batch: int, capacity: int,
                         attn_type: str, dtype=None, device="cpu",
                         ring_capacity: Optional[int] = None) -> Dict:
    """Allocate one layer's decode cache (zeros).  Local layers get a ring
    of ``min(capacity, window)`` K/V slots, or ``ring_capacity`` (the pool
    layout's ``block_size``-row pages)."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    if _window(cfg, attn_type) is not None:
        cap = ring_capacity if ring_capacity is not None else \
            min(capacity, cfg.sliding_window)
        return {name: torch.full((batch, cfg.num_kv_heads, cap, *s.suffix),
                                 s.fill, dtype=s.leaf_dtype(dtype),
                                 device=device)
                for name, s in backends.kv_leaf_specs(cfg).items()}
    backend = backends.get_backend(cfg.attention_backend)
    return backend.init_cache(cfg, batch, cfg.num_kv_heads, capacity, dtype,
                              device)


# ---------------------------------------------------------------- prefill

def attention_prefill(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                      positions: torch.Tensor, attn_type: str,
                      capacity: int, last_index=None,
                      paged: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt + build this layer's decode cache; the
    output matches :func:`attention_train` (the projections are computed
    once and shared, where the JAX package recomputes them).

    Local layers build the contiguous ring of ``min(capacity, window)``
    slots, or with ``paged`` of the pool's page-aligned
    ``cfg.ring_geometry()`` capacity, so it scatters 1:1 into pool
    pages: slot ``s`` holds the newest prompt position ``p ≡ s (mod
    cap)`` up to ``last_index``, a ``(B,)`` tensor of each row's last
    *real* position (bucket-padded prompts; the last position when
    None)."""
    window = _window(cfg, attn_type)
    q, k, v = _project_qkv(cfg, params, x, positions)
    y = _merge_heads(cfg, params,
                     _attend_prompt(cfg, q, k, v, x.dtype, window))
    kc = k.transpose(1, 2)                       # (B, KV, T, hd)
    vc = v.transpose(1, 2)
    if window is not None:
        b, t = x.shape[:2]
        cap = cfg.ring_geometry()[1] if paged else min(capacity, window)
        li = torch.full((b,), t - 1, device=x.device) if last_index is None \
            else torch.as_tensor(last_index, device=x.device).long()
        sl = torch.arange(cap, device=x.device)
        ring_pos = li[:, None] - torch.remainder(li[:, None] - sl, cap)
        valid = (ring_pos >= 0)[:, None, :, None]            # (B, 1, cap, 1)
        idx = ring_pos.clamp(0, t - 1)[:, None, :, None].expand(
            b, kc.shape[1], cap, kc.shape[3])
        return y, backends.quantize_kv(
            cfg, torch.where(valid, kc.gather(2, idx), 0),
            torch.where(valid, vc.gather(2, idx), 0))
    cache = init_attention_cache(cfg, x.shape[0], capacity, attn_type,
                                 dtype=kc.dtype, device=x.device)
    backend = backends.get_backend(cfg.attention_backend)
    return y, backend.prefill_build(cfg, params, cache, kc, vc)


def attention_prefill_chunk(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                            positions: torch.Tensor, attn_type: str,
                            cache: Dict, bt_row: torch.Tensor, history: int,
                            last_index: int) -> Tuple[torch.Tensor, Dict]:
    """One **prefix-extension** prefill chunk straight against the pool.

    ``x`` is ``(1, C, d)``, ``positions`` the absolute positions
    ``history + [0, C)``, ``cache`` this layer's *pool* leaves (written in
    place), ``bt_row`` the request's trash-padded block-id row,
    ``history`` the prompt tokens committed by earlier chunks and
    ``last_index`` the last *real* in-chunk index (the final chunk is
    padded to C).

    The chunk's K/V and backend metadata are built on a chunk-sized mini
    cache by the backend's own ``prefill_build`` and committed row by row
    (padding rows go to the trash page); then the chunk attends causally
    over the paged logical view, whose ``si <= ti`` mask covers the
    earlier chunks' pages and in-chunk causality alike.  The view is cut
    at the chunk's end: rows past it are masked for every query anyway.

    Local layers attend over the pre-write ring (history) plus the
    in-chunk K/V under the window mask, then write the chunk's real rows
    into the ring in token order with the page-opening scrub; padded rows
    go to the trash page, so ring slots only ever hold positions the
    decode-side ring arithmetic can reconstruct.
    """
    window = _window(cfg, attn_type)
    b, t, _ = x.shape
    hd = cfg.head_dim
    kv = params["wk"].shape[1]
    g = params["wq"].shape[1] // kv
    scale = 1.0 / math.sqrt(hd)
    q, k, v = _project_qkv(cfg, params, x, positions)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)     # (B, KV, C, hd)
    if window is not None:
        ctx = _prefill_chunk_ring(cfg, q.reshape(b, t, kv, g, hd), kc, vc,
                                  cache, bt_row, history, last_index, scale)
        return _merge_heads(cfg, params,
                            ctx.reshape(b, t, kv * g, hd).to(x.dtype)), cache
    bs = cfg.serving.block_size
    backend = backends.get_backend(cfg.attention_backend)
    mini = backend.init_cache(cfg, b, kv, t, getattr(torch, cfg.compute_dtype),
                              x.device)
    mini = backend.prefill_build(cfg, params, mini, kc, vc)
    spec = backend.cache_spec(cfg)
    for name in cache:
        if spec[name].granularity == 1:
            backends.write_chunk_rows(cache[name], mini[name], bt_row,
                                      history, last_index)
        else:
            backends.write_chunk_blocks(cache[name], mini[name], bt_row,
                                        history // bs)
    # the chunk attends over the pool rows as stored (dequantized), its
    # own just-committed rows included
    nblk = -(-(history + t) // bs)
    view = backends.PagedView(cache, spec, bt_row[None, :nblk], bs)
    k_full = backends.dequant_leaf(cfg, view, "k")
    v_full = backends.dequant_leaf(cfg, view, "v")
    ctx = _attn_chunk(cfg, q.reshape(b, t, kv, g, hd),
                      k_full.transpose(1, 2), v_full.transpose(1, 2),
                      history, scale)
    ctx = ctx.reshape(b, t, kv * g, hd)
    return _merge_heads(cfg, params, ctx.to(x.dtype)), cache


def _prefill_chunk_ring(cfg: ModelConfig, qg: torch.Tensor,
                        kc: torch.Tensor, vc: torch.Tensor, cache: Dict,
                        bt_row: torch.Tensor, history: int, last_index: int,
                        scale: float) -> torch.Tensor:
    """A local layer's share of one prefill chunk (see
    :func:`attention_prefill_chunk`).  qg (1, C, KV, G, hd); kc/vc (1, KV,
    C, hd).  Returns ctx (1, C, KV, G, hd); the ring pages of ``cache``
    are written in place."""
    t = qg.shape[1]
    rb, cap = cfg.ring_geometry()
    w = cfg.sliding_window
    dev = qg.device
    # the ring as of position history-1: slot s holds the newest committed
    # position p ≡ s (mod cap); slots never written (or out of the window)
    # mask out.  Gathered (and dequantized) BEFORE the chunk writes, so
    # early chunk queries still see positions a later in-chunk token
    # recycles.
    view = backends.RingView(cache, backends.kv_leaf_specs(cfg),
                             bt_row[None], cfg.serving.block_size, rb, w)
    ring_k = backends.dequant_leaf(cfg, view, "k")
    ring_v = backends.dequant_leaf(cfg, view, "v")
    sl = torch.arange(cap, device=dev)
    lp = int(history) - 1
    rp = lp - torch.remainder(lp - sl, cap)                     # (cap,)
    ti = int(history) + torch.arange(t, device=dev)             # (t,)
    ring_mask = (rp[None, :] >= 0) & (ti[:, None] - rp[None, :] < w)
    ij = torch.arange(t, device=dev)
    in_mask = (ij[None, :] <= ij[:, None]) & (ij[:, None] - ij[None, :] < w)
    k_all = torch.cat([ring_k, kc], dim=2).float()      # (1, KV, cap+C, hd)
    v_all = torch.cat([ring_v, vc], dim=2).float()
    logits = torch.einsum("btkgd,bknd->bkgtn", qg.float(), k_all) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    mask = torch.cat([ring_mask, in_mask], dim=1)             # (t, cap+C)
    logits = torch.where(mask, logits, NEG_INF)
    ctx = torch.einsum("bkgtn,bknd->btkgd", torch.softmax(logits, dim=-1),
                       v_all)
    for name, val in backends.quantize_kv(cfg, kc, vc).items():
        backends.ring_write_chunk(cache[name], val, bt_row, history,
                                  last_index,
                                  block_size=cfg.serving.block_size,
                                  ring_blocks=rb, window=w)
    return ctx


# ----------------------------------------------------------------- decode

def attention_decode(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                     cache: Dict, pos, attn_type: str,
                     block_tables: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  x: (B, 1, d); pos: int (lockstep batch) or a
    ``(B,)`` tensor of per-request positions.

    ``block_tables``: when given (``(B, blocks_per_seq)`` physical block
    ids), ``cache`` is the serving engine's **page pool** — the backend
    appends and attends through a
    :class:`~repro_torch.models.backends.PagedView`, so paged-capable
    backends never materialize the per-request K/V view.

    Local layers write and attend their ring: the contiguous ring of the
    static path (``block_tables`` None), or the pool's circular page list
    through a :class:`~repro_torch.models.backends.RingView`, attended by
    the plain masked softmax or, with ``cfg.use_ring_kernel``, by the
    fused ring kernel.

    The cache (or pool) is updated in place and returned.  Returns
    (y (B, 1, d), cache)."""
    window = _window(cfg, attn_type)
    b = x.shape[0]
    hd = cfg.head_dim
    h, kv = params["wq"].shape[1], params["wk"].shape[1]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.reshape(b, 1).to(device=x.device, dtype=torch.int64)
    else:
        positions = torch.full((b, 1), int(pos), dtype=torch.int64,
                               device=x.device)
    q, k_new, v_new = _project_qkv(cfg, params, x, positions)
    qg = q.reshape(b, 1, kv, g, hd).permute(0, 2, 3, 1, 4)   # (B,KV,G,1,hd)
    if window is not None:
        ctx = _decode_ring(cfg, qg, k_new[:, 0], v_new[:, 0], cache, pos,
                           block_tables, scale)
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
        return _merge_heads(cfg, params, ctx.to(x.dtype)), cache
    backend = backends.get_backend(cfg.attention_backend)
    spec = backend.cache_spec(cfg)
    if block_tables is None:
        view = backends.ContiguousView(cache, spec)
    else:
        view = backends.PagedView(cache, spec, block_tables,
                                  cfg.serving.block_size)
    backend.append(cfg, params, view, k_new.transpose(1, 2),
                   v_new.transpose(1, 2), pos)
    ctx = backend.attend(cfg, params, qg, view, length=pos + 1, scale=scale)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    return _merge_heads(cfg, params, ctx.to(x.dtype)), view.arrays


def _decode_ring(cfg: ModelConfig, qg: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, cache: Dict, pos, block_tables,
                 scale: float) -> torch.Tensor:
    """A local layer's decode step (see :func:`attention_decode`): write
    the token's K/V ``(B, KV, hd)`` into its ring slot, then attend over
    the ring.  qg (B, KV, G, 1, hd) -> ctx (B, KV, G, 1, hd) f32."""
    w = cfg.sliding_window
    if block_tables is None:
        cap = cache["k"].shape[2]
        view = backends.ContiguousView(cache, backends.kv_leaf_specs(cfg))
        slot = pos % cap
    else:
        rb, cap = cfg.ring_geometry()
        view = backends.RingView(cache, backends.kv_leaf_specs(cfg),
                                 block_tables, cfg.serving.block_size, rb, w)
        slot = pos
    backends.write_token_kv(cfg, view, slot, k_new, v_new)
    if block_tables is not None and cfg.use_ring_kernel:
        from repro_torch.kernels.paged_attention import ops as pa_ops
        return pa_ops.paged_ring_attend(
            qg, cache["k"], cache["v"], block_tables[:, :rb], pos=pos,
            window=w, softcap=cfg.attn_logit_softcap, scale=scale,
            k_scale=backends.kv_scales_of(cache, "k"),
            v_scale=backends.kv_scales_of(cache, "v"))
    # ring-slot absolute positions; the window bound is a no-op when cap
    # <= window (static path) but trims page-aligned rings that hold
    # slightly more than a window
    sl = torch.arange(cap, device=qg.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos_b = pos.to(qg.device).long()[:, None]                # (B, 1)
    else:
        pos_b = torch.full((1, 1), int(pos), device=qg.device)
    ring_pos = pos_b - torch.remainder(pos_b - sl, cap)           # (B|1, cap)
    valid = (ring_pos >= 0) & (pos_b - ring_pos < w)
    logits = torch.einsum("bkgtd,bknd->bkgtn", qg.float(),
                          backends.dequant_leaf(cfg, view, "k").float()
                          ) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    return torch.einsum("bkgtn,bknd->bkgtd", torch.softmax(logits, dim=-1),
                        backends.dequant_leaf(cfg, view, "v").float())
