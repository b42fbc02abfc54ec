"""Public wrappers of the fused paged-attention kernels.

* :func:`paged_socket_attend`   — SOCKET (``paged_attention.cu``);
* :func:`paged_hard_lsh_attend` — hard LSH (``paged_attention.cu``'s
  hard-LSH mode);
* :func:`paged_quest_attend`    — Quest (``paged_quest.cu``);
* :func:`paged_ring_attend`     — the sliding-window ring
  (``paged_ring.cu``).

Each accepts the serving engine's layouts (5-D decode query, pool
leaves, per-request block table / length / budget vectors) with the JAX
wrapper's signature (``repro.kernels.paged_attention.ops``).  On CPU
tensors it runs the plain version (:mod:`.ref`); on CUDA tensors it
launches its kernel (built on first use by
:mod:`repro_torch.kernels.build`) or raises.  ``LAUNCHES``,
``HARD_LSH_LAUNCHES``, ``QUEST_LAUNCHES`` and ``RING_LAUNCHES`` count each
kernel's launches, so a run can show that it went through the kernel.

K/V pages may be float32, bf16, int8 or ``float8_e4m3fn``, with the f32
per-row scale pools ``k_scale``/``v_scale`` ``(NB, KVH, bs)`` (both or
neither; the quantized pools of ``serving.kv_dtype`` int8/fp8): each
kernel reads a row as ``float(q) * scale[row]``, each plain version
dequantizes the logical view the same way.  A lone scale pool raises the
JAX wrappers' ``ValueError``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import socket as sk
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import (
    paged_hard_lsh_attend_ref, paged_quest_attend_ref, paged_ring_attend_ref,
    paged_socket_attend_ref)

__all__ = ["paged_socket_attend", "launch_paged_socket_attend",
           "paged_attention_plan",
           "paged_hard_lsh_attend", "launch_paged_hard_lsh_attend",
           "paged_quest_attend", "launch_paged_quest_attend",
           "paged_quest_plan",
           "paged_ring_attend", "launch_paged_ring_attend",
           "paged_ring_plan", "KV_TYPES", "Q_TYPES",
           "LAUNCHES", "HARD_LSH_LAUNCHES", "QUEST_LAUNCHES", "RING_LAUNCHES",
           "SOURCE", "QUEST_SOURCE", "RING_SOURCE"]

SOURCE = Path(__file__).with_name("paged_attention.cu")
QUEST_SOURCE = Path(__file__).with_name("paged_quest.cu")
RING_SOURCE = Path(__file__).with_name("paged_ring.cu")
LAUNCHES = 0
HARD_LSH_LAUNCHES = 0
QUEST_LAUNCHES = 0
RING_LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# the kernels' element type codes of the K/V pages (paged_common.cuh's
# KvType)
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}


def _library() -> ctypes.CDLL:
    lib = build.load_library(SOURCE)
    fn = lib.paged_socket_attend_launch
    fn.argtypes = [_P] * 15 + [_I] * 11 + [_F] * 2 + [_I] * 2 + [_P]
    fn.restype = ctypes.c_int
    fn = lib.paged_hard_lsh_attend_launch
    fn.argtypes = [_P] * 14 + [_I] * 11 + [_F] + [_I] * 2 + [_P]
    fn.restype = ctypes.c_int
    lib.paged_socket_attend_error_string.argtypes = [ctypes.c_int]
    lib.paged_socket_attend_error_string.restype = ctypes.c_char_p
    lib.paged_socket_attend_plan.argtypes = [_I] * 12 + [_P]
    lib.paged_socket_attend_plan.restype = ctypes.c_int
    return lib


def paged_attention_plan(q, k_pages, bits_pages, qhash, block_table, *,
                         hard: bool = False) -> dict:
    """How ``paged_attention.cu`` launches on these shapes (CUDA only):
    ``cluster``, the C ranks a (request, KV head) is split over (the
    largest whose B * KVH clusters the card holds at once, at most one
    rank a 512 table positions; else the fewest waves times positions a
    rank); ``smem_bytes`` a CTA; ``clusters_at_once`` at that C;
    ``stages``, the K/V chunk stages of the attend pass."""
    q, _ = _split_q(q)
    b, kvh, g, hd = q.shape
    bs, w = bits_pages.shape[2:]
    gs, l, p = qhash.shape[2:]
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(q.device):
        err = _library().paged_socket_attend_plan(
            int(hard), KV_TYPES[k_pages.dtype], b, kvh, g, gs, hd, bs, w,
            block_table.shape[1], l, p, info)
    if err != 0:
        raise RuntimeError("paged_attention plan failed: " + _library()
                           .paged_socket_attend_error_string(err).decode())
    return dict(zip(("cluster", "smem_bytes", "clusters_at_once", "stages",
                     "chunk_rows"), info))


def _quest_library() -> ctypes.CDLL:
    lib = build.load_library(QUEST_SOURCE)
    fn = lib.paged_quest_attend_launch
    fn.argtypes = [_P] * 13 + [_I] * 8 + [_F] + [_I] * 2 + [_P]
    fn.restype = ctypes.c_int
    lib.paged_quest_attend_error_string.argtypes = [ctypes.c_int]
    lib.paged_quest_attend_error_string.restype = ctypes.c_char_p
    lib.paged_quest_attend_plan.argtypes = [_I] * 8 + [_P]
    lib.paged_quest_attend_plan.restype = ctypes.c_int
    return lib


def paged_quest_plan(q, k_pages, block_table, *, page_size: int) -> dict:
    """How ``paged_quest.cu`` launches on these shapes (CUDA only):
    ``cluster``, the C ranks a (request, KV head) is split over (the
    largest whose B * KVH clusters the card holds at once, at most one
    rank a 256 table pages; else the fewest waves times pages a rank);
    ``smem_bytes`` a CTA; ``clusters_at_once`` at that C; ``stages``, the
    K/V chunk stages of the attend pass, and ``chunk_rows``, the K/V rows
    a stage holds (by hd and page type)."""
    q, _ = _split_q(q)
    b, kvh, g, hd = q.shape
    bs = k_pages.shape[2]
    info = (ctypes.c_int * 5)()
    lib = _quest_library()
    with torch.cuda.device(q.device):
        err = lib.paged_quest_attend_plan(
            KV_TYPES[k_pages.dtype], b, kvh, g, hd, bs, int(page_size),
            block_table.shape[1], info)
    if err != 0:
        raise RuntimeError("paged_quest plan failed: " +
                           lib.paged_quest_attend_error_string(err).decode())
    return dict(zip(("cluster", "smem_bytes", "clusters_at_once", "stages",
                     "chunk_rows"), info))


def _ring_library() -> ctypes.CDLL:
    lib = build.load_library(RING_SOURCE)
    fn = lib.paged_ring_attend_launch
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_F, _I, _F, _P]
    fn.restype = ctypes.c_int
    lib.paged_ring_attend_error_string.argtypes = [ctypes.c_int]
    lib.paged_ring_attend_error_string.restype = ctypes.c_char_p
    lib.paged_ring_attend_plan.argtypes = [_I] * 8 + [_P]
    lib.paged_ring_attend_plan.restype = ctypes.c_int
    return lib


def paged_ring_plan(q, k_pages, block_table, *, window: int) -> dict:
    """How ``paged_ring.cu`` launches on these shapes (CUDA only):
    ``cluster``, the C ranks a (request, KV head) is split over (the
    largest whose B * KVH clusters the card holds at once, at most one
    rank a 128 rows of the window); ``smem_bytes`` a CTA;
    ``clusters_at_once`` at that C; ``stages``, the K/V stages of its
    ring and ``stage_rows`` a stage; ``lanes_per_row``, the lanes that
    hold a K/V row in the fold, and ``heads_per_unit``, the query heads
    each of its units holds; ``row_elems``, the elements a staged K/V
    row takes (hd padded to the lanes' width)."""
    q, _ = _split_q(q)
    b, kvh, g, hd = q.shape
    info = (ctypes.c_int * 8)()
    lib = _ring_library()
    with torch.cuda.device(q.device):
        err = lib.paged_ring_attend_plan(
            KV_TYPES[k_pages.dtype], b, kvh, g, hd, k_pages.shape[2],
            block_table.shape[1], int(window), info)
    if err != 0:
        raise RuntimeError("paged_ring plan failed: " +
                           lib.paged_ring_attend_error_string(err).decode())
    return dict(zip(("cluster", "smem_bytes", "clusters_at_once", "stages",
                     "stage_rows", "lanes_per_row", "heads_per_unit",
                     "row_elems"), info))


def _outputs(q, nb: int, bs: int, n_scratch: int, with_selection: bool):
    """The output (B, KVH, G, hd) f32, the int32 (B, KVH, nb, bs) selection
    mask or None, and the kernel's f32 (B, KVH, n_scratch) score scratch
    in device memory (shared memory would cap the context near 56K
    tokens)."""
    b, kvh = q.shape[:2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    sel = (torch.empty((b, kvh, nb, bs), dtype=torch.int32, device=q.device)
           if with_selection else None)
    eff = torch.empty((b, kvh, n_scratch), dtype=torch.float32,
                      device=q.device)
    return out, sel, eff


def _call(fn, name: str, describe, tensors, *scalars) -> None:
    """Launch ``fn`` on the current stream of the tensors' device (a None
    among ``tensors`` passes a null pointer); raises with the CUDA error's
    text when the launch fails."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() if t is not None else None
                   for t in tensors], *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: " +
                           describe(err).decode())


def _paired(k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale must be given together")


def _per_request(x, b: int, dev) -> torch.Tensor:
    """An int scalar or (B,) vector as a contiguous int32 (B,) tensor."""
    return torch.as_tensor(x, device=dev).to(torch.int32).expand(
        b).contiguous()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


# the query types the wrappers take (and Quest's page bounds); the
# kernels read them as float32, as the TPU kernels cast them
# (paged_attention.py:173, paged_quest.py:70-72)
Q_TYPES = (torch.float32, torch.bfloat16)


def _check_pool(q, k_pages, v_pages, block_table, k_scale, v_scale) -> int:
    """Checks q (one of Q_TYPES), the K/V pools (one of the KV_TYPES),
    their scale pools and the table; returns the K/V element type code."""
    b, kvh, g, hd = q.shape
    nblocks, _, bs, _ = k_pages.shape
    if q.dtype not in Q_TYPES:
        raise TypeError(f"q must be one of {list(Q_TYPES)}, got {q.dtype}")
    _check("q", q, q.dtype, (b, kvh, g, hd))
    if k_pages.dtype not in KV_TYPES:
        raise TypeError(f"k_pages must be one of {list(KV_TYPES)}, got "
                        f"{k_pages.dtype}")
    _check("k_pages", k_pages, k_pages.dtype, (nblocks, kvh, bs, hd))
    _check("v_pages", v_pages, k_pages.dtype, (nblocks, kvh, bs, hd))
    _paired(k_scale, v_scale)
    if k_scale is not None:
        _check("k_scale", k_scale, torch.float32, (nblocks, kvh, bs))
        _check("v_scale", v_scale, torch.float32, (nblocks, kvh, bs))
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table shape {tuple(block_table.shape)} "
                         f"is not (B={b}, nb)")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's y limit 65535")
    if nblocks * kvh * bs >= 2 ** 31:
        raise ValueError("the kernel indexes pool rows with int32: "
                         f"{nblocks * kvh * bs} rows")
    return KV_TYPES[k_pages.dtype]


def _check_bounds(kmin_pages, kmax_pages, shape) -> None:
    """Checks Quest's page bounds: float32 or bf16 (a bf16 model's pool
    holds them in its compute dtype; the kernel reads them as float32, as
    the TPU kernel casts them, paged_quest.py:71), both of ``shape``."""
    if kmin_pages.dtype not in Q_TYPES:
        raise TypeError(f"kmin_pages must be one of {list(Q_TYPES)}, got "
                        f"{kmin_pages.dtype}")
    _check("kmin_pages", kmin_pages, kmin_pages.dtype, shape)
    _check("kmax_pages", kmax_pages, kmin_pages.dtype, shape)


def _pools(k_pages, v_pages, k_scale, v_scale):
    """The K/V pools and their scale pools (None: a null pointer) as the
    kernels take them: contiguous."""
    return [t.contiguous() if t is not None else None
            for t in (k_pages, v_pages, k_scale, v_scale)]


def _check_bits(bits_pages, vnorm_pages, qhash, num_tables: int,
                num_planes: int, g: int) -> None:
    nblocks, kvh, bs, w = bits_pages.shape
    _check("bits_pages", bits_pages, torch.int32, (nblocks, kvh, bs, w))
    _check("vnorm_pages", vnorm_pages, torch.bfloat16, (nblocks, kvh, bs))
    gs, l, p = qhash.shape[2:]
    if (l, p) != (num_tables, num_planes):
        raise ValueError(f"query hash shape {tuple(qhash.shape)} does not "
                         f"end in (L, P) = {(num_tables, num_planes)}")
    if (w * 32) % p or w * 32 < l * p:
        raise ValueError(f"packed width {w * 32} bits does not hold whole "
                         f"tables of P={p} for L={l}")
    if gs not in (1, g):
        raise ValueError(f"query hash group axis {gs} must be 1 (pooled) or "
                         f"G={g}")


def _launch_fused(hard: bool, q, k_pages, v_pages, bits_pages, vnorm_pages,
                  qhash, block_table, length, budget, k_scale, v_scale, *,
                  num_tables: int, num_planes: int, tau: float, scale: float,
                  sink_tokens: int, window_tokens: int, with_selection: bool):
    """Launch ``paged_attention.cu`` in its SOCKET mode (``qhash`` = u)
    or its hard-LSH mode (``qhash`` = u_signs)."""
    global LAUNCHES, HARD_LSH_LAUNCHES
    b, kvh, g, hd = q.shape
    w = bits_pages.shape[3]
    nb, bs = block_table.shape[1], bits_pages.shape[2]
    kv_type = _check_pool(q, k_pages, v_pages, block_table, k_scale, v_scale)
    _check_bits(bits_pages, vnorm_pages, qhash, num_tables, num_planes, g)
    gs, l, p = qhash.shape[2:]
    dev = q.device
    qhash = qhash.to(dtype=torch.float32)
    if hard:
        if p >= 32:
            raise ValueError(f"P={p} planes do not fit a 32-bit sign "
                             "pattern")
        # the kernel packs each (g, l) sign pattern itself
        hashes = [qhash.contiguous()]
    else:
        # the wrapper computes logZ (paged_attention.py:323-328); the
        # kernel scores the L real tables only
        hashes = [qhash.contiguous(),
                  sk.log_normalizer(qhash, tau).contiguous()]  # (B,KVH,GS,L)
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    length, budget = _per_request(length, b, dev), _per_request(budget, b, dev)
    out, sel, eff = _outputs(q, nb, bs, nb * bs, with_selection)
    if b * kvh and nb:
        lib = _library()
        tensors = [q.float().contiguous(),
                   *_pools(k_pages, v_pages, k_scale, v_scale),
                   bits_pages.contiguous(), vnorm_pages.contiguous(), *hashes,
                   bt, length, budget, out]
        shape = (kv_type, b, kvh, g, gs, hd, bs, w, nb, l, p)
        if hard:
            _call(lib.paged_hard_lsh_attend_launch, "paged_hard_lsh",
                  lib.paged_socket_attend_error_string, [*tensors, sel, eff],
                  *shape, float(scale), int(sink_tokens), int(window_tokens))
            HARD_LSH_LAUNCHES += 1
        else:
            _call(lib.paged_socket_attend_launch, "paged_attention",
                  lib.paged_socket_attend_error_string, [*tensors, sel, eff],
                  *shape, float(tau), float(scale), int(sink_tokens),
                  int(window_tokens))
            LAUNCHES += 1
    return (out, sel) if with_selection else out


def launch_paged_socket_attend(q, k_pages, v_pages, bits_pages, vnorm_pages,
                               u, block_table, length, budget, *,
                               num_tables: int, num_planes: int, tau: float,
                               scale: float, sink_tokens: int,
                               window_tokens: int,
                               with_selection: bool = False,
                               k_scale=None, v_scale=None):
    """Launch the CUDA kernel.  q (B, KVH, G, hd) f32 or bf16
    (read as f32); k/v pages
    (NB, KVH, bs, hd) f32, bf16, int8 or float8_e4m3fn, with f32
    (NB, KVH, bs) k/v scales or none; bits int32 (NB, KVH, bs, W); vnorm
    bf16 (NB, KVH, bs); u f32 (B, KVH, GS, L, P); block_table (B, nb);
    length, budget (B,).  Returns f32 (B, KVH, G, hd), plus the int32
    (B, KVH, nb, bs) selection mask when ``with_selection``."""
    return _launch_fused(
        False, q, k_pages, v_pages, bits_pages, vnorm_pages, u, block_table,
        length, budget, k_scale, v_scale, num_tables=num_tables,
        num_planes=num_planes,
        tau=tau, scale=scale, sink_tokens=sink_tokens,
        window_tokens=window_tokens, with_selection=with_selection)


def launch_paged_hard_lsh_attend(q, k_pages, v_pages, bits_pages,
                                 vnorm_pages, u_signs, block_table, length,
                                 budget, *, num_tables: int, num_planes: int,
                                 scale: float, sink_tokens: int,
                                 window_tokens: int,
                                 with_selection: bool = False,
                                 k_scale=None, v_scale=None):
    """Launch the CUDA kernel's hard-LSH mode.  As
    :func:`launch_paged_socket_attend`, with ``u_signs`` f32 ±1
    ``(B, KVH, GS, L, P)`` in place of ``u``: the kernel packs each (g, l)
    sign pattern (bit j set where the plane-j sign is +1), the layout of
    the key's P-bit field."""
    return _launch_fused(
        True, q, k_pages, v_pages, bits_pages, vnorm_pages, u_signs,
        block_table, length, budget, k_scale, v_scale, num_tables=num_tables,
        num_planes=num_planes, tau=1.0, scale=scale, sink_tokens=sink_tokens,
        window_tokens=window_tokens, with_selection=with_selection)


def launch_paged_quest_attend(q, k_pages, v_pages, kmin_pages, kmax_pages,
                              block_table, length, page_budget, *,
                              page_size: int, scale: float, sink_tokens: int,
                              window_tokens: int,
                              with_selection: bool = False,
                              k_scale=None, v_scale=None):
    """Launch the Quest CUDA kernel.  q (B, KVH, G, hd) f32 or bf16
    (read as f32); k/v pages
    (NB, KVH, bs, hd) and their scales as in
    :func:`launch_paged_socket_attend`; kmin/kmax f32 or bf16 (read as
    f32) (NB, KVH, bs / page_size, hd);
    block_table (B, nb); length, page_budget (B,) or scalars.  Returns f32
    (B, KVH, G, hd), plus the int32 (B, KVH, nb, bs) selected-rows mask
    when ``with_selection``."""
    global QUEST_LAUNCHES
    b, kvh, g, hd = q.shape
    nblocks, _, bs, _ = k_pages.shape
    nb = block_table.shape[1]
    if page_size < 1 or bs % page_size:
        raise ValueError(f"page_size {page_size} must divide block_size "
                         f"{bs}")
    ppb = bs // page_size
    kv_type = _check_pool(q, k_pages, v_pages, block_table, k_scale, v_scale)
    _check_bounds(kmin_pages, kmax_pages, (nblocks, kvh, ppb, hd))
    dev = q.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    length = _per_request(length, b, dev)
    budget = _per_request(page_budget, b, dev)
    # the scratch holds page scores, then selected-page flags
    out, sel, eff = _outputs(q, nb, bs, nb * ppb, with_selection)
    if b * kvh and nb:
        lib = _quest_library()
        tensors = [q.float().contiguous(),
                   *_pools(k_pages, v_pages, k_scale, v_scale),
                   kmin_pages.float().contiguous(),
                   kmax_pages.float().contiguous(), bt, length, budget, out]
        _call(lib.paged_quest_attend_launch, "paged_quest",
              lib.paged_quest_attend_error_string, [*tensors, sel, eff],
              kv_type, b, kvh, g, hd, bs, int(page_size), nb, float(scale),
              int(sink_tokens), int(window_tokens))
        QUEST_LAUNCHES += 1
    return (out, sel) if with_selection else out


def launch_paged_ring_attend(q, k_pages, v_pages, block_table, pos, *,
                             window: int, softcap: float, scale: float,
                             k_scale=None, v_scale=None):
    """Launch the ring CUDA kernel.  q (B, KVH, G, hd) f32 or bf16
    (read as f32); k/v pages
    (NB, KVH, bs, hd) and their scales as in
    :func:`launch_paged_socket_attend`; block_table (B, ring_blocks), the
    ring slice; pos (B,) or a scalar.  Returns f32 (B, KVH, G, hd)."""
    global RING_LAUNCHES
    b, kvh, g, hd = q.shape
    bs, rb = k_pages.shape[2], block_table.shape[1]
    kv_type = _check_pool(q, k_pages, v_pages, block_table, k_scale, v_scale)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dev = q.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    pos = _per_request(pos, b, dev)
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    if b * kvh and rb:
        lib = _ring_library()
        tensors = [q.float().contiguous(),
                   *_pools(k_pages, v_pages, k_scale, v_scale),
                   bt, pos, out]
        _call(lib.paged_ring_attend_launch, "paged_ring",
              lib.paged_ring_attend_error_string, tensors, kv_type, b, kvh, g,
              hd, bs, rb, float(scale), int(window), float(softcap))
        RING_LAUNCHES += 1
    return out


def _split_q(q):
    """(B, KVH, G, 1, hd) -> (B, KVH, G, hd), and whether it was 5-D."""
    if q.ndim != 5:
        return q, False
    b, kvh, g, t, hd = q.shape
    if t != 1:
        raise ValueError(f"one query step per request, got T={t}")
    return q.reshape(b, kvh, g, hd), True


def _dispatch(q, launch, plain, with_selection: bool):
    """What the public wrappers share: q as (B, KVH, G, hd); on CUDA
    tensors ``launch(q, with_selection=...)``, its selection as a bool
    ``(B, KVH, nb * bs)`` mask; on CPU tensors ``plain(q)`` -> (out,
    sel); the output back in q's layout."""
    q, orig5 = _split_q(q)
    if q.is_cuda:
        res = launch(q, with_selection=with_selection)
        out, sel = res if with_selection else (res, None)
        if sel is not None:
            sel = sel.reshape(*sel.shape[:2], -1).bool()
    else:
        out, sel = plain(q)
    if orig5:
        out = out[:, :, :, None]
    return (out, sel) if with_selection else out


def _plain_budget(budget, b: int, n: int) -> dict:
    """The plain versions' (B,) ``budget`` and static ``top_k``."""
    budget = torch.as_tensor(budget)
    return dict(budget=budget.expand(b),
                top_k=max(min(n, int(budget.max())), 1))


def paged_socket_attend(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, bits_pages: torch.Tensor,
                        vnorm_pages: torch.Tensor, u: torch.Tensor,
                        block_table: torch.Tensor, *, length, budget,
                        num_tables: int, num_planes: int, tau: float,
                        scale: float, sink_tokens: int, window_tokens: int,
                        with_selection: bool = False,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None):
    """Fused score → select → attend over the paged pool for one decode
    step.

    Shapes:
      q            (B, KVH, G, 1, hd) or (B, KVH, G, hd)
      k/v_pages    (NB, KVH, bs, hd)
      k/v_scale    f32 (NB, KVH, bs) per-row scales, or None
      bits_pages   int32 (NB, KVH, bs, W)  (uint32 bit pattern)
      vnorm_pages  bf16 (NB, KVH, bs)
      u            f32 (B, KVH, GS, L, P)  (GS=1 for pooled selection)
      block_table  int (B, nb)  (trash-padded with block 0)
      length       int scalar or (B,)
      budget       int scalar or (B,)  (dynamic top-k budget)

    ``k_pages``/``v_pages`` are f32, bf16, int8 or float8_e4m3fn, with
    the f32 ``(NB, KVH, bs)`` per-row scale pools ``k_scale``/``v_scale``
    (both or neither).

    Returns the attention output in q's layout (f32), plus the bool
    ``(B, KVH, nb * bs)`` selection mask when ``with_selection``.
    """
    _paired(k_scale, v_scale)
    kw = dict(num_tables=num_tables, num_planes=num_planes, tau=tau,
              scale=scale, sink_tokens=sink_tokens,
              window_tokens=window_tokens, k_scale=k_scale, v_scale=v_scale)
    args = (k_pages, v_pages, bits_pages, vnorm_pages, u, block_table)
    n = block_table.shape[1] * bits_pages.shape[2]
    return _dispatch(
        q, lambda q, **o: launch_paged_socket_attend(
            q, *args, length, budget, **kw, **o),
        lambda q: paged_socket_attend_ref(
            q, *args, length=length, **_plain_budget(budget, q.shape[0], n),
            **kw),
        with_selection)


def paged_hard_lsh_attend(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, bits_pages: torch.Tensor,
                          vnorm_pages: torch.Tensor, u_signs: torch.Tensor,
                          block_table: torch.Tensor, *, length, budget,
                          num_tables: int, num_planes: int, scale: float,
                          sink_tokens: int, window_tokens: int,
                          with_selection: bool = False,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None):
    """Fused hard-collision score → select → attend for one decode step.

    Same shapes as :func:`paged_socket_attend` except the query-side
    hash is ``u_signs``: f32 ±1 plane signs ``(B, KVH, GS, L, P)``
    (``where(u >= 0, +1, -1)`` of the soft hash).
    """
    _paired(k_scale, v_scale)
    kw = dict(num_tables=num_tables, num_planes=num_planes, scale=scale,
              sink_tokens=sink_tokens, window_tokens=window_tokens,
              k_scale=k_scale, v_scale=v_scale)
    args = (k_pages, v_pages, bits_pages, vnorm_pages, u_signs, block_table)
    n = block_table.shape[1] * bits_pages.shape[2]
    return _dispatch(
        q, lambda q, **o: launch_paged_hard_lsh_attend(
            q, *args, length, budget, **kw, **o),
        lambda q: paged_hard_lsh_attend_ref(
            q, *args, length=length, **_plain_budget(budget, q.shape[0], n),
            **kw),
        with_selection)


def paged_quest_attend(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, kmin_pages: torch.Tensor,
                       kmax_pages: torch.Tensor, block_table: torch.Tensor, *,
                       length, page_budget, page_size: int, scale: float,
                       sink_tokens: int, window_tokens: int,
                       with_selection: bool = False,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None):
    """Fused page-granular Quest select → attend for one decode step.

    Shapes:
      q              (B, KVH, G, 1, hd) or (B, KVH, G, hd)
      k/v_pages      (NB, KVH, bs, hd)
      kmin/kmax      (NB, KVH, bs / page_size, hd) per-page key bounds
      block_table    int (B, nb)  (trash-padded with block 0)
      length         int scalar or (B,)
      page_budget    int scalar or (B,): pages to attend (the static
                     ``baselines.quest.page_budget``)
      k/v_scale      f32 (NB, KVH, bs) per-row scales, both or neither

    Returns the attention output in q's layout (f32), plus the bool
    ``(B, KVH, nb * bs)`` selected-rows mask when ``with_selection``.
    """
    _paired(k_scale, v_scale)
    kw = dict(page_size=page_size, scale=scale, sink_tokens=sink_tokens,
              window_tokens=window_tokens, k_scale=k_scale, v_scale=v_scale)
    args = (k_pages, v_pages, kmin_pages, kmax_pages, block_table)
    return _dispatch(
        q, lambda q, **o: launch_paged_quest_attend(
            q, *args, length, page_budget, **kw, **o),
        lambda q: paged_quest_attend_ref(
            q, *args, length=length, page_budget=page_budget, **kw),
        with_selection)


def paged_ring_attend(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_table: torch.Tensor, *,
                      pos, window: int, softcap: float, scale: float,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None):
    """Fused sliding-window decode over the circular page list.

    Shapes:
      q            (B, KVH, G, 1, hd) or (B, KVH, G, hd)
      k/v_pages    (NB, KVH, bs, hd)
      block_table  int (B, ring_blocks) — the ring slice of the table
      pos          int scalar or (B,) — the decode token's position
                   (already written to its ring slot)
      k/v_scale    f32 (NB, KVH, bs) per-row scales, both or neither

    Returns the attention output in q's layout (f32).
    """
    _paired(k_scale, v_scale)
    kw = dict(window=window, softcap=softcap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    return _dispatch(
        q, lambda q, **o: launch_paged_ring_attend(
            q, k_pages, v_pages, block_table, pos, **kw),
        lambda q: (paged_ring_attend_ref(q, k_pages, v_pages, block_table,
                                         pos=pos, **kw), None),
        False)
