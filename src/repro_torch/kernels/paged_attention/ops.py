"""Public wrapper of the fused SOCKET paged-attention kernel.

Accepts the serving engine's layouts (5-D decode query, pool leaves,
per-request block table / length / budget vectors) with the JAX
wrapper's signature (``repro.kernels.paged_attention.ops
.paged_socket_attend``).  On CPU tensors it runs the plain version
(:mod:`.ref`); on CUDA tensors it launches ``paged_attention.cu`` (built
on first use by :mod:`repro_torch.kernels.build`) or raises.
``LAUNCHES`` counts kernel launches, so a run can show that it went
through the kernel.

The quantized pool mode (``k_scale``/``v_scale``, int8/fp8 pages) comes
with the quantized-pages slice; given scales, the wrapper raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import socket as sk
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_socket_attend_ref

__all__ = ["paged_socket_attend", "launch_paged_socket_attend", "LAUNCHES",
           "SOURCE"]

SOURCE = Path(__file__).with_name("paged_attention.cu")
LAUNCHES = 0


def _library() -> ctypes.CDLL:
    lib = build.load_library(SOURCE)
    fn = lib.paged_socket_attend_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 +
                   [ctypes.c_float] * 2 + [ctypes.c_int] * 2 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_socket_attend_error_string.argtypes = [ctypes.c_int]
    lib.paged_socket_attend_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def launch_paged_socket_attend(q, k_pages, v_pages, bits_pages, vnorm_pages,
                               u, block_table, length, budget, *,
                               num_tables: int, num_planes: int, tau: float,
                               scale: float, sink_tokens: int,
                               window_tokens: int,
                               with_selection: bool = False):
    """Launch the CUDA kernel.  q (B, KVH, G, hd) f32; k/v pages
    (NB, KVH, bs, hd) f32; bits int32 (NB, KVH, bs, W); vnorm bf16
    (NB, KVH, bs); u f32 (B, KVH, GS, L, P); block_table (B, nb);
    length, budget (B,).  Returns f32 (B, KVH, G, hd), plus the int32
    (B, KVH, nb, bs) selection mask when ``with_selection``."""
    global LAUNCHES
    b, kvh, g, hd = q.shape
    nblocks, _, bs, w = bits_pages.shape
    nb = block_table.shape[1]
    gs, l, p = u.shape[2:]
    if (l, p) != (num_tables, num_planes):
        raise ValueError(f"u shape {tuple(u.shape)} does not end in (L, P) "
                         f"= {(num_tables, num_planes)}")
    if (w * 32) % p or w * 32 < l * p:
        raise ValueError(f"packed width {w * 32} bits does not hold whole "
                         f"tables of P={p} for L={l}")
    if gs not in (1, g):
        raise ValueError(f"u group axis {gs} must be 1 (pooled) or G={g}")
    _check("q", q, torch.float32, (b, kvh, g, hd))
    _check("k_pages", k_pages, torch.float32, (nblocks, kvh, bs, hd))
    _check("v_pages", v_pages, torch.float32, (nblocks, kvh, bs, hd))
    _check("bits_pages", bits_pages, torch.int32, (nblocks, kvh, bs, w))
    _check("vnorm_pages", vnorm_pages, torch.bfloat16, (nblocks, kvh, bs))
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's y limit 65535")
    if nblocks * kvh * bs >= 2 ** 31:
        raise ValueError("the kernel indexes pool rows with int32: "
                         f"{nblocks * kvh * bs} rows")
    dev = q.device
    l_pad = (w * 32) // p
    u = u.to(dtype=torch.float32)
    # the wrapper computes logZ (paged_attention.py:323-328); padded
    # tables get u = 0 and logZ = 1e30, so they add exp(-1e30) = 0
    logz = sk.log_normalizer(u, tau)                         # (B,KVH,GS,L)
    u_pad = F.pad(u, (0, 0, 0, l_pad - l)).contiguous()
    logz_pad = F.pad(logz, (0, l_pad - l), value=1e30).contiguous()
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    length = torch.as_tensor(length, device=dev).to(torch.int32).expand(
        b).contiguous()
    budget = torch.as_tensor(budget, device=dev).to(torch.int32).expand(
        b).contiguous()
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    sel = (torch.empty((b, kvh, nb, bs), dtype=torch.int32, device=dev)
           if with_selection else None)
    # per-(request, head) effective-score scratch in device memory: shared
    # memory would cap the context at ~56K tokens
    eff = torch.empty((b, kvh, nb * bs), dtype=torch.float32, device=dev)
    if b * kvh and nb:
        lib = _library()
        args = [q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
                bits_pages.contiguous(), vnorm_pages.contiguous(), u_pad,
                logz_pad, bt, length, budget, out]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.paged_socket_attend_launch(
                *[t.data_ptr() for t in args],
                sel.data_ptr() if sel is not None else None, eff.data_ptr(),
                b, kvh, g, gs, hd, bs, w, nb, l_pad, p,
                float(tau), float(scale), int(sink_tokens),
                int(window_tokens), stream)
        if err != 0:
            raise RuntimeError(
                "paged_attention kernel launch failed: " +
                lib.paged_socket_attend_error_string(err).decode())
        LAUNCHES += 1
    return (out, sel) if with_selection else out


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
      bits_pages   int32 (NB, KVH, bs, W)  (uint32 bit pattern)
      vnorm_pages  bf16 (NB, KVH, bs)
      u            f32 (B, KVH, GS, L, P)  (GS=1 for pooled selection)
      block_table  int (B, nb)  (trash-padded with block 0)
      length       int scalar or (B,)
      budget       int scalar or (B,)  (dynamic top-k budget)

    Returns the attention output in q's layout (f32), plus the bool
    ``(B, KVH, nb * bs)`` selection mask when ``with_selection``.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized K/V pages (k_scale/v_scale) come with the "
            "quantized-pages slice (ROADMAP.md queue 1 item 5)")
    orig5 = q.ndim == 5
    if orig5:
        b, kvh, g, t, hd = q.shape
        if t != 1:
            raise ValueError(f"one query step per request, got T={t}")
        q = q.reshape(b, kvh, g, hd)
    kw = dict(num_tables=num_tables, num_planes=num_planes, tau=tau,
              scale=scale, sink_tokens=sink_tokens,
              window_tokens=window_tokens)
    if q.is_cuda:
        res = launch_paged_socket_attend(
            q, k_pages, v_pages, bits_pages, vnorm_pages, u, block_table,
            length, budget, with_selection=with_selection, **kw)
        out, sel = res if with_selection else (res, None)
        if sel is not None:
            sel = sel.reshape(*sel.shape[:2], -1).bool()
    else:
        b = q.shape[0]
        n = block_table.shape[1] * bits_pages.shape[2]
        top_k = min(n, int(torch.as_tensor(budget).max()))
        out, sel = paged_socket_attend_ref(
            q, k_pages, v_pages, bits_pages, vnorm_pages, u, block_table,
            length=length, budget=torch.as_tensor(budget).expand(b),
            top_k=max(top_k, 1), **kw)
    if orig5:
        out = out[:, :, :, None]
    return (out, sel) if with_selection else out
