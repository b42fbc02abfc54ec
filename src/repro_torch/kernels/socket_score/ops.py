"""Public wrapper of the SOCKET scoring kernel.

Accepts the model's layouts and flattens to the kernel's ``(BH, ...)``
convention.  On CPU tensors it runs the plain version (:mod:`.ref`); on
plain CUDA tensors it launches the CUDA kernel (``socket_score.cu``,
built on first use by :mod:`repro_torch.kernels.build`) or raises; on
any other device, or under a dispatch mode
(:func:`~repro_torch.kernels.build.dispatch_free`), it calls the
operator ``repro_torch::socket_score``, whose CUDA implementation is the
same launch and whose fake implementation (``meta`` and fake tensors:
the dry run, ``launch/dryrun.py``) only checks shapes; its FLOP formula
(:func:`socket_score_flops`) counts the operations of the bound in
``PERF.md``'s table.  ``LAUNCHES`` counts kernel launches, so a run can
show that it went through the kernel.  :func:`key_runs` is the host's
copy of how the kernel splits a row's keys over the C ranks of its
cluster, :func:`socket_score_plan` the shape a launch takes (C, shared
memory, the instance).
:func:`table_dump` runs a diagnostic build of the same source that also
returns each rank's split tables as it held them (``tables_of_dump``
reads them out).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.socket_score.ref import socket_score_ref

__all__ = ["socket_score", "launch_socket_score", "socket_score_plan",
           "socket_score_flops",
           "key_runs", "table_dump", "tables_of_dump", "LAUNCHES", "SOURCE",
           "THREADS", "DUMP_DEFINE"]

SOURCE = Path(__file__).with_name("socket_score.cu")
DUMP_DEFINE = "SOCKET_SCORE_DUMP_TABLES"     # the diagnostic build's define
LAUNCHES = 0
THREADS = 512          # threads a CTA, the most keys a tile (kThreads)


def key_runs(n: int, c: int,
             tile: int = THREADS) -> Tuple[int, List[Tuple[int, int]]]:
    """How the kernel splits a row's ``n`` keys over ``c`` ranks
    (``key_run`` in ``socket_score.cu``): rank r scores the r-th run
    ``[r0, r1)`` of ceil(n / c) keys, in tiles of ``rows`` keys (at most
    ``tile``, whole warps, spread evenly over a run).  Returns ``(rows,
    runs)``."""
    per = -(-n // c)                        # keys a rank
    tiles = max(1, -(-per // tile))         # tiles a rank
    keys = -(-per // tiles)                 # keys a tile
    rows = min(tile, -(-keys // 32) * 32)
    return rows, [(min(n, r * per), min(n, (r + 1) * per)) for r in range(c)]


def _library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = build.load_library(SOURCE, defines)
    fn = lib.socket_score_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.socket_score_error_string.argtypes = [ctypes.c_int]
    lib.socket_score_error_string.restype = ctypes.c_char_p
    lib.socket_score_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.socket_score_plan.restype = ctypes.c_int
    if defines:
        lib.socket_score_set_table_dump.argtypes = [ctypes.c_void_p]
        lib.socket_score_set_table_dump.restype = ctypes.c_int
        lib.socket_score_table_stride.argtypes = [ctypes.c_int]
        lib.socket_score_table_stride.restype = ctypes.c_int
    return lib


def socket_score_plan(bits: torch.Tensor, g: int, *, num_tables: int,
                      num_planes: int) -> dict:
    """The shape the kernel's launch takes on ``bits`` (BH, N, ·) with
    ``g`` query-hash groups: cluster size ``C``, ``smem`` bytes a CTA,
    the ``clusters_at_once`` the card holds, the ``instance`` (split
    tables for P <= 16, else sign-add), the most ``tile`` rows, and
    whether all tables stay ``resident`` (else ``tables_a_chunk``)."""
    bh, n, w = bits.shape
    lib = _library()
    info = (ctypes.c_int * 7)()
    err = lib.socket_score_plan(int(bits.dtype == torch.int8), bh, n, w, g,
                                num_tables, num_planes, info)
    if err != 0:
        raise RuntimeError("socket_score plan failed: " +
                           lib.socket_score_error_string(err).decode())
    return dict(C=info[0], smem=info[1], clusters_at_once=info[2],
                instance="split" if info[3] else "sign-add", tile=info[4],
                resident=bool(info[5]), tables_a_chunk=info[6])


def _ctypes_launch(lib, bits, u, vnorm, out, num_tables, num_planes,
                   tau) -> None:
    """One launch of ``lib``'s kernel into ``out`` (the C call)."""
    bh, n, w = bits.shape
    dev = bits.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.socket_score_launch(
            bits.data_ptr(), int(bits.dtype == torch.int8), u.data_ptr(),
            vnorm.data_ptr() if vnorm is not None else None,
            out.data_ptr(), bh, n, w, u.shape[1], num_tables, num_planes,
            float(tau), stream)
    if err != 0:
        raise RuntimeError("socket_score kernel launch failed: " +
                           lib.socket_score_error_string(err).decode())


def _cuda_op(bits, u, vnorm, out, num_tables, num_planes, tau) -> None:
    """``repro_torch::socket_score`` on CUDA tensors: build (on first
    use), launch, count the launch."""
    global LAUNCHES
    _ctypes_launch(_library(), bits, u, vnorm, out, num_tables, num_planes,
                   tau)
    LAUNCHES += 1


def _fake_op(bits, u, vnorm, out, num_tables, num_planes, tau) -> None:
    if out.shape != bits.shape[:2]:
        raise ValueError(f"out {tuple(out.shape)} != {tuple(bits.shape[:2])}")


def socket_score_flops(bh: int, n: int, g: int, num_tables: int) -> int:
    """The operations the function needs (the bound's count): a (key, g,
    l) term is one multiply-add of two table lookups."""
    return bh * n * g * num_tables * 2


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("socket_score(Tensor bits, Tensor u, Tensor? vnorm, "
            "Tensor(a!) out, int num_tables, int num_planes, float tau) "
            "-> ()")
_OPS.impl("socket_score", _cuda_op, "CUDA")
torch.library.register_fake("repro_torch::socket_score", _fake_op, lib=_OPS)

# the wrapper's call under a fake run or a counting mode (``_cuda_op`` on
# plain CUDA tensors: ``build.dispatch_free``)
_OP = torch.ops.repro_torch.socket_score


@register_flop_formula(torch.ops.repro_torch.socket_score)
def _flop_formula(bits, u, vnorm, out, num_tables, *args, out_shape=None,
                  **kw) -> int:
    return socket_score_flops(bits[0], bits[1], u[1], num_tables)


def launch_socket_score(bits: torch.Tensor, u: torch.Tensor,
                        vnorm: Optional[torch.Tensor], *, num_tables: int,
                        num_planes: int, tau: float,
                        _lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the CUDA kernel on flat ``(BH, ...)`` CUDA tensors through
    the operator (``_lib``: another build of the source, launched
    directly, which counts no launch)."""
    bh, n, w = bits.shape
    l, p = num_tables, num_planes
    if bits.dtype == torch.int8:
        if w != l * p:
            raise ValueError(f"int8 bits width {w} != L*P = {l * p}")
    elif bits.dtype == torch.int32:
        if w * 32 < l * p:
            raise ValueError(f"{w} words hold fewer than L*P={l * p} bits")
    else:
        raise TypeError(f"bits must be int32 (packed) or int8, got "
                        f"{bits.dtype}")
    if not 0 < p <= 32:
        raise ValueError(f"the kernel reads P <= 32 planes per table, "
                         f"got P={p}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the grid's y limit 65535")
    dev = bits.device
    u = u.to(device=dev, dtype=torch.float32).contiguous()
    if vnorm is not None:
        vnorm = vnorm.to(device=dev, dtype=torch.float32).contiguous()
        if vnorm.shape != (bh, n):
            raise ValueError(f"vnorm {tuple(vnorm.shape)} != {(bh, n)}")
    bits = bits.contiguous()
    out = torch.empty((bh, n), dtype=torch.float32, device=dev)
    if n == 0 or bh == 0:
        return out
    if _lib is not None:
        _ctypes_launch(_lib, bits, u, vnorm, out, l, p, tau)
    else:
        (_cuda_op if build.dispatch_free(bits) else _OP)(
            bits, u, vnorm, out, l, p, float(tau))
    return out


def table_dump(bits: torch.Tensor, u: torch.Tensor, *, num_tables: int,
               num_planes: int, tau: float):
    """One launch of the diagnostic build (``-D`` :data:`DUMP_DEFINE`) on
    flat CUDA tensors, no vnorm.  Returns ``(scores (BH, N), dump (BH, C,
    G * L, stride))``: each rank's table sets as it held them when it
    began to score (set k = l * G + g; split tables: ``T_lo`` then
    ``T_hi``, then padding).  Only where all tables stay resident."""
    g = u.shape[1]
    pl = socket_score_plan(bits, g, num_tables=num_tables,
                           num_planes=num_planes)
    if not pl["resident"]:
        raise ValueError("the tables are not resident: built a chunk at a "
                         "time, nothing stays to dump")
    lib = _library((DUMP_DEFINE,))
    stride = lib.socket_score_table_stride(num_planes)
    dump = torch.full((bits.shape[0], pl["C"], g * num_tables, stride),
                      float("nan"), device=bits.device)
    with torch.cuda.device(bits.device):
        err = lib.socket_score_set_table_dump(dump.data_ptr())
    if err != 0:
        raise RuntimeError("socket_score table dump: " +
                           lib.socket_score_error_string(err).decode())
    out = launch_socket_score(bits, u, None, num_tables=num_tables,
                              num_planes=num_planes, tau=tau, _lib=lib)
    return out, dump


def tables_of_dump(dump: torch.Tensor, g: int, num_planes: int):
    """The split tables of a :func:`table_dump` dump, ``(T_lo, T_hi)`` of
    shapes ``(BH, C, G, L, 2^ceil(P/2))`` and ``(..., 2^floor(P/2))``, to
    hold against ``ref.split_tables`` (P <= 16)."""
    bh, c, gl, stride = dump.shape
    sets = dump.reshape(bh, c, gl // g, g, stride).transpose(2, 3)
    n_lo = 1 << ((num_planes + 1) // 2)
    n_hi = 1 << (num_planes // 2)
    return sets[..., :n_lo], sets[..., n_lo:n_lo + n_hi]


def socket_score(bits: torch.Tensor, u: torch.Tensor,
                 vnorm: Optional[torch.Tensor] = None, *, num_tables: int,
                 num_planes: int, tau: float) -> torch.Tensor:
    """Score keys for one decode step.

    Shapes (model layout):
      bits  int32 (B, KVH, N, W) / int8 (B, KVH, N, L*P), or (BH, N, ·)
      u     f32   (B, KVH, G, L, P) or (BH, G, L, P)
      vnorm       (B, KVH, N) or (BH, N) or None

    Returns f32 scores matching the leading layout: (B, KVH, N) / (BH, N).
    """
    lead = None
    if bits.ndim == 4:
        b, kvh, n, w = bits.shape
        lead = (b, kvh)
        bits = bits.reshape(b * kvh, n, w)
        u = u.reshape(b * kvh, *u.shape[2:])
        if vnorm is not None:
            vnorm = vnorm.reshape(b * kvh, n)
    if u.shape[-2:] != (num_tables, num_planes):
        raise ValueError(f"u shape {tuple(u.shape)} does not end in "
                         f"(L, P) = {(num_tables, num_planes)}")
    if bits.device.type != "cpu":
        out = launch_socket_score(bits, u, vnorm, num_tables=num_tables,
                                  num_planes=num_planes, tau=tau)
    else:
        out = socket_score_ref(bits, u, vnorm, num_tables=num_tables,
                               num_planes=num_planes, tau=tau)
    if lead is not None:
        out = out.reshape(*lead, out.shape[-1])
    return out
