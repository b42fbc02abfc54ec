"""Plain PyTorch version of the SOCKET scoring kernel.

Computes exactly what ``socket_score.cu`` (and the TPU kernel it
replaces) computes, shape for shape:

    scores[bh, n] = vnorm[bh, n] * sum_g sum_l exp( (S . u)/tau - logZ )

Inputs:
  bits  : int32 (BH, N, W) packed sign words (hashing.pack_signs),
          or int8 (BH, N, L*P) ±1 plane bytes
  u     : f32   (BH, G, L, P) query soft-hash (socket.soft_hash_query)
  vnorm : f32   (BH, N) value norms, or None for unweighted scores

:func:`split_table_scores` emulates in plain torch how the CUDA kernels
form these scores (``socket_score.cu``, and ``paged_attention.cu``'s
score pass): split tables of exp(.) per (g, l), or per-key sign-adds
where P > 16, summed in the kernels' one fixed order.  The CPU tests
hold it to the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashing, socket


def socket_score_ref(bits: torch.Tensor, u: torch.Tensor,
                     vnorm: Optional[torch.Tensor], *, num_tables: int,
                     num_planes: int, tau: float) -> torch.Tensor:
    """Returns f32 (BH, N) group-summed, value-weighted scores."""
    if bits.dtype == torch.int8:
        signs = bits.float().reshape(*bits.shape[:-1], num_tables,
                                     num_planes)
    else:
        signs = hashing.unpack_signs(bits, num_tables, num_planes)
    logits = torch.einsum("bnlp,bglp->bgnl", signs, u.float()) / tau
    logz = socket.log_normalizer(u.float(), tau)                 # (BH,G,L)
    z = torch.exp(logits - logz[:, :, None, :])                  # (BH,G,N,L)
    # tables first, then the group (the TPU kernel's order): each key's
    # sum then runs the same code path, so keys with equal bits tie exactly
    scores = z.sum(dim=3).sum(dim=1)                             # (BH,N)
    if vnorm is not None:
        scores = scores * vnorm.float()
    return scores


SPLIT_MAX_PLANES = 16   # the largest P the kernels score by split tables


def _fields(bits: torch.Tensor, num_tables: int, num_planes: int):
    """Each key's plane bits ``(BH, N, L, P)`` (1 where the sign is +1; an
    int8 plane byte >= 0 reads as +1, as the kernel reads it) and its
    P-bit field per table ``(BH, N, L)`` (bit j = plane j)."""
    l, p = num_tables, num_planes
    bh, n = bits.shape[:2]
    dev = bits.device
    if bits.dtype == torch.int8:
        flat = (bits >= 0).long().reshape(bh, n, l, p)
    else:
        words = bits.long() & 0xFFFFFFFF                   # (BH, N, W)
        flat = (words[..., :, None] >> torch.arange(32, device=dev)) & 1
        flat = flat.reshape(bh, n, -1)[..., :l * p].reshape(bh, n, l, p)
    return flat, (flat << torch.arange(p, device=dev)).sum(-1)


def split_tables(u: torch.Tensor, tau: float):
    """The split tables of exp(.) the kernels score with, ``(T_lo, T_hi)``
    of shapes ``(BH, G, L, 2^ceil(P/2))`` and ``(BH, G, L, 2^floor(P/2))``
    for u ``(BH, G, L, P)``, P <= 16: entry c sums +-u_j / tau over the
    low (high) planes, bit j of c giving plane j's sign, in plane order;
    the low table also subtracts logZ (see :func:`split_table_scores`)."""
    u = u.float()
    p = u.shape[-1]
    assert p <= SPLIT_MAX_PLANES, p
    dev = u.device
    logz = socket.log_normalizer(u, tau)                   # (BH, G, L)
    lo_bits = (p + 1) // 2
    code = torch.arange(1 << lo_bits, device=dev)
    sign = ((code[:, None] >> torch.arange(lo_bits, device=dev)) & 1)
    sign = sign.float() * 2 - 1                            # (2^lo, lo)

    def table(planes):                                     # (BH, G, L, 2^n)
        k = planes.shape[-1]
        s = torch.zeros((*planes.shape[:-1], 1 << k), device=dev)
        for j in range(k):                                 # plane order
            s = s + sign[:1 << k, j] * planes[..., j:j + 1]
        return s / tau

    return (torch.exp(table(u[..., :lo_bits]) - logz[..., None]),
            torch.exp(table(u[..., lo_bits:])))


def split_table_scores(bits: torch.Tensor, u: torch.Tensor,
                       vnorm: Optional[torch.Tensor] = None, *,
                       num_tables: int, num_planes: int,
                       tau: float) -> torch.Tensor:
    """SOCKET scores ``(BH, N)`` f32 as the CUDA kernels form them: bits
    int32 ``(BH, N, W)`` or int8 ``(BH, N, L*P)``, u ``(BH, G, L, P)``,
    vnorm ``(BH, N)`` or None.  For P <= 16 each (g, l) gets two f32
    tables over the low ceil(P/2) and high floor(P/2) planes, ``T_lo[c] =
    exp(sum_j +-u_j / tau - logZ)`` and ``T_hi[c] = exp(sum_j +-u_j /
    tau)``, and a term is ``T_lo[lo] * T_hi[hi]``; for P > 16 a term is
    ``exp(sum_j +-u_j / tau - logZ)``, the signs added in plane order.
    A key sums its terms over the tables in order, then over the groups,
    then takes vnorm (logZ from ``log_normalizer``)."""
    l, p = num_tables, num_planes
    dev = bits.device
    u = u.float()
    logz = socket.log_normalizer(u, tau)                   # (BH, G, L)
    flat, codes = _fields(bits, l, p)
    bh, n = bits.shape[:2]
    if p <= SPLIT_MAX_PLANES:
        lo_bits = (p + 1) // 2
        t_lo, t_hi = split_tables(u, tau)
        lo = codes & ((1 << lo_bits) - 1)
        hi = codes >> lo_bits

        def term(gg, tb):
            return (torch.gather(t_lo[:, gg, tb], 1, lo[..., tb]) *
                    torch.gather(t_hi[:, gg, tb], 1, hi[..., tb]))
    else:
        signs = flat.float() * 2 - 1                       # (BH, N, L, P)

        def term(gg, tb):
            dot = torch.zeros((bh, n), device=dev)
            for j in range(p):                             # plane order
                dot = dot + signs[:, :, tb, j] * u[:, gg, tb, j, None]
            return torch.exp(dot / tau - logz[:, gg, tb, None])

    score = torch.zeros((bh, n), device=dev)
    for gg in range(u.shape[1]):
        sg = torch.zeros((bh, n), device=dev)
        for tb in range(l):
            sg = sg + term(gg, tb)
        score = score + sg
    if vnorm is not None:
        score = score * vnorm.float()
    return score
