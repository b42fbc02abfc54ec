"""Traditional (hard) LSH scorer — the paper's central ablation.

Port of ``repro.baselines.hard_lsh``.  Scores keys by the number of
tables in which the key's bucket equals the query's (eq. 3 left):

    s_hard(k_j, q) = sum_l  I[ b_j^(l) == b_q^(l) ]

Same storage as SOCKET (packed sign bits); only the query-side rule
differs.  With ±1 signs a collision in table l is ``S_k . s_q == P``, so
the count is a ±1 contraction and a threshold.  The paper needs (P=2,
L>=300) for this rule to approach SOCKET's (P=10, L=60) retrieval
(Tables 2, 7).  The continuous engine's hard-LSH decode is
``models/backends/hard_lsh.py``; this is the standalone scorer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing, socket

__all__ = ["HardLSHConfig", "build", "score", "attend"]


@dataclasses.dataclass(frozen=True)
class HardLSHConfig:
    num_planes: int = 2
    num_tables: int = 300
    sparsity: float = 10.0
    sink_tokens: int = 128
    window_tokens: int = 128
    min_k: int = 16

    @property
    def bits_per_token(self) -> int:
        return self.num_planes * self.num_tables


@dataclasses.dataclass
class HardLSHState:
    w: torch.Tensor       # (L, P, d)
    packed: torch.Tensor  # (..., N, W) int32 words
    vnorm: torch.Tensor   # (..., N)


def build(cfg: HardLSHConfig, rng: torch.Generator, keys: torch.Tensor,
          values: torch.Tensor) -> HardLSHState:
    """Prefill, SOCKET's Algorithm 1: planes drawn from ``rng``, keys
    hashed and packed, value norms."""
    w = hashing.make_hash_params(rng, keys.shape[-1], cfg.num_planes,
                                 cfg.num_tables).to(keys.device)
    packed = hashing.pack_signs(hashing.hash_keys_signs(w, keys))
    vnorm = torch.linalg.vector_norm(values.float(), dim=-1)
    return HardLSHState(w=w, packed=packed, vnorm=vnorm)


def query_signs(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """±1 float32 signs ``(..., L, P)`` of ``W q``, 0 taken as +1."""
    s = torch.sign(torch.einsum("...d,lpd->...lp", q.float(), w.float()))
    return torch.where(s == 0, 1.0, s)


def agreement(packed: torch.Tensor, q_signs: torch.Tensor, num_tables: int,
              num_planes: int) -> torch.Tensor:
    """``S_k . s_q`` per key and table ``(..., N, L)``: P where every
    plane agrees."""
    k_signs = hashing.unpack_signs(packed, num_tables, num_planes)
    return torch.einsum("...nlp,...lp->...nl", k_signs, q_signs)


def score(state: HardLSHState, cfg: HardLSHConfig,
          q: torch.Tensor) -> torch.Tensor:
    """Hard collision counts ``(..., N)`` float32 for query ``(..., d)``."""
    agree = agreement(state.packed, query_signs(state.w, q), cfg.num_tables,
                      cfg.num_planes)
    return torch.sum(agree >= cfg.num_planes, dim=-1).float()


def attend(cfg: HardLSHConfig, state: HardLSHState, q: torch.Tensor,
           k_cache: torch.Tensor, v_cache: torch.Tensor, *, length,
           scale: float) -> torch.Tensor:
    """Decode attention with hard-LSH selection: each q head's counts
    against its KV head's keys, summed over the group, value-aware top-k
    with sink and window rows, exact attention over the subset.  q ``(B,
    KVH, G, 1, hd)``; caches and ``state`` built on keys ``(B, KVH, N,
    ...)``.

    JAX's ``attend`` scores ``q[..., 0, :]`` against the state without a
    group axis, so its (B, KVH, G) lead broadcasts against (B, KVH): it
    runs as documented only at B = KVH = 1 (ROADMAP.md, faults in the
    reference); this equals it on every (b, h) slice."""
    n = k_cache.shape[2]
    kq = min(max(cfg.min_k, int(np.ceil(n / cfg.sparsity))), n)
    agree = agreement(state.packed[:, :, None],
                      query_signs(state.w, q[..., 0, :]), cfg.num_tables,
                      cfg.num_planes)                         # (B,KVH,G,N,L)
    s = torch.sum(agree >= cfg.num_planes, dim=(2, 4)).float()  # (B,KVH,N)
    sel_cfg = socket.SocketConfig(
        sparsity=cfg.sparsity, sink_tokens=cfg.sink_tokens,
        window_tokens=cfg.window_tokens, min_k=cfg.min_k)
    idx, sel_mask = socket.value_aware_topk(
        sel_cfg, s, state.vnorm, k=kq, length=length, n_total=n)
    k_sel = socket._take_rows(k_cache, idx, 2)
    v_sel = socket._take_rows(v_cache, idx, 2)
    return socket.sparse_attention_over_subset(q, k_sel, v_sel, sel_mask,
                                               scale=scale)
