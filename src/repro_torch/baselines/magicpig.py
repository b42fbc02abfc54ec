"""MagicPig-style LSH importance sampling [8].

Port of ``repro.baselines.magicpig``.  MagicPig *samples* candidate keys
by hard LSH collisions and corrects with importance weights towards an
unbiased estimate of softmax attention, where SOCKET retrieves a
deterministic top-k (paper Section 2).  The estimator's skeleton:

  1. candidates: keys colliding with the query in >= ``min_collisions``
     of L tables (a mask: the set's size depends on the query);
  2. inclusion probability ``1 - (1 - c_hat)^L`` from the add-one
     smoothed collision rate ``c_hat``;
  3. ``y = sum_{j in C} softmax(k_j.q)_j / p_j * v_j``, renormalized.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.baselines import hard_lsh
from repro_torch.core import hashing

__all__ = ["MagicPigConfig", "build", "collision_counts", "attend_estimate"]


@dataclasses.dataclass(frozen=True)
class MagicPigConfig:
    num_planes: int = 8
    num_tables: int = 128       # paper uses ~1024 bits/token budgets
    min_collisions: int = 2     # K in MagicPig's (K, L) scheme
    sparsity: float = 10.0

    @property
    def bits_per_token(self) -> int:
        return self.num_planes * self.num_tables


@dataclasses.dataclass
class MagicPigState:
    w: torch.Tensor
    packed: torch.Tensor
    vnorm: torch.Tensor


def build(cfg: MagicPigConfig, rng: torch.Generator, keys: torch.Tensor,
          values: torch.Tensor) -> MagicPigState:
    w = hashing.make_hash_params(rng, keys.shape[-1], cfg.num_planes,
                                 cfg.num_tables).to(keys.device)
    packed = hashing.pack_signs(hashing.hash_keys_signs(w, keys))
    vnorm = torch.linalg.vector_norm(values.float(), dim=-1)
    return MagicPigState(w=w, packed=packed, vnorm=vnorm)


def collision_counts(state: MagicPigState, cfg: MagicPigConfig,
                     q: torch.Tensor) -> torch.Tensor:
    """Tables in which each key's bucket equals the query's, int32
    ``(..., N)``."""
    q_signs = hard_lsh.query_signs(state.w, q)
    agree = hard_lsh.agreement(state.packed, q_signs, cfg.num_tables,
                               cfg.num_planes)
    return torch.sum(agree >= cfg.num_planes, dim=-1, dtype=torch.int32)


def attend_estimate(cfg: MagicPigConfig, state: MagicPigState,
                    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                    *, scale: float) -> torch.Tensor:
    """Importance-sampled attention estimate for one query ``(..., d)``
    over keys/values ``(..., N, d)``; returns ``(..., d)``."""
    counts = collision_counts(state, cfg, q)
    cand = counts >= cfg.min_collisions
    c_hat = (counts + 1.0) / (cfg.num_tables + 2.0)
    p_incl = torch.clamp(1.0 - torch.pow(1.0 - c_hat, cfg.num_tables),
                         1e-6, 1.0)
    logits = torch.einsum("...nd,...d->...n", keys.float(), q.float()) * scale
    logits = torch.where(cand, logits, -1e30)
    w = torch.softmax(logits, dim=-1) / p_incl
    w = torch.where(cand, w, 0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return torch.einsum("...n,...nd->...d", w, values.float())
