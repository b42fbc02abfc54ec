"""HashAttention-style Hamming scorer [13].

Port of ``repro.baselines.hash_attn``.  HashAttention maps queries and
keys to bit codes with learned projections and ranks by Hamming
similarity over a fixed budget (128 bits a token in the paper's Table
1); offline the learned mapping is replaced by random signed projections
(the data-agnostic analogue): one table of ``num_bits`` planes, scored by
partial agreement rather than exact bucket collision.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.baselines import hard_lsh
from repro_torch.core import hashing

__all__ = ["HashAttnConfig", "build", "score"]


@dataclasses.dataclass(frozen=True)
class HashAttnConfig:
    num_bits: int = 128
    sparsity: float = 10.0

    @property
    def bits_per_token(self) -> int:
        return self.num_bits


@dataclasses.dataclass
class HashAttnState:
    w: torch.Tensor       # (1, bits, d): one "table" of `bits` planes
    packed: torch.Tensor  # (..., N, W) int32 words


def build(cfg: HashAttnConfig, rng: torch.Generator, keys: torch.Tensor,
          values: torch.Tensor) -> HashAttnState:
    del values
    w = hashing.make_hash_params(rng, keys.shape[-1], cfg.num_bits,
                                 1).to(keys.device)
    return HashAttnState(
        w=w, packed=hashing.pack_signs(hashing.hash_keys_signs(w, keys)))


def score(state: HashAttnState, cfg: HashAttnConfig,
          q: torch.Tensor) -> torch.Tensor:
    """Hamming similarity, the number of agreeing bits ``(..., N)``."""
    q_signs = hard_lsh.query_signs(state.w, q)
    agree = hard_lsh.agreement(state.packed, q_signs, 1,
                               cfg.num_bits)[..., 0]  # in [-bits, bits]
    return (agree + cfg.num_bits) * 0.5
