"""Theory-side objects from Section 5 of the paper, in PyTorch.

Port of ``repro.core.theory``.  Not on the inference path: the tests
check the paper's claims numerically with them.

* angular kernel weights ``w_j`` (eq. 4) and angular attention ``y*``;
* finite-L soft-count attention ``y_{tau,L}`` (eq. 5; Lemmas 5-6);
* the value-aware sampling estimator ``T(q)`` (eq. 6, Lemma 7);
* the soft-bucketization bias ``eps_tau`` (Theorem 3);
* Lemma 4's closed-form correlation ``Gamma = C q^T W^T s_hat``.

Every random draw comes from an explicit ``torch.Generator``: the hash
planes through :func:`repro_torch.core.hashing.make_hash_params`, the
estimator's samples through :func:`_choice`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import hashing, socket

__all__ = [
    "angular_weights",
    "angular_attention",
    "soft_count_attention",
    "sampling_estimator",
    "eps_tau_monte_carlo",
    "lemma4_gamma",
]


def angular_weights(q: torch.Tensor, keys: torch.Tensor,
                    p: int) -> torch.Tensor:
    """Angular kernel weights ``w_j = (1 - arccos(cos_sim)/pi)^P``."""
    qn = q / torch.linalg.vector_norm(q)
    kn = keys / torch.linalg.vector_norm(keys, dim=-1, keepdim=True)
    cos = torch.clamp(kn @ qn, -1.0, 1.0)
    return (1.0 - torch.arccos(cos) / math.pi) ** p


def angular_attention(q: torch.Tensor, keys: torch.Tensor,
                      values: torch.Tensor, p: int) -> torch.Tensor:
    """``y* = sum_j a_j v_j`` with ``a_j = w_j / Z``."""
    w = angular_weights(q, keys, p)
    return (w / torch.sum(w)) @ values


def soft_count_attention(cfg: socket.SocketConfig, gen: torch.Generator,
                         q: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-L soft-count attention ``y_{tau,L}`` and its normalized
    weights ``a_tilde``, with ``L`` tables drawn from ``gen``."""
    w = hashing.make_hash_params(gen, q.shape[-1], cfg.num_planes,
                                 cfg.num_tables).to(q.device)
    signs = hashing.hash_keys_signs(w, keys[None])[0]        # (N, L, P)
    u = socket.soft_hash_query(w, q)                         # (L, P)
    logits = torch.einsum("nlp,lp->nl", signs.float() * 2 - 1, u) / cfg.tau
    logz = socket.log_normalizer(u, cfg.tau)
    s = torch.exp(logits - logz[None, :])                    # (N, L)
    w_tilde = torch.mean(s, dim=-1)
    a_tilde = w_tilde / torch.sum(w_tilde)
    return a_tilde @ values, a_tilde


def _choice(gen: torch.Generator, p: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` indices drawn with replacement with probabilities ``p``."""
    return torch.multinomial(p, m, replacement=True, generator=gen)


def sampling_estimator(gen: torch.Generator, a_tilde: torch.Tensor,
                       values: torch.Tensor, m: int) -> torch.Tensor:
    """Value-aware importance-sampling estimator ``T(q)`` (eq. 6): ``m``
    keys drawn with ``p_j ∝ a_j ||v_j||``, each weighted ``a_j / p_j``."""
    vn = torch.linalg.vector_norm(values, dim=-1)
    p = a_tilde * vn
    p = p / torch.sum(p)
    idx = _choice(gen, p, m)
    contrib = (a_tilde[idx] / p[idx])[:, None] * values[idx]
    return torch.mean(contrib, dim=0)


def eps_tau_monte_carlo(gen: torch.Generator, q: torch.Tensor, tau: float,
                        num_planes: int, n_tables: int = 256
                        ) -> torch.Tensor:
    """``eps_tau(q) = E[1 - p_tau(b_q | q)]`` over ``n_tables`` random
    tables, from the factorized ``log p(b_q|q) = -sum_i log1p(exp(-2|u_i|
    / tau))``.  Theorem 3: -> 0 as tau -> 0, -> 1 - 1/R as tau -> inf."""
    w = hashing.make_hash_params(gen, q.shape[-1], num_planes,
                                 n_tables).to(q.device)
    u = socket.soft_hash_query(w, q)                         # (T, P)
    x = torch.abs(u) / tau
    log_p = -torch.sum(torch.log1p(torch.exp(-2.0 * x)), dim=-1)
    return torch.mean(1.0 - torch.exp(log_p))


def lemma4_gamma(q: torch.Tensor, w_orth: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """``Gamma = C q^T W^T s_hat`` (Lemma 4): unit query ``(d,)``,
    orthonormal planes ``(P, d)``, per-plane scores ``(P,)``."""
    c = math.sqrt(2.0 / math.pi)
    s_hat = s / torch.linalg.vector_norm(s)
    return c * (w_orth @ q) @ s_hat
