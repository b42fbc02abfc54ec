"""Step functions shared by the serve loop.

Port of ``make_prefill_step`` and ``make_serve_step`` of
``repro.runtime.steps`` for the static (non-bucketed, non-paged) path.
PyTorch runs eagerly, so where the JAX package jits these closures the
port runs them under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, capacity: int) -> Callable:
    """(params, batch) -> (last-token logits, caches)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return tfm.prefill(cfg, params, batch, capacity=capacity)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, caches, inp, pos) -> (logits, caches); the caches are
    updated in place."""
    @torch.no_grad()
    def serve_step(params, caches, inp, pos):
        return tfm.decode_step(cfg, params, caches, inp, pos)
    return serve_step
