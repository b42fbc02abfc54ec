"""Step functions shared by the serve loop.

Port of ``make_prefill_step``, ``make_chunk_prefill_step`` and ``make_serve_step`` of
``repro.runtime.steps``.  PyTorch runs eagerly, so where the JAX package
jits these closures the port runs them under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

__all__ = ["make_prefill_step", "make_chunk_prefill_step",
           "make_serve_step"]


def make_prefill_step(cfg: ModelConfig, capacity: int,
                      paged: bool = False) -> Callable:
    """(params, batch, last_index=None) -> (last-token logits, caches).
    The continuous engine's legacy prefill pads prompts to a bucket and
    passes each prompt's last *real* position as ``last_index`` (see
    :func:`tfm.prefill`), which also pins sliding-window rings to the
    prompt's true end.  ``paged=True`` builds caches in pool geometry
    (page-aligned rings)."""
    @torch.no_grad()
    def prefill_step(params, batch, last_index=None):
        return tfm.prefill(cfg, params, batch, capacity=capacity,
                           last_index=last_index, paged=paged)
    return prefill_step


def make_chunk_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, pages, tokens, bt_row, history, last_index) ->
    (last-real-token logits, pages).  One prefix-extension prefill chunk
    straight against the paged pool (see :func:`tfm.prefill_chunk`); the
    pages are updated in place.  The JAX step's ``slot`` argument carries
    Mamba state, which the port does not serve yet, so it is left out."""
    @torch.no_grad()
    def chunk_step(params, pages, tokens, bt_row, history, last_index):
        return tfm.prefill_chunk(cfg, params, pages, tokens, bt_row=bt_row,
                                 history=history, last_index=last_index)
    return chunk_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, caches, inp, pos[, block_tables]) -> (logits, caches); the
    caches are updated in place.  ``pos`` may be an int (static batch) or
    a ``(B,)`` tensor (ragged continuous batch); ``block_tables``
    switches ``caches`` to the paged pool."""
    @torch.no_grad()
    def serve_step(params, caches, inp, pos, block_tables=None):
        return tfm.decode_step(cfg, params, caches, inp, pos,
                               block_tables=block_tables)
    return serve_step
