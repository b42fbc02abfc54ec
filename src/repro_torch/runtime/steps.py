"""Step functions shared by the train loop and the serve loop.

Port of ``repro.runtime.steps``.  PyTorch runs eagerly, so where the JAX
package jits these closures the port runs the serving ones under
``torch.no_grad()`` and the train step as one forward and backward per
microbatch.

``make_train_step`` supports gradient accumulation: the batch is split
into ``accum`` microbatches run one after the other, their gradients
summed in float32 buffers and divided by ``accum``, the loss averaged.
The JAX function's ``grad_shardings`` (pinning the accumulators'
sharding across devices) comes with ROADMAP.md queue 1 item 11's
``distributed/`` step.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import (is_trainable_path, tree_leaves,
                                     tree_map)

__all__ = ["make_train_step", "loss_and_grads", "make_prefill_step",
           "make_chunk_prefill_step", "make_serve_step"]


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, {path: gradient}) of :func:`tfm.loss_and_metrics`
    for every trainable leaf of ``params`` (JAX ``keystr`` paths, see
    :func:`repro_torch.optim.adamw.tree_leaves`); a leaf the loss does
    not reach gets zeros.  The caller's tensors are not modified."""
    leaves = []

    def track(path, t):
        # a detached alias that requires grad: the same storage, so the
        # in-place update reaches the caller's tensors
        if not is_trainable_path(path):
            return t
        leaves.append((path, t.detach().requires_grad_()))
        return leaves[-1][1]

    loss, metrics = tfm.loss_and_metrics(cfg, tree_map(track, params),
                                         batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        path: torch.zeros_like(t) if g is None else g
        for (path, t), g in zip(leaves, grads)}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    accum: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch``: ``tokens`` and ``labels`` (B, T) tensors on the
    parameters' device, B a multiple of ``accum``.  The parameters and
    the moments are updated in place (:func:`adamw_update`) and
    returned.  ``metrics``: at ``accum == 1`` those of
    :func:`tfm.loss_and_metrics`, above it the mean ``loss``; with
    ``grad_norm`` and ``lr`` of the update, all 0-d tensors."""
    stacked = cfg.num_groups * len(cfg.pattern)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} "
                                 "microbatches")
            mb = b // accum
            gsum = {path: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                    for path, p in tree_leaves(params)
                    if is_trainable_path(path)}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=gsum[next(iter(gsum))].device)
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, _, g = loss_and_grads(cfg, params, micro)
                for path, gi in g.items():
                    gsum[path].add_(gi.to(torch.float32))
                lsum = lsum + loss_i
                del g
            grads = {path: g.div_(accum) for path, g in gsum.items()}
            loss = lsum / accum
            metrics = {"loss": loss}
        params, opt_state, om = adamw_update(
            ocfg, tree_map(lambda path, _: grads.get(path), params),
            opt_state, params, stacked_layers=stacked)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


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
    """(params, pages, tokens, bt_row, slot, history, last_index) ->
    (last-real-token logits, pages).  One prefix-extension prefill chunk
    straight against the paged pool (see :func:`tfm.prefill_chunk`); the
    pages are updated in place, and the request's decode ``slot`` carries
    its Mamba state across chunks."""
    @torch.no_grad()
    def chunk_step(params, pages, tokens, bt_row, slot, history,
                   last_index):
        return tfm.prefill_chunk(cfg, params, pages, tokens, bt_row=bt_row,
                                 slot=slot, history=history,
                                 last_index=last_index)
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
