"""Step functions shared by the train loop and the serve loop.

Port of ``repro.runtime.steps``.  PyTorch runs eagerly, so where the JAX
package jits these closures the port runs the serving ones under
``torch.no_grad()`` and the train step as one forward and backward per
microbatch.

``make_train_step`` supports gradient accumulation: the batch is split
into ``accum`` microbatches run one after the other, their gradients
summed in float32 buffers and divided by ``accum``, the loss averaged.

The step is the sharded one, standing in for XLA's SPMD partitioning
of JAX's jitted step: every rank holds only its blocks of the
parameters and the moments (``grad_shardings``, the parameters'
shardings as JAX's), takes its rows of the global batch, gathers each
layer group's weights inside the group's rematerialised function and
reduce-scatters their gradients in its backward
(``distributed/fsdp.py``), keeps its float32 accumulators at its
blocks' size and updates its blocks (``optim/adamw.py``).  Its losses
and gradient norm are the global batch's, as one process computes
them.  Without ``grad_shardings`` it runs on a one-rank mesh
(``fsdp.one_rank_shardings``), where every block is the whole leaf and
every collective the identity: one process's step is the same code.

``make_prefill_step`` and ``make_serve_step`` take the same parameter
shardings and the caches' (``launch/specs.py::cache_specs``), and are
then one rank's step on the mesh, as JAX's ``pjit`` of them is the
partitioned one: the rank holds its parameter blocks and gathers each
unit's weights as it reaches it, takes its rows of the batch (the rows
the caches' batch axes give it), holds its cache blocks
(:class:`~repro_torch.distributed.fsdp.CacheBlocks`: gathered over the
other split axes before a layer attends, or left split along a global
SOCKET layer's context-parallel axes) and returns the whole batch's
logits, gathered over the batch axes (JAX's replicated output).
Without shardings each is the single-process step.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import (is_trainable_path, tree_leaves,
                                     tree_map)

__all__ = ["make_train_step", "loss_and_grads", "make_prefill_step",
           "make_chunk_prefill_step", "make_serve_step"]


def loss_and_grads(cfg: ModelConfig, params, batch, shardings=None):
    """(loss, metrics, {path: gradient}) of :func:`tfm.loss_and_metrics`
    for every trainable leaf of ``params`` (JAX ``keystr`` paths, see
    :func:`repro_torch.optim.adamw.tree_leaves`); a leaf the loss does
    not reach gets zeros.  The caller's tensors are not modified.

    ``shardings`` (``{path: NamedSharding}``, a one-rank mesh's when
    None): ``params`` are a rank's blocks and ``batch`` its rows of a
    global batch; the gradients are its blocks' of the global loss, and
    the loss and ``ce`` the global batch's (all-reduced over the batch
    axes)."""
    shardings = shardings or fsdp.one_rank_shardings(cfg)
    mesh = fsdp.mesh_of(shardings)
    valid = fsdp.global_tokens(batch["labels"], mesh)
    leaves = []

    def track(path, t):
        # a detached alias that requires grad: the same storage, so the
        # in-place update reaches the caller's tensors
        if not is_trainable_path(path):
            return t
        leaves.append((path, t.detach().requires_grad_()))
        return leaves[-1][1]

    loss, metrics = tfm.loss_and_metrics(cfg, tree_map(track, params),
                                         batch,
                                         gather=fsdp.gatherer(shardings,
                                                              cfg),
                                         valid_tokens=valid, split=mesh)
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    group = mesh.group(fsdp.BATCH_AXES)
    if group is not None:
        # ce is this rank's share of the global mean (the sum is the
        # global one); the MoE aux losses are the global batch's already,
        # and the first batch rank's sum is every rank's (the ranks' ce
        # shares round the aux part apart)
        ce = collectives.all_reduce(metrics["ce"], dist.ReduceOp.SUM, group)
        metrics["loss"] = collectives.broadcast(
            metrics["loss"] - metrics["ce"] + ce, mesh, fsdp.BATCH_AXES, 0)
        metrics["ce"] = ce
    return metrics["loss"], metrics, {
        path: torch.zeros_like(t) if g is None else g
        for (path, t), g in zip(leaves, grads)}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    accum: int = 1, grad_shardings=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch``: ``tokens`` and ``labels`` (B, T) tensors on the
    parameters' device, B a multiple of ``accum``.  The parameters and
    the moments are updated in place (:func:`adamw_update`) and
    returned.  ``metrics``: at ``accum == 1`` those of
    :func:`tfm.loss_and_metrics`, above it the mean ``loss``; with
    ``grad_norm`` and ``lr`` of the update, all 0-d tensors.

    ``grad_shardings``: the tree of the parameters' shardings
    (``launch/specs.py::param_specs``; a one-rank mesh's when None):
    ``params`` and ``opt_state`` are this rank's blocks, ``batch`` is
    the global batch on every rank, and B splits into ``accum``
    microbatches of the batch axes' ranks' rows (see the module
    docstring)."""
    stacked = cfg.num_groups * len(cfg.pattern)
    shardings = fsdp.one_rank_shardings(cfg) if grad_shardings is None \
        else fsdp.flat_tree(grad_shardings)
    mesh = fsdp.mesh_of(shardings)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(
                cfg, params, fsdp.local_rows(cfg, batch, mesh, 1, 0),
                shardings)
        else:
            gsum = {path: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                    for path, p in tree_leaves(params)
                    if is_trainable_path(path)}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=gsum[next(iter(gsum))].device)
            for i in range(accum):
                loss_i, _, g = loss_and_grads(
                    cfg, params, fsdp.local_rows(cfg, batch, mesh, accum, i),
                    shardings)
                for path, gi in g.items():
                    gsum[path].add_(gi.to(torch.float32))
                lsum = lsum + loss_i
                del g
            grads = {path: g.div_(accum) for path, g in gsum.items()}
            loss = lsum / accum
            metrics = {"loss": loss}
        params, opt_state, om = adamw_update(
            ocfg, tree_map(lambda path, _: grads.get(path), params),
            opt_state, params, stacked_layers=stacked, shardings=shardings)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


def _sharded(cfg: ModelConfig, param_shardings, cache_shardings, rules):
    """(config, gather, cache blocks, MoE split, the mesh context) of the
    sharded prefill and serve steps (see the module docstring).  The step
    takes this rank's rows itself, so the context-parallel route splits
    no batch axis of its own: the config's ``decode_cp_batch_axes`` is
    empty."""
    cfg = cfg.replace(decode_cp_batch_axes=())
    shardings = fsdp.flat_tree(param_shardings)
    blocks = fsdp.CacheBlocks(cfg, cache_shardings)
    mesh = blocks.mesh
    split = mesh if blocks.rows_axes else None

    def context():
        return shd.activate_mesh(mesh, rules)

    return cfg, fsdp.gatherer(shardings, cfg), blocks, split, context


def _whole_rows(blocks, logits):
    return collectives.all_gather(logits, blocks.mesh, blocks.rows_axes, 0)


def make_prefill_step(cfg: ModelConfig, capacity: int,
                      paged: bool = False, param_shardings=None,
                      cache_shardings=None, rules=None) -> Callable:
    """(params, batch, last_index=None) -> (last-token logits, caches);
    ``batch`` holds ``tokens`` (B, T), or an embeddings-input model's
    ``embeds`` (B, T, d).  The continuous engine's legacy prefill pads prompts to a bucket and
    passes each prompt's last *real* position as ``last_index`` (see
    :func:`tfm.prefill`), which also pins sliding-window rings to the
    prompt's true end.  ``paged=True`` builds caches in pool geometry
    (page-aligned rings).

    ``param_shardings`` and ``cache_shardings`` (both or neither; the
    mesh's ``rules``): one rank's step on the mesh (module docstring):
    ``params`` its blocks, ``batch`` the global batch, the caches its
    blocks, the logits the whole batch's."""
    if param_shardings is None:
        @torch.no_grad()
        def prefill_step(params, batch, last_index=None):
            return tfm.prefill(cfg, params, batch, capacity=capacity,
                               last_index=last_index, paged=paged)
        return prefill_step
    cfg, gather, blocks, split, context = _sharded(
        cfg, param_shardings, cache_shardings, rules)

    @torch.no_grad()
    def sharded_prefill_step(params, batch, last_index=None):
        rows = {k: blocks.rows(v) for k, v in batch.items()}
        if last_index is not None:
            last_index = blocks.rows(torch.as_tensor(last_index))
        with context():
            logits, caches = tfm.prefill(
                cfg, params, rows, capacity=capacity, last_index=last_index,
                paged=paged, gather=gather, split=split,
                cache_blocks=blocks)
        return _whole_rows(blocks, logits), caches
    return sharded_prefill_step


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


def make_serve_step(cfg: ModelConfig, param_shardings=None,
                    cache_shardings=None, rules=None) -> Callable:
    """(params, caches, inp, pos[, block_tables]) -> (logits, caches); the
    caches are updated in place.  ``inp``: (B, 1) token ids, or (B, 1, d)
    embeddings for an embeddings-input model.  ``pos`` may be an int (static batch) or
    a ``(B,)`` tensor (ragged continuous batch); ``block_tables``
    switches ``caches`` to the paged pool.

    ``param_shardings`` and ``cache_shardings`` (both or neither; the
    mesh's ``rules``): one rank's step on the mesh over the static
    caches (module docstring): ``params`` and ``caches`` its blocks,
    ``inp`` the whole batch's, the logits the whole batch's."""
    if param_shardings is None:
        @torch.no_grad()
        def serve_step(params, caches, inp, pos, block_tables=None):
            return tfm.decode_step(cfg, params, caches, inp, pos,
                                   block_tables=block_tables)
        return serve_step
    cfg, gather, blocks, split, context = _sharded(
        cfg, param_shardings, cache_shardings, rules)

    @torch.no_grad()
    def sharded_serve_step(params, caches, inp, pos):
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            pos = blocks.rows(pos)
        with context():
            logits, caches = tfm.decode_step(
                cfg, params, caches, blocks.rows(inp), pos, gather=gather,
                split=split, cache_blocks=blocks)
        return _whole_rows(blocks, logits), caches
    return sharded_serve_step
