"""The decoder stack: init / train / prefill / decode entry points.

Port of ``repro.models.transformer``.  The JAX
package scans over stacked layer groups; here the stack is a Python list
of per-layer parameter dicts (``params["layers"]``, in ``cfg.layer_specs``
order) walked by a loop, and the decode caches — or the continuous
engine's page pool, which has the same per-layer list layout with
``(num_blocks, KVH, block_size, ...)`` leaves — are a list of per-layer
dicts updated in place.  Mamba layers' caches are their recurrent
state (``{"ssm", "conv"}``, one row per batch row, or in the pool one
row per decode slot), also updated in place.

Training (:func:`forward_train`, :func:`loss_and_metrics`) is plain
autograd over the same loop; every attention layer's causal attention
goes through the ``flash_prefill`` kernel and its autograd function
(``kernels/flash_prefill/ops.py``).  ``cfg.remat_policy`` rematerialises
each layer group in the backward, as the JAX package remats its scanned
group body: ``"full"`` keeps only the group's input
(``torch.utils.checkpoint``), ``"dots"`` also keeps the weight products'
outputs (a selective-checkpoint policy, JAX's
``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import param as pm
from repro_torch.models.layers import (apply_mlp, embed_tokens,
                                       init_embedding, init_mlp,
                                       init_rmsnorm, lm_head, rmsnorm)

__all__ = ["init_model", "init_model_boxed", "param_axes", "forward_train",
           "loss_and_metrics", "init_decode_caches", "decode_cache_axes",
           "prefill", "prefill_chunk", "decode_step",
           "model_flops_per_token"]


def _input_embed(cfg: ModelConfig, embed: Dict,
                 batch: Dict) -> torch.Tensor:
    """The stack's input: ``batch["tokens"]`` (B, T) through the table,
    or an embeddings-input model's ``batch["embeds"]`` (B, T, d) (the
    frontend's output: frame or patch embeddings) at the compute
    dtype."""
    if cfg.input_mode == "tokens":
        return embed_tokens(cfg, embed, batch["tokens"])
    return batch["embeds"].to(getattr(torch, cfg.compute_dtype))


# ------------------------------------------------------------------ blocks

def _init_block(cfg: ModelConfig, gen: torch.Generator,
                spec: LayerSpec) -> Dict:
    params: Dict = {"norm_mix": init_rmsnorm(cfg.d_model, gen.device)}
    if spec.kind == "attn":
        params["attn"] = attn.init_attention(cfg, gen)
    else:
        params["mamba"] = mb.init_mamba(cfg, gen)
    if spec.mlp == "dense":
        params["norm_mlp"] = init_rmsnorm(cfg.d_model, gen.device)
        params["mlp"] = init_mlp(cfg, gen)
    elif spec.mlp == "moe":
        params["norm_mlp"] = init_rmsnorm(cfg.d_model, gen.device)
        params["moe"] = moe_mod.init_moe(cfg, gen)
    return params


def _mlp(cfg: ModelConfig, params: Dict, spec: LayerSpec,
         x: torch.Tensor, split=None) -> torch.Tensor:
    if spec.mlp == "dense":
        x = x + apply_mlp(cfg, params["mlp"], rmsnorm(params["norm_mlp"], x))
    elif spec.mlp == "moe":
        y, _ = moe_mod.apply_moe(cfg, params["moe"],
                                 rmsnorm(params["norm_mlp"], x), split)
        x = x + y
    return x


def _block_train(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                 x: torch.Tensor, positions: torch.Tensor, split=None):
    """One block's training forward: (x, MoE load-balance loss, router
    z-loss), the losses 0 for a dense block (``split``: see
    :func:`forward_train`)."""
    h = rmsnorm(params["norm_mix"], x)
    if spec.kind == "attn":
        h = attn.attention_train(cfg, params["attn"], h, positions,
                                 spec.attn_type)
    else:
        h = mb.mamba_train(cfg, params["mamba"], h)
    x = x + h
    if spec.mlp == "moe":
        y, aux = moe_mod.apply_moe(cfg, params["moe"],
                                   rmsnorm(params["norm_mlp"], x), split)
        return x + y, aux["moe_lb_loss"], aux["moe_z_loss"]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mlp(cfg, params, spec, x), zero, zero


def _block_prefill(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                   x: torch.Tensor, positions: torch.Tensor, capacity: int,
                   last_index=None, paged: bool = False, split=None):
    h = rmsnorm(params["norm_mix"], x)
    if spec.kind == "attn":
        h, cache = attn.attention_prefill(cfg, params["attn"], h, positions,
                                          spec.attn_type, capacity,
                                          last_index=last_index, paged=paged)
    else:
        h, cache = mb.mamba_train(cfg, params["mamba"], h,
                                  return_state=True, last_index=last_index)
    return _mlp(cfg, params, spec, x + h, split), cache


def _block_prefill_chunk(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                         x: torch.Tensor, positions: torch.Tensor,
                         cache: Dict, bt_row: torch.Tensor, slot: int,
                         history: int, last_index: int):
    """One block's share of one prefill chunk, writing the pool in place
    (see :func:`prefill_chunk`)."""
    h = rmsnorm(params["norm_mix"], x)
    if spec.kind == "attn":
        h, cache = attn.attention_prefill_chunk(
            cfg, params["attn"], h, positions, spec.attn_type, cache,
            bt_row, history, last_index)
    else:
        # Mamba state carries across chunks through the slot's rows: read
        # the previous chunk's SSD state and conv tail, run the chunk
        # (padding past last_index is exact identity steps), write back.
        # The first chunk starts from zeros: the slot row still holds the
        # previous occupant's state (nothing scrubs it on free).
        first = history == 0
        h, st = mb.mamba_train(
            cfg, params["mamba"], h,
            h0=None if first else cache["ssm"][slot][None],
            conv0=None if first else cache["conv"][slot][None],
            return_state=True, last_index=[last_index])
        for name in ("ssm", "conv"):
            cache[name][slot] = st[name][0]
    return _mlp(cfg, params, spec, x + h), cache


def _block_decode(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                  x: torch.Tensor, cache: Dict, pos, block_tables=None,
                  split=None):
    h = rmsnorm(params["norm_mix"], x)
    if spec.kind == "attn":
        h, cache = attn.attention_decode(cfg, params["attn"], h, cache, pos,
                                         spec.attn_type,
                                         block_tables=block_tables)
    else:
        # every row's state moves on (in the pool: every decode slot's);
        # the engine keeps idle slots' rows (paged.keep_state_rows)
        h, new = mb.mamba_decode(cfg, params["mamba"], h, cache)
        for name in ("ssm", "conv"):
            cache[name].copy_(new[name])
    return _mlp(cfg, params, spec, x + h, split), cache


# ------------------------------------------------------------------- model

def init_model_boxed(cfg: ModelConfig, seed: int = 0, device="cpu") -> Dict:
    """:func:`init_model`'s tree with every leaf a
    :class:`~repro_torch.models.param.Boxed` carrying its logical axes
    (the JAX package's, without the ``groups`` axis of its stacked
    layers).  On the ``meta`` device it allocates nothing: the shapes,
    dtypes and axes of a full-size model."""
    return _init_units(cfg, seed, device, lambda path, unit: unit)


def _init_units(cfg: ModelConfig, seed: int, device, place) -> Dict:
    """The boxed tree, drawn a unit at a time (the embedding, each layer,
    the final norm, in the generator's order) and each unit handed to
    ``place(path, unit)`` as soon as it is drawn."""
    gen = pm.generator(seed, device)
    embed = place("['embed']", init_embedding(cfg, gen))
    layers = [place(f"['layers'][{i}]", _init_block(cfg, gen, spec))
              for i, spec in enumerate(cfg.layer_specs)]
    return {"embed": embed, "layers": layers,
            "final_norm": place("['final_norm']",
                                init_rmsnorm(cfg.d_model, gen.device))}


def init_model(cfg: ModelConfig, seed: int = 0, device="cpu") -> Dict:
    """Parameters ``{embed, layers, final_norm}`` drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed``, with the JAX package's
    distributions (``N(0, 1/fan_in)`` projections, ``N(0, 1)`` embedding
    table and hash planes, unit norm scales); an embeddings-input model's
    ``embed`` holds its untied ``head`` alone (no table).  The numbers differ from
    the JAX package's for the same seed; the tests carry the JAX weights
    across with :func:`repro_torch.models.weights.from_jax_params`."""
    return pm.unbox(init_model_boxed(cfg, seed, device))


def init_model_placed(cfg: ModelConfig, seed: int, device, place) -> Dict:
    """:func:`init_model`'s tensors, each leaf passed through ``place(path,
    tensor)`` as soon as its unit is drawn (paths as
    ``optim.adamw.tree_leaves`` writes them): with ``place`` keeping a
    rank's block, the whole model is never on the device at once, only
    its largest unit (``distributed/fsdp.py::init_shards``)."""
    def unit(path, boxed):
        return _map_paths(place, pm.unbox(boxed), path)

    return _init_units(cfg, seed, device, unit)


def _map_paths(fn, tree, path: str):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return fn(path, tree)


def param_axes(cfg: ModelConfig) -> Dict:
    """Every parameter's logical axes in :func:`init_model`'s layout (a
    shape-only init: nothing is allocated)."""
    return pm.axes_of(init_model_boxed(cfg, device="meta"))


# the weight products (no batch dimension) that ``remat_policy="dots"``
# keeps: ``x @ w`` of a 3-D x dispatches to ``mm`` on the flattened rows
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` rematerialised in the backward as ``cfg.remat_policy``
    says (the JAX package's ``_remat`` of its group body)."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(cfg.remat_policy)


def _whole(path: str, tree):
    return tree


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict,
                  gather=None, split=None):
    """Full forward.  ``batch``: ``tokens`` (B, T), or ``embeds`` (B, T,
    d) for an embeddings-input model, and optional
    ``positions`` -> (padded-vocab logits (B, T, V), aux) with aux's
    ``moe_lb_loss``/``moe_z_loss`` summed over the layers and divided by
    the number of MoE layers (1 when there is none).

    Each of the ``num_groups`` repeats of ``cfg.pattern`` is one
    rematerialisation unit, the remainder layers are not rematerialised:
    the JAX package's scan body and its loop over the remainder.  (JAX
    also puts an ``optimization_barrier`` on the scan carry, an XLA
    scheduling device with nothing to do in an eager backward.)

    ``gather(path, subtree)``: where ``params`` are a rank's shards
    (``distributed/fsdp.py``), the subtree at ``path`` (``"['embed']"``,
    ``"['layers'][3]"``, ``"['final_norm']"``) with its leaves whole.  A
    group's layers are gathered inside the group's rematerialised
    function, so its backward gathers them again.  ``split``: the mesh
    whose batch axes split the batch's rows over ranks (the sharded
    step's), which the MoE layers' dispatch reads
    (``models/moe.py``); it is held by the rematerialised function, so
    the backward's recomputation takes the forward's route."""
    gather = gather or _whole
    embed = gather("['embed']", params["embed"])
    x = _input_embed(cfg, embed, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    npat = len(cfg.pattern)

    def group(x, lb, zl, first, *layers):
        for i, (spec, lp) in enumerate(zip(cfg.pattern, layers)):
            lp = gather(f"['layers'][{first + i}]", lp)
            x, dlb, dzl = _block_train(cfg, lp, spec, x, positions, split)
            lb, zl = lb + dlb, zl + dzl
        return x, lb, zl

    body = _remat(cfg, group)
    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        x, lb, zl = body(x, lb, zl, g * npat,
                         *params["layers"][g * npat:(g + 1) * npat])
    base = cfg.num_groups * npat
    for i, spec in enumerate(cfg.remainder):
        lp = gather(f"['layers'][{base + i}]", params["layers"][base + i])
        x, dlb, dzl = _block_train(cfg, lp, spec, x, positions, split)
        lb, zl = lb + dlb, zl + dzl
    x = rmsnorm(gather("['final_norm']", params["final_norm"]), x)
    logits = lm_head(cfg, embed, x)
    n_moe = sum(1 for sp in cfg.layer_specs if sp.mlp == "moe") or 1
    return logits, {"moe_lb_loss": lb / n_moe, "moe_z_loss": zl / n_moe}


def loss_and_metrics(cfg: ModelConfig, params: Dict, batch: Dict,
                     lb_coef: float = 0.01, gather=None,
                     valid_tokens=None, split=None):
    """Causal-LM loss: ``batch["labels"]`` (B, T) int, -1 = padding.
    Padded vocab entries are masked to -1e30, the log-softmax is taken in
    f32, and the loss is ``ce + lb_coef * moe_lb_loss + moe_z_loss``.
    Returns (loss, {"loss", "ce", "tokens", "moe_lb_loss"}).

    Where ``batch`` is one rank's rows of a global batch,
    ``valid_tokens`` is the global batch's valid-token count: ``ce`` is
    then this rank's share of the global mean (``distributed/fsdp.py``);
    ``gather`` and ``split`` go to :func:`forward_train`."""
    logits, aux = forward_train(cfg, params, batch, gather, split)
    labels = batch["labels"]
    v = logits.shape[-1]
    if v > cfg.vocab_size:
        pad = torch.arange(v, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long()
                            )[..., 0]
    denom = torch.clamp(valid.sum() if valid_tokens is None
                        else valid_tokens, min=1)
    ce = -torch.where(valid, token_ll, 0.0).sum() / denom
    loss = ce + lb_coef * aux["moe_lb_loss"] + aux["moe_z_loss"]
    return loss, {"loss": loss, "ce": ce, "tokens": denom,
                  "moe_lb_loss": aux["moe_lb_loss"]}


def init_decode_caches(cfg: ModelConfig, batch: int, capacity: int,
                       device="cpu", pool=None, *,
                       long_context: bool = False) -> List[Dict]:
    """One zero cache dict per layer, at ``capacity`` tokens.  ``pool`` (a
    ``ServingSettings``) switches to the paged-pool layout: local layers
    get full ``block_size``-row pages (the ring handler addresses them
    circularly; no window truncation) and Mamba layers one state row per
    decode slot (``pool.max_batch``) instead of one per block.  Under
    context-parallel decode each global layer's cache is this rank's
    block (``distributed/context_parallel.py``).  ``long_context`` is
    the JAX argument: it changes no leaf, only the axes
    (:func:`decode_cache_axes`) that place the caches."""
    caches = []
    for spec in cfg.layer_specs:
        if spec.kind != "attn":
            caches.append(mb.init_mamba_cache(
                cfg, batch if pool is None else pool.max_batch,
                device=device))
            continue
        ring_cap = pool.block_size if (
            pool is not None and spec.attn_type == "local") else None
        caches.append(attn.init_attention_cache(
            cfg, batch, capacity, spec.attn_type, device=device,
            ring_capacity=ring_cap))
    return caches


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, capacity: int,
            last_index=None, paged: bool = False, gather=None, split=None,
            cache_blocks=None):
    """Process the prompt ``batch["tokens"]`` (B, T), or ``batch["embeds"]``
    (B, T, d) for an embeddings-input model; returns (last-token logits
    (B, 1, V_padded), per-layer caches).

    ``last_index``: optional ``(B,)`` last *real* prompt positions of
    bucket-padded prompts (the continuous engine's legacy whole-prompt
    prefill): the logits are taken there, and sliding-window rings are
    built at it, not at the padding's end.  ``paged``: build the caches
    in the pool's geometry (page-aligned local rings).

    The sharded step (``runtime/steps.py``): ``gather(path, subtree)``
    gives each unit's weights whole from a rank's blocks (as in
    :func:`forward_train`), ``split`` is the mesh whose batch axes split
    ``batch``'s rows (the MoE layers' dispatch reads it), and
    ``cache_blocks.cut(i, cache)`` keeps layer ``i``'s cache block
    (``distributed/fsdp.py::CacheBlocks``)."""
    gather = gather or _whole
    embed = gather("['embed']", params["embed"])
    x = _input_embed(cfg, embed, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches = []
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        x, cache = _block_prefill(cfg, gather(f"['layers'][{i}]", lp), spec,
                                  x, positions, capacity, last_index, paged,
                                  split)
        caches.append(cache if cache_blocks is None
                      else cache_blocks.cut(i, cache))
    if last_index is None:
        x = x[:, -1:]
    else:
        li = torch.as_tensor(last_index, device=x.device).long()
        x = x[torch.arange(b, device=x.device), li][:, None]
    x = rmsnorm(gather("['final_norm']", params["final_norm"]), x)
    return lm_head(cfg, embed, x), caches


def prefill_chunk(cfg: ModelConfig, params: Dict, caches: List[Dict],
                  tokens: torch.Tensor, *, bt_row: torch.Tensor, slot: int,
                  history: int, last_index: int):
    """One prefix-extension prefill chunk for the whole stack, straight
    against the serving engine's page pool.

    ``tokens``: ``(1, C)`` chunk token ids (the final chunk zero-padded to
    the chunk length); ``caches``: the pool (pages written in place);
    ``bt_row``: ``(max_blocks_per_seq + C / block_size,)`` trash-padded
    block ids; ``slot``: the request's decode slot (carries Mamba state
    across chunks); ``history``: prompt tokens committed by earlier chunks;
    ``last_index``: the last real in-chunk index.

    Returns ``(logits (1, 1, V_padded) at last_index, caches)`` — the
    logits mean something only on the final chunk.  Token models only,
    as the continuous engine that calls it.
    """
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode={cfg.input_mode!r}: prefill_chunk takes token ids "
            "(the continuous engine serves token models only)")
    x = embed_tokens(cfg, params["embed"], tokens)
    b, c, _ = x.shape
    positions = (history + torch.arange(c, device=x.device)).expand(b, c)
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        x, caches[i] = _block_prefill_chunk(cfg, lp, spec, x, positions,
                                            caches[i], bt_row, slot,
                                            history, last_index)
    x = rmsnorm(params["final_norm"], x[:, last_index:last_index + 1])
    return lm_head(cfg, params["embed"], x), caches


def decode_step(cfg: ModelConfig, params: Dict, caches: List[Dict],
                inputs: torch.Tensor, pos, block_tables=None, gather=None,
                split=None, cache_blocks=None):
    """One token for the whole stack.  inputs: (B, 1) token ids, or (B, 1,
    d) embeddings for an embeddings-input model; pos: int or a ``(B,)``
    tensor.

    ``block_tables``: per-request ``(B, blocks_per_seq)`` physical block
    ids — when given, ``caches`` is the serving engine's page pool and
    attention layers read and write it through ``PagedView`` (global) or
    ``RingView`` (local).  The caches
    are updated in place.  Returns (logits (B, 1, V_padded), caches).

    The sharded step: ``gather`` and ``split`` as in :func:`prefill`;
    ``cache_blocks.open(i, block)`` gives layer ``i``'s cache whole
    over the axes it attends across, and ``cache_blocks.close(i, block,
    whole)`` writes the step's rows back into the block."""
    gather = gather or _whole
    embed = gather("['embed']", params["embed"])
    if cfg.input_mode == "tokens":
        x = embed_tokens(cfg, embed, inputs)
    else:
        x = inputs.to(getattr(torch, cfg.compute_dtype))
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        lp = gather(f"['layers'][{i}]", lp)
        if cache_blocks is None:
            x, caches[i] = _block_decode(cfg, lp, spec, x, caches[i], pos,
                                         block_tables, split)
            continue
        whole = cache_blocks.open(i, caches[i])
        x, whole = _block_decode(cfg, lp, spec, x, whole, pos, block_tables,
                                 split)
        caches[i] = cache_blocks.close(i, caches[i], whole)
    x = rmsnorm(gather("['final_norm']", params["final_norm"]), x)
    return lm_head(cfg, embed, x), caches


def _block_cache_axes(cfg: ModelConfig, spec: LayerSpec,
                      long_context: bool) -> Dict:
    if spec.kind == "attn":
        return attn.cache_logical_axes(cfg, spec.attn_type, long_context)
    return mb.mamba_cache_logical_axes()


def decode_cache_axes(cfg: ModelConfig, long_context: bool = False
                      ) -> List[Dict]:
    """Each layer's cache leaves' logical axes, in
    :func:`init_decode_caches`' per-layer layout: JAX's stacked group
    axes without their leading ``groups`` entry."""
    return [_block_cache_axes(cfg, spec, long_context)
            for spec in cfg.layer_specs]


# ------------------------------------------------------------- accounting

def model_flops_per_token(cfg: ModelConfig, seq_len: int,
                          training: bool = True) -> float:
    """The JAX package's MODEL_FLOPS: 6 (training) or 2 x the active
    parameters, plus the attention products over each attention layer's
    span (half the sequence, or the window), for the roofline's
    useful-compute ratio."""
    n_active = cfg.active_param_count()
    mult = 6.0 if training else 2.0
    flops = mult * n_active
    attended = 0.0
    for spec in cfg.layer_specs:
        if spec.kind != "attn":
            continue
        span = seq_len / 2 if spec.attn_type == "global" else min(
            cfg.sliding_window, seq_len / 2)
        attended += span
    flops += mult / 3 * 2 * 2 * cfg.num_heads * cfg.head_dim * attended * 3
    return flops
