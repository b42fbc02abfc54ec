"""The decoder stack: init / prefill / decode entry points.

Port of the serving half of ``repro.models.transformer``.  The JAX
package scans over stacked layer groups; here the stack is a Python list
of per-layer parameter dicts (``params["layers"]``, in ``cfg.layer_specs``
order) walked by a loop, and the decode caches — or the continuous
engine's page pool, which has the same per-layer list layout with
``(num_blocks, KVH, block_size, ...)`` leaves — are a list of per-layer
dicts updated in place.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, embed_tokens,
                                       init_embedding, init_mlp,
                                       init_rmsnorm, lm_head, rmsnorm)

__all__ = ["init_model", "init_decode_caches", "prefill", "prefill_chunk",
           "decode_step"]


def _check_spec(spec: LayerSpec) -> None:
    """Attention layers (global or sliding-window) with a dense MLP or
    none; Mamba and MoE layers raise."""
    if spec.kind != "attn" or spec.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"{spec.kind}/{spec.mlp} layers are not ported yet: Mamba and "
            "MoE layers come with ROADMAP.md queue 1 item 7")


def _check_inputs(cfg: ModelConfig) -> None:
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode={cfg.input_mode!r}: embeddings-input frontends "
            "come with a later slice (ROADMAP.md queue 1)")


# ------------------------------------------------------------------ blocks

def _init_block(cfg: ModelConfig, gen: torch.Generator,
                spec: LayerSpec) -> Dict:
    _check_spec(spec)
    params: Dict = {"norm_mix": init_rmsnorm(cfg.d_model, gen.device),
                    "attn": attn.init_attention(cfg, gen)}
    if spec.mlp == "dense":
        params["norm_mlp"] = init_rmsnorm(cfg.d_model, gen.device)
        params["mlp"] = init_mlp(cfg, gen)
    return params


def _mlp(cfg: ModelConfig, params: Dict, spec: LayerSpec,
         x: torch.Tensor) -> torch.Tensor:
    if spec.mlp == "dense":
        x = x + apply_mlp(cfg, params["mlp"], rmsnorm(params["norm_mlp"], x))
    return x


def _block_prefill(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                   x: torch.Tensor, positions: torch.Tensor, capacity: int,
                   last_index=None, paged: bool = False):
    _check_spec(spec)
    h, cache = attn.attention_prefill(cfg, params["attn"],
                                      rmsnorm(params["norm_mix"], x),
                                      positions, spec.attn_type, capacity,
                                      last_index=last_index, paged=paged)
    return _mlp(cfg, params, spec, x + h), cache


def _block_prefill_chunk(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                         x: torch.Tensor, positions: torch.Tensor,
                         cache: Dict, bt_row: torch.Tensor, history: int,
                         last_index: int):
    """One block's share of one prefill chunk, writing the pool in place
    (see :func:`prefill_chunk`)."""
    _check_spec(spec)
    h, cache = attn.attention_prefill_chunk(
        cfg, params["attn"], rmsnorm(params["norm_mix"], x), positions,
        spec.attn_type, cache, bt_row, history, last_index)
    return _mlp(cfg, params, spec, x + h), cache


def _block_decode(cfg: ModelConfig, params: Dict, spec: LayerSpec,
                  x: torch.Tensor, cache: Dict, pos, block_tables=None):
    _check_spec(spec)
    h, cache = attn.attention_decode(cfg, params["attn"],
                                     rmsnorm(params["norm_mix"], x), cache,
                                     pos, spec.attn_type,
                                     block_tables=block_tables)
    return _mlp(cfg, params, spec, x + h), cache


# ------------------------------------------------------------------- model

def init_model(cfg: ModelConfig, seed: int = 0, device="cpu") -> Dict:
    """Parameters ``{embed, layers, final_norm}`` drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed``, with the JAX package's
    distributions (``N(0, 1/fan_in)`` projections, ``N(0, 1)`` embedding
    table and hash planes, unit norm scales).  The numbers differ from
    the JAX package's for the same seed; the tests carry the JAX weights
    across with :func:`repro_torch.models.weights.from_jax_params`."""
    _check_inputs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": init_embedding(cfg, gen),
        "layers": [_init_block(cfg, gen, spec) for spec in cfg.layer_specs],
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }


def init_decode_caches(cfg: ModelConfig, batch: int, capacity: int,
                       device="cpu", pool=None) -> List[Dict]:
    """One zero cache dict per layer, at ``capacity`` tokens.  ``pool`` (a
    ``ServingSettings``) switches to the paged-pool layout: local layers
    get full ``block_size``-row pages (the ring handler addresses them
    circularly; no window truncation)."""
    caches = []
    for spec in cfg.layer_specs:
        _check_spec(spec)
        ring_cap = pool.block_size if (
            pool is not None and spec.attn_type == "local") else None
        caches.append(attn.init_attention_cache(
            cfg, batch, capacity, spec.attn_type, device=device,
            ring_capacity=ring_cap))
    return caches


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, capacity: int,
            last_index=None, paged: bool = False):
    """Process the prompt ``batch["tokens"]`` (B, T); returns (last-token
    logits (B, 1, V_padded), per-layer caches).

    ``last_index``: optional ``(B,)`` last *real* prompt positions of
    bucket-padded prompts (the continuous engine's legacy whole-prompt
    prefill): the logits are taken there, and sliding-window rings are
    built at it, not at the padding's end.  ``paged``: build the caches
    in the pool's geometry (page-aligned local rings)."""
    _check_inputs(cfg)
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches = []
    for spec, lp in zip(cfg.layer_specs, params["layers"]):
        x, cache = _block_prefill(cfg, lp, spec, x, positions, capacity,
                                  last_index, paged)
        caches.append(cache)
    if last_index is None:
        x = x[:, -1:]
    else:
        li = torch.as_tensor(last_index, device=x.device).long()
        x = x[torch.arange(b, device=x.device), li][:, None]
    x = rmsnorm(params["final_norm"], x)
    return lm_head(cfg, params["embed"], x), caches


def prefill_chunk(cfg: ModelConfig, params: Dict, caches: List[Dict],
                  tokens: torch.Tensor, *, bt_row: torch.Tensor, history: int,
                  last_index: int):
    """One prefix-extension prefill chunk for the whole stack, straight
    against the serving engine's page pool.

    ``tokens``: ``(1, C)`` chunk token ids (the final chunk zero-padded to
    the chunk length); ``caches``: the pool (pages written in place);
    ``bt_row``: ``(max_blocks_per_seq + C / block_size,)`` trash-padded
    block ids; ``history``: prompt tokens committed by earlier chunks;
    ``last_index``: the last real in-chunk index.

    Returns ``(logits (1, 1, V_padded) at last_index, caches)`` — the
    logits mean something only on the final chunk.
    """
    _check_inputs(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    b, c, _ = x.shape
    positions = (history + torch.arange(c, device=x.device)).expand(b, c)
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        x, caches[i] = _block_prefill_chunk(cfg, lp, spec, x, positions,
                                            caches[i], bt_row, history,
                                            last_index)
    x = rmsnorm(params["final_norm"], x[:, last_index:last_index + 1])
    return lm_head(cfg, params["embed"], x), caches


def decode_step(cfg: ModelConfig, params: Dict, caches: List[Dict],
                inputs: torch.Tensor, pos, block_tables=None):
    """One token for the whole stack.  inputs: (B, 1) token ids; pos: int
    or a ``(B,)`` tensor.

    ``block_tables``: per-request ``(B, blocks_per_seq)`` physical block
    ids — when given, ``caches`` is the serving engine's page pool and
    attention layers read and write it through ``PagedView`` (global) or
    ``RingView`` (local).  The caches
    are updated in place.  Returns (logits (B, 1, V_padded), caches)."""
    _check_inputs(cfg)
    x = embed_tokens(cfg, params["embed"], inputs)
    for i, (spec, lp) in enumerate(zip(cfg.layer_specs, params["layers"])):
        x, caches[i] = _block_decode(cfg, lp, spec, x, caches[i], pos,
                                     block_tables)
    x = rmsnorm(params["final_norm"], x)
    return lm_head(cfg, params["embed"], x), caches
