"""Mixture-of-Experts FFN with sort-based (MegaBlocks-style) dispatch.

Port of ``repro.models.moe``.  Token→expert assignments are sorted by
expert (a stable sort, as ``jnp.argsort``), each assignment's position
within its expert is computed by a cumulative count, and tokens are
scattered into an ``(E, C, d)`` buffer; assignments past an expert's
capacity ``C`` are dropped first come, first served (the residual
connection carries a dropped token through unchanged).  Decode is
dropless: capacity ``n * k``.  The expert products are batched matrix
products over the expert axis, plain PyTorch as they are plain ``jnp``
in the JAX package.

``cfg.moe_dispatch``: ``"global"`` sorts all ``B * T`` tokens at once;
``"batch"`` dispatches each batch row on its own (per-row capacity).
``"alltoall"`` is the JAX package's expert-parallel exchange across
devices, which comes with ROADMAP.md queue 1 item 11.

Router losses: Switch load-balancing loss + router z-loss, returned as
scalars beside the output.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm

__all__ = ["init_moe", "apply_moe"]


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """The JAX package's distributions: an f32 ``N(0, 1/d)`` router, ``N(0,
    1/d)`` gate/up and ``N(0, 1/d_ff)`` down projections per expert."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    ff_axis = None if cfg.moe_parallelism == "ep" else "expert_mlp"
    e_axis = "experts" if cfg.moe_parallelism == "ep" else None
    dt = cfg.param_dtype
    return {
        "router": pm.normal(gen, (d, e), ("embed_w", None), stddev=s_in),
        "w_gate": pm.normal(gen, (e, d, ff), (e_axis, "embed_w", ff_axis),
                            stddev=s_in, dtype=dt),
        "w_up": pm.normal(gen, (e, d, ff), (e_axis, "embed_w", ff_axis),
                          stddev=s_in, dtype=dt),
        "w_down": pm.normal(gen, (e, ff, d), (e_axis, ff_axis, "embed_w"),
                            stddev=s_out, dtype=dt),
    }


def _router(cfg: ModelConfig, params: Dict, x2d: torch.Tensor):
    """Top-k routing.  x2d: (N, d) -> (top_idx, top_probs, aux_losses).
    Among equal probabilities the lower expert index ranks first, as
    ``jax.lax.top_k`` ranks them."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    k = cfg.num_experts_per_tok
    top_probs, top_idx = top_probs[:, :k], top_idx[:, :k]
    top_probs = top_probs / torch.clamp(
        torch.sum(top_probs, dim=-1, keepdim=True), min=1e-9)

    # Switch load-balance loss: E * sum_e f_e * P_e
    e = cfg.num_experts
    one_hot = F.one_hot(top_idx[:, 0], e).float()
    f = torch.mean(one_hot, dim=0)
    p_mean = torch.mean(probs, dim=0)
    lb_loss = e * torch.sum(f * p_mean)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return top_idx, top_probs, {"moe_lb_loss": lb_loss,
                                "moe_z_loss": z_loss}


def _expert_ffn(cfg: ModelConfig, params: Dict, buf: torch.Tensor
                ) -> torch.Tensor:
    """The expert FFN as batched products over the expert axis:
    ``(E, C, d)`` -> ``(E, C, d)``."""
    cdt = buf.dtype
    gate = torch.bmm(buf, params["w_gate"].to(cdt))
    up = torch.bmm(buf, params["w_up"].to(cdt))
    act = F.gelu(gate, approximate="tanh") if cfg.mlp_activation == \
        "geglu" else F.silu(gate)
    return torch.bmm(act * up, params["w_down"].to(cdt))


def _dispatch_ffn(cfg: ModelConfig, params: Dict, x2d: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, Dict]:
    """Sort-dispatch + expert FFN + combine over flat tokens (N, d)."""
    n, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cdt = getattr(torch, cfg.compute_dtype)
    dev = x2d.device

    top_idx, top_probs, aux = _router(cfg, params, x2d)

    # ---- sort-based dispatch -------------------------------------------
    flat_expert = top_idx.reshape(n * k)
    flat_token = torch.arange(n, device=dev).repeat_interleave(k)
    flat_prob = top_probs.reshape(n * k)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_prob = flat_prob[order]

    counts = torch.bincount(sorted_expert, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_expert = torch.arange(n * k, device=dev) - starts[sorted_expert]
    keep = pos_in_expert < capacity
    slot = torch.where(keep, pos_in_expert,
                       torch.full_like(pos_in_expert, capacity - 1))

    # scatter tokens into (E, C, d) buffers (dropped tokens masked to 0:
    # they add nothing to the slot they land in)
    zero = torch.zeros((), dtype=cdt, device=dev)
    gathered = torch.where(keep[:, None], x2d[sorted_token].to(cdt), zero)
    buf = torch.zeros((e, capacity, d), dtype=cdt, device=dev)
    buf.index_put_((sorted_expert, slot), gathered, accumulate=True)

    out_buf = _expert_ffn(cfg, params, buf)                     # (E, C, d)

    # ---- combine back to tokens ----------------------------------------
    expert_out = torch.where(keep[:, None], out_buf[sorted_expert, slot],
                             zero)
    weighted = expert_out * sorted_prob[:, None].to(cdt)
    y2d = torch.zeros((n, d), dtype=cdt, device=dev).index_add_(
        0, sorted_token, weighted)
    return y2d.to(x2d.dtype), aux


def _capacity_for(cfg: ModelConfig, n: int, t: int) -> int:
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if t == 1:
        # decode: guarantee dropless routing (worst case: every token on
        # the same expert); capacity drops would corrupt generation.
        capacity = n * k
    else:
        capacity = int(math.ceil(n * k / e * cfg.capacity_factor))
        capacity = max(capacity, 4)
    return min(capacity, n * k)


def apply_moe(cfg: ModelConfig, params: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict]:
    """MoE FFN.  x: (B, T, d) -> (y, aux_losses).

    ``cfg.moe_dispatch``: ``"global"``, one sort over all B*T tokens;
    ``"batch"``, each batch row dispatched on its own with a per-row
    capacity (the JAX package's ``vmap``; the aux losses are the mean
    over rows)."""
    b, t, d = x.shape
    if cfg.moe_dispatch == "alltoall":
        raise NotImplementedError(
            "moe_dispatch='alltoall' (expert-parallel exchange across "
            "devices) is not ported yet: it comes with ROADMAP.md queue 1 "
            "item 11")
    if cfg.moe_dispatch == "batch" and b > 1 and t > 1:
        capacity = _capacity_for(cfg, t, t)
        rows = [_dispatch_ffn(cfg, params, x[i], capacity) for i in range(b)]
        y = torch.stack([r[0] for r in rows])
        aux = {name: torch.stack([r[1][name] for r in rows]).mean()
               for name in rows[0][1]}
        return y.to(x.dtype), aux
    capacity = _capacity_for(cfg, b * t, t)
    y2d, aux = _dispatch_ffn(cfg, params, x.reshape(b * t, d), capacity)
    return y2d.reshape(b, t, d).to(x.dtype), aux
