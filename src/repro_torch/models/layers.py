"""Shared neural layers: RMSNorm, RoPE, gated MLPs, embeddings.

Port of ``repro.models.layers`` with its conventions kept exactly:
RMSNorm multiplies by ``(1 + scale)`` with eps 1e-6, RoPE is half-split
(not interleaved), embeddings are scaled by ``sqrt(d_model)``, and
``lm_head`` returns padded-vocab logits.  Parameters are plain dicts of
tensors, laid out as in the JAX package; the ``init_*`` functions return
them boxed with their logical axes (``models/param.py``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm

__all__ = ["rmsnorm", "init_rmsnorm", "apply_rope", "init_mlp", "apply_mlp",
           "init_embedding", "embed_tokens", "lm_head", "softcap"]


# --------------------------------------------------------------------- norm

def init_rmsnorm(d: int, device) -> Dict:
    return {"scale": pm.ones((d,), (None,), device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


# --------------------------------------------------------------------- rope

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, T, H, hd); positions: (B, T) int."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq          # (B,T,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# --------------------------------------------------------------------- mlp

def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    dt = cfg.param_dtype
    return {
        "w_gate": pm.normal(gen, (d, ff), ("embed_w", "mlp"), stddev=s_in,
                            dtype=dt),
        "w_up": pm.normal(gen, (d, ff), ("embed_w", "mlp"), stddev=s_in,
                          dtype=dt),
        "w_down": pm.normal(gen, (ff, d), ("mlp", "embed_w"), stddev=s_out,
                            dtype=dt),
    }


def apply_mlp(cfg: ModelConfig, params: Dict, x: torch.Tensor
              ) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    x = x.to(cdt)
    gate = x @ params["w_gate"].to(cdt)
    up = x @ params["w_up"].to(cdt)
    if cfg.mlp_activation == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        act = F.silu(gate)
    return (act * up) @ params["w_down"].to(cdt)


# ------------------------------------------------------------ embeddings

def init_embedding(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """``{table, head}``: an embeddings-input model has no table (its
    frontend supplies the embeddings), a tied one no head."""
    v = cfg.padded_vocab()
    out = {}
    if cfg.input_mode == "tokens":
        out["table"] = pm.normal(gen, (v, cfg.d_model), ("vocab", "embed_w"),
                                 dtype=cfg.param_dtype)
    if not cfg.tie_embeddings:
        out["head"] = pm.normal(gen, (cfg.d_model, v), ("embed_w", "vocab"),
                                stddev=1.0 / math.sqrt(cfg.d_model),
                                dtype=cfg.param_dtype)
    return out


def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    x = params["table"][tokens].to(cdt)
    # the scale rounded to the compute dtype first, as JAX rounds it
    # (sqrt(3072) is not a bf16 value)
    return x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cdt))


def lm_head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    w = params.get("head")
    if w is None:
        w = params["table"].T
    return x.to(cdt) @ w.to(cdt)
