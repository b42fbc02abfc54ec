"""Mamba-2 (SSD — state-space duality) block [arXiv:2405.21060].

Port of ``repro.models.mamba``: the chunked SSD forward for prefill (the
intra-chunk quadratic part plus the inter-chunk recurrent state passing,
which the JAX package runs under ``lax.scan`` and the port as a Python
loop over chunks with the same ``h * decay + state`` update), and the
O(1)-state decode step.  Layout: x (B, S, d_model) -> in_proj ->
[z | xc | B | C | dt] -> causal depthwise conv over (xc, B, C) -> SSD ->
gated RMSNorm -> out_proj.

Numerics follow the JAX package: ``softplus`` is ``logaddexp(x, 0)``
(``jax.nn.softplus``; torch's ``softplus`` switches to ``x`` above its
threshold), the SSD runs in float32, and the three-operand contractions
are taken as an elementwise product and one matrix product each, so no
intermediate larger than ``(B, NC, nh, Q, Q)`` is formed.

SOCKET does not apply to these layers: they have no K/V cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm

__all__ = ["init_mamba", "mamba_train", "mamba_decode", "init_mamba_cache",
           "mamba_cache_logical_axes"]

N_GROUPS = 1  # B/C shared across heads (mamba2 default n_groups=1)


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    st = cfg.ssm_state
    conv_dim = di + 2 * N_GROUPS * st
    return di, nh, st, conv_dim


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every magnitude."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """The JAX package's distributions: ``N(0, 1/d)`` in_proj, ``N(0,
    0.25)`` conv taps, zero conv bias, ``A_log = log(1..nh)``, ``dt_bias``
    the inverse softplus of a log-uniform draw in [1e-3, 1e-1], unit
    ``D`` and norm scale, ``N(0, 1/d_inner)`` out_proj (the f32 leaves
    stay f32 whatever ``param_dtype`` is)."""
    d = cfg.d_model
    di, nh, st, conv_dim = _dims(cfg)
    dev = gen.device
    dt_ = cfg.param_dtype
    proj_out = 2 * di + 2 * N_GROUPS * st + nh   # z, xc, B, C, dt
    u = pm.uniform(gen, (nh,))
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": pm.normal(gen, (d, proj_out), ("embed_w", "ssm_inner"),
                             stddev=1.0 / math.sqrt(d), dtype=dt_),
        "conv_w": pm.normal(gen, (conv_dim, cfg.ssm_conv_width),
                            ("conv", None), stddev=0.5, dtype=dt_),
        "conv_b": pm.zeros((conv_dim,), ("conv",), dtype=dt_, device=dev),
        "A_log": pm.constant(torch.log(torch.arange(
            1, nh + 1, device=dev, dtype=torch.float32)), ("ssm_heads",)),
        "dt_bias": pm.constant(dt_bias, ("ssm_heads",)),
        "D": pm.ones((nh,), ("ssm_heads",), device=dev),
        "norm_scale": pm.ones((di,), ("ssm_inner",), device=dev),
        "out_proj": pm.normal(gen, (di, d), ("ssm_inner", "embed_w"),
                              stddev=1.0 / math.sqrt(di), dtype=dt_),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, nh, st, _ = _dims(cfg)
    return torch.split(proj, [di, di, N_GROUPS * st, N_GROUPS * st, nh],
                       dim=-1)


def _causal_conv(cfg: ModelConfig, params: Dict, u: torch.Tensor,
                 conv0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  u: (B, S, C).

    ``conv0``: optional ``(B, K-1, C)`` carried tail of the *previous*
    segment's conv inputs (chunked prefill) — replaces the zero left-pad
    so a chunk's first outputs see exactly the history a whole-sequence
    run would."""
    w = params["conv_w"].to(u.dtype)               # (C, K)
    k = w.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0)) if conv0 is None else \
        torch.cat([conv0.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(k):          # the JAX package's unrolled taps, in order
        out = out + pad[:, i:i + u.shape[1]] * w[None, None, :, i]
    return F.silu(out + params["conv_b"].to(u.dtype))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} x[..., k], -inf
    above the diagonal (``exp`` of it is the causal mask)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _ssd_chunked(cfg: ModelConfig, xh: torch.Tensor, dt: torch.Tensor,
                 a_coef: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Chunked SSD.  Shapes:
      xh (B,S,nh,hd) — inputs per head;  dt (B,S,nh) — discretization;
      a_coef (nh,) negative;  bmat/cmat (B,S,G,st).
    Returns (y (B,S,nh,hd), h_final (B,nh,hd,st)).
    """
    b, s, nh, hd = xh.shape
    st = bmat.shape[-1]
    q = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % q:
        # zero-pad to a chunk multiple: dt=0 on padding => decay=1 and no
        # input contribution, so the carried state is unaffected.
        pad = q - s % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // q

    # broadcast groups to heads
    bmat = torch.repeat_interleave(bmat, nh // N_GROUPS, dim=2)
    cmat = torch.repeat_interleave(cmat, nh // N_GROUPS, dim=2)

    xb = (xh * dt[..., None]).reshape(b, nc, q, nh, hd)
    da = (dt * a_coef[None, None, :]).reshape(b, nc, q, nh)
    bm = bmat.reshape(b, nc, q, nh, st)
    cm = cmat.reshape(b, nc, q, nh, st)

    da_t = da.permute(0, 1, 3, 2)                     # (B,NC,nh,Q)
    da_cum = torch.cumsum(da_t, dim=-1)               # within-chunk cumsum

    # 1. intra-chunk (quadratic) term: (C·Bᵀ ∘ L) · (x dt)
    scores = torch.einsum("bcqhs,bckhs->bchqk", cm, bm)   # (B,NC,nh,Q,Q)
    scores = scores * torch.exp(_segsum(da_t))
    y_diag = torch.einsum("bchqk,bckhd->bcqhd", scores, xb)
    del scores

    # 2. chunk-final states
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)    # (B,NC,nh,Q)
    states = torch.einsum("bcqhs,bcqhd->bchds",
                          bm * decay_states.permute(0, 1, 3, 2)[..., None],
                          xb)                              # (B,NC,nh,hd,st)

    # 3. inter-chunk recurrence over chunk index (lax.scan in JAX)
    chunk_decay = torch.exp(da_cum[..., -1])               # (B,NC,nh)
    h = torch.zeros((b, nh, hd, st), dtype=xh.dtype, device=xh.device) \
        if h0 is None else h0
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                    # (B,NC,nh,hd,st)

    # 4. contribution of carried state to each position
    state_decay = torch.exp(da_cum).permute(0, 1, 3, 2)    # (B,NC,Q,nh)
    y_off = torch.einsum("bcqhs,bchds->bcqhd", cm, h_prev) * \
        state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, nh, hd)
    return y[:, :s_orig], h


def _gated_out(cfg: ModelConfig, params: Dict, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm then out_proj, in the compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    y = y.to(cdt) * F.silu(z)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) *
         params["norm_scale"].float()).to(cdt)
    return y @ params["out_proj"].to(cdt)


def mamba_train(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                conv0: Optional[torch.Tensor] = None,
                return_state: bool = False, last_index=None):
    """Full-sequence Mamba-2 block.  x: (B, S, d_model).

    ``last_index``: optional ``(B,)`` of per-row last *real* positions
    (bucket- or chunk-padded prompts).  Positions past it get ``dt = 0`` —
    decay ``exp(0·a) = 1`` and zero input, so they are exact identity
    steps and the returned ``ssm`` state is the state at ``last_index``;
    the conv tail is likewise taken ending at ``last_index``.  Outputs at
    real positions are causal and unaffected.

    ``h0`` / ``conv0``: optional carried SSD state ``(B, nh, hd, st)`` and
    conv tail ``(B, conv_width-1, conv_dim)`` of an earlier segment:
    chunked prefill runs the prompt through this function one chunk at a
    time, threading both through ``return_state``.  When the segment
    length is a multiple of ``ssm_chunk`` the chunk boundaries land on the
    SSD grid and the state trajectory equals a whole-sequence run's.
    """
    b, s, _ = x.shape
    di, nh, st, conv_dim = _dims(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    proj = x.to(cdt) @ params["in_proj"].to(cdt)
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xc, bmat, cmat], dim=-1)          # (B,S,conv_dim)
    conv_out = _causal_conv(cfg, params, conv_in, conv0=conv0)
    xc, bmat, cmat = torch.split(conv_out, [di, N_GROUPS * st,
                                            N_GROUPS * st], dim=-1)

    dt = _softplus(dt.float() + params["dt_bias"].float())
    if last_index is not None:
        li = torch.as_tensor(last_index, device=x.device).long().reshape(b)
        keep = torch.arange(s, device=x.device)[None, :] <= li[:, None]
        dt = dt * keep[..., None]
    a_coef = -torch.exp(params["A_log"].float())

    xh = xc.reshape(b, s, nh, cfg.ssm_head_dim).float()
    bg = bmat.reshape(b, s, N_GROUPS, st).float()
    cg = cmat.reshape(b, s, N_GROUPS, st).float()
    if h0 is not None:
        h0 = h0.float()
    y, h_final = _ssd_chunked(cfg, xh, dt, a_coef, bg, cg, h0)
    y = y + xh * params["D"].float()[None, None, :, None]
    out = _gated_out(cfg, params, y.reshape(b, s, di), z)
    if not return_state:
        return out.to(x.dtype)
    kw = cfg.ssm_conv_width - 1
    # conv0 given: the carried tail prefixes conv_in, so a chunk whose real
    # tokens number fewer than kw reaches back into the previous chunk's
    # rows instead of zeroing them
    ext = conv_in if conv0 is None else torch.cat(
        [conv0.to(conv_in.dtype), conv_in], dim=1)
    off = 0 if conv0 is None else kw
    if last_index is None:
        conv_tail = ext[:, -kw:].clone()    # not a view pinning conv_in
        if ext.shape[1] < kw:
            conv_tail = F.pad(ext, (0, 0, kw - ext.shape[1], 0))
    else:
        idx = off + li[:, None] - kw + 1 + torch.arange(kw, device=x.device)
        tail = torch.gather(ext, 1, idx.clamp(min=0)[..., None].expand(
            b, kw, ext.shape[-1]))
        conv_tail = torch.where((idx >= 0)[..., None], tail,
                                torch.zeros((), dtype=ext.dtype,
                                            device=ext.device))
    return out.to(x.dtype), {"ssm": h_final, "conv": conv_tail.to(cdt)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None,
                     device="cpu") -> Dict:
    """Zero state of ``batch`` rows: the SSD state in float32, the conv
    tail in the compute dtype."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    di, nh, st, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, st),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_cache_logical_axes() -> Dict:
    """Logical axis names mirroring :func:`init_mamba_cache`."""
    return {"ssm": ("cache_batch", "ssm_heads", None, None),
            "conv": ("cache_batch", None, "conv")}


def mamba_decode(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent update.  x: (B, 1, d_model); returns (out,
    the new cache) and leaves ``cache`` as it was."""
    b = x.shape[0]
    di, nh, st, conv_dim = _dims(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    proj = x[:, 0].to(cdt) @ params["in_proj"].to(cdt)     # (B, ·)
    z, xc, bmat, cmat, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xc, bmat, cmat], dim=-1)           # (B, conv_dim)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    w = params["conv_w"].to(cdt)                            # (C, K)
    conv_out = torch.einsum("bkc,ck->bc", hist, w) + params["conv_b"].to(cdt)
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [di, N_GROUPS * st,
                                            N_GROUPS * st], dim=-1)

    dt = _softplus(dt.float() + params["dt_bias"].float())  # (B, nh)
    a_coef = -torch.exp(params["A_log"].float())            # (nh,)
    xh = xc.reshape(b, nh, cfg.ssm_head_dim).float()
    bg = torch.repeat_interleave(bmat.reshape(b, N_GROUPS, st),
                                 nh // N_GROUPS, dim=1).float()
    cg = torch.repeat_interleave(cmat.reshape(b, N_GROUPS, st),
                                 nh // N_GROUPS, dim=1).float()

    decay = torch.exp(dt * a_coef[None])                    # (B, nh)
    h = cache["ssm"] * decay[..., None, None] + \
        (xh * dt[..., None])[..., :, None] * bg[:, :, None, :]
    y = torch.einsum("bhds,bhs->bhd", h, cg) + \
        xh * params["D"].float()[None, :, None]
    out = _gated_out(cfg, params, y.reshape(b, di), z)[:, None]
    return out.to(x.dtype), {"ssm": h,
                             "conv": hist[:, 1:].to(cache["conv"].dtype)}
