"""AdamW from scratch: global-norm clipping, decoupled weight decay with
a path-based mask, non-trainable-parameter freezing (the SOCKET hash
planes), optional 8-bit moment states.

Port of ``repro.optim.adamw`` on the port's parameter tree (dicts and
the per-layer list ``params["layers"]``).  The state mirrors the
parameters leaf for leaf: float32 moments, or 8-bit ones
(``quantized_state``), and a 0-d placeholder for every frozen leaf.
The arithmetic is JAX's, in float32: the clip factor from the global
norm of every gradient given, bias-corrected moments, the new parameter
computed in float32 and cast back to the parameter's dtype (there is no
float32 master copy).

Two differences of layout, not of result:

* The update writes the parameters and the moments **in place** (under
  ``torch.no_grad``), a slab of rows at a time (``SLAB``), where JAX
  returns new trees: a full-size float32 temporary of the largest leaf
  (llama31-8b's 525 M-entry embedding) would otherwise be held several
  times over.  Each value's arithmetic is elementwise, so slabs change
  nothing.
* JAX stacks its scanned layer groups along a leading axis, and
  ``wants_weight_decay`` judges a leaf by its rank there: a group
  layer's leaves have one axis more than the port's per-layer ones.
  ``stacked_layers`` (the first that many entries of
  ``params["layers"]``, ``num_groups * len(pattern)``) restores that
  rank, so the port decays the leaves JAX decays, Mamba's 1-D ``D``
  inside the groups included (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.optim import quantized_state as q8
from repro_torch.optim.schedule import ScheduleConfig, learning_rate

__all__ = ["AdamWConfig", "init_adamw", "adamw_update", "is_trainable_path",
           "wants_weight_decay", "jax_rank", "tree_leaves", "tree_map"]

# values updated at once per leaf: 2**26 float32 entries are 268 MB, and
# the update holds about eight such temporaries
SLAB = 1 << 26
_LAYER = re.compile(r"\['layers'\]\[(\d+)\]")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_bits: int = 32            # 32 | 8
    schedule: ScheduleConfig = ScheduleConfig()


def is_trainable_path(path: str) -> bool:
    """hash planes are data-agnostic constants (never trained)."""
    return "hash_w" not in path


def wants_weight_decay(path: str, ndim: int) -> bool:
    """Whether the leaf at ``path`` is decayed; ``ndim`` is its rank in
    the JAX package's tree (:func:`jax_rank`)."""
    if ndim < 2:
        return False
    for tag in ("norm", "scale", "A_log", "dt_bias", "conv_b"):
        if tag in path:
            return False
    return True


def jax_rank(path: str, leaf: torch.Tensor, stacked_layers: int) -> int:
    """The rank of the leaf at ``path`` in the JAX package's tree: one
    more for the first ``stacked_layers`` layers (its scanned groups)."""
    m = _LAYER.match(path)
    return leaf.ndim + int(m is not None and int(m.group(1)) <
                           stacked_layers)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or x is None or (
        isinstance(x, dict) and set(x) == {"q", "scale"})


def tree_leaves(tree, path: str = ""):
    """``(path, leaf)`` of a tree of dicts and lists, paths written as
    JAX's ``keystr`` writes them (``['layers'][3]['attn']['wq']``); a
    q8 moment (``{"q", "scale"}``) is one leaf."""
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}['{k}']")
    else:
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")


def tree_map(fn: Callable, tree, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (paths as
    :func:`tree_leaves` writes them)."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    return [tree_map(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]


def init_adamw(cfg: AdamWConfig, params) -> Dict[str, Any]:
    def moment(path, p):
        if not is_trainable_path(path):
            return torch.zeros((), dtype=torch.float32, device=p.device)
        if cfg.state_bits == 8:
            return q8.qzeros_like(p)
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(tree_leaves(params))[1].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(moment, params), "v": tree_map(moment, params)}


def _global_norm(grads) -> torch.Tensor:
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for _, g in tree_leaves(grads) if g is not None]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _slabs(shape) -> list:
    """Row slices of the leading axis, about ``SLAB`` values each."""
    if len(shape) < 2 or shape[0] < 2:
        return [...]
    per_row = max(1, int(torch.Size(shape[1:]).numel()))
    rows = max(1, SLAB // per_row)
    return [slice(r, r + rows) for r in range(0, shape[0], rows)]


def adamw_update(cfg: AdamWConfig, grads, state, params,
                 stacked_layers: int = 0
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the moments of ``state`` updated in
    place.  ``grads`` mirrors ``params``; a frozen leaf's gradient may be
    ``None``, and the global norm counts every gradient given.  Returns
    (params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = learning_rate(cfg.schedule, step)
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    is_q8 = cfg.state_bits == 8

    def core(p, g, m, v, decay):
        g = g.to(torch.float32) * clip
        m_f = q8.dequantize(m, p.shape, power=3) if is_q8 else m
        v_f = q8.dequantize(v, p.shape, power=6) if is_q8 else v
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * torch.square(g)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if decay:
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
        if is_q8:
            for old, new in ((m, q8.quantize(m_new, power=3)),
                             (v, q8.quantize(v_new, power=6))):
                old["q"].copy_(new["q"])
                old["scale"].copy_(new["scale"])
        else:
            m.copy_(m_new)
            v.copy_(v_new)

    g_leaves = dict(tree_leaves(grads))
    m_leaves = dict(tree_leaves(state["m"]))
    v_leaves = dict(tree_leaves(state["v"]))
    with torch.no_grad():
        for path, p in tree_leaves(params):
            g = g_leaves[path]
            if not is_trainable_path(path) or g is None:
                continue
            decay = bool(cfg.weight_decay) and wants_weight_decay(
                path, jax_rank(path, p, stacked_layers))
            m, v = m_leaves[path], v_leaves[path]
            for sl in _slabs(p.shape):
                if is_q8:
                    core(p[sl], g[sl], {k: t[sl] for k, t in m.items()},
                         {k: t[sl] for k, t in v.items()}, decay)
                else:
                    core(p[sl], g[sl], m[sl], v[sl], decay)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"grad_norm": gnorm, "lr": lr}
