"""Weight and cache bridge between the JAX package's trees and the port.

The JAX package keeps parameters as a tree of boxed arrays with the
layer groups stacked along a leading axis (``repro.models.param``); the
port keeps a plain dict with a per-layer list.  :func:`from_jax_params`
takes the unboxed JAX tree **as numpy arrays** (the caller converts with
``np.asarray``; this module imports no JAX) and unstacks the groups,
keeping every leaf's layout and dtype (bf16 leaves of a
``param_dtype="bfloat16"`` tree bit for bit; ``wq (d, h, hd)``, ``wo (h, hd,
d)``, ``hash_w (L, P, hd)``; a Mamba layer's ``mamba`` subtree with its
float32 ``A_log``, ``dt_bias`` and ``D``; an MoE layer's ``moe`` subtree
with its float32 router and ``(E, d, ff)`` experts): the hash planes are
copied, never re-sampled.  :func:`caches_to_numpy` lays the port's
per-layer caches (Mamba layers' ``ssm``/``conv`` state among them) out as
the JAX package's ``{"groups": {"slot_i": ...}, "remainder": ...}`` tree,
so the two can be compared leaf by leaf.  :func:`opt_state_from_jax`
carries the JAX package's AdamW state (``init_adamw``/``adamw_update``:
the step and the float32 or 8-bit ``{"q", "scale"}`` moments, as numpy)
into the port's layout, so both optimizers can step from one state.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["from_jax_params", "opt_state_from_jax", "caches_to_numpy"]


def _tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 torch can take: carry the 16-bit words as
        # they are, bit for bit
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _take(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    # a frozen leaf's 0-d moment placeholder is not stacked
    return tree if np.ndim(tree) == 0 else tree[g]


def from_jax_params(cfg: ModelConfig, tree: Dict, device="cpu") -> Dict:
    """The port's parameters from an unboxed JAX ``init_model`` tree of
    numpy arrays."""
    layers: List[Dict] = []
    for g in range(cfg.num_groups):
        for i in range(len(cfg.pattern)):
            layers.append(_tensors(_take(tree["groups"][f"slot_{i}"], g),
                                   device))
    for i in range(len(cfg.remainder)):
        layers.append(_tensors(tree["remainder"][f"slot_{i}"], device))
    return {"embed": _tensors(tree["embed"], device), "layers": layers,
            "final_norm": _tensors(tree["final_norm"], device)}


def opt_state_from_jax(cfg: ModelConfig, state: Dict, device="cpu") -> Dict:
    """The port's AdamW state from the JAX package's, as numpy: the step
    and the ``m``/``v`` trees unstacked as :func:`from_jax_params`
    unstacks parameters (8-bit moments' ``q``/``scale`` alike)."""
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device),
            "m": from_jax_params(cfg, state["m"], device),
            "v": from_jax_params(cfg, state["v"], device)}


def _leaf_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if name == "bits" and t.dtype == torch.int32:
        return t.numpy().view(np.uint32)       # the JAX package's words
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def caches_to_numpy(cfg: ModelConfig, caches: List[Dict]) -> Dict:
    """Per-layer caches as the JAX cache tree of numpy arrays: group
    layers stacked on a leading axis, packed bits as uint32, bf16 leaves
    widened to float32."""
    npat = len(cfg.pattern)
    groups = {}
    for i in range(npat):
        per_group = [caches[g * npat + i] for g in range(cfg.num_groups)]
        groups[f"slot_{i}"] = {
            name: np.stack([_leaf_numpy(name, c[name]) for c in per_group])
            for name in per_group[0]}
    base = cfg.num_groups * npat
    rem = {f"slot_{i}": {name: _leaf_numpy(name, t)
                         for name, t in caches[base + i].items()}
           for i in range(len(cfg.remainder))}
    return {"groups": groups, "remainder": rem}
