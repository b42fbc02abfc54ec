"""Weight and cache bridge between the JAX package's trees and the port.

The JAX package keeps parameters as a tree of boxed arrays with the
layer groups stacked along a leading axis (``repro.models.param``); the
port keeps a plain dict with a per-layer list.  :func:`from_jax_params`
takes the unboxed JAX tree **as numpy arrays** (the caller converts with
``np.asarray``; this module imports no JAX) and unstacks the groups,
keeping every leaf's layout (``wq (d, h, hd)``, ``wo (h, hd, d)``,
``hash_w (L, P, hd)``): the hash planes are copied, never re-sampled.
:func:`caches_to_numpy` lays the port's per-layer caches out as the JAX
package's ``{"groups": {"slot_i": ...}, "remainder": ...}`` tree, so the
two can be compared leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["from_jax_params", "caches_to_numpy"]


def _tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _take(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


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
