"""Boxed parameters: a tensor and its logical sharding axes.

Port of ``repro.models.param``.  The model's ``init_*`` functions build
trees (dicts and lists) of :class:`Boxed` leaves; :func:`unbox` and
:func:`axes_of` split them into the values and the axes, and
``distributed/sharding.py`` maps the axes to a mesh.

Draws come from a ``torch.Generator`` on the parameters' device.  A
:class:`ShapeOnly` generator makes every leaf on the ``meta`` device
instead: the same tree, shapes, dtypes and axes, and no storage, so the
specs of a full-size model are built without allocating it
(``launch/specs.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

__all__ = ["Boxed", "ShapeOnly", "generator", "normal", "uniform", "zeros",
           "ones", "constant", "unbox", "axes_of", "stack_boxed",
           "tree_paths_matching", "leaf_count"]


@dataclasses.dataclass
class Boxed:
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]

    @property
    def shape(self):
        return tuple(self.value.shape)


class ShapeOnly:
    """A generator for a shape-only init: every draw is an empty tensor
    on the ``meta`` device."""

    device = torch.device("meta")


def generator(seed: int, device):
    """A generator seeded with ``seed`` on ``device``; a
    :class:`ShapeOnly` one for the ``meta`` device."""
    if torch.device(device).type == "meta":
        return ShapeOnly()
    return torch.Generator(device=device).manual_seed(seed)


def _check(shape, axes):
    if len(shape) != len(axes):
        raise ValueError(f"axes {axes} do not match shape {shape}")


def _draw(fn, gen, shape) -> torch.Tensor:
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return fn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def normal(gen, shape, axes, *, stddev: float = 1.0,
           dtype: str = "float32") -> Boxed:
    """``N(0, stddev^2)`` samples drawn in float32 from ``gen`` on its
    device, scaled in place (one float32 copy of a large expert stack at a
    time) and cast to ``dtype``."""
    _check(shape, axes)
    x = _draw(torch.randn, gen, shape)
    return Boxed(x.mul_(stddev).to(getattr(torch, dtype)), tuple(axes))


def uniform(gen, shape) -> torch.Tensor:
    """Float32 samples of ``U[0, 1)`` from ``gen`` (not a parameter
    itself: the Mamba layer's ``dt_bias`` is computed from them)."""
    return _draw(torch.rand, gen, shape)


def zeros(shape, axes, *, dtype: str = "float32", device="cpu") -> Boxed:
    _check(shape, axes)
    return Boxed(torch.zeros(shape, dtype=getattr(torch, dtype),
                             device=device), tuple(axes))


def ones(shape, axes, *, dtype: str = "float32", device="cpu") -> Boxed:
    _check(shape, axes)
    return Boxed(torch.ones(shape, dtype=getattr(torch, dtype),
                            device=device), tuple(axes))


def constant(value: torch.Tensor, axes) -> Boxed:
    _check(value.shape, axes)
    return Boxed(value, tuple(axes))


def _map(fn: Callable, tree):
    if isinstance(tree, Boxed):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return tree


def unbox(tree):
    return _map(lambda b: b.value, tree)


def axes_of(tree):
    return _map(lambda b: b.axes, tree)


def stack_boxed(boxes):
    """Stack a list of identically-structured Boxed trees along a new
    leading ``"groups"`` axis (the JAX package's scanned-group layout; the
    port keeps its layers in a list and stacks only to compare)."""
    first = boxes[0]
    if isinstance(first, Boxed):
        return Boxed(torch.stack([b.value for b in boxes]),
                     ("groups",) + first.axes)
    if isinstance(first, dict):
        return {k: stack_boxed([b[k] for b in boxes]) for k in first}
    return [stack_boxed([b[i] for b in boxes]) for i in range(len(first))]


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def tree_paths_matching(tree, predicate: Callable[[str], bool]):
    """A tree of booleans: True where the leaf's path (written as JAX's
    ``keystr`` writes it, ``['layers'][3]['attn']['hash_w']``) satisfies
    ``predicate`` (optimizer masks, e.g. the frozen hash planes)."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}['{k}']") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(t)]
        return predicate(path)
    return walk(tree, "")


def leaf_count(tree) -> int:
    """The number of values in the tree's tensors (Boxed or plain)."""
    return sum(math.prod(t.shape) for _, t in _leaves(tree))
