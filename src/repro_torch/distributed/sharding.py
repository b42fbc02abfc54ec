"""Logical-axis sharding rules (MaxText-style) + divisibility-safe mapping.

Port of ``repro.distributed.sharding``.  Parameters and activations are
annotated with *logical* axis names; a rule table maps them to mesh axes.
:func:`logical_to_spec` drops a mapping when the dimension size is not
divisible by the mesh-axis extent (e.g. musicgen's 24 heads on a 16-way
"model" axis) and records the fallback.

A spec is a tuple with one entry a dim: ``None``, an axis name, or a
tuple of axis names (the entries of JAX's ``PartitionSpec``).  A mesh is
anything with a ``shape`` mapping axis name -> size
(:class:`repro_torch.launch.mesh.Mesh`).

The module keeps a thread-local "current mesh" context, so model code can
ask :func:`current_mesh` unconditionally (``None`` when no mesh is
active).  Eager torch has no SPMD partitioner: a rank's own code takes the
place of JAX's ``shard_map`` (``distributed/context_parallel.py``), and
:func:`lsc` only checks and logs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_RULES", "activate_mesh", "current_mesh", "fallback_log", "lsc",
    "logical_to_spec", "spec_for_shape",
]

Spec = Tuple[Optional[object], ...]

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    # residual-stream sequence dim: ("model",) enables Megatron-style
    # sequence parallelism of activations between blocks
    "act_seq": None,
    "embed": None,
    "q_heads": ("model",),
    # weights
    "embed_w": ("data",),          # FSDP: weight shards over data axis
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),      # intra-expert TP (moe_parallelism="tp")
    "moe_capacity": ("data",),     # (E, C, ·) dispatch-buffer capacity dim
    "moe_tokens": ("data",),       # flattened (N·k, ·) assignment tensors
    # kv-cache
    "cache_batch": ("pod", "data"),
    "cache_heads": ("model",),
    "cache_seq": None,
    "cache_seq_cp": ("pod", "data"),  # context parallel (long_500k decode)
    # misc
    "groups": None,                 # scan-group stacking axis
    "tables": None,
    "conv": ("model",),
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "state": None,
}

_CTX = threading.local()


class _MeshContext:
    def __init__(self, mesh, rules: Dict[str, Optional[Tuple[str, ...]]]):
        self.mesh = mesh
        self.rules = rules
        self.fallbacks: List[str] = []


def _ctx() -> Optional[_MeshContext]:
    return getattr(_CTX, "ctx", None)


@contextlib.contextmanager
def activate_mesh(mesh, rules: Optional[Dict] = None):
    """Install ``mesh`` (+ optional rule overrides) as the current mesh."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    prev = _ctx()
    _CTX.ctx = _MeshContext(mesh, merged)
    try:
        yield _CTX.ctx
    finally:
        _CTX.ctx = prev


def current_mesh():
    c = _ctx()
    return c.mesh if c else None


def fallback_log() -> List[str]:
    c = _ctx()
    return c.fallbacks if c else []


def _axis_size(mesh, names: Sequence[str]) -> int:
    total = 1
    for n in names:
        if n in mesh.shape:
            total *= mesh.shape[n]
    return total


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int], mesh,
                    rules: Optional[Dict] = None,
                    log: Optional[List[str]] = None) -> Spec:
    """Map per-dim logical names to a spec, checking divisibility.

    ``rules`` are *overrides* merged on top of DEFAULT_RULES.
    """
    rules = {**DEFAULT_RULES, **(rules or {})}
    entries = []
    for dim, name in enumerate(logical_axes):
        if name is None:
            entries.append(None)
            continue
        if name not in rules:
            raise KeyError(f"unknown logical axis {name!r}")
        mapped = rules[name]
        if mapped is None:
            entries.append(None)
            continue
        mesh_axes = tuple(a for a in mapped if a in mesh.shape)
        if not mesh_axes:
            entries.append(None)
            continue
        size = _axis_size(mesh, mesh_axes)
        if shape[dim] % size != 0:
            if log is not None:
                log.append(
                    f"replicated dim {dim} ({name}={shape[dim]}) — not "
                    f"divisible by mesh axes {mesh_axes} (size {size})")
            entries.append(None)
        else:
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(entries)


def spec_for_shape(mesh, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Spec:
    return logical_to_spec(logical_axes, shape, mesh)


def lsc(x, *logical_axes: Optional[str]):
    """Logical sharding constraint on an activation: the identity.

    Eager torch has no SPMD partitioner to hand the constraint to, so
    ``x`` is returned as it is.  Under an active mesh the axes are still
    checked against ``x``'s rank and mapped, so a non-divisible dim lands
    in :func:`fallback_log` as it does in the JAX package.
    """
    c = _ctx()
    if c is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"lsc: {len(logical_axes)} axes for rank-{x.ndim}")
    logical_to_spec(logical_axes, x.shape, c.mesh, c.rules, c.fallbacks)
    return x
