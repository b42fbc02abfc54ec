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

A :class:`NamedSharding` (:func:`named_sharding`) is a mesh, a spec and
one placement a mesh axis (``torch.distributed.tensor``'s ``Shard(dim)``
or ``Replicate()``): :meth:`NamedSharding.shard` cuts this rank's block
out of a whole tensor and :meth:`NamedSharding.gather` rebuilds the
whole tensor from the blocks through the mesh's groups.  Blocks stay
plain tensors (the model never runs on ``DTensor``): a rank's own code
takes the place of JAX's SPMD partitioner (``distributed/fsdp.py`` for
the train step, ``distributed/context_parallel.py`` for decode).

The module keeps a thread-local "current mesh" context, so model code can
ask :func:`current_mesh` unconditionally (``None`` when no mesh is
active).  :func:`lsc` only checks and logs: eager torch has no
partitioner to hand an activation's constraint to.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed import collectives

__all__ = [
    "DEFAULT_RULES", "NamedSharding", "activate_mesh", "current_mesh",
    "entry_axes", "fallback_log", "fit_spec", "lsc", "logical_to_spec",
    "named_sharding", "spec_for_shape",
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


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A tensor's layout on a mesh: ``spec`` has one entry a dim (see the
    module docstring).  A dim sharded over axes ``A`` is cut into
    ``extent(A)`` equal blocks, block ``index(A)`` on this rank; the mesh
    axes that shard no dim replicate the tensor."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"

    @property
    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` for each mesh axis."""
        out = []
        for name in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if name in entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def replicated_axes(self) -> Tuple[str, ...]:
        """The mesh axes (of more than one rank) that shard no dim."""
        used = {a for e in self.spec for a in entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names
                     if a not in used and self.mesh.shape[a] > 1)

    def owns(self) -> bool:
        """Whether this rank's block is the one copy counted of it: its
        coordinate is 0 on every replicated axis."""
        return all(self.mesh.coords[a] == 0 for a in self.replicated_axes())

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        for d, e in enumerate(self.spec):
            n = self.mesh.extent(entry_axes(e))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {n} blocks ({self.spec})")
            out[d] //= n
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a copy, so ``full`` can go)."""
        if full.ndim != len(self.spec):
            raise ValueError(f"{self.spec} for a rank-{full.ndim} tensor")
        local = self.shard_shape(full.shape)
        idx = tuple(slice(i * n, (i + 1) * n) for i, n in zip(
            (self.mesh.index(entry_axes(e)) for e in self.spec), local))
        return full[idx].clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (collective over the
        groups of the sharded axes; the identity on a replicated one)."""
        out = local
        for d, e in enumerate(self.spec):
            if e is not None:
                out = collectives.all_gather(out, self.mesh, entry_axes(e),
                                             d)
        return out


def fit_spec(mesh, spec: Spec, shape) -> NamedSharding:
    """Reuse a spec on a tensor of the same rank, dropping the entries
    that no longer divide (the JAX package's ``opt_specs._fit``: the
    8-bit moments' padded last dim, their blocked scale's)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, e in enumerate(entries):
        keep = e is not None and \
            shape[dim] % mesh.extent(entry_axes(e)) == 0
        out.append(e if keep else None)
    return NamedSharding(mesh, tuple(out))


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int], rules: Optional[Dict] = None,
                   log: Optional[List[str]] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, shape, mesh,
                                               rules, log))


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
