"""Meshes of ranks over ``torch.distributed``, and how ranks start.

Port of ``repro.launch.mesh``.  A :class:`Mesh` names the axes of a grid
of ranks (one process a rank) and knows each rank's coordinates, in the
row-major order in which ``jax.make_mesh`` lays out devices, and the
process group of every subset of its axes: the ranks that share this
rank's coordinates on the other axes.  The groups are built with
``dist.new_group`` from the rank grid by :meth:`Mesh.build_groups`, by
every rank in the same order (``new_group`` is collective).

:func:`make_test_mesh` builds the mesh over the initialised default
process group; :func:`default_mesh_factory` the Trainer's ``(n, 1)``
mesh over a list of ranks, which after a loss may be a subset of the
world (the ranks off the mesh still join its ``new_group`` calls).
:func:`make_production_mesh` the 16 x 16 (or 2 x 16 x 16) mesh of the
dry run, for one rank, its groups unbuilt: :meth:`Mesh.group` gives the
collectives' dry-run route a stand-in group while that route is on.

Ranks start with :func:`spawn_ranks` (``torch.multiprocessing.spawn``
joined against a deadline) and each calls :func:`init_rank`.  The
collective backend goes by the device count, never by a failure: NCCL,
one rank a card, when ``torch.cuda.device_count() >= world``; else gloo,
with every rank on ``cuda:0`` (NCCL refuses two ranks on one device) or
on the CPU.
"""

from __future__ import annotations

import datetime
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives

__all__ = ["Mesh", "default_mesh_factory", "make_test_mesh",
           "make_production_mesh",
           "collective_backend", "init_rank", "spawn_ranks",
           "INIT_TIMEOUT_S"]

# every init_process_group's timeout: a rank that dies fails the others'
# collectives in this many seconds instead of hanging them
INIT_TIMEOUT_S = 60


class Mesh:
    """A named grid of ranks (see the module docstring).

    ``shape`` maps axis name -> size in axis order, as JAX's
    ``Mesh.shape`` does.  ``ranks`` lists the global ranks of the grid's
    positions in row-major order (``range(size)`` when None): a mesh over
    a subset of the world, as the elastic Trainer rebuilds one.  ``rank``
    is this process's global rank; ``coords`` its coordinate on each axis,
    ``None`` when it is not on the mesh (:attr:`member` False).
    """

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], *,
                 rank: int = 0, ranks: Optional[Sequence[int]] = None):
        if len(axis_names) != len(sizes) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh axes {axis_names} vs sizes {sizes}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self.ranks = list(range(self.size)) if ranks is None else \
            [int(r) for r in ranks]
        if len(self.ranks) != self.size or \
                len(set(self.ranks)) != self.size:
            raise ValueError(f"mesh {self.shape} over ranks {self.ranks}")
        self.rank = rank
        self.member = rank in self.ranks
        self.coords = self.coords_of(rank) if self.member else None
        self._groups: Dict[frozenset, object] = {}
        self._built = False

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of global ``rank``, row-major over the axes."""
        pos = self.ranks.index(rank)
        out = {}
        for name in reversed(self.axis_names):
            out[name] = pos % self.shape[name]
            pos //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords``."""
        pos = 0
        for name in self.axis_names:
            pos = pos * self.shape[name] + coords[name]
        return self.ranks[pos]

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in axes if a in self.shape)

    def extent(self, axes: Sequence[str]) -> int:
        """Ranks along ``axes`` (axes not in the mesh ignored)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index along ``axes`` in the order given
        (JAX's combined ``axis_index``)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def members(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's group along ``axes``, in the
        order of their :meth:`index` along ``axes``."""
        axes = self._axes(axes)
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, vals))
            out.append(self.rank_of(c))
        return out

    def group(self, axes: Sequence[str]):
        """The process group of this rank along ``axes``; ``None`` when
        the group is this rank alone."""
        if self.extent(axes) == 1:
            return None
        if not self._built and collectives.dry_run_active():
            return collectives.DryGroup(self, self._axes(axes))
        if not self._built:
            raise RuntimeError("Mesh.group: build_groups() has not run")
        return self._groups[frozenset(a for a in self._axes(axes)
                                      if self.shape[a] > 1)]

    def build_groups(self) -> None:
        """Create the process group of every subset of axes with more
        than one rank.  Collective over the whole world: every rank of the
        default group calls it, in one order, those off the mesh too
        (``dist.new_group`` needs them all); it runs once a mesh."""
        if self._built:
            return
        names = [a for a in self.axis_names if self.shape[a] > 1]
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                rest = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = []
                    for vals in itertools.product(
                            *(range(self.shape[a]) for a in axes)):
                        c = dict(zip(rest, fixed))
                        c.update(zip(axes, vals))
                        ranks.append(self.rank_of(c))
                    g = dist.new_group(sorted(ranks))
                    if self.rank in ranks:
                        self._groups[frozenset(axes)] = g
        self._built = True


def default_mesh_factory(ranks: Sequence[int]) -> Optional[Mesh]:
    """A ``("data", "model")`` mesh of shape ``(n, 1)`` over ``ranks``;
    ``None`` for one rank (the JAX Trainer's ``default_mesh_factory``).
    Its groups are not built yet (:meth:`Mesh.build_groups`)."""
    n = len(ranks)
    if n <= 1:
        return None
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(("data", "model"), (n, 1), rank=rank, ranks=ranks)


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A ``("data", "model")`` mesh over the initialised process group
    (its world size must be ``data * model``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh: torch.distributed is not "
                           "initialised (call init_rank first)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"make_test_mesh({data}, {model}) needs "
                         f"{data * model} ranks, the group has {world}")
    mesh = Mesh(("data", "model"), (data, model), rank=dist.get_rank())
    mesh.build_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The production mesh: 16 x 16 = 256 cards, ``("data", "model")``;
    two pods, 2 x 16 x 16 = 512, ``("pod", "data", "model")``, the
    ``pod`` axis the slow cross-pod data parallelism (JAX's shapes and
    axes, its row-major rank order).  ``rank`` is the rank this process
    plays.  Its groups are not built: the dry run (``launch/dryrun.py``)
    runs one rank's step on the collectives' dry-run route, which needs
    none."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, rank=rank)


def collective_backend(world: int, device: str) -> str:
    """NCCL, one rank a card, when the card count covers ``world``; gloo
    otherwise (CPU ranks, or every rank on ``cuda:0``)."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, init_method: str,
              device: str = "cuda") -> Tuple[str, torch.device]:
    """Join the process group as ``rank`` of ``world`` (timeout
    :data:`INIT_TIMEOUT_S`); returns (backend, this rank's device)."""
    backend = collective_backend(world, device)
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    # NCCL binds the rank to its card (its barriers need no guess)
    bind = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **bind)
    return backend, dev


def spawn_ranks(fn, world: int, args: tuple = (),
                deadline_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes and join them
    by ``deadline_s``: a rank that raises fails the call (the others are
    terminated) and a run past the deadline is killed and raises."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{deadline_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
