"""The collectives of the port's meshes, over ``torch.distributed``.

Each runs over the process group of this rank's group along some mesh
axes (:meth:`repro_torch.launch.mesh.Mesh.group`), orders its blocks by
the ranks' index along those axes (the order JAX lays a sharded
dimension out in), and is the identity on a group of one rank.

One route per backend and device:

* **NCCL** (one rank a card): every collective on the device.
* **gloo on CPU tensors** (the CPU tests): gloo's own collectives.
* **gloo on CUDA tensors**, which serves one layout only: every rank of
  the group on ``cuda:0``, ``launch.mesh.init_rank``'s layout when the
  cards do not cover the ranks (a test rig of several ranks on one
  card, not a deployment).  Every collective goes card to card: each
  rank of the group keeps a mailbox on the card, opened in the others
  through CUDA IPC (:class:`_Mailboxes`); a rank copies its tensor into
  its mailbox and reads the others' after a barrier (a gloo barrier of
  the group, and another before any mailbox is written again).  No rank
  frees a buffer another may still map: a grown mailbox's old buffer
  outlives every rank's view of it, and :func:`close_mailboxes` drops
  every view before any buffer.  Each is counted in
  :data:`PEER_COPIED`.  A reduction sums (or takes the
  largest) in the members' index order, so every rank reads the same
  bits.  Ranks of one gloo group on different devices are refused.

Beside the gathers, reductions and the reduce-scatter: the all-to-all
of JAX's ``all_to_all(..., tiled=True)`` (:func:`all_to_all`), the ring
shift of its ``ppermute`` (:func:`permute`, ``isend``/``irecv`` pairs:
blocking sends on a ring deadlock), a broadcast from one member and a
sum onto one member.  The ``torch.autograd.Function`` classes at the
end make them differentiable: an all-to-all's backward is the
all-to-all of the gradients, a permute's the permute the other way.

**The dry run** (:func:`dry_run`, a context manager): no process group
and no other rank.  Each collective of a group of more than one rank
records its kind, named as XLA names it (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``, ``collective-broadcast``), and its result's
bytes in the route's records (``roofline.collective_bytes`` sums them,
as the JAX package sums the result shapes of its HLO's collectives),
and returns a tensor of the result's shape with finite data that is not
a model's: a gather tiles this rank's block, a reduction or a
reduce-scatter returns this rank's part of its input, an all-to-all, a
permute or a broadcast its input.  ``launch/dryrun.py`` runs one rank
of the production mesh on it, on fake tensors on the CPU and for real
on the card alike; :meth:`repro_torch.launch.mesh.Mesh.group` hands it
a :class:`DryGroup` while its groups are unbuilt.

With ``TIMING["on"]`` each call synchronises the device before and after
itself and adds its seconds to :data:`SECONDS` by kind (the share of a
train step in gathers, reduce-scatters and all-to-alls); the
synchronisations cost the overlap of a collective with the work queued
before it, so a step timed this way is not a gated step.
"""

from __future__ import annotations

import contextlib
import functools
import socket
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["comm_route", "dry_run", "dry_run_active", "DryGroup",
           "all_reduce", "all_gather", "reduce_scatter",
           "all_to_all", "permute", "broadcast", "reduce",
           "close_mailboxes", "PEER_COPIED", "TIMING", "SECONDS",
           "AllToAll", "Permute", "TakeBlock", "GatherBlocks",
           "GatherRows", "SumGrad", "ScaleGrad", "MeanOver",
           "BroadcastFrom"]

# collectives of a group on one card through its ranks' mailboxes: calls
# and the bytes each rank posted
PEER_COPIED: Dict[str, int] = {"calls": 0, "bytes": 0}
TIMING = {"on": False}
SECONDS: Dict[str, float] = {"all_reduce": 0.0, "all_gather": 0.0,
                             "reduce_scatter": 0.0, "all_to_all": 0.0,
                             "permute": 0.0, "broadcast": 0.0,
                             "reduce": 0.0}


_DRY: Dict[str, object] = {"records": None}


@contextlib.contextmanager
def dry_run():
    """The dry-run route (module docstring) for the calls inside; yields
    its list of ``(kind, result bytes)`` records."""
    prev = _DRY["records"]
    records: List[Tuple[str, int]] = []
    _DRY["records"] = records
    try:
        yield records
    finally:
        _DRY["records"] = prev


def dry_run_active() -> bool:
    return _DRY["records"] is not None


class DryGroup:
    """The stand-in process group of ``axes`` on the dry-run route."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = mesh.extent(self.axes)


def _dry(kind: str, out: torch.Tensor) -> torch.Tensor:
    _DRY["records"].append((kind, out.numel() * out.element_size()))
    return out


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(fn):
    """Adds the call's seconds to ``SECONDS[fn.__name__]`` while
    ``TIMING["on"]``."""
    @functools.wraps(fn)
    def wrapper(t, *args, **kw):
        if not TIMING["on"]:
            return fn(t, *args, **kw)
        _sync(t)
        t0 = time.perf_counter()
        out = fn(t, *args, **kw)
        _sync(out)
        SECONDS[fn.__name__] += time.perf_counter() - t0
        return out
    return wrapper


def comm_route(t: torch.Tensor, group=None) -> str:
    """``"mailbox"`` for gloo on a CUDA tensor (every rank on ``cuda:0``:
    card to card through the ranks' mailboxes), else ``"device"``."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return "mailbox"
    return "device"


class _Mailboxes:
    """Each rank's byte buffer on the one card of a group, and every
    other rank's opened through CUDA IPC; grown (a collective over the
    group) when a tensor needs more, which every rank asks for at the
    same call, the tensors of a group's collectives being of one size.

    Growing never frees or unmaps a buffer another rank may still hold:
    each rank drops its views of the others' buffers, posts its new
    buffer (a collective of the group: past it, every rank has dropped
    its views), and only then frees its old one.  It posts one share of
    the buffer a peer: torch keeps an unsigned reference count a share,
    which its consumer counts down once, so one share opened by three
    peers wraps below zero and the buffer stays in torch's limbo to the
    process's end ("Producer process has been terminated before all
    shared CUDA tensors released").  Releasing a view opens the
    producer's reference-count file in ``/dev/shm`` by name; meeting the
    producer's own close of that file, both processes can count it down
    to zero, and the second unlink aborts ("could not unlink the shared
    memory file").  ``experiments/mailbox_churn.py`` counts the aborts
    and those warnings over many starts."""

    def __init__(self, group):
        self.group = group
        self.nbytes = 0
        self.own = None
        self.peers: list = []

    def ensure(self, nbytes: int, device) -> None:
        if nbytes <= self.nbytes:
            return
        from torch.multiprocessing.reductions import reduce_tensor
        self.peers = []                 # this rank's views of the others'
        torch.cuda.synchronize(device)
        own = torch.empty(nbytes, dtype=torch.uint8, device=device)
        me, world = dist.get_rank(self.group), dist.get_world_size(self.group)
        # a share of its own for each peer: torch keeps one reference
        # count a share, which the one process opening it counts down once
        posted = [None] * world
        dist.all_gather_object(
            posted, (socket.gethostname(), own.device.index,
                     [None if g == me else reduce_tensor(own)
                      for g in range(world)]), group=self.group)
        # every rank has dropped its views: the old buffer may go
        self.own, self.nbytes = own, nbytes
        if len({p[:2] for p in posted}) != 1:
            raise RuntimeError(
                "a gloo group of CUDA tensors on more than one device: "
                f"{[p[:2] for p in posted]} (launch.mesh.init_rank puts "
                "every gloo rank on cuda:0)")
        self.peers = [own if g == me else shares[me][0](*shares[me][1])
                      for g, (_, _, shares) in enumerate(posted)]


_MAILBOXES: Dict[object, _Mailboxes] = {}


def _mailboxes(group) -> _Mailboxes:
    if group not in _MAILBOXES:
        _MAILBOXES[group] = _Mailboxes(group)
    return _MAILBOXES[group]


def close_mailboxes() -> None:
    """Drop this rank's mailboxes and its views of the others' (call on
    every rank of the world together, before the processes end): every
    rank's views first, then, past a barrier, the buffers, released to
    the card (``torch.cuda.ipc_collect``) before a second barrier, so no
    rank frees a buffer another still maps, and none ends while another
    frees."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for box in _MAILBOXES.values():
        box.peers = []
    if cuda:
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()                  # every rank's views dropped
    for box in _MAILBOXES.values():
        box.own, box.nbytes = None, 0
    _MAILBOXES.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
    if dist.is_initialized():
        dist.barrier()                  # every rank's buffers freed


def _post(t: torch.Tensor, group, write: bool = True) -> _Mailboxes:
    """``t``'s bytes in this rank's mailbox (where ``write``), every
    rank's posted (a barrier)."""
    raw = t.contiguous().view(-1).view(torch.uint8)
    box = _mailboxes(group)
    box.ensure(raw.numel(), t.device)
    if write:
        box.own[:raw.numel()].copy_(raw)
        PEER_COPIED["calls"] += 1
        PEER_COPIED["bytes"] += raw.numel()
    torch.cuda.synchronize(t.device)
    dist.barrier(group=group)
    return box


def _read(box: _Mailboxes, g: int, t: torch.Tensor) -> torch.Tensor:
    """Group rank ``g``'s posted tensor of ``t``'s shape and dtype."""
    n = t.numel() * t.element_size()
    return box.peers[g][:n].view(t.dtype).view(t.shape)


def _done(t: torch.Tensor, group) -> None:
    """Every rank has read the mailboxes (they may be written again)."""
    torch.cuda.synchronize(t.device)
    dist.barrier(group=group)


def _members(mesh, axes):
    """(the group's global ranks in index order along ``axes``, the same
    in the group's own rank order)."""
    members = mesh.members(axes)
    return members, sorted(members)


_FOLD = {dist.ReduceOp.SUM: torch.Tensor.add_,
         dist.ReduceOp.MAX: lambda a, b: torch.maximum(a, b, out=a),
         dist.ReduceOp.MIN: lambda a, b: torch.minimum(a, b, out=a)}


def _fold(box, order, ranks, t, op) -> torch.Tensor:
    """The posted tensors of ``ranks``, reduced by ``op`` in that
    order."""
    if op not in _FOLD:
        raise ValueError(f"reduction {op} has no mailbox route")
    out = None
    for r in ranks:
        part = _read(box, order.index(r), t)
        out = part.clone() if out is None else _FOLD[op](out, part)
    return out


@_timed
def all_reduce(t: torch.Tensor, op, group, mesh=None, axes=None
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor; ``group`` None means a
    group of this rank alone).  On the mailbox route the members are
    read in the order of their global rank, or of their index along
    ``axes`` where ``mesh`` and ``axes`` are given."""
    if group is None:
        return t.clone()
    if isinstance(group, DryGroup):
        return _dry("all-reduce", t.clone())
    if comm_route(t, group) == "mailbox":
        order = sorted(dist.get_process_group_ranks(group))
        ranks = order if mesh is None else mesh.members(axes)
        box = _post(t, group)
        out = _fold(box, order, ranks, t, op)
        _done(t, group)
        return out
    buf = t.detach().clone().contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf


@_timed
def all_gather(t: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """The tensors ``t`` of this rank's group along ``axes``, concatenated
    along ``dim`` in the order of the ranks' index along ``axes``; moved
    as bytes, so any dtype crosses bit for bit."""
    group = mesh.group(axes)
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry("all-gather", torch.cat([t] * group.size, dim=dim))
    members, order = _members(mesh, axes)
    if comm_route(t, group) == "mailbox":
        box = _post(t, group)
        out = torch.cat([_read(box, order.index(r), t) for r in members],
                        dim=dim)
        _done(t, group)
        return out
    raw = t.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in members]
    dist.all_gather(parts, raw, group=group)
    parts = [parts[order.index(r)] for r in members]
    return torch.cat(parts, dim=dim).view(t.dtype)


@_timed
def reduce_scatter(t: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
    """``t`` summed over this rank's group along ``axes``, of which this
    rank keeps its block along ``dim``: block ``mesh.index(axes)`` of
    ``extent(axes)`` equal blocks."""
    group = mesh.group(axes)
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry("reduce-scatter", _block(t, mesh, axes, dim).contiguous())
    members, order = _members(mesh, axes)
    if comm_route(t, group) == "mailbox":
        box = _post(t, group)
        n = len(members)
        size = t.shape[dim] // n
        i = members.index(mesh.rank)
        # every member's block i, summed in the members' index order
        out = None
        for r in members:
            part = _read(box, order.index(r), t).narrow(dim, i * size, size)
            out = part.clone() if out is None else out.add_(part)
        _done(t, group)
        return out.contiguous()
    blocks = t.movedim(dim, 0).chunk(len(members), dim=0)
    # the group's rank r receives the block of the member it is
    x = torch.cat([blocks[members.index(r)] for r in order], dim=0)
    out = torch.empty((x.shape[0] // len(members),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.detach().contiguous(), group=group)
    return out.movedim(0, dim)


@_timed
def all_to_all(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """JAX's ``all_to_all(t, axes, 0, 0, tiled=True)``: ``t``'s dim 0 in
    ``extent(axes)`` equal blocks, block ``j`` sent to the member of
    index ``j``; returns the blocks received, the one from the member of
    index ``i`` at block ``i``.  Moved as bytes."""
    group = mesh.group(axes)
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry("all-to-all", t.clone())
    members, order = _members(mesh, axes)
    n = len(members)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does not "
                         f"split into {n} blocks")
    size = t.shape[0] // n
    if comm_route(t, group) == "mailbox":
        me = members.index(mesh.rank)
        box = _post(t, group)
        out = torch.cat([_read(box, order.index(r), t).narrow(
            0, me * size, size) for r in members], dim=0)
        _done(t, group)
        return out
    raw = t.contiguous().view(t.shape[0], -1).view(torch.uint8)
    blocks = raw.chunk(n, dim=0)
    # the group's rank q gets the block of the member it is
    x = torch.cat([blocks[members.index(r)] for r in order], dim=0)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    got = out.chunk(n, dim=0)
    out = torch.cat([got[order.index(r)] for r in members], dim=0)
    return out.view(t.dtype).view(t.shape)


@_timed
def permute(t: torch.Tensor, mesh, axis: str, shift: int = 1
            ) -> torch.Tensor:
    """JAX's ``ppermute(t, axis, [(i, (i + shift) % n)])``: this rank's
    ``t`` goes to the member ``shift`` places on along ``axis`` (a ring),
    and the tensor of the member ``shift`` places back comes in."""
    group = mesh.group((axis,))
    n = mesh.extent((axis,))
    if group is None or shift % n == 0:
        return t
    if isinstance(group, DryGroup):
        return _dry("collective-permute", t.clone())
    members, order = _members(mesh, (axis,))
    i = members.index(mesh.rank)
    src, dst = members[(i - shift) % n], members[(i + shift) % n]
    if comm_route(t, group) == "mailbox":
        box = _post(t, group)
        out = _read(box, order.index(src), t).clone()
        _done(t, group)
        return out
    raw = t.contiguous().view(-1).view(torch.uint8)
    out = torch.empty_like(raw)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, raw, dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out.view(t.dtype).view(t.shape)


@_timed
def broadcast(t: torch.Tensor, mesh, axes: Sequence[str], src: int
              ) -> torch.Tensor:
    """The ``t`` of the member of index ``src`` along ``axes``, on every
    member (each passes a tensor of that shape and dtype)."""
    group = mesh.group(axes)
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry("collective-broadcast", t.clone())
    members, order = _members(mesh, axes)
    mine = members.index(mesh.rank) == src
    if comm_route(t, group) == "mailbox":
        box = _post(t, group, write=mine)
        out = _read(box, order.index(members[src]), t).clone()
        _done(t, group)
        return out
    buf = t.detach().clone().contiguous()
    dist.broadcast(buf, src=members[src], group=group)
    return buf


@_timed
def reduce(t: torch.Tensor, mesh, axes: Sequence[str], dst: int
           ) -> torch.Tensor:
    """On the member of index ``dst`` along ``axes``, the members' ``t``
    summed (in their index order on the mailbox route); on the others,
    zeros."""
    group = mesh.group(axes)
    if group is None:
        return t
    if isinstance(group, DryGroup):
        return _dry("all-reduce", t.clone())
    members, order = _members(mesh, axes)
    mine = members.index(mesh.rank) == dst
    if comm_route(t, group) == "mailbox":
        box = _post(t, group)
        out = _fold(box, order, members, t, dist.ReduceOp.SUM) if mine \
            else torch.zeros_like(t)
        _done(t, group)
        return out
    buf = t.detach().clone().contiguous()
    dist.reduce(buf, dst=members[dst], op=dist.ReduceOp.SUM, group=group)
    return buf if mine else torch.zeros_like(t)


# ------------------------------------------------------------ autograd

def _block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.extent(axes)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size)


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; backward: the all-to-all of the gradients."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axes), None, None


class Permute(torch.autograd.Function):
    """:func:`permute`; backward: the permute the other way."""

    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return permute(t, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class TakeBlock(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every member of
    ``axes`` holds whole and alike; backward: the blocks' gradients
    gathered over ``axes`` (each member's share of the whole
    gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(t, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), \
            None, None, None


class GatherBlocks(torch.autograd.Function):
    """The members' blocks gathered along ``dim``, to be used alike on
    every member; backward: this rank's block of the gradient (every
    member computed the same one)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(t.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, \
            None, None


class GatherRows(torch.autograd.Function):
    """The members' rows gathered along ``dim``, each member's use of
    them a part of the whole (the members hold different rows of a
    batch); backward: the parts' gradients reduce-scattered."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(t.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.mesh, ctx.axes,
                              ctx.dim), None, None, None


class SumGrad(torch.autograd.Function):
    """The identity; backward: the gradient summed over ``axes`` (a
    tensor every member holds alike, each member's use of it a part)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), dist.ReduceOp.SUM,
                          ctx.mesh.group(ctx.axes), ctx.mesh, ctx.axes), \
            None, None


class ScaleGrad(torch.autograd.Function):
    """The identity; backward: the gradient divided by ``k`` (a value
    computed alike on ``k`` members whose gradients are summed)."""

    @staticmethod
    def forward(ctx, t, k):
        ctx.k = k
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.k, None


class MeanOver(torch.autograd.Function):
    """JAX's ``pmean`` over ``axes``: the members' values summed and
    divided by their count; backward: the gradient divided by the count
    (each member's share; the members' gradients are summed
    downstream)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.n = mesh.extent(axes)
        return all_reduce(t.detach(), dist.ReduceOp.SUM, mesh.group(axes),
                          mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class BroadcastFrom(torch.autograd.Function):
    """:func:`broadcast` from the member of index ``src``, the result used
    alike on every member; backward: the members' gradients averaged
    onto ``src`` (JAX's cotangent of a replicated output), zeros on the
    others."""

    @staticmethod
    def forward(ctx, t, mesh, axes, src):
        ctx.mesh, ctx.axes, ctx.src = mesh, axes, src
        return broadcast(t.contiguous(), mesh, axes, src)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.extent(ctx.axes)
        return reduce(g.contiguous(), ctx.mesh, ctx.axes, ctx.src) / n, \
            None, None, None
