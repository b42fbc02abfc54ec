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
  card, not a deployment).  The gather and the reduce-scatter go card
  to card: each rank of the group keeps a mailbox on the card, opened
  in the others through CUDA IPC (:class:`_Mailboxes`); a rank copies
  its tensor into its mailbox and reads the others' after a barrier (a
  gloo barrier of the group, and another before any mailbox is written
  again).  Each is counted in :data:`PEER_COPIED`.  The all-reduce (the
  CP merge's, the loss's and the norm's scalars) goes through host
  memory: copied to the CPU, reduced there and copied back, each
  counted in :data:`HOST_STAGED` (calls and bytes), which
  ``chip_smoke.py`` logs beside the times.  Ranks of one gloo group on
  different devices are refused.

With ``TIMING["on"]`` each call synchronises the device before and after
itself and adds its seconds to :data:`SECONDS` by kind (the share of a
train step in gathers and reduce-scatters); the synchronisations cost
the overlap of a collective with the work queued before it, so a step
timed this way is not a gated step.
"""

from __future__ import annotations

import functools
import socket
import time
from typing import Dict, Sequence

import torch
import torch.distributed as dist

__all__ = ["comm_route", "all_reduce", "all_gather",
           "reduce_scatter", "close_mailboxes", "HOST_STAGED",
           "PEER_COPIED", "TIMING", "SECONDS"]

# collectives of CUDA tensors staged through host memory (gloo): calls and
# bytes moved to the host, since the process started
HOST_STAGED: Dict[str, int] = {"calls": 0, "bytes": 0}
# gathers and reduce-scatters of a group on one card through its ranks'
# mailboxes: calls and the bytes each rank posted
PEER_COPIED: Dict[str, int] = {"calls": 0, "bytes": 0}
TIMING = {"on": False}
SECONDS: Dict[str, float] = {"all_reduce": 0.0, "all_gather": 0.0,
                             "reduce_scatter": 0.0}


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
    """``"host"`` for gloo on a CUDA tensor (every rank on ``cuda:0``:
    the all-reduce is staged through host memory, the gather and the
    reduce-scatter go through the mailboxes), else ``"device"``."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return "host"
    return "device"


def _stage(t: torch.Tensor, group):
    """(a copy of ``t`` the collective runs on, whether it is on the
    host)."""
    if comm_route(t, group) == "host":
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += t.numel() * t.element_size()
        return t.detach().to("cpu", copy=True).contiguous(), True
    return t.detach().clone().contiguous(), False


class _Mailboxes:
    """Each rank's byte buffer on the one card of a group, and every
    other rank's opened through CUDA IPC; grown (a collective over the
    group) when a tensor needs more, which every rank asks for at the
    same call, the tensors of a group's collectives being of one size."""

    def __init__(self, group):
        self.group = group
        self.nbytes = 0
        self.own = None
        self.peers: list = []

    def ensure(self, nbytes: int, device) -> None:
        if nbytes <= self.nbytes:
            return
        from torch.multiprocessing.reductions import reduce_tensor
        self.peers, self.own = [], None
        torch.cuda.synchronize(device)
        own = torch.empty(nbytes, dtype=torch.uint8, device=device)
        posted = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(
            posted, (socket.gethostname(), own.device.index,
                     reduce_tensor(own)), group=self.group)
        me = dist.get_rank(self.group)
        if len({p[:2] for p in posted}) != 1:
            raise RuntimeError(
                "a gloo group of CUDA tensors on more than one device: "
                f"{[p[:2] for p in posted]} (launch.mesh.init_rank puts "
                "every gloo rank on cuda:0)")
        self.peers = [own if g == me else fn(*args)
                      for g, (_, _, (fn, args)) in enumerate(posted)]
        self.own, self.nbytes = own, nbytes


_MAILBOXES: Dict[object, _Mailboxes] = {}


def _mailboxes(group) -> _Mailboxes:
    if group not in _MAILBOXES:
        _MAILBOXES[group] = _Mailboxes(group)
    return _MAILBOXES[group]


def close_mailboxes() -> None:
    """Drop this rank's mailboxes and its views of the others' (call on
    every rank, then a barrier, before the processes end)."""
    for box in _MAILBOXES.values():
        box.peers, box.own, box.nbytes = [], None, 0
    _MAILBOXES.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _post(t: torch.Tensor, group) -> _Mailboxes:
    """``t``'s bytes in this rank's mailbox, every rank's posted (a
    barrier)."""
    raw = t.contiguous().view(-1).view(torch.uint8)
    box = _mailboxes(group)
    box.ensure(raw.numel(), t.device)
    box.own[:raw.numel()].copy_(raw)
    torch.cuda.synchronize(t.device)
    dist.barrier(group=group)
    PEER_COPIED["calls"] += 1
    PEER_COPIED["bytes"] += raw.numel()
    return box


def _read(box: _Mailboxes, g: int, t: torch.Tensor) -> torch.Tensor:
    """Group rank ``g``'s posted tensor of ``t``'s shape and dtype."""
    n = t.numel() * t.element_size()
    return box.peers[g][:n].view(t.dtype).view(t.shape)


def _done(t: torch.Tensor, group) -> None:
    """Every rank has read the mailboxes (they may be written again)."""
    torch.cuda.synchronize(t.device)
    dist.barrier(group=group)


@_timed
def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor; ``group`` None means a
    group of this rank alone)."""
    if group is None:
        return t.clone()
    buf, host = _stage(t, group)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device) if host else buf


@_timed
def all_gather(t: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """The tensors ``t`` of this rank's group along ``axes``, concatenated
    along ``dim`` in the order of the ranks' index along ``axes``; moved
    as bytes, so any dtype crosses bit for bit."""
    group = mesh.group(axes)
    if group is None:
        return t
    members = mesh.members(axes)
    order = sorted(members)               # the group's own rank order
    if comm_route(t, group) == "host":
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
    members = mesh.members(axes)
    order = sorted(members)               # the group's own rank order
    if comm_route(t, group) == "host":
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
