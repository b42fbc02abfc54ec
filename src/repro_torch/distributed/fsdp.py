"""The sharded train step's parts: each rank holds only its shards.

The JAX package jits ``make_train_step`` with ``in_shardings`` and
``grad_shardings`` and leaves the rest to XLA's SPMD partitioner.  Eager
torch has none, so this module stands in for it, one process a rank:

* **Parameters** live as this rank's blocks of the
  :class:`~repro_torch.distributed.sharding.NamedSharding` of each leaf
  (``launch/specs.py::param_specs``: FSDP over ``data``, heads, MLP and
  vocab over ``model``).  :func:`gather_param` rebuilds a whole leaf in
  the forward (an all-gather over the groups of its sharded axes); its
  backward takes the whole gradient this rank computed and returns the
  gradient of its block: **reduce-scattered over the batch axes**
  (``pod``, ``data``), whose ranks saw other rows and whose gradients
  are summed, and **sliced over the other axes**, whose ranks saw the
  same rows and computed the same gradient (summing them would multiply
  it).  The model gathers each layer group inside the group's
  rematerialised function (``transformer.forward_train``'s ``gather``),
  so a rank holds one group's whole weights at a time beside the
  embedding and head, and under ``remat_policy="full"`` the backward
  gathers them again.  Every rank issues the same collectives in the
  same order: the model never branches on the rank.
* The ``model`` axis shards storage only, its ranks computing on the
  gathered weights, but for MoE under ``moe_dispatch="alltoall"``
  (``models/moe.py``), the first compute split over ``model``: a rank
  routes its slice of the tokens and runs its own ``E / model``
  experts.  So the expert leaves (:func:`gather_experts`) gather only
  this rank's experts: under ``moe_parallelism="ep"`` its block along
  ``experts -> model``, gathered over the batch axes; under ``"tp"``
  (``d_ff`` over ``model``) the ``d_ff`` shards of its own experts,
  exchanged by an all-to-all over ``model``.  Their gradients are
  reduced over the batch axes and never summed over ``model``: each
  rank computed its own experts' whole gradient.  Every other leaf
  keeps the rule above (the MoE layer's own collectives make every
  ``model`` rank's gradient of it whole and alike).
* **Batch**: every rank holds the global batch and takes its rows
  (:func:`local_rows`, through ``launch/specs.py::batch_specs``):
  microbatch ``j``'s block of the batch axes' index, as JAX's reshape
  into microbatches and then sharding lays them.
* **Init**: :func:`init_shards` draws a unit of the model at a time and
  keeps this rank's blocks, so no rank holds the whole model.  One
  process is a one-rank mesh (:func:`one_rank_shardings`): every block
  the whole leaf, every collective the identity.
* **Loss**: JAX's global-batch mean, each rank's sum over its rows
  divided by the valid-token count all-reduced over the batch axes
  (:func:`global_tokens`), so padding (``labels = -1``) that differs
  across ranks gives JAX's number.

MoE layers keep the JAX package's global-batch semantics under a data
extent above 1: the capacity and the aux losses of each dispatch are
those of the global batch (``models/moe.py``).

The sharded prefill and serve steps (``runtime/steps.py``) use the same
parameter gathers, and :class:`CacheBlocks` for the decode caches laid
out by ``launch/specs.py::cache_specs``: a rank holds its block of each
leaf.  Its rows are the batch's rows it serves (the cache's batch axes
split the batch alike).  The ``model`` axis shards storage here too:
before a layer attends, :meth:`CacheBlocks.open` gathers its block over
every other sharded axis (the KV heads, or the sequence where the heads
do not divide ``model``) and :meth:`CacheBlocks.close` writes the
step's rows back into the block; a global SOCKET layer's sequence axes
under ``cfg.decode_cp_axes`` stay split, the context-parallel route
attending its block.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import NamedSharding, entry_axes

__all__ = ["BATCH_AXES", "gather_param", "reduce_grad", "gatherer",
           "flat_tree", "shard_tree", "gather_tree", "init_shards",
           "one_rank_shardings", "zeros_tree", "local_rows",
           "global_tokens", "batch_extent", "mesh_of", "gather_experts",
           "CacheBlocks"]

# the mesh axes a batch's rows are split over (the "batch" rule)
BATCH_AXES = ("pod", "data")


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def batch_extent(mesh) -> int:
    return mesh.extent(BATCH_AXES)


def _block(t: torch.Tensor, mesh, axes, dim: int):
    """(this rank's block of ``t`` along ``dim``, whether it is a part)."""
    n = mesh.extent(axes)
    if n == 1:
        return t, False
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size), True


def reduce_grad(grad: torch.Tensor, sharding: NamedSharding
                ) -> torch.Tensor:
    """The gradient of this rank's block from the whole gradient ``grad``
    this rank computed: sliced on the dims sharded over other axes than
    the batch axes, then summed over the batch axes' group, where a dim
    sharded over exactly the batch axes takes a reduce-scatter (else an
    all-reduce and a slice)."""
    mesh = sharding.mesh
    bax = _batch_axes(mesh)
    g, scatter, pending, sliced = grad, None, [], False
    for d, e in enumerate(sharding.spec):
        axes = entry_axes(e)
        if not axes:
            continue
        if any(a in bax for a in axes):
            if axes == bax and scatter is None:
                scatter = d
            else:
                pending.append(d)
            continue
        g, part = _block(g, mesh, axes, d)
        sliced |= part
    group = mesh.group(bax) if bax else None
    if group is not None and scatter is not None and not pending:
        return collectives.reduce_scatter(g, mesh, bax, scatter)
    if group is not None:
        g = collectives.all_reduce(g, dist.ReduceOp.SUM, group)
        sliced = False
    for d in ([scatter] if scatter is not None else []) + pending:
        g, part = _block(g, mesh, entry_axes(sharding.spec[d]), d)
        sliced |= part
    # a slice of the whole gradient would keep all of it alive
    return g.clone() if sliced else g


class _GatherParam(torch.autograd.Function):
    """Forward: the whole leaf from this rank's block; backward: the
    block's gradient (:func:`reduce_grad`)."""

    @staticmethod
    def forward(ctx, local, sharding):
        ctx.sharding = sharding
        full = sharding.gather(local)
        return local.view_as(local) if full is local else full

    @staticmethod
    def backward(ctx, grad):
        return reduce_grad(grad, ctx.sharding), None


def gather_param(local: torch.Tensor, sharding: NamedSharding
                 ) -> torch.Tensor:
    return _GatherParam.apply(local, sharding)


def flat_tree(tree, path: str = "") -> Dict[str, object]:
    """``{path: leaf}`` of a tree of dicts and lists (of shardings or
    tensors), paths as ``optim.adamw.tree_leaves`` writes them but for an
    8-bit moment's ``q`` and ``scale``, each a leaf of its own
    (``path['q']``, ``path['scale']``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tree(v, f"{path}['{k}']"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{path}[{i}]"))
    else:
        out[path] = tree
    return out


def _drop_model(sharding: NamedSharding) -> NamedSharding:
    """``sharding`` with the ``model`` axis taken out of every entry."""
    spec = []
    for e in sharding.spec:
        axes = tuple(a for a in entry_axes(e) if a != "model")
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return NamedSharding(sharding.mesh, tuple(spec))


def _model_dim(sharding: NamedSharding):
    dims = [d for d, e in enumerate(sharding.spec)
            if "model" in entry_axes(e)]
    return dims[0] if dims else None


class _GatherExperts(torch.autograd.Function):
    """Forward: this rank's ``E / model`` experts of an expert leaf, whole
    but for the expert axis; backward: their gradient onto this rank's
    stored block (see the module docstring).  Under ``"tp"`` the
    all-to-all over ``model`` moves the stored blocks before the gather
    over the batch axes (and the gradients after the reduce-scatter), so
    it carries a rank's share of the batch axes' dims only."""

    @staticmethod
    def forward(ctx, local, sharding):
        mesh = sharding.mesh
        rest = _drop_model(sharding)
        fdim = _model_dim(sharding)
        ctx.rest, ctx.fdim, ctx.mesh = rest, fdim, mesh
        n = mesh.shape["model"]
        if fdim is not None and fdim > 0:
            # "tp": member j's d_ff shard of this rank's experts, for
            # each j, along d_ff
            got = collectives.all_to_all(local, mesh, ("model",))
            local = torch.cat(got.chunk(n, dim=0), dim=fdim)
        w = rest.gather(local)                     # whole over batch axes
        if fdim is None:                           # replicated: cut it
            e_local = w.shape[0] // n
            m = mesh.index(("model",))
            return w[m * e_local:(m + 1) * e_local].clone()
        return w                                   # "ep": its own block

    @staticmethod
    def backward(ctx, grad):
        mesh, fdim = ctx.mesh, ctx.fdim
        g = reduce_grad(grad, ctx.rest)
        if fdim is None:
            g = collectives.all_gather(g.contiguous(), mesh, ("model",), 0)
        elif fdim > 0:
            n = mesh.shape["model"]
            g = collectives.all_to_all(
                torch.cat(g.chunk(n, dim=fdim), dim=0).contiguous(), mesh,
                ("model",))
        return g, None


def gather_experts(local: torch.Tensor, sharding: NamedSharding
                   ) -> torch.Tensor:
    return _GatherExperts.apply(local, sharding)


def gatherer(shardings: Dict[str, NamedSharding], cfg=None):
    """``gather(path, subtree)`` for ``transformer.forward_train``: the
    subtree of a rank's shards at ``path`` with each leaf whole; where
    ``cfg``'s MoE layers take the all-to-all on this mesh, their expert
    leaves as :func:`gather_experts` gives them."""
    from repro_torch.models import moe
    experts = cfg is not None and moe.alltoall_applies(
        cfg, mesh_of(shardings))

    def gather(path, tree):
        if isinstance(tree, dict):
            return {k: gather(f"{path}['{k}']", v) for k, v in tree.items()}
        if experts and path.endswith(tuple(f"['moe']['{n}']" for n in
                                           moe.EXPERT_LEAVES)):
            return gather_experts(tree, shardings[path])
        return gather_param(tree, shardings[path])

    return gather


def _map(fn, tree, shardings, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, shardings, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, shardings, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(tree, shardings[path])


def shard_tree(tree, shardings: Dict[str, NamedSharding], device=None):
    """Each leaf of a whole tree (parameters, or an optimizer state with
    its 8-bit ``q``/``scale``) cut to this rank's block, on ``device``."""
    return _map(lambda t, sh: sh.shard(t).to(device or t.device), tree,
                shardings)


def gather_tree(tree, shardings: Dict[str, NamedSharding], device=None,
                keep: bool = True):
    """The whole tree from every rank's blocks (collective), a leaf at a
    time: each whole leaf moved to ``device`` (where it is when None) as
    soon as it is gathered, or dropped (``None``) where ``keep`` is
    False, so a rank holds one whole leaf on the card at a time."""
    def one(t, sh):
        whole = sh.gather(t)
        if not keep:
            return None
        return whole if device is None else whole.to(device, copy=True)

    return _map(one, tree, shardings)


def init_shards(cfg, seed: int, shardings: Dict[str, NamedSharding],
                device):
    """This rank's blocks of ``transformer.init_model(cfg, seed, device)``
    (the same numbers), each unit of the model drawn whole on ``device``,
    cut to the block and dropped before the next is drawn: the init
    holds the largest unit, never the whole model."""
    from repro_torch.models import transformer as tfm
    return tfm.init_model_placed(cfg, seed, device,
                                 lambda path, t: shardings[path].shard(t))


def one_rank_shardings(cfg) -> Dict[str, NamedSharding]:
    """``{path: NamedSharding}`` of every parameter on a one-rank
    ``("data", "model")`` mesh: every block the whole leaf, every
    collective the identity (the single-process step)."""
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    return flat_tree(sp.param_specs(cfg, Mesh(("data", "model"), (1, 1)),
                                    {})[1])


def zeros_tree(sds, shardings: Dict[str, NamedSharding], device):
    """Zeros of each leaf's block shape and dtype, from a tree of
    shape-only (``meta``) tensors: a rank's optimizer state allocated at
    its shards' size."""
    return _map(lambda t, sh: torch.zeros(sh.shard_shape(t.shape),
                                          dtype=t.dtype, device=device),
                sds, shardings)


def mesh_of(shardings: Dict[str, NamedSharding]):
    return next(iter(shardings.values())).mesh


def local_rows(cfg, batch: Dict[str, torch.Tensor], mesh, accum: int,
               j: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``j`` of ``accum`` of the global ``batch``, this rank's
    block of it under ``launch/specs.py::batch_specs`` (JAX: the batch
    reshaped to ``(accum, B / accum, ...)``, then each microbatch's rows
    sharded over the batch axes)."""
    from repro_torch.launch import specs as sp
    b, s = next(iter(batch.values())).shape[:2]
    n = batch_extent(mesh)
    if b % (accum * n):
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches of {n} ranks' rows")
    mb = b // accum
    _, sh = sp.batch_specs(cfg, sp.ShapeSpec("step", "train", s, mb), mesh,
                           {})
    return {k: sh[k].shard(v[j * mb:(j + 1) * mb]) for k, v in batch.items()}


def global_tokens(labels: torch.Tensor, mesh) -> torch.Tensor:
    """The valid (``labels >= 0``) tokens of the global microbatch: this
    rank's count all-reduced over the batch axes."""
    count = (labels >= 0).sum()
    group = mesh.group(_batch_axes(mesh)) if _batch_axes(mesh) else None
    if group is None:
        return count
    return collectives.all_reduce(count, dist.ReduceOp.SUM, group)


class CacheBlocks:
    """This rank's blocks of the decode caches, ``shardings`` the
    per-layer list of each leaf's :class:`NamedSharding`
    (``cache_specs``): see the module docstring.  ``rows_axes`` are the
    mesh axes of the caches' batch dim, which split the step's rows."""

    def __init__(self, cfg, shardings):
        self.shardings = shardings
        first = next(iter(shardings[0].values()))
        self.mesh = first.mesh
        self.rows_axes = tuple(a for a in entry_axes(first.spec[0])
                               if self.mesh.shape.get(a, 1) > 1)
        # the axes context_parallel.cp_mesh finds on this mesh
        cp_seq = tuple(a for a in cfg.decode_cp_axes if a in self.mesh.shape
                       ) if cfg.attention_backend == "socket" else ()
        self._dims = []
        for spec, layer in zip(cfg.layer_specs, shardings):
            cp_layer = spec.kind == "attn" and spec.attn_type == "global"
            self._dims.append({name: self._split_dims(
                sh, cp_seq if cp_layer else ()) for name, sh in
                layer.items()})

    def _split_dims(self, sh: NamedSharding, cp_seq) -> list:
        """(dim, axes) of each dim past the batch dim that is split over
        more than one rank, but for the context-parallel sequence dim."""
        out = []
        for d, e in enumerate(sh.spec):
            axes = entry_axes(e)
            if d == 0 or self.mesh.extent(axes) == 1 or \
                    (d == 2 and cp_seq and axes == cp_seq):
                continue
            out.append((d, axes))
        return out

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a whole-batch tensor."""
        return _block(t, self.mesh, self.rows_axes, 0)[0]

    def open(self, i: int, block: Dict) -> Dict:
        """Layer ``i``'s cache whole over its split dims (the block
        itself where none is split)."""
        dims = self._dims[i]
        if not any(dims.values()):
            return block
        out = {}
        for name, t in block.items():
            for d, axes in dims[name]:
                t = collectives.all_gather(t, self.mesh, axes, d)
            out[name] = t
        return out

    def close(self, i: int, block: Dict, whole: Dict) -> Dict:
        """Write ``whole``'s rows back into ``block`` (in place)."""
        dims = self._dims[i]
        if not any(dims.values()):
            return whole
        for name, t in block.items():
            w = whole[name]
            for d, axes in dims[name]:
                w = _block(w, self.mesh, axes, d)[0]
            t.copy_(w)
        return block

    def cut(self, i: int, cache: Dict) -> Dict:
        """This rank's block of layer ``i``'s cache built whole over its
        split dims (the sharded prefill)."""
        dims = self._dims[i]
        if not any(dims.values()):
            return cache
        out = {}
        for name, t in cache.items():
            for d, axes in dims[name]:
                t = _block(t, self.mesh, axes, d)[0]
            out[name] = t.clone() if dims[name] else t
        return out
