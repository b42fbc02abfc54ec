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

Three differences of layout, not of result:

* The update writes the parameters and the moments **in place** (under
  ``torch.no_grad``), a slab of rows at a time (``SLAB``), where JAX
  returns new trees: a full-size float32 temporary of the largest leaf
  (llama31-8b's 525 M-entry embedding) would otherwise be held several
  times over.  Each value's arithmetic is elementwise, so slabs change
  nothing.
* On a mesh (``shardings``) every tensor is a rank's block: the
  update runs on the blocks, and the global norm and an 8-bit moment
  whose blocks of 16 straddle the shards take collectives
  (:func:`_global_norm`, :class:`_Q8Row`), as XLA partitions JAX's
  update.
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
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import entry_axes
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


def _global_norm(grads, shardings=None) -> torch.Tensor:
    """The L2 norm of every gradient given.  With ``shardings`` (``{path:
    NamedSharding}``) the gradients are a rank's blocks: each block's
    squared sum counts once, on the rank that :meth:`owns` it (a block
    replicated over an axis is not counted once a rank), and the sums are
    all-reduced over the whole mesh (the identity on one rank)."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for path, g in tree_leaves(grads)
            if g is not None and (shardings is None or
                                  shardings[path].owns())]
    device = next(g for _, g in tree_leaves(grads) if g is not None).device
    total = torch.sum(torch.stack(sums)) if sums else \
        torch.zeros((), dtype=torch.float32, device=device)
    if shardings is not None:
        mesh = next(iter(shardings.values())).mesh
        total = collectives.all_reduce(total, dist.ReduceOp.SUM,
                                       mesh.group(mesh.axis_names))
    return torch.sqrt(total)


class _Q8Row:
    """An 8-bit moment in JAX's global blocks of 16 along its
    parameter's last dim, which may be sharded over ``axes`` (none: the
    row is whole here).  ``q`` keeps the parameter's spec where the
    padded dim divides (else it is whole on every rank) and ``scale``,
    without the last entry, holds the whole row of block scales
    (``fit_spec``).  Where this rank's columns are whole blocks of the
    global row, it quantizes its blocks and all-gathers their scales;
    otherwise it gathers the moment's row and quantizes it whole, as JAX
    does.  On a row that is whole here every gather is the identity."""

    def __init__(self, sharding, p: torch.Tensor):
        self.mesh = None if sharding is None else sharding.mesh
        self.axes = () if sharding is None or not p.ndim else \
            entry_axes(sharding.spec[-1])
        n = 1 if self.mesh is None else self.mesh.extent(self.axes)
        self.i = 0 if n == 1 else self.mesh.index(self.axes)
        self.dl = p.shape[-1] if p.ndim else 1
        self.d = self.dl * n
        blk = min(q8.BLOCK, self.d)
        padded = q8.padded_dim(self.d)
        self.q_sharded = padded % n == 0
        self.ql = padded // n
        self.nbl = self.dl // blk
        self.whole_blocks = self.q_sharded and padded == self.d and \
            self.dl % blk == 0

    def _gather(self, t):
        if self.mesh is None:
            return t
        return collectives.all_gather(t, self.mesh, self.axes, t.ndim - 1)

    def read(self, qs, shape, power):
        if self.whole_blocks:
            cols = slice(self.i * self.nbl, (self.i + 1) * self.nbl)
            return q8.dequantize({"q": qs["q"], "scale": qs["scale"][
                ..., cols]}, shape, power=power)
        q = self._gather(qs["q"]) if self.q_sharded else qs["q"]
        row = q8.dequantize({"q": q, "scale": qs["scale"]},
                            tuple(shape[:-1]) + (self.d,), power=power)
        return row[..., self.i * self.dl:(self.i + 1) * self.dl].reshape(
            shape)

    def write(self, qs, x, power):
        if self.whole_blocks:
            new = q8.quantize(x, power=power)
            qs["q"].copy_(new["q"])
            qs["scale"].copy_(self._gather(new["scale"]))
            return
        new = q8.quantize(self._gather(x), power=power)
        q = new["q"][..., self.i * self.ql:(self.i + 1) * self.ql] \
            if self.q_sharded else new["q"]
        qs["q"].copy_(q)
        qs["scale"].copy_(new["scale"])


def _slabs(shape) -> list:
    """Row slices of the leading axis, about ``SLAB`` values each."""
    if len(shape) < 2 or shape[0] < 2:
        return [...]
    per_row = max(1, int(torch.Size(shape[1:]).numel()))
    rows = max(1, SLAB // per_row)
    return [slice(r, r + rows) for r in range(0, shape[0], rows)]


def adamw_update(cfg: AdamWConfig, grads, state, params,
                 stacked_layers: int = 0, shardings=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the moments of ``state`` updated in
    place.  ``grads`` mirrors ``params``; a frozen leaf's gradient may be
    ``None``, and the global norm counts every gradient given.  Returns
    (params, new state, {"grad_norm", "lr"}).

    ``shardings`` (``{path: NamedSharding}`` of the parameters) makes
    ``params``, ``grads`` and the moments a rank's blocks
    (``distributed/fsdp.py``): the update runs on the blocks, the global
    norm is all-reduced (:func:`_global_norm`) and an 8-bit moment of a
    parameter whose last dim is sharded keeps JAX's global blocks of 16
    (:class:`_Q8Row`)."""
    step = state["step"] + 1
    lr = learning_rate(cfg.schedule, step)
    gnorm = _global_norm(grads, shardings)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    is_q8 = cfg.state_bits == 8

    def advance(p, g, m_f, v_f, decay):
        """The new parameter, written into ``p``; returns the new float32
        moments."""
        g = g.to(torch.float32) * clip
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * torch.square(g)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if decay:
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))
        return m_new, v_new

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
            io = _Q8Row(None if shardings is None else shardings[path], p)
            for sl in _slabs(p.shape):
                if not is_q8:
                    m_new, v_new = advance(p[sl], g[sl], m[sl], v[sl], decay)
                    m[sl].copy_(m_new)
                    v[sl].copy_(v_new)
                    continue
                ms = {k: t[sl] for k, t in m.items()}
                vs = {k: t[sl] for k, t in v.items()}
                shape = p[sl].shape
                m_new, v_new = advance(p[sl], g[sl], io.read(ms, shape, 3),
                                       io.read(vs, shape, 6), decay)
                io.write(ms, m_new, 3)
                io.write(vs, v_new, 6)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"grad_norm": gnorm, "lr": lr}
