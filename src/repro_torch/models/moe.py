"""Mixture-of-Experts FFN with sort-based (MegaBlocks-style) dispatch.

Port of ``repro.models.moe``.  Token→expert assignments are sorted by
expert (a stable sort, as ``jnp.argsort``), each assignment's position
within its expert is computed by a cumulative count, and tokens are
scattered into an ``(E, C, d)`` buffer; assignments past an expert's
capacity ``C`` are dropped first come, first served (the residual
connection carries a dropped token through unchanged).  Decode is
dropless: capacity ``n * k``.  The expert products are batched matrix
products over the expert axis, plain PyTorch as they are plain ``jnp``
in the JAX package.

``cfg.moe_dispatch``: ``"global"`` sorts all ``B * T`` tokens at once;
``"batch"`` dispatches each batch row on its own (per-row capacity);
``"alltoall"`` is the expert-parallel exchange over the mesh's
``model`` ranks (:func:`_apply_moe_alltoall`), which applies where the
JAX package's does (``T > 1``, a mesh, ``model > 1``, ``E % model ==
0``) and falls through to global dispatch elsewhere.

Under the sharded train step (``split``, the mesh whose batch axes split
the rows, ``distributed/fsdp.py``) each dispatch keeps the JAX
package's global-batch semantics: ``"global"`` gathers the batch's
tokens over the batch axes (the gather's backward a reduce-scatter),
dispatches them as one process does and keeps this rank's rows;
``"batch"`` dispatches its own rows and averages the rows' aux losses
over the batch axes; ``"alltoall"`` exchanges this rank's tokens with
the ``model`` ranks holding their experts.  Without ``split`` every
rank holds the whole batch (serving under a mesh).

Router losses: Switch load-balancing loss + router z-loss, returned as
scalars beside the output.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as cl
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fsdp import BATCH_AXES
from repro_torch.models import param as pm

__all__ = ["init_moe", "apply_moe", "alltoall_applies",
           "apply_moe_alltoall_ref", "EXPERT_LEAVES"]

# the expert leaves a rank holds E / model of under the all-to-all
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """The JAX package's distributions: an f32 ``N(0, 1/d)`` router, ``N(0,
    1/d)`` gate/up and ``N(0, 1/d_ff)`` down projections per expert."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    ff_axis = None if cfg.moe_parallelism == "ep" else "expert_mlp"
    e_axis = "experts" if cfg.moe_parallelism == "ep" else None
    dt = cfg.param_dtype
    return {
        "router": pm.normal(gen, (d, e), ("embed_w", None), stddev=s_in),
        "w_gate": pm.normal(gen, (e, d, ff), (e_axis, "embed_w", ff_axis),
                            stddev=s_in, dtype=dt),
        "w_up": pm.normal(gen, (e, d, ff), (e_axis, "embed_w", ff_axis),
                          stddev=s_in, dtype=dt),
        "w_down": pm.normal(gen, (e, ff, d), (e_axis, ff_axis, "embed_w"),
                            stddev=s_out, dtype=dt),
    }


def _router(cfg: ModelConfig, params: Dict, x2d: torch.Tensor):
    """Top-k routing.  x2d: (N, d) -> (top_idx, top_probs, aux_losses).
    Among equal probabilities the lower expert index ranks first, as
    ``jax.lax.top_k`` ranks them."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    k = cfg.num_experts_per_tok
    top_probs, top_idx = top_probs[:, :k], top_idx[:, :k]
    top_probs = top_probs / torch.clamp(
        torch.sum(top_probs, dim=-1, keepdim=True), min=1e-9)

    # Switch load-balance loss: E * sum_e f_e * P_e
    e = cfg.num_experts
    one_hot = F.one_hot(top_idx[:, 0], e).float()
    f = torch.mean(one_hot, dim=0)
    p_mean = torch.mean(probs, dim=0)
    lb_loss = e * torch.sum(f * p_mean)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return top_idx, top_probs, {"moe_lb_loss": lb_loss,
                                "moe_z_loss": z_loss}


def _act(cfg: ModelConfig, gate: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate, approximate="tanh") if cfg.mlp_activation == \
        "geglu" else F.silu(gate)


def _expert_ffn(cfg: ModelConfig, params: Dict, buf: torch.Tensor
                ) -> torch.Tensor:
    """The expert FFN as batched products over the expert axis:
    ``(E, C, d)`` -> ``(E, C, d)``."""
    cdt = buf.dtype
    gate = torch.bmm(buf, params["w_gate"].to(cdt))
    up = torch.bmm(buf, params["w_up"].to(cdt))
    return torch.bmm(_act(cfg, gate) * up, params["w_down"].to(cdt))


def _dispatch_ffn(cfg: ModelConfig, params: Dict, x2d: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, Dict]:
    """Sort-dispatch + expert FFN + combine over flat tokens (N, d)."""
    n, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cdt = getattr(torch, cfg.compute_dtype)
    dev = x2d.device

    top_idx, top_probs, aux = _router(cfg, params, x2d)

    # ---- sort-based dispatch -------------------------------------------
    flat_expert = top_idx.reshape(n * k)
    flat_token = torch.arange(n, device=dev).repeat_interleave(k)
    flat_prob = top_probs.reshape(n * k)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_prob = flat_prob[order]

    counts = _counts(sorted_expert, e)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_expert = torch.arange(n * k, device=dev) - starts[sorted_expert]
    keep = pos_in_expert < capacity
    slot = torch.where(keep, pos_in_expert,
                       torch.full_like(pos_in_expert, capacity - 1))

    # scatter tokens into (E, C, d) buffers (dropped tokens masked to 0:
    # they add nothing to the slot they land in)
    zero = torch.zeros((), dtype=cdt, device=dev)
    gathered = torch.where(keep[:, None], x2d[sorted_token].to(cdt), zero)
    buf = torch.zeros((e, capacity, d), dtype=cdt, device=dev)
    buf.index_put_((sorted_expert, slot), gathered, accumulate=True)

    out_buf = _expert_ffn(cfg, params, buf)                     # (E, C, d)

    # ---- combine back to tokens ----------------------------------------
    expert_out = torch.where(keep[:, None], out_buf[sorted_expert, slot],
                             zero)
    weighted = expert_out * sorted_prob[:, None].to(cdt)
    y2d = torch.zeros((n, d), dtype=cdt, device=dev).index_add_(
        0, sorted_token, weighted)
    return y2d.to(x2d.dtype), aux


def _capacity_for(cfg: ModelConfig, n: int, t: int) -> int:
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if t == 1:
        # decode: guarantee dropless routing (worst case: every token on
        # the same expert); capacity drops would corrupt generation.
        capacity = n * k
    else:
        capacity = int(math.ceil(n * k / e * cfg.capacity_factor))
        capacity = max(capacity, 4)
    return min(capacity, n * k)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``, at its
    fixed size ``n`` (bincount's size depends on the data, which a
    shape-only run, ``launch/dryrun.py``, cannot read)."""
    ids = ids.long()
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def alltoall_applies(cfg: ModelConfig, mesh) -> bool:
    """Whether ``moe_dispatch="alltoall"`` exchanges over ``mesh`` (for
    ``T > 1``): a mesh, ``model > 1`` and ``E % model == 0``, as the JAX
    package's switch; every rank decides alike."""
    model = mesh.shape.get("model", 1) if mesh is not None else 1
    return cfg.moe_dispatch == "alltoall" and mesh is not None and \
        model > 1 and cfg.num_experts % model == 0


def apply_moe(cfg: ModelConfig, params: Dict, x: torch.Tensor,
              split=None) -> Tuple[torch.Tensor, Dict]:
    """MoE FFN.  x: (B, T, d) -> (y, aux_losses).

    ``cfg.moe_dispatch``: ``"global"``, one sort over all B*T tokens;
    ``"batch"``, each batch row dispatched on its own with a per-row
    capacity (the JAX package's ``vmap``; the aux losses are the mean
    over rows); ``"alltoall"``, see the module docstring.

    ``split``: the mesh whose batch axes split ``x``'s rows over ranks
    (the sharded train step; ``x`` is this rank's rows of the global
    batch); None: ``x`` is the whole batch, under the current mesh if
    any."""
    b, t, d = x.shape
    mesh = split if split is not None else shd.current_mesh()
    if t > 1 and alltoall_applies(cfg, mesh):
        return _apply_moe_alltoall(cfg, params, x, mesh, split is not None)
    e = cfg.num_experts
    if params["w_gate"].shape[0] != e:
        raise ValueError(
            f"{params['w_gate'].shape[0]} of {e} experts given to a "
            f"dispatch that is not the all-to-all (T {t}): the sharded "
            "step gathers a rank's own experts only where the all-to-all "
            "applies, which needs T > 1")
    bax = tuple(a for a in BATCH_AXES if split is not None and
                a in split.shape and split.shape[a] > 1)
    if cfg.moe_dispatch == "batch" and t > 1 and (b > 1 or bax):
        capacity = _capacity_for(cfg, t, t)
        rows = [_dispatch_ffn(cfg, params, x[i], capacity) for i in range(b)]
        y = torch.stack([r[0] for r in rows])
        aux = {name: torch.stack([r[1][name] for r in rows]).mean()
               for name in rows[0][1]}
        if bax:
            # the global batch's mean: each rank's mean over as many rows
            aux = {k: cl.MeanOver.apply(v, split, bax) for k, v in
                   aux.items()}
        return y.to(x.dtype), aux
    if bax:
        # one dispatch over the global batch on every rank of the batch
        # axes (JAX's pjit of the global sort), this rank's rows kept
        whole = cl.GatherRows.apply(x, split, bax, 0)
        y, aux = _global(cfg, params, whole)
        lo = split.index(bax) * b
        n = split.extent(bax)
        # every batch rank computed the aux losses alike and their
        # gradients are summed over the batch axes
        return y[lo:lo + b], {k: cl.ScaleGrad.apply(v, n)
                              for k, v in aux.items()}
    return _global(cfg, params, x)


def _global(cfg: ModelConfig, params: Dict, x: torch.Tensor):
    b, t, d = x.shape
    capacity = _capacity_for(cfg, b * t, t)
    y2d, aux = _dispatch_ffn(cfg, params, x.reshape(b * t, d), capacity)
    return y2d.reshape(b, t, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert-parallel all-to-all dispatch (moe_dispatch="alltoall")
# ---------------------------------------------------------------------------

def _sort_slots(ids: torch.Tensor, count: int, capacity: int):
    """(keep, slot) of each entry of ``ids`` (N,) in ``[0, count)``: its
    position among the entries of its id in index order (a stable sort,
    as ``jnp.argsort``), kept below ``capacity``; a dropped entry's slot
    is ``capacity - 1``."""
    n = ids.numel()
    order = torch.argsort(ids, stable=True)
    inv = torch.argsort(order, stable=True)
    counts = _counts(ids, count)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = (torch.arange(n, device=ids.device) - starts[ids[order]])[inv]
    keep = pos < capacity
    return keep, torch.where(keep, pos, torch.full_like(pos, capacity - 1))


def _grouped_ffn(cfg: ModelConfig, wg, wu, wd, tokens2d: torch.Tensor,
                 expert_ids: torch.Tensor, e_count: int, capacity: int
                 ) -> torch.Tensor:
    """The FFN over tokens with precomputed local expert ids ``(N,)`` in
    ``[0, e_count)``: sort-dispatched into ``(e_count, capacity, d)``
    and combined; zero rows where dropped (JAX's ``_grouped_ffn``)."""
    n, d = tokens2d.shape
    cdt, dev = tokens2d.dtype, tokens2d.device
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    counts = _counts(sorted_e, e_count)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(n, device=dev) - starts[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    zero = torch.zeros((), dtype=cdt, device=dev)
    gathered = torch.where(keep[:, None], tokens2d[order], zero)
    buf = torch.zeros((e_count, capacity, d), dtype=cdt,
                      device=dev).index_put((sorted_e, slot), gathered,
                                            accumulate=True)
    out_buf = torch.bmm(_act(cfg, torch.bmm(buf, wg)) * torch.bmm(buf, wu),
                        wd)
    out = torch.where(keep[:, None], out_buf[sorted_e, slot], zero)
    return torch.zeros((n, d), dtype=cdt, device=dev).index_add(0, order,
                                                                out)


def _local_experts(params: Dict, e: int, e_local: int, m: int):
    """This rank's ``e_local`` experts of each expert leaf: the leaf as
    given where the sharded step gathered this rank's own, else its
    block ``m``."""
    out = []
    for name in EXPERT_LEAVES:
        w = params[name]
        if w.shape[0] == e:
            w = w[m * e_local:(m + 1) * e_local]
        elif w.shape[0] != e_local:
            raise ValueError(f"{name} holds {w.shape[0]} experts: neither "
                             f"all {e} nor a rank's {e_local}")
        out.append(w)
    return out


def _pack(cfg: ModelConfig, router: torch.Tensor, x2d: torch.Tensor,
          model: int, cdt):
    """A rank's routing and its pages (JAX's body up to the exchange):
    ``(send_x (model, cap, d), send_e (model * cap,), route, aux)`` with
    ``route`` the assignments' ``(dest, slot, keep, src_tok, probs)``."""
    n_l, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    e_local = e // model
    dev = x2d.device
    top_idx, top_probs, aux = _router(cfg, {"router": router}, x2d)
    dest = (top_idx // e_local).reshape(-1)                 # (n_l k,)
    local_e = (top_idx % e_local).reshape(-1)
    cap = max(int(math.ceil(n_l * k / model * cfg.capacity_factor)), 8)
    keep, slot = _sort_slots(dest, model, cap)
    src_tok = torch.arange(n_l, device=dev).repeat_interleave(k)
    zero = torch.zeros((), dtype=cdt, device=dev)
    send_x = torch.zeros((model, cap, d), dtype=cdt, device=dev).index_put(
        (dest, slot), torch.where(keep[:, None], x2d[src_tok].to(cdt), zero),
        accumulate=True)
    # JAX's .at[].max: an empty slot reads 0, a dropped entry writes 0
    send_e = torch.zeros(model * cap, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, dest * cap + slot, torch.where(keep, local_e,
                                          torch.zeros_like(local_e)),
        "amax", include_self=True)
    return send_x, send_e, (dest, slot, keep, src_tok,
                            top_probs.reshape(-1)), aux


def _run_experts(cfg: ModelConfig, recv_x: torch.Tensor,
                 recv_e: torch.Tensor, weights) -> torch.Tensor:
    """The received ``(model * cap, d)`` slots through this rank's
    experts: the plain product for one, else the grouped FFN, where an
    empty slot goes to local expert 0, whose capacity holds them all."""
    wg, wu, wd = weights
    if wg.shape[0] == 1:
        return (_act(cfg, recv_x @ wg[0]) * (recv_x @ wu[0])) @ wd[0]
    return _grouped_ffn(cfg, wg, wu, wd, recv_x, recv_e, wg.shape[0],
                        recv_x.shape[0])


def _combine(back: torch.Tensor, route, n_l: int) -> torch.Tensor:
    """The returned ``(model, cap, d)`` pages back to the assignments,
    weighted by their router probabilities: ``(n_l, d)``."""
    dest, slot, keep, src_tok, probs = route
    zero = torch.zeros((), dtype=back.dtype, device=back.device)
    res = torch.where(keep[:, None], back[dest, slot], zero)
    return torch.zeros((n_l, back.shape[-1]), dtype=back.dtype,
                       device=back.device).index_add(
        0, src_tok, res * probs.to(back.dtype)[:, None])


def _apply_moe_alltoall(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                        mesh, split: bool) -> Tuple[torch.Tensor, Dict]:
    """Expert parallelism with an explicit all-to-all exchange over
    ``model`` (JAX's ``shard_map`` body, one rank's share of it).

    The ``model`` ranks hold the same rows (the port's ``model`` axis
    replicates activations), so each takes its ``T / model`` slice of
    them (the whole ``T`` where ``T % model != 0``, JAX's ``tax =
    None``; serving also takes its block of rows over the batch axes,
    JAX's ``bax``), routes it, packs a page of ``cap`` slots for each
    destination rank, exchanges the pages, runs its ``E / model``
    experts, exchanges the outputs back and combines them; the slices
    are then gathered over ``model`` (and serving's rows over the batch
    axes).  The capacity is per rank: ``max(ceil(n_l k / model cf),
    8)``.  The aux losses are ``pmean``-ed over every mesh axis.

    Gradients: a slice's backward gathers the slices' gradients and the
    gather's takes this rank's, so every ``model`` rank holds the whole
    gradient of the layer's input; the router's gradient is summed over
    ``model`` (each rank routed its own slice); the experts' gradients
    are this rank's own experts' whole, never summed over ``model``.
    Where every ``model`` rank routes the whole ``T``, the output is the
    first ``model`` rank's (JAX takes one replica) and the input's
    gradient is summed over ``model``."""
    b, t, d = x.shape
    e = cfg.num_experts
    model = mesh.shape["model"]
    e_local = e // model
    cdt = getattr(torch, cfg.compute_dtype)
    maxes = ("model",)

    bax = tuple(a for a in BATCH_AXES if a in mesh.shape and
                mesh.shape[a] > 1)
    rows_over = () if split or b % mesh.extent(bax) else bax
    if rows_over:
        nb = b // mesh.extent(bax)
        x = x[mesh.index(bax) * nb:(mesh.index(bax) + 1) * nb]
    sliced = t % model == 0
    x_l = cl.TakeBlock.apply(x, mesh, maxes, 1) if sliced else \
        cl.SumGrad.apply(x, mesh, maxes)
    b_l, t_l, _ = x_l.shape
    router = cl.SumGrad.apply(params["router"], mesh, maxes)
    send_x, send_e, route, aux = _pack(cfg, router, x_l.reshape(-1, d),
                                       model, cdt)
    aux = {name: cl.MeanOver.apply(v, mesh, mesh.axis_names)
           for name, v in aux.items()}
    recv_x = cl.AllToAll.apply(send_x.reshape(-1, d), mesh, maxes)
    recv_e = cl.all_to_all(send_e, mesh, maxes)
    out = _run_experts(cfg, recv_x, recv_e, [
        w.to(cdt) for w in _local_experts(params, e, e_local,
                                          mesh.index(maxes))])
    back = cl.AllToAll.apply(out, mesh, maxes).reshape(send_x.shape)
    y = _combine(back, route, b_l * t_l).reshape(b_l, t_l, d).to(x.dtype)
    y = cl.GatherBlocks.apply(y, mesh, maxes, 1) if sliced else \
        cl.BroadcastFrom.apply(y, mesh, maxes, 0)
    if rows_over:
        y = cl.all_gather(y, mesh, rows_over, 0)
    return y, aux


def apply_moe_alltoall_ref(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                           data: int, model: int
                           ) -> Tuple[torch.Tensor, Dict]:
    """The plain single-process version of the all-to-all dispatch of a
    whole batch ``x`` on a ``(data, model)`` mesh: every rank's routing,
    pages and experts computed in one process, the exchange a loop over
    the ranks' pages; the output and the aux losses (their mean over the
    ranks).  ``chip_smoke.py`` and the tests hold the route to it."""
    b, t, d = x.shape
    e = cfg.num_experts
    e_local = e // model
    cdt = getattr(torch, cfg.compute_dtype)
    nb = b // data if b % data == 0 else b
    t_l = t // model if t % model == 0 else t
    ys, auxes = [], []
    for di in range(data if b % data == 0 else 1):
        xr = x[di * nb:(di + 1) * nb]
        packs = [_pack(cfg, params["router"],
                       xr[:, m * t_l:(m + 1) * t_l].reshape(-1, d)
                       if t_l < t else xr.reshape(-1, d), model, cdt)
                 for m in range(model)]
        auxes += [p[3] for p in packs] * (1 if b % data == 0 else data)
        outs = [_run_experts(
            cfg, torch.cat([p[0][j] for p in packs]),
            torch.cat([p[1].reshape(model, -1)[j] for p in packs]),
            [w.to(cdt) for w in _local_experts(params, e, e_local, j)])
            for j in range(model)]
        cap = packs[0][0].shape[1]
        parts = [_combine(torch.stack([o[m * cap:(m + 1) * cap]
                                       for o in outs]), packs[m][2],
                          nb * t_l).reshape(nb, t_l, d)
                 for m in range(model)]
        ys.append(torch.cat(parts, dim=1) if t_l < t else parts[0])
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    return torch.cat(ys).to(x.dtype), aux
