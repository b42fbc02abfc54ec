"""Pipeline parallelism (GPipe schedule) over a "stage" mesh axis.

Port of ``repro.distributed.pipeline``.  One process a rank, each rank
one stage holding only its slice of the stacked stage parameters; the
boundary transfers are a ring :func:`~repro_torch.distributed.
collectives.permute` and the schedule is JAX's:

    for t in range(num_micro + stages - 1):        # fill + steady + drain
        x = stage_fn(stage_params, x)  if active
        x = ppermute(x, stage -> stage+1)

Stage 0 feeds microbatch ``t``; a stage is active while ``0 <= t -
stage < num_micro``; the last stage records its finished microbatch;
then every stage sends to the next, the last to stage 0 (real traffic
that stage 0 ignores, as in JAX).  A stage skips its ``stage_fn`` when
it is inactive (JAX computes and discards it): the bubble is idle time,
``(stages - 1) / (num_micro + stages - 1)`` of the ticks.  The outputs
are broadcast from the last stage (JAX's ``all_gather(...)[stages -
1]``).

Training composes with autograd through :class:`_GPipe`, whose backward
is the transpose of the schedule, tick by tick in reverse: each permute
reversed, each active tick's ``stage_fn`` differentiated from the graph
its forward kept, the outputs' gradient averaged onto the last stage
(JAX's cotangent of a replicated output) and the input's summed over
the stages (only stage 0 reads it).  Every rank issues the same
collectives in the same order whatever its stage, which an autograd
graph of the ring cannot promise: PyTorch skips a node that no
gradient reaches, and which nodes those are differs from stage to
stage.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.distributed import collectives as cl

__all__ = ["gpipe_forward", "stage_slice"]


def stage_slice(stacked, mesh, stage_axis: str):
    """This rank's ``(1, ...)`` block of a tree whose leaves have a
    leading ``stages`` dim (JAX's ``P(stage_axis)`` block)."""
    i = mesh.index((stage_axis,))
    return pytree.tree_map(lambda t: t[i:i + 1].clone(), stacked)


class _GPipe(torch.autograd.Function):
    """The schedule (see the module docstring) as one differentiable
    function of ``x`` and this stage's parameter leaves."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        mesh, axis, stage_fn, spec, num_micro = plan
        stages = mesh.shape[axis]
        stage = mesh.index((axis,))
        b = x.shape[0]
        mb = b // num_micro
        grad = any(ctx.needs_input_grad[1:])
        with torch.enable_grad() if grad else torch.no_grad():
            params_in = [t.detach()[0] for t in leaves]
            for p, t in zip(params_in, leaves):
                p.requires_grad_(t.requires_grad)
            params = pytree.tree_unflatten(params_in, spec)
            micro = x.detach().reshape(num_micro, mb, *x.shape[1:])
            buf = torch.zeros_like(micro[0])
            outs = torch.zeros_like(micro)
            saved = {}
            for t in range(num_micro + stages - 1):
                cur = micro[min(t, num_micro - 1)] if stage == 0 else buf
                y = buf
                if 0 <= t - stage < num_micro:
                    cur = cur.detach().requires_grad_(grad)
                    y = stage_fn(params, cur)
                    if grad:
                        saved[t] = (cur, y)
                    y = y.detach()
                    if stage == stages - 1:
                        outs[t - stages + 1] = y
                buf = cl.permute(y, mesh, axis, 1)
        ctx.plan, ctx.saved, ctx.params_in = plan, saved, params_in
        ctx.x_shape = x.shape
        return cl.broadcast(outs.reshape(x.shape), mesh, (axis,),
                            stages - 1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, _, _, num_micro = ctx.plan
        stages = mesh.shape[axis]
        stage = mesh.index((axis,))
        shape = ctx.x_shape
        mb = shape[0] // num_micro
        g_outs = (cl.reduce(g.contiguous(), mesh, (axis,), stages - 1)
                  / stages).reshape(num_micro, mb, *shape[1:])
        g_micro = torch.zeros_like(g_outs)
        g_params = [None] * len(ctx.params_in)
        gbuf = torch.zeros_like(g_outs[0])
        for t in reversed(range(num_micro + stages - 1)):
            g_y = cl.permute(gbuf, mesh, axis, -1)
            if t not in ctx.saved:
                gbuf = g_y                   # an idle tick passed y = buf
                continue
            if stage == stages - 1:
                g_y = g_y + g_outs[t - stages + 1]
            cur, y = ctx.saved.pop(t)
            wrt = [cur] + [p for p in ctx.params_in if p.requires_grad]
            got = list(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
            g_cur = got.pop(0)
            g_cur = torch.zeros_like(cur) if g_cur is None else g_cur
            for i, p in enumerate(ctx.params_in):
                if not p.requires_grad:
                    continue
                gp = got.pop(0)
                if gp is not None:
                    g_params[i] = gp if g_params[i] is None else \
                        g_params[i] + gp
            if stage == 0:
                g_micro[t] = g_cur
                gbuf = torch.zeros_like(gbuf)  # stage 0 fed, not buf
            else:
                gbuf = g_cur
        # only stage 0 reads x, which every stage holds alike
        g_x = cl.all_reduce(g_micro.reshape(shape), dist.ReduceOp.SUM,
                            mesh.group((axis,)), mesh, (axis,))
        return (None, g_x) + tuple(
            None if gp is None else gp[None] for gp in g_params)


def gpipe_forward(mesh, stage_axis: str, stage_fn: Callable, stage_params,
                  x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline; called by every rank of
    ``mesh`` together.

    Args:
      stage_fn: (params_slice, x_micro) -> x_micro, one stage's layers.
      stage_params: this rank's slice of the tree whose leaves have a
        leading ``stages`` dim sharded over ``stage_axis``: leaves of
        leading dim 1 (:func:`stage_slice` cuts it from the stacked tree).
      x: (B, ...) global input batch, replicated across stages.
      num_micro: number of microbatches (must divide B).

    Returns (B, ...) outputs (the last stage's, on every stage).
    """
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} must divide into {num_micro} micro")
    leaves, spec = pytree.tree_flatten(stage_params)
    for t in leaves:
        if t.shape[:1] != (1,):
            raise ValueError(f"a stage parameter of shape {tuple(t.shape)}: "
                             "each leaf is this rank's (1, ...) block of "
                             "the stacked (stages, ...) leaf")
    plan = (mesh, stage_axis, stage_fn, spec, num_micro)
    return _GPipe.apply(plan, x, *leaves)
