"""The GPipe pipeline (``distributed/pipeline.py``), held to the JAX
package on the CPU.

JAX's own case (``tests/test_distributed.py``): 4 stages of 2 ``tanh``
layers, d 16, a batch of 8 in 4 microbatches.  The port's
``gpipe_forward`` on 4 gloo ranks (one process a stage, one intra-op
thread each, each holding only its stage's ``(1, 2, 16, 16)`` block)
against JAX's ``gpipe_forward`` on 4 host devices (one subprocess):
the output within 1e-5 on every rank; the gradients of ``sum(out^2)``
(each rank's block of the weights, and the input on every rank) within
1e-5 of JAX's ``jax.grad`` through its pipeline and of plain autograd
through the sequential stack.  The ring permute's autograd function
sends a tensor one stage on and its gradient one back.  A batch that
does not split into the microbatches raises JAX's ``ValueError``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import SRC

STAGES, LAYERS, D, B, MICRO = 4, 2, 16, 8, 4
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((STAGES, LAYERS, D, D)) * 0.2).astype(
        np.float32)
    return ws, rng.standard_normal((B, D)).astype(np.float32)


def stage_fn(params, x):
    for i in range(LAYERS):
        x = torch.tanh(x @ params[i])
    return x


_JAX = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import gpipe_forward

TMP, MICRO, LAYERS = ARGS
mesh = jax.make_mesh((4,), ("stage",),
                     axis_types=(jax.sharding.AxisType.Auto,))
inp = np.load(TMP + "/inputs.npz")
ws, x = jnp.asarray(inp["ws"]), jnp.asarray(inp["x"])

def stage_fn(params, x):
    for i in range(LAYERS):
        x = jnp.tanh(x @ params[i])
    return x

def loss(w, xx):
    out = gpipe_forward(mesh, "stage", stage_fn, w, xx, num_micro=MICRO)
    return jnp.sum(out ** 2), out

(_, out), (gw, gx) = jax.jit(jax.value_and_grad(
    loss, argnums=(0, 1), has_aux=True))(ws, x)
np.savez(TMP + "/jax.npz", out=np.asarray(out), gw=np.asarray(gw),
         gx=np.asarray(gx))
print("OK")
"""


def _rank(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.distributed.pipeline import gpipe_forward, stage_slice
    from repro_torch.launch.mesh import Mesh, init_rank
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    mesh = Mesh(("stage",), (world,), rank=rank)
    mesh.build_groups()
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    w = stage_slice(torch.from_numpy(inp["ws"]), mesh,
                    "stage").requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    out = gpipe_forward(mesh, "stage", stage_fn, w, x, MICRO)
    gw, gx = torch.autograd.grad((out ** 2).sum(), [w, x])
    # the ring permute's autograd function: this rank's tensor goes one
    # stage on, its gradient one stage back
    from repro_torch.distributed.collectives import Permute
    t = torch.full((3,), float(rank), requires_grad=True)
    shifted = Permute.apply(t, mesh, "stage", 1)
    (g_t,) = torch.autograd.grad((shifted * (rank + 1)).sum(), [t])
    torch.save(dict(out=out.detach(), gw=gw, gx=gx, w=tuple(w.shape),
                    shifted=shifted.detach(), g_t=g_t),
               os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    tmp = str(tmp_path_factory.mktemp("gpipe"))
    ws, x = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), ws=ws, x=x)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={STAGES}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # JAX's run beside the ranks'
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX.replace("= ARGS", "= " + repr(
            (tmp, MICRO, LAYERS)))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        spawn_ranks(_rank, STAGES, (STAGES, tmp), deadline_s=120)
        _, err = jax_run.communicate(timeout=240)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(STAGES)]
    return dict(np.load(os.path.join(tmp, "jax.npz"))), ranks


def _sequential():
    ws, x = (torch.from_numpy(a).requires_grad_() for a in _inputs())
    out = x
    for s in range(STAGES):
        out = stage_fn(ws[s], out)
    gw, gx = torch.autograd.grad((out ** 2).sum(), [ws, x])
    return out.detach(), gw, gx


def test_gpipe_forward_matches_jax_and_sequential(runs):
    jres, ranks = runs
    seq, _, _ = _sequential()
    np.testing.assert_allclose(jres["out"], seq.numpy(), **TOL)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["out"].numpy(), jres["out"], **TOL,
                                   err_msg=r)


def test_gpipe_gradients_match_jax_and_sequential(runs):
    jres, ranks = runs
    _, gw, gx = _sequential()
    for r, got in enumerate(ranks):
        assert got["w"] == (1, LAYERS, D, D)     # its stage's block only
        for want in (jres["gw"][r], gw[r].numpy()):
            np.testing.assert_allclose(got["gw"][0].numpy(), want, **TOL,
                                       err_msg=r)
        for want in (jres["gx"], gx.numpy()):
            np.testing.assert_allclose(got["gx"].numpy(), want, **TOL,
                                       err_msg=r)


def test_permute_and_its_gradient_go_round_the_ring(runs):
    """``Permute`` (JAX's ``ppermute`` ring ``(i, (i + 1) % n)``): stage
    ``r`` receives stage ``r - 1``'s tensor, and its gradient goes back
    the other way (stage ``r`` reads the loss weight of stage ``r +
    1``)."""
    _, ranks = runs
    for r, got in enumerate(ranks):
        assert torch.equal(got["shifted"],
                           torch.full((3,), float((r - 1) % STAGES)))
        assert torch.equal(got["g_t"],
                           torch.full((3,), float((r + 1) % STAGES + 1)))


def test_gpipe_batch_must_split_into_microbatches():
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.launch.mesh import Mesh
    w = torch.zeros(1, LAYERS, D, D)
    with pytest.raises(ValueError,
                       match="batch 6 must divide into 4 micro"):
        gpipe_forward(Mesh(("stage",), (STAGES,)), "stage", stage_fn, w,
                      torch.zeros(6, D), MICRO)
