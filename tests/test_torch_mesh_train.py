"""The Trainer's mesh, held to the JAX package on the CPU.

* **Axes.** ``param_axes`` (the port's init on the ``meta`` device)
  equals JAX's ``axes_of(init_model)`` leaf for leaf, the stacked
  layers' ``groups`` axis dropped, for every registered arch; the port's
  ``init_model`` draws the same tensors as before the axes were added
  (digests of its smoke trees, f32 and bf16).
* **Specs.** ``param_specs``, ``opt_specs`` (32- and 8-bit moments) and
  ``batch_specs`` equal JAX's entry for entry on ``AbstractMesh`` (4, 2)
  and (16, 16), shape-only on both sides; llama4 with
  ``logical_pad_heads`` (40 -> 48 heads) among them.
* **Padded heads.** ``llama31-8b.smoke()`` with ``logical_pad_heads``
  (4 -> 16 query heads) gives JAX's loss (rtol 1e-5) and gradients
  (relative L2 1e-4, ``test_torch_train.py``'s) on JAX's padded weights;
  the port's init zeros the padded heads, and llama4's full config draws
  48.
* **The sharded step** on 4 gloo ranks (one process a rank, one intra-op
  thread each), ``llama31-8b.smoke()`` at ``remat_policy="full"`` from
  JAX's weights (``from_jax_params``): meshes (4, 1) and (2, 2), accum 1
  and 2, 32- and 8-bit moments, and a batch whose padding differs across
  ranks, against JAX's jitted ``make_train_step`` for 2 steps: loss and
  gradient norm rtol 1e-5, the parameters (each rank's blocks) within
  1e-4 of each leaf's largest magnitude (``test_torch_train_loop.py``'s
  tolerances).  Every rank's parameter and moment blocks have their
  spec's shard shapes.  ``mamba2-780m.smoke()`` on (2, 2) runs the 8-bit
  moments whose blocks of 16 straddle the shards (its ``in_proj``'s 296
  columns over 2 ranks; the moment's row gathered and quantized whole)
  against the port's single-process step, which ``test_torch_train.py``
  holds to JAX.
* **The checkpoint.** A tree saved from the (2, 2) blocks restores onto
  (4, 1) shardings as each rank's block of the whole tree, bit for bit.
* **Compression.** ``compressed_psum`` on the 4 ranks, 3 rounds of error
  feedback, against JAX's ``compressed_psum`` under ``shard_map`` on 4
  host devices (one subprocess; ``Mesh(...)`` with Auto axes) and
  against ``compressed_psum_ref``: int8 payloads and scales equal, sums
  and error buffers within rtol 1e-6 / atol 1e-6, JAX's error buffers
  within ``ERROR_ULPS`` float32 ulps of the corrected gradient's largest
  value (XLA fuses the subtraction and the product).

MoE under a data mesh and the expert-parallel exchange are
``test_torch_moe_alltoall.py``'s.
"""

import functools
import hashlib
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_subprocess_devices

WORLD = 4
SCHED = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=3)
STEPS = 2
ROWS, SEQ = 8, 32
# name -> (mesh (data, model), accum, state bits, padding)
CASES = {
    "4x1-a1-b32": ((4, 1), 1, 32, "light"),
    "4x1-a2-b32": ((4, 1), 2, 32, "light"),
    "4x1-a1-b8": ((4, 1), 1, 8, "light"),
    "4x1-a2-b8": ((4, 1), 2, 8, "light"),
    "2x2-a1-b32": ((2, 2), 1, 32, "light"),
    "2x2-a2-b32": ((2, 2), 2, 32, "light"),
    "2x2-a1-b8": ((2, 2), 1, 8, "light"),
    "2x2-a2-b8": ((2, 2), 2, 8, "light"),
    "4x1-a2-b32-padding": ((4, 1), 2, 32, "heavy"),
}
COMPRESSION_ROUNDS = 3
# sums of 4 float32 terms of magnitude up to ~4 in another order (JAX's
# psum, gloo's reduction, the plain loop's rank order)
COMPRESSION_TOL = dict(rtol=1e-6, atol=1e-6)
# JAX's error buffers against the port's: XLA contracts ``corrected - q *
# scale`` into one fused multiply-add, so they part by a few float32 ulps
# of the corrected gradient's largest value (measured 2.1e-6 at 13.7)
ERROR_ULPS = 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(arch="llama31-8b"):
    from repro_torch.configs import get_config
    return get_config(arch).smoke().replace(remat_policy="full")


def _jcfg(arch="llama31-8b"):
    from repro.configs import get_config
    return get_config(arch).smoke().replace(remat_policy="full")


def _batch(step, padding):
    """The global batch of ``step``: numpy draws, labels -1 on rows'
    prefixes of lengths that differ from row to row (and so from rank to
    rank); ``heavy`` pads whole rows and most of others."""
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(0, 256, (ROWS, SEQ)).astype(np.int32)
    labels = rng.integers(0, 256, (ROWS, SEQ)).astype(np.int32)
    cut = [0, 3, 0, 9, 1, 0, 17, 5] if padding == "light" else \
        [SEQ, 0, 30, 2, SEQ, 28, 0, 31]
    for r, c in enumerate(cut):
        labels[r, :c] = -1
    return {"tokens": tokens, "labels": labels}


def _ocfg(mod, sched_mod, bits):
    return mod.AdamWConfig(state_bits=bits,
                           schedule=sched_mod.ScheduleConfig(**SCHED))


def _shape_ok(tree, shardings, sds):
    """Every block of ``tree`` has its spec's shard shape of the whole
    tensor's shape in ``sds``."""
    from repro_torch.distributed import fsdp
    flat = fsdp.flat_tree(shardings)
    whole = dict(_flat(sds))
    return all(tuple(t.shape) == flat[p].shard_shape(whole[p].shape)
               for p, t in _flat(tree))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


# ------------------------------------------------------------ 4 gloo ranks

def _compression_grads(rank):
    g = torch.Generator().manual_seed(1000 + rank)
    return [{"w": torch.randn(64, 48, generator=g) * (rank + 1),
             "b": torch.randn(48, generator=g) * 1e-3}
            for _ in range(COMPRESSION_ROUNDS)]


def _mesh_rank(rank, world, tmp):
    """Every case of the sharded step, the q8 gather path, the
    resharding restore and the compressed all-reduce on one rank."""
    torch.set_num_threads(1)
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import compression, fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw as tadam
    from repro_torch.optim import schedule as tsched
    from repro_torch.runtime.steps import make_train_step
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    meshes = {(4, 1): make_test_mesh(4, 1), (2, 2): make_test_mesh(2, 2)}
    whole = torch.load(os.path.join(tmp, "params.pt"), weights_only=True)
    res = {}

    def run(cfg, params, mesh, accum, bits, padding):
        ocfg = _ocfg(tadam, tsched, bits)
        psds, psh = sp.param_specs(cfg, mesh, {})
        osds, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
        params = fsdp.shard_tree(params, fsdp.flat_tree(psh))
        opt = fsdp.zeros_tree(osds, fsdp.flat_tree(osh), "cpu")
        step = make_train_step(cfg, ocfg, accum, grad_shardings=psh)
        metrics = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in _batch(i, padding).items()}
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        shapes = _shape_ok(params, psh, psds) and \
            _shape_ok(opt, osh, osds)
        return params, opt, metrics, shapes, psh, osh

    cfg = _tcfg()
    for name, (shape, accum, bits, padding) in CASES.items():
        params, _, metrics, shapes, _, _ = run(cfg, whole, meshes[shape],
                                               accum, bits, padding)
        res[name] = dict(params=params, metrics=metrics, shapes=shapes)
    # the 8-bit moments gathered and quantized whole (mamba2's in_proj)
    mcfg = _tcfg("mamba2-780m")
    mparams = tfm.init_model(mcfg, 5)
    p, o, metrics, shapes, psh, osh = run(mcfg, mparams, meshes[(2, 2)], 1,
                                          8, "light")
    res["mamba2"] = dict(params=p, opt=o, metrics=metrics, shapes=shapes)
    # the checkpoint written from (2, 2) blocks, restored onto (4, 1)
    ck = Checkpointer(os.path.join(tmp, "ckpt"))
    tree = {"params": p, "opt": o}
    ck.save(3, tree, shardings={"params": psh, "opt": osh},
            write=rank == 0, blocking=True)
    dist.barrier()
    ocfg = _ocfg(tadam, tsched, 8)
    psds, psh4 = sp.param_specs(mcfg, meshes[(4, 1)], {})
    _, osh4 = sp.opt_specs(ocfg, psds, psh4, meshes[(4, 1)], {})
    res["restored"] = ck.restore(shardings={"params": psh4, "opt": osh4})[
        "tree"]
    # error-feedback int8 all-reduce, 3 rounds
    grads = _compression_grads(rank)
    errors = compression.init_error_buffers(grads[0])
    rounds = []
    group = meshes[(4, 1)].group(("data",))
    for g in grads:
        synced, errors = compression.compressed_psum(g, errors, group)
        rounds.append(dict(synced=synced, errors=errors))
    res["compression"] = rounds
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


_JAX_COMPRESSION = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compression import compressed_psum
from repro.distributed.sharding import shard_map

inp_path, out_path, rounds = ARGS
inp = np.load(inp_path)
mesh = Mesh(np.asarray(jax.devices()[:4]), ("pod",))
spec = {"w": P("pod"), "b": P("pod")}

def body(g, e):
    g = {k: v[0] for k, v in g.items()}
    e = {k: v[0] for k, v in e.items()}
    s, ne = compressed_psum(g, e, "pod")
    return ({k: v[None] for k, v in s.items()},
            {k: v[None] for k, v in ne.items()})

f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False))
errors = {k: jnp.zeros(inp[f"{k}0"].shape, jnp.float32) for k in ("w", "b")}
out = {}
for r in range(rounds):
    g = {k: jnp.asarray(inp[f"{k}{r}"]) for k in ("w", "b")}
    synced, errors = f(g, errors)
    for k in ("w", "b"):
        out[f"synced_{k}{r}"] = np.asarray(synced[k])
        out[f"errors_{k}{r}"] = np.asarray(errors[k])
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's weights and steps, the 4 gloo ranks' results (one spawn for
    every case) and JAX's compressed all-reduce (one subprocess)."""
    import jax
    import jax.numpy as jnp
    from repro.models import param as jpm
    from repro.models import transformer as jtfm
    from repro.optim import adamw as jadam
    from repro.optim import schedule as jsched
    from repro.runtime.steps import make_train_step as jmake
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.weights import from_jax_params
    tmp = str(tmp_path_factory.mktemp("mesh"))
    jc, tc = _jcfg(), _tcfg()
    jp0 = jpm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))
    torch.save(from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp0)),
               os.path.join(tmp, "params.pt"))
    spawn_ranks(_mesh_rank, WORLD, (WORLD, tmp), deadline_s=300)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    jax_runs, steps = {}, {}
    for name, (_, accum, bits, padding) in CASES.items():
        if (accum, bits) not in steps:
            jo = _ocfg(jadam, jsched, bits)
            steps[accum, bits] = (jo, jax.jit(jmake(jc, jo, accum=accum)))
        jo, jstep = steps[accum, bits]
        jp, js = jp0, jadam.init_adamw(jo, jp0)
        metrics = []
        for i in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in _batch(i, padding).items()}
            jp, js, m = jstep(jp, js, b)
            metrics.append({k: float(v) for k, v in m.items()})
        jax_runs[name] = dict(metrics=metrics, params=from_jax_params(
            tc, jax.tree_util.tree_map(np.asarray, jp)))
    inp = {f"{k}{r}": np.stack([_compression_grads(rank)[r][k].numpy()
                                for rank in range(WORLD)])
           for r in range(COMPRESSION_ROUNDS) for k in ("w", "b")}
    np.savez(os.path.join(tmp, "comp_in.npz"), **inp)
    args = (os.path.join(tmp, "comp_in.npz"), os.path.join(tmp, "comp.npz"),
            COMPRESSION_ROUNDS)
    run_subprocess_devices(_JAX_COMPRESSION.replace("= ARGS", "= " +
                                                    repr(args)),
                           devices=WORLD, timeout=240)
    return ranks, jax_runs, dict(np.load(os.path.join(tmp, "comp.npz")))


def _block_of(sharding_tree_fn, rank, tree):
    """Rank ``rank``'s blocks of the whole ``tree``."""
    from repro_torch.distributed import fsdp
    return fsdp.shard_tree(tree, fsdp.flat_tree(sharding_tree_fn(rank)))


def _param_shardings(cfg, shape, rank):
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    return sp.param_specs(cfg, Mesh(("data", "model"), shape, rank=rank),
                          {})[1]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(runs, name):
    ranks, jax_runs, _ = runs
    shape = CASES[name][0]
    want = jax_runs[name]
    whole = dict(_flat(want["params"]))
    cfg = _tcfg()
    for rank, got in enumerate(ranks):
        got = got[name]
        assert got["shapes"], f"rank {rank}: a block off its spec's shape"
        for i, (m, jm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-5,
                                           err_msg=(rank, i, k))
        block = _block_of(functools.partial(_param_shardings, cfg, shape),
                          rank, want["params"])
        for (path, t), (_, j) in zip(_flat(got["params"]), _flat(block)):
            np.testing.assert_allclose(
                t.numpy(), j.numpy(), rtol=0,
                atol=1e-4 * float(whole[path].abs().max()),
                err_msg=(rank, path))


def test_padding_differs_across_ranks():
    """The padding case's ranks hold different valid-token counts (so the
    global count, not a rank's, is the loss's denominator)."""
    counts = []
    for r in range(WORLD):
        labels = _batch(0, "heavy")["labels"]
        rows = ROWS // 2 // WORLD
        lo = r * rows
        counts.append(int((labels[lo:lo + rows] >= 0).sum()))
    assert len(set(counts)) > 1


def test_q8_moments_gathered_where_blocks_straddle_shards(runs):
    """mamba2's 8-bit moments on (2, 2) against one process: the same
    metrics, and every rank's parameter and moment blocks the blocks of
    the single-process ones (moment codes equal but where the companding
    quotient sits on a rounding edge: at most one code apart)."""
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw as tadam
    from repro_torch.optim import schedule as tsched
    from repro_torch.optim import quantized_state as q8
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.distributed import fsdp
    ranks, _, _ = runs
    cfg = _tcfg("mamba2-780m")
    ocfg = _ocfg(tadam, tsched, 8)
    params = tfm.init_model(cfg, 5)
    opt = tadam.init_adamw(ocfg, params)
    step = make_train_step(cfg, ocfg, 1)
    metrics = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in _batch(i, "light").items()}
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = dict(_flat(params))
    # in_proj's columns over the 2 model ranks: no whole blocks of 16
    assert params["layers"][0]["mamba"]["in_proj"].shape[1] // 2 % \
        q8.BLOCK != 0
    for rank, got in enumerate(ranks):
        got = got["mamba2"]
        assert got["shapes"]
        for m, ref in zip(got["metrics"], metrics):
            for k in ref:
                np.testing.assert_allclose(m[k], ref[k], rtol=1e-5,
                                           err_msg=(rank, k))
        mesh = Mesh(("data", "model"), (2, 2), rank=rank)
        psds, psh = sp.param_specs(cfg, mesh, {})
        _, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
        pb = fsdp.shard_tree(params, fsdp.flat_tree(psh))
        ob = fsdp.shard_tree(opt, fsdp.flat_tree(osh))
        for (path, t), (_, j) in zip(_flat(got["params"]), _flat(pb)):
            np.testing.assert_allclose(
                t.numpy(), j.numpy(), rtol=0,
                atol=1e-4 * float(whole[path].abs().max()),
                err_msg=(rank, path))
        for (path, t), (_, j) in zip(_flat(got["opt"]), _flat(ob)):
            if t.dtype == torch.int8:
                assert int((t.int() - j.int()).abs().max()) <= 1, path
            else:
                np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5,
                                           atol=1e-12, err_msg=path)


def test_resharding_restore_gives_each_rank_its_block(runs):
    """The tree saved from (2, 2) blocks, restored onto (4, 1), is each
    rank's (4, 1) block of the whole tree (the (2, 2) blocks gathered),
    bit for bit."""
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw as tadam
    from repro_torch.optim import schedule as tsched
    from repro_torch.distributed import fsdp
    from repro_torch.distributed.sharding import entry_axes
    ranks, _, _ = runs
    cfg = _tcfg("mamba2-780m")
    ocfg = _ocfg(tadam, tsched, 8)

    @functools.lru_cache(maxsize=None)
    def shardings(shape, rank):
        mesh = Mesh(("data", "model"), shape, rank=rank)
        psds, psh = sp.param_specs(cfg, mesh, {})
        return fsdp.flat_tree({"params": psh, "opt": sp.opt_specs(
            ocfg, psds, psh, mesh, {})[1]})

    def whole_of(path):
        # the (2, 2) blocks put back together on the host
        parts = [dict(_flat({"params": ranks[r]["mamba2"]["params"],
                             "opt": ranks[r]["mamba2"]["opt"]}))[path]
                 for r in range(WORLD)]
        specs = [shardings((2, 2), r)[path] for r in range(WORLD)]
        sizes = [n * specs[0].mesh.extent(entry_axes(e))
                 for n, e in zip(parts[0].shape, specs[0].spec)]
        out = torch.zeros(sizes, dtype=parts[0].dtype)
        for t, sh in zip(parts, specs):
            out[tuple(slice(sh.mesh.index(entry_axes(e)) * n,
                            (sh.mesh.index(entry_axes(e)) + 1) * n)
                      for n, e in zip(t.shape, sh.spec))] = t
        return out

    for rank, got in enumerate(ranks):
        flat4 = shardings((4, 1), rank)
        for path, t in _flat(got["restored"]):
            want = flat4[path].shard(whole_of(path))
            assert t.dtype == want.dtype and torch.equal(t, want), \
                (rank, path)


def test_compressed_psum_matches_jax_and_plain(runs):
    """Every round on every rank: the synced mean and the error buffers
    within COMPRESSION_TOL of JAX's (under ``shard_map``) and of the
    plain single-process loop; the plain loop's int8 payloads and scales
    are those of each rank's corrected gradient, and the error feedback
    carries: round 2's buffers differ from round 1's."""
    from repro_torch.distributed import compression
    ranks, _, jres = runs
    grads = [_compression_grads(r) for r in range(WORLD)]
    errors = [compression.init_error_buffers(grads[r][0])
              for r in range(WORLD)]
    for i in range(COMPRESSION_ROUNDS):
        mean, new_errors, payloads = compression.compressed_psum_ref(
            [g[i] for g in grads], errors)
        for r in range(WORLD):
            for k in ("w", "b"):
                corrected = grads[r][i][k] + errors[r][k]
                c = compression.compress_leaf(corrected)
                assert torch.equal(c["q"], payloads[r][k]["q"])
                assert torch.equal(c["scale"], payloads[r][k]["scale"])
                got = ranks[r]["compression"][i]
                ulps = ERROR_ULPS * 2.0 ** -23 * float(
                    corrected.abs().max())
                for name, ref, jax_ref, jax_tol in (
                        ("synced", mean[k], jres[f"synced_{k}{i}"][r],
                         COMPRESSION_TOL),
                        ("errors", new_errors[r][k],
                         jres[f"errors_{k}{i}"][r],
                         dict(rtol=0, atol=ulps))):
                    np.testing.assert_allclose(got[name][k].numpy(),
                                               ref.numpy(),
                                               **COMPRESSION_TOL)
                    np.testing.assert_allclose(got[name][k].numpy(),
                                               jax_ref, **jax_tol)
        errors = new_errors
    assert not torch.equal(ranks[0]["compression"][0]["errors"]["w"],
                           ranks[0]["compression"][1]["errors"]["w"])


# ------------------------------------------------------------- in process

def _jax_axes_in_port_layout(cfg, jaxes):
    import jax

    def drop(tree):
        return jax.tree_util.tree_map(lambda a: a[1:], tree,
                                      is_leaf=lambda x: isinstance(x, tuple))
    layers = [drop(jaxes["groups"][f"slot_{i}"])
              for _ in range(cfg.num_groups)
              for i in range(len(cfg.pattern))]
    layers += [jaxes["remainder"][f"slot_{i}"]
               for i in range(len(cfg.remainder))]
    return {"embed": jaxes["embed"], "layers": layers,
            "final_norm": jaxes["final_norm"]}


def _archs():
    from repro_torch.configs.registry import ARCHITECTURES
    return list(ARCHITECTURES)


@pytest.mark.parametrize("arch", _archs())
def test_param_axes_match_jax(arch):
    """Full-size configs, shape-only on both sides (``jax.eval_shape``,
    the ``meta`` device): every leaf's logical axes JAX's."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import param as jpm
    from repro.models import transformer as jtfm
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as ttfm
    jc, tc = jget(arch), tget(arch)
    boxed = jax.eval_shape(functools.partial(jtfm.init_model, jc),
                           jax.random.PRNGKey(0))
    assert ttfm.param_axes(tc) == _jax_axes_in_port_layout(
        jc, jpm.axes_of(boxed))
    meta = ttfm.init_model_boxed(tc, device="meta")
    assert all(t.value.is_meta for _, t in _flat(meta))


# init_model's smoke trees before the axes were added: sha256 (first 16
# hex digits) of every leaf's path, dtype, shape and bytes; seeds 3 (f32)
# and 5 (bf16)
INIT_DIGESTS = {
    "stablelm-12b": ("a36387dc2cfe59f6", "97a2a2899195424b"),
    "llama31-8b": ("90ad98e890adba4f", "640f77e9a0f7a0da"),
    "gemma3-27b": ("bcf99da6cf095c22", "3ba1d6f029871016"),
    "minitron-8b": ("90ad98e890adba4f", "640f77e9a0f7a0da"),
    "gemma-7b": ("90ad98e890adba4f", "640f77e9a0f7a0da"),
    "mixtral-8x22b": ("395d85085b524c99", "62929e2cac0b0e93"),
    "llama4-maverick-400b-a17b": ("41dc0be20377e164", "8895de40dfbf2950"),
    "jamba-v0.1-52b": ("0bdac7eb7bee4e22", "a3152d39b7df8ec0"),
    "mamba2-780m": ("e9f6b0380faed969", "a79c014b9ac3edbb"),
}


def _digest(params):
    from repro_torch.optim.adamw import tree_leaves
    h = hashlib.sha256()
    for path, t in tree_leaves(params):
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", list(INIT_DIGESTS))
def test_init_model_tensors_unchanged(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).smoke()
    assert (_digest(tfm.init_model(cfg, 3)),
            _digest(tfm.init_model(cfg.replace(param_dtype="bfloat16"), 5))
            ) == INIT_DIGESTS[arch]


def _jax_specs_in_port_layout(cfg, tree):
    import jax

    def specs(t, drop):
        def one(x):
            spec = tuple(x.spec)
            return spec[1:] if drop and spec else spec
        return jax.tree_util.tree_map(one, t,
                                      is_leaf=lambda x: hasattr(x, "spec"))
    layers = [specs(tree["groups"][f"slot_{i}"], True)
              for _ in range(cfg.num_groups)
              for i in range(len(cfg.pattern))]
    layers += [specs(tree["remainder"][f"slot_{i}"], False)
               for i in range(len(cfg.remainder))]
    return {"embed": specs(tree["embed"], False), "layers": layers,
            "final_norm": specs(tree["final_norm"], False)}


def _port_specs(tree):
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_specs(v) for v in tree]
    return tree.spec


SPEC_ARCHS = [("llama31-8b", False), ("gemma-7b", False),
              ("jamba-v0.1-52b", False), ("mixtral-8x22b", False),
              ("llama4-maverick-400b-a17b", True),
              ("musicgen-medium", False), ("internvl2-26b", False)]


@pytest.mark.parametrize("arch,pad", SPEC_ARCHS,
                         ids=[a for a, _ in SPEC_ARCHS])
@pytest.mark.parametrize("shape", [(4, 2), (16, 16)], ids=["4x2", "16x16"])
def test_specs_match_jax(shape, arch, pad):
    """``param_specs``, ``opt_specs`` at 32 and 8 bits and
    ``batch_specs`` (``train_4k``) entry for entry; the fallback logs
    name the same leaves (JAX's dim numbers count the groups axis)."""
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.launch import specs as jsp
    from repro.optim import adamw as jadam
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import specs as tsp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import adamw as tadam
    jc, tc = jget(arch), tget(arch)
    if pad:
        jc, tc = (c.replace(logical_pad_heads=True) for c in (jc, tc))
    am = AbstractMesh(shape, ("data", "model"))
    tm = Mesh(("data", "model"), shape)
    jlog, tlog = [], []
    jv, jsh = jsp.param_specs(jc, am, {}, jlog)
    tv, tsh = tsp.param_specs(tc, tm, {}, tlog)
    assert _port_specs(tsh) == _jax_specs_in_port_layout(jc, jsh)
    assert all(t.is_meta for _, t in _flat(tv))

    def names(log):
        return sorted({re.sub(r"dim \d+ ", "", x) for x in log})
    assert names(tlog) == names(jlog)
    for bits in (32, 8):
        _, josh = jsp.opt_specs(jadam.AdamWConfig(state_bits=bits), jv, jsh,
                                am, {}, [])
        tos, tosh = tsp.opt_specs(tadam.AdamWConfig(state_bits=bits), tv,
                                  tsh, tm, {}, [])
        assert tosh["step"].spec == tuple(josh["step"].spec) == ()
        for k in ("m", "v"):
            assert _port_specs(tosh[k]) == _jax_specs_in_port_layout(
                jc, josh[k]), (bits, k)
        assert all(t.is_meta for _, t in _flat(tos))
    jb, jbs = jsp.batch_specs(jc, jsp.SHAPES["train_4k"], am, {}, [])
    tb, tbs = tsp.batch_specs(tc, tsp.SHAPES["train_4k"], tm, {}, [])
    assert {k: v.spec for k, v in tbs.items()} == \
        {k: tuple(v.spec) for k, v in jbs.items()}
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {k: tuple(v.shape) for k, v in jb.items()}
    assert tsp.scalar_sharding(tm).spec == ()


def test_named_sharding_placements_and_blocks():
    """``named_sharding``'s placements (one a mesh axis) and ``shard``'s
    blocks tile the whole tensor."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import named_sharding
    from repro_torch.launch.mesh import Mesh
    full = torch.arange(8 * 6).reshape(8, 6)
    seen = torch.zeros_like(full)
    for rank in range(4):
        sh = named_sharding(Mesh(("data", "model"), (2, 2), rank=rank),
                            ("embed_w", "mlp"), full.shape)
        assert sh.spec == ("data", "model")
        assert sh.placements == (Shard(0), Shard(1))
        block = sh.shard(full)
        assert tuple(block.shape) == sh.shard_shape(full.shape) == (4, 3)
        c = sh.mesh.coords
        seen[c["data"] * 4:(c["data"] + 1) * 4,
             c["model"] * 3:(c["model"] + 1) * 3] = block
        rep = named_sharding(sh.mesh, (None, "mlp"), full.shape)
        assert rep.placements == (Replicate(), Shard(1))
        assert rep.owns() == (c["data"] == 0)
    assert torch.equal(seen, full)


def test_padded_heads_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import param as jpm
    from repro.models import transformer as jtfm
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.weights import from_jax_params
    from repro_torch.runtime.steps import loss_and_grads
    big = tget("llama4-maverick-400b-a17b").replace(logical_pad_heads=True)
    meta = ttfm.init_model(big, device="meta")
    assert next(lp["attn"]["wq"].shape for lp in meta["layers"]
                if "attn" in lp)[1] == 48
    jc = jget("llama31-8b").smoke().replace(logical_pad_heads=True)
    tc = tget("llama31-8b").smoke().replace(logical_pad_heads=True)
    own = ttfm.init_model(tc, 0)
    attn = own["layers"][0]["attn"]
    assert attn["wq"].shape[1] == 16 and attn["wo"].shape[0] == 16
    assert not attn["wq"][:, tc.num_heads:].any()
    assert not attn["wo"][tc.num_heads:].any()
    assert attn["wq"][:, :tc.num_heads].all()
    jp = jpm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))
    b = _batch(0, "light")
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtfm.loss_and_metrics(jc, p, {k: jnp.asarray(v) for k, v
                                               in b.items()}),
        has_aux=True)(jp)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    tl, _, tg = loss_and_grads(tc, tp, {k: torch.from_numpy(v).long()
                                        for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(_flat(from_jax_params(tc, jax.tree_util.tree_map(
        np.asarray, jg))))
    for path, g in tg.items():
        j = want[path].double()
        rel = float((g.double() - j).norm() / j.norm().clamp(min=1e-30))
        assert rel < 1e-4, (path, rel)


def test_param_helpers_match_jax():
    """``stack_boxed`` of the port's layers, a group a list entry, gives
    JAX's stacked ``groups`` tree (values and axes); ``leaf_count`` JAX's
    count; ``tree_paths_matching`` marks exactly the frozen hash planes,
    as the optimizer's ``is_trainable_path`` does."""
    import jax
    from repro.models import param as jpm
    from repro.models import transformer as jtfm
    from repro_torch.models import param as tpm
    from repro_torch.models import transformer as ttfm
    from repro_torch.optim.adamw import is_trainable_path
    jc, tc = (_jcfg("llama4-maverick-400b-a17b"),
              _tcfg("llama4-maverick-400b-a17b"))
    jboxed = jtfm.init_model(jc, jax.random.PRNGKey(0))
    jp = jpm.unbox(jboxed)
    from repro_torch.models.weights import from_jax_params
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    axes = ttfm.param_axes(tc)
    npat = len(tc.pattern)
    per_group = []
    for g in range(tc.num_groups):
        tree = {}
        for i in range(npat):
            layer = tp["layers"][g * npat + i]
            tree[f"slot_{i}"] = _box(layer, axes["layers"][g * npat + i])
        per_group.append(tree)
    stacked = tpm.stack_boxed(per_group)
    assert tpm.axes_of(stacked) == jpm.axes_of(jboxed)["groups"]
    for (path, t), (_, j) in zip(_flat(tpm.unbox(stacked)),
                                 _flat(jax.tree_util.tree_map(
                                     np.asarray, jp["groups"]))):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32),
                                      err_msg=path)
    assert tpm.leaf_count(tp) == jpm.leaf_count(jp)
    frozen = tpm.tree_paths_matching(tp, lambda p: not is_trainable_path(p))
    marked = [p for p, v in _flat(frozen) if v]
    assert marked and all(p.endswith("['hash_w']") for p in marked)
    assert len(marked) == sum(1 for lp in tp["layers"] if "attn" in lp)


def _box(tree, axes):
    from repro_torch.models import param as tpm
    if isinstance(tree, dict):
        return {k: _box(v, axes[k]) for k, v in tree.items()}
    return tpm.Boxed(tree, axes)
