"""The sharded prefill and serve steps (``runtime/steps.py`` with
``param_shardings``/``cache_shardings``) on 4 gloo ranks, a (2, 2)
``("data", "model")`` mesh, held to one process's steps on the CPU.

Each rank holds its blocks of the parameters (``param_specs``) and
runs the sharded ``make_prefill_step`` on the whole prompt batch, then
two sharded ``make_serve_step`` calls on given tokens (the second with a
``(B,)`` position tensor).  Its rows of the batch are the rows of the
caches' batch axis (``data``), its cache blocks those of
``cache_specs``.  The cases (smoke configs, float32, one intra-op thread
a rank):

* ``seq``: llama31-8b with one KV head, which ``model`` (2) does not
  divide: the caches split over sequence on ``model``, gathered
  before a layer attends (``CacheBlocks.open``/``close``/``cut``);
* ``heads``: gemma-7b, whose two KV heads split over ``model``;
* ``cp``: the ``seq`` model with the dry run's ``"opt"`` lines
  (``decode_cp_axes=("model",)``, pooled selection): the
  context-parallel route attends each rank's block, its rows the step's
  (the second serve step, ragged, gathers the block and takes the
  global route, as one process does);
* ``hybrid``: jamba at one group, its Mamba states and MoE layers under
  the rows split.

The references are one process's unsharded steps on the same weights
and inputs; for ``cp`` one process on a (1, 1) mesh with the CP attend
replaced by ``context_parallel_socket_attend_ref`` over the 2 sequence
shards (``tests/test_torch_cp_model.py``'s reference).  Every rank's
logits (the whole batch's, gathered over ``data``) are held to the
reference's within 1e-5, and every cache leaf of every rank, after the
prefill and after the decode steps, to the reference's cache cut by
that rank's sharding (hash bits bitwise).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

BATCH, PLEN, CAP, DATA, MODEL = 4, 32, 40, 2, 2
WORLD = DATA * MODEL
CASES = ("seq", "heads", "cp", "hybrid")
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(case):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import kernel_route
    arch = {"heads": "gemma-7b", "hybrid": "jamba-v0.1-52b"}.get(
        case, "llama31-8b")
    cfg = get_config(arch).smoke()
    if case in ("seq", "cp"):
        cfg = cfg.replace(num_kv_heads=1)
    if case == "hybrid":
        cfg = cfg.replace(num_groups=1)
    if case == "cp":
        # launch/dryrun.py's "opt" lines for a decode cell whose KV heads
        # model does not divide
        cfg = cfg.replace(decode_cp_axes=("model",),
                          socket=dataclasses.replace(cfg.socket,
                                                     selection="pooled"))
    return kernel_route(cfg)


def _specs(cfg, mesh):
    from repro_torch.launch import specs as sp
    shape = sp.ShapeSpec("mesh", "decode", CAP, BATCH)
    rules = sp.arch_rules(cfg, shape, mesh)
    _, psh = sp.param_specs(cfg, mesh, rules)
    _, csh = sp.cache_specs(cfg, shape, mesh, rules)
    return rules, psh, csh


def _inputs(cfg):
    gen = np.random.default_rng(0)
    return (torch.from_numpy(gen.integers(0, cfg.vocab_size, (BATCH, PLEN))),
            torch.from_numpy(gen.integers(0, cfg.vocab_size, (BATCH, 2))))


def _positions():
    return (PLEN, torch.full((BATCH,), PLEN + 1))


def _copy(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def _run(prefill, serve, params, cfg):
    """The prefill and the two serve steps: (logits, caches after
    prefill, caches after decode)."""
    prompt, toks = _inputs(cfg)
    logits, caches = prefill(params, {"tokens": prompt})
    pre = _copy(caches)
    logs = [logits[:, -1]]
    for t, pos in enumerate(_positions()):
        logits, caches = serve(params, caches, toks[:, t:t + 1], pos)
        logs.append(logits[:, -1])
    return torch.stack(logs), pre, caches


def _rank(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.runtime import steps
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    mesh = make_test_mesh(DATA, MODEL)
    out = {}
    for case in CASES:
        cfg = _cfg(case)
        rules, psh, csh = _specs(cfg, mesh)
        params = fsdp.shard_tree(torch.load(os.path.join(tmp, f"{case}.pt")),
                                 fsdp.flat_tree(psh))
        out[case] = _run(
            steps.make_prefill_step(cfg, CAP, param_shardings=psh,
                                    cache_shardings=csh, rules=rules),
            steps.make_serve_step(cfg, psh, csh, rules), params, cfg)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _reference(case, params):
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import steps
    cfg = _cfg(case)
    if case != "cp":
        return _run(steps.make_prefill_step(cfg, CAP),
                    steps.make_serve_step(cfg), params, cfg)
    cfg = cfg.replace(decode_cp_batch_axes=())
    ref = cp.context_parallel_socket_attend_ref

    def plain(cfg, mesh, seq_axes, *a, batch_axes=(), **kw):
        return ref(cfg, MODEL, *a, **kw)

    with activate_mesh(Mesh(("data", "model"), (1, 1))), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(cp, "context_parallel_socket_attend", plain)
        return _run(steps.make_prefill_step(cfg, CAP),
                    steps.make_serve_step(cfg), params, cfg)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Each case's reference and the 4 ranks' results."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as tfm
    tmp = str(tmp_path_factory.mktemp("sharded_steps"))
    params = {case: tfm.init_model(_cfg(case), 0) for case in CASES}
    for case, p in params.items():
        torch.save(p, os.path.join(tmp, f"{case}.pt"))
    spawn_ranks(_rank, WORLD, (WORLD, tmp), deadline_s=240)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(WORLD)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {case: _reference(case, params[case]) for case in CASES}
    finally:
        torch.set_num_threads(n)
    return refs, ranks


@pytest.mark.parametrize("case", CASES)
def test_sharded_logits_equal_one_process(ranked, case):
    refs, ranks = ranked
    for r, got in enumerate(ranks):
        torch.testing.assert_close(got[case][0], refs[case][0], **TOL,
                                   msg=lambda m: f"rank {r}: {m}")


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_cache_blocks(ranked, case):
    """After the prefill and after the decode steps, each rank's leaves
    are its blocks (``NamedSharding.shard``) of the reference's; the
    sequence-split and head-split layouts both occur, and blocks differ
    from the whole leaf."""
    from repro_torch.launch.mesh import Mesh
    refs, ranks = ranked
    cfg = _cfg(case)
    split = set()
    for r, got in enumerate(ranks):
        _, _, csh = _specs(cfg, Mesh(("data", "model"), (DATA, MODEL),
                                     rank=r))
        for phase in (1, 2):
            for i, (have, whole) in enumerate(zip(got[case][phase],
                                                  refs[case][phase])):
                assert set(have) == set(whole), (r, i)
                for name, leaf in have.items():
                    sh = csh[i][name]
                    want = sh.shard(whole[name])
                    assert leaf.shape == want.shape, (r, i, name)
                    if leaf.shape != whole[name].shape:
                        split.add(tuple(d for d, (a, b) in enumerate(
                            zip(leaf.shape, whole[name].shape)) if a != b))
                    where = f"rank {r}, phase {phase}, layer {i}, {name}"
                    if leaf.dtype in (torch.int32, torch.uint8):
                        assert torch.equal(leaf, want), where
                    else:
                        torch.testing.assert_close(
                            leaf, want, **TOL, msg=lambda m: f"{where}: {m}")
    # every case splits the batch dim; the attention layouts split
    # sequence (dim 2) or KV heads (dim 1) as well
    assert (0,) in split or (0, 2) in split or (0, 1) in split, split
    want_dim = {"seq": 2, "cp": 2, "heads": 1}.get(case)
    if want_dim is not None:
        assert any(want_dim in dims for dims in split), split
