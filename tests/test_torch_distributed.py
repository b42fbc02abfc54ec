"""The port's sharding rules, mesh and context-parallel SOCKET decode,
held to the JAX package's ``repro.distributed`` on the CPU.

* ``logical_to_spec`` / ``spec_for_shape`` equal JAX's entry for entry,
  fallback log included, on meshes of the axis sizes the test gives (the
  rule logic reads only ``mesh.shape``).
* ``context_parallel_socket_attend`` on 4 gloo ranks (one process a rank,
  one intra-op thread each) against JAX's on 4 host devices (one
  subprocess for every case): each rank's selection equals the JAX
  shard's (``jax.lax.top_k``'s indices, captured) index for index, and
  the merged output is within ``TOL`` of JAX's.  Cases: kvhead, pooled
  and qhead selection on ``("data",)``; ``("data", "model")`` on 2x2 in
  both axis orders; ``batch_axes``; shards with no valid row; the
  ``k_local > n_l`` error on both sides.
* ``context_parallel_socket_attend_ref`` (one process, shards looped,
  closed-form merge) equals the gloo route within ``TOL``, on the plain
  scores and on ``socket_score``'s plain version.
* The ragged-length fallback warns once and is bit-equal to the global
  route at world 1 and world 2, and gathers over batch and sequence
  axes at world 4.
* A rank that raises fails the spawn within seconds.

Inputs come from numpy with a seed; the hash bits and value norms from
JAX's ``precompute_key_hashes``.  ``TOL``: float32 sums in other orders
(einsum, gloo's reduction order) over values of order 1.
"""

import math
import os
import time
import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_subprocess_devices

TOL = dict(rtol=1e-5, atol=1e-6)
SOCKET = dict(num_planes=8, num_tables=24, tau=0.4, sparsity=4.0,
              sink_tokens=8, window_tokens=8, min_k=16)
D, KVH, G = 32, 2, 2
# name -> mesh (data, model), seq axes, batch axes, selection, batch,
# cache rows, global length, min_k, socket_score's plain version
CASES = {
    "kvhead": ((4, 1), ("data",), (), "kvhead", 1, 512, 480, 16, False),
    "pooled": ((4, 1), ("data",), (), "pooled", 1, 512, 480, 16, False),
    "qhead": ((4, 1), ("data",), (), "qhead", 1, 512, 470, 16, False),
    "2x2": ((2, 2), ("data", "model"), (), "kvhead", 1, 512, 500, 16,
            False),
    "2x2-model-first": ((2, 2), ("model", "data"), (), "pooled", 1, 512,
                        500, 16, False),
    "batch-axes": ((2, 2), ("model",), ("data",), "kvhead", 2, 512, 250,
                   16, False),
    "empty-shards": ((4, 1), ("data",), (), "kvhead", 1, 512, 200, 16,
                     False),
    "k-local-error": ((4, 1), ("data",), (), "kvhead", 1, 64, 60, 20,
                      False),
    "score-kernel": ((4, 1), ("data",), (), "kvhead", 1, 512, 480, 16,
                     True),
}
WORLD = 4


def _case(name):
    mesh, seq, batch, sel, b, n, length, min_k, kernel = CASES[name]
    return types.SimpleNamespace(mesh=mesh, seq=seq, batch=batch, sel=sel,
                                 b=b, n=n, length=length, min_k=min_k,
                                 kernel=kernel)


def _scfg(c):
    from repro_torch.core import socket as sk
    return sk.SocketConfig(**{**SOCKET, "min_k": c.min_k},
                           selection=c.sel)


def _inputs(path):
    """Every case's inputs: numpy draws, JAX's hash bits and norms."""
    import jax.numpy as jnp
    from repro.core import socket as jsk
    out = {}
    for i, name in enumerate(CASES):
        c = _case(name)
        rng = np.random.default_rng(100 + i)
        keys = rng.normal(size=(c.b, KVH, c.n, D)).astype(np.float32)
        vals = rng.normal(size=(c.b, KVH, c.n, D)).astype(np.float32)
        w = rng.normal(size=(SOCKET["num_tables"], SOCKET["num_planes"],
                             D)).astype(np.float32)
        hot = min(c.length - 1, 300)
        q = (2.0 * keys[:, :, hot][:, :, None, None, :] + 0.1 * rng.normal(
            size=(c.b, KVH, G, 1, D))).astype(np.float32)
        side = jsk.precompute_key_hashes(
            jsk.SocketConfig(**{**SOCKET, "min_k": c.min_k},
                             selection=c.sel), jnp.asarray(w),
            jnp.asarray(keys), jnp.asarray(vals))
        out.update({f"{name}/keys": keys, f"{name}/vals": vals,
                    f"{name}/w": w, f"{name}/q": q,
                    f"{name}/bits": np.asarray(side.bits),
                    f"{name}/vnorm": np.asarray(
                        side.vnorm.astype(jnp.float32))})
    np.savez(path, **out)
    return out


_JAX_CASES = r"""
import numpy as np
import jax, jax.numpy as jnp
from repro.core import socket
from repro.distributed import context_parallel as jcp
from repro.launch.mesh import make_test_mesh

CASES, SOCKET, inp_path, out_path = ARGS
inp = np.load(inp_path)
res = {}
top_k = jax.lax.top_k
captured = []

def spy(x, k):
    v, i = top_k(x, k)
    captured.append(i)
    return v, i

def shard_selection(cfg, w, q, k, v, bits, vnorm, lo, length, k_local,
                    scale):
    # the indices _local_attend's top_k picks, as an output of the jit
    jax.lax.top_k = spy
    try:
        jcp._local_attend(cfg, w, q, k, v, bits, vnorm, lo, length,
                          k_local, scale)
    finally:
        jax.lax.top_k = top_k
    return captured.pop()

for name, (mesh_shape, seq, batch, sel, b, n, length, min_k) in \
        CASES.items():
    cfg = socket.SocketConfig(**{**SOCKET, "min_k": min_k}, selection=sel)
    mesh = make_test_mesh(*mesh_shape)
    a = {k: jnp.asarray(inp[f"{name}/{k}"]) for k in
         ("w", "q", "keys", "vals", "bits", "vnorm")}
    scale = 1 / np.sqrt(a["q"].shape[-1])
    attend = jax.jit(lambda *x: jcp.context_parallel_socket_attend(
        cfg, mesh, seq, *x, length=length, scale=scale, batch_axes=batch))
    try:
        res[f"{name}/out"] = np.asarray(attend(*a.values()))
    except Exception as e:          # the k_local > n_l edge
        res[f"{name}/error"] = np.asarray(type(e).__name__)
        continue
    shards = int(np.prod([mesh.shape[x] for x in seq]))
    n_l = n // shards
    k_local = max(cfg.min_k, -(-socket.topk_budget(cfg, n) // shards))
    select = jax.jit(lambda w, q, *x: shard_selection(
        cfg, w, q, *x, length, k_local, scale))
    for s in range(shards):
        rows = slice(s * n_l, (s + 1) * n_l)
        res[f"{name}/idx{s}"] = np.asarray(select(
            a["w"], a["q"], *(a[k][:, :, rows] for k in
                              ("keys", "vals", "bits", "vnorm")),
            jnp.int32(s * n_l)))
mesh = make_test_mesh(2, 2)
res["mesh22/devices"] = np.vectorize(lambda d: d.id)(mesh.devices)
np.savez(out_path, **res)
print("OK")
"""


def _cp_rank(rank, world, tmp):
    """One gloo rank: every case's attend, selection and mesh layout."""
    torch.set_num_threads(1)
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    meshes = {(4, 1): make_test_mesh(4, 1), (2, 2): make_test_mesh(2, 2)}
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    res = {}
    for name in CASES:
        c = _case(name)
        mesh, cfg = meshes[c.mesh], _scfg(c)
        a = {k: torch.from_numpy(inp[f"{name}/{k}"].copy()) for k in
             ("keys", "vals", "w", "q", "bits", "vnorm")}
        a["bits"] = a["bits"].view(torch.int32)
        shards, si = mesh.extent(c.seq), mesh.index(c.seq)
        bl = c.b // mesh.extent(c.batch)
        b0 = mesh.index(c.batch) * bl
        n_l = c.n // shards

        def block(x):
            return x[b0:b0 + bl, :, si * n_l:(si + 1) * n_l]

        scale = 1 / math.sqrt(D)
        try:
            out = cp.context_parallel_socket_attend(
                cfg, mesh, c.seq, a["w"], a["q"], block(a["keys"]),
                block(a["vals"]), block(a["bits"]), block(a["vnorm"]),
                length=c.length, scale=scale, batch_axes=c.batch,
                use_score_kernel=c.kernel)
        except ValueError as e:
            res[name] = {"error": str(e)}
            continue
        scores = cp.local_scores(cfg, a["w"], a["q"][b0:b0 + bl],
                                 block(a["bits"]),
                                 use_score_kernel=c.kernel)
        idx, mask = cp.local_select(
            cfg, scores, block(a["vnorm"]), cp.shard_lo(mesh, c.seq, n_l),
            c.length, cp.local_budget(cfg, c.n, shards))
        res[name] = {"out": out, "idx": idx, "mask": mask, "seq_index": si,
                     "b0": b0, "bl": bl}
    m = meshes[(2, 2)]
    res["mesh22"] = {"coords": m.coords, "members": {
        axes: m.members(axes) for axes in
        (("data",), ("model",), ("data", "model"), ("model", "data"))}}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, JAX's results on 4 host devices and the 4 gloo ranks'
    results (each run once for every case)."""
    from repro_torch.launch.mesh import spawn_ranks
    tmp = str(tmp_path_factory.mktemp("cp"))
    inp = _inputs(os.path.join(tmp, "inputs.npz"))
    spawn_ranks(_cp_rank, WORLD, (WORLD, tmp), deadline_s=240)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    jax_cases = {k: v[:-1] for k, v in CASES.items() if not v[-1]}
    args = (jax_cases, SOCKET, os.path.join(tmp, "inputs.npz"),
            os.path.join(tmp, "jax.npz"))
    run_subprocess_devices(_JAX_CASES.replace("= ARGS", "= " + repr(args)),
                           devices=WORLD, timeout=240)
    jres = dict(np.load(os.path.join(tmp, "jax.npz")))
    return inp, jres, ranks


# ------------------------------------------------------------ sharding

def _jax_spec(axes, shape, sizes, rules):
    from repro.distributed.sharding import logical_to_spec
    log = []
    spec = logical_to_spec(axes, shape, types.SimpleNamespace(shape=sizes),
                           rules, log)
    return tuple(spec), log


SPEC_MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 4}, {"model": 8}, {"data": 2, "model": 2}]
SPEC_AXES = [
    (("batch", "seq", "embed"), (32, 4096, 4096)),
    (("embed_w", "heads", "head_dim"), (4096, 24, 128)),   # 24 % 16
    (("vocab", "embed_w"), (128256, 4096)),
    (("cache_batch", "cache_heads", "cache_seq", None), (1, 8, 524288, 128)),
    (("cache_batch", "cache_heads", "cache_seq_cp", None),
     (1, 8, 524288, 128)),
    (("experts", "embed_w", "expert_mlp"), (8, 6144, 16384)),
    (("moe_capacity", None, "mlp"), (33, 8, 14336)),
]
SPEC_RULES = [None, {"cache_seq": ("data", "model"), "batch": None},
              {"heads": ("data", "model"), "act_seq": ("model",)}]


@pytest.mark.parametrize("rules", SPEC_RULES, ids=["default", "cp", "tp"])
@pytest.mark.parametrize("sizes", SPEC_MESHES,
                         ids=["16x16", "pod", "data4", "model8", "2x2"])
def test_logical_to_spec_matches_jax(sizes, rules):
    from repro_torch.distributed import sharding as shd
    mesh = types.SimpleNamespace(shape=sizes)
    for axes, shape in SPEC_AXES:
        log = []
        spec = shd.logical_to_spec(axes, shape, mesh, rules, log)
        assert (spec, log) == _jax_spec(axes, shape, sizes, rules), axes
        if rules is None:
            assert shd.spec_for_shape(mesh, axes, shape) == spec


def test_default_rules_and_errors_match_jax():
    from repro.distributed import sharding as jshd
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as tmesh
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    mesh = types.SimpleNamespace(shape={"model": 1})
    with pytest.raises(KeyError):
        shd.logical_to_spec(("not_an_axis",), (8,), mesh)
    x = torch.ones(4, 4)
    assert shd.lsc(x, "batch", "embed") is x and shd.current_mesh() is None
    m = tmesh.Mesh(("data", "model"), (2, 2))
    with shd.activate_mesh(m, rules={"embed": ("model",)}) as ctx:
        assert shd.current_mesh() is m and ctx.rules["embed"] == ("model",)
        assert shd.lsc(torch.ones(3, 4), "embed", "mlp") is not None
        assert shd.fallback_log() == [
            "replicated dim 0 (embed=3) — not divisible by mesh axes "
            "('model',) (size 2)"]
        with pytest.raises(ValueError):
            shd.lsc(x, "batch")
    assert shd.current_mesh() is None and shd.fallback_log() == []
    # the production mesh is built (the dry run's); its groups are not,
    # and outside the collectives' dry-run route asking for one raises
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="build_groups"):
        prod.group(("data",))


# ---------------------------------------------------- the CP attend

@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in ("k-local-error",
                                               "score-kernel")])
def test_cp_attend_matches_jax(runs, name):
    """Each rank's selection is JAX's shard's, index for index; the merged
    output is JAX's within TOL on every rank."""
    _, jres, ranks = runs
    for r in ranks:
        got = r[name]
        rows = slice(got["b0"], got["b0"] + got["bl"])
        jidx = jres[f"{name}/idx{got['seq_index']}"][rows]
        np.testing.assert_array_equal(got["idx"].numpy(), jidx)
        np.testing.assert_allclose(got["out"].numpy(),
                                   jres[f"{name}/out"], **TOL)
    if name == "empty-shards":          # rows 256.. hold no valid row
        assert not any(r[name]["mask"].any() for r in ranks
                       if r[name]["seq_index"] >= 2)


def test_k_local_over_shard_rows_raises_on_both_sides(runs):
    _, jres, ranks = runs
    assert "k-local-error/error" in jres and \
        "k-local-error/out" not in jres
    for r in ranks:
        assert "k_local 20 exceeds the shard's 16 rows" in \
            r["k-local-error"]["error"]


@pytest.mark.parametrize("name", [n for n in CASES if n != "k-local-error"])
def test_cp_ref_equals_gloo_route(runs, name):
    """The plain single-process version over the whole cache equals every
    rank's merged output."""
    from repro_torch.distributed import context_parallel as cp
    inp, _, ranks = runs
    c = _case(name)
    a = {k: torch.from_numpy(inp[f"{name}/{k}"].copy()) for k in
         ("keys", "vals", "w", "q", "bits", "vnorm")}
    shards = math.prod(dict(zip(("data", "model"), c.mesh))[x]
                       for x in c.seq)
    ref = cp.context_parallel_socket_attend_ref(
        _scfg(c), shards, a["w"], a["q"], a["keys"], a["vals"],
        a["bits"].view(torch.int32), a["vnorm"], length=c.length,
        scale=1 / math.sqrt(D), use_score_kernel=c.kernel)
    for r in ranks:
        torch.testing.assert_close(r[name]["out"], ref, **TOL)


def test_mesh_layout_matches_jax_devices(runs):
    """Rank r sits where JAX's ``make_test_mesh(2, 2)`` puts device r;
    each group lists its ranks in index order."""
    _, jres, ranks = runs
    devices = jres["mesh22/devices"]
    for rank, r in enumerate(ranks):
        m = r["mesh22"]
        assert devices[m["coords"]["data"], m["coords"]["model"]] == rank
        d, mo = m["coords"]["data"], m["coords"]["model"]
        assert m["members"][("data",)] == [2 * i + mo for i in range(2)]
        assert m["members"][("model",)] == [2 * d + j for j in range(2)]
        assert m["members"][("data", "model")] == [0, 1, 2, 3]
        assert m["members"][("model", "data")] == [0, 2, 1, 3]


# ------------------------------------------------------- ragged fallback

def _ragged_setup(tmp):
    """A smoke llama layer's hash planes, a filled whole cache (batch 2,
    64 rows) and a query; the global route's ragged output."""
    from repro_torch.configs import get_config
    from repro_torch.models import backends as bk
    cfg = get_config("llama31-8b").smoke()
    be = bk.get_backend("socket")
    gen = torch.Generator().manual_seed(0)
    hd, kv = cfg.head_dim, cfg.num_kv_heads
    params = {"hash_w": torch.randn(cfg.socket.num_tables,
                                    cfg.socket.num_planes, hd,
                                    generator=gen)}
    keys = torch.randn(2, kv, 64, hd, generator=gen)
    vals = torch.randn(2, kv, 64, hd, generator=gen)
    cache = be.prefill_build(cfg, params,
                             be.init_cache(cfg, 2, kv, 64, torch.float32,
                                           "cpu"), keys, vals)
    q = torch.randn(2, kv, cfg.gqa_groups, 1, hd, generator=gen)
    lengths = torch.tensor([13, 29])
    plain = be.attend(cfg, params, q, bk.ContiguousView(dict(cache),
                                                        be.cache_spec(cfg)),
                      length=lengths, scale=0.125)
    torch.save({"params": params, "cache": cache, "q": q}, tmp)
    return cfg, be, params, cache, q, lengths, plain


def _ragged_attend(cfg, be, params, cache, q, mesh, seq, batch):
    """This rank's block of the cache, attended twice at the ragged
    lengths under ``mesh``; returns (outputs, warnings of each call)."""
    import repro_torch.serving.obs as obs
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import backends as bk
    cfg = cfg.replace(decode_cp_axes=seq, decode_cp_batch_axes=batch)
    n_l = 64 // mesh.extent(seq)
    si, bl = mesh.index(seq), 2 // mesh.extent(batch)
    b0 = mesh.index(batch) * bl
    block = {k: v[b0:b0 + bl, :, si * n_l:(si + 1) * n_l].clone()
             for k, v in cache.items()}
    obs._WARNED.discard("socket-ragged-cp-fallback")
    outs, warned = [], []
    with shd.activate_mesh(mesh):
        for _ in range(2):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                view = bk.ContiguousView(block, be.cache_spec(cfg))
                outs.append(be.attend(cfg, params, q, view,
                                      length=torch.tensor([13, 29]),
                                      scale=0.125))
            warned.append(sum("ragged decode" in str(x.message) for x in w))
    return outs, warned


def _ragged_rank(rank, world, tmp, data, model, seq, batch):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    from repro_torch.configs import get_config
    from repro_torch.models import backends as bk
    st = torch.load(os.path.join(tmp, "setup.pt"))
    outs, warned = _ragged_attend(
        get_config("llama31-8b").smoke(), bk.get_backend("socket"),
        st["params"], st["cache"], st["q"], make_test_mesh(data, model),
        seq, batch)
    torch.save({"outs": outs, "warned": warned},
               os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_ragged_fallback_world1(tmp_path):
    """World 1: the warning once, the output bit-equal to the global
    route's."""
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    cfg, be, params, cache, q, _, plain = _ragged_setup(
        str(tmp_path / "setup.pt"))
    init_rank(0, 1, f"file://{tmp_path}/init", device="cpu")
    try:
        outs, warned = _ragged_attend(cfg, be, params, cache, q,
                                      make_test_mesh(1, 1), ("data",), ())
    finally:
        dist.destroy_process_group()
    assert warned == [1, 0]
    for out in outs:
        assert torch.equal(out, plain)


@pytest.mark.parametrize("layout", ["world2", "world4-batch"])
def test_ragged_fallback_gathers_the_ranks_blocks(tmp_path, layout):
    """World 2 (sequence over data) and world 4 (sequence over model,
    batch over data): each rank's output equals the global route's bit
    for bit, and warns once."""
    from repro_torch.launch.mesh import spawn_ranks
    *_, plain = _ragged_setup(str(tmp_path / "setup.pt"))
    world, args = {"world2": (2, (2, 1, ("data",), ())),
                   "world4-batch": (4, (2, 2, ("model",), ("data",)))
                   }[layout]
    spawn_ranks(_ragged_rank, world, (world, str(tmp_path), *args),
                deadline_s=120)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["warned"] == [1, 0]
        for out in got["outs"]:
            assert torch.equal(out, plain)


# ------------------------------------------------------------ no hangs

def _dying_rank(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_rank
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    if rank == 1:
        raise RuntimeError("rank 1 fails before the collective")
    dist.all_reduce(torch.ones(1))          # rank 0 waits for rank 1


def test_a_rank_that_raises_fails_the_run_in_seconds(tmp_path):
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(_dying_rank, 2, (2, str(tmp_path)), deadline_s=60)
    assert time.monotonic() - t0 < 30


def test_backend_goes_by_the_device_count():
    from repro_torch.launch.mesh import collective_backend
    assert collective_backend(4, "cpu") == "gloo"
    want = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    assert collective_backend(4, "cuda") == want
