"""The port's dry run (``launch/dryrun.py``) and what it needs, held to
the JAX package on the CPU.

* **Specs on the production mesh.** ``arch_rules``,
  ``decode_input_specs`` and ``cache_specs`` (shapes, dtypes, spec
  entries) and each call's fallback log equal JAX's on ``AbstractMesh``
  (16, 16), shape-only on both sides, for every registered architecture
  at ``decode_32k`` and ``long_500k``.  JAX's caches are stacked layer
  groups; a port layer's leaf is the group leaf without its leading
  ``groups`` entry and dim, and JAX's ``uint32`` SOCKET bit words are
  the port's ``int32`` (the same bit pattern).  The fallback logs are
  compared with their dim numbers dropped (JAX's count the groups axis).
* ``input_specs`` gives JAX's ``tests/test_roofline.py::
  test_input_specs_api`` cases (``meta`` tensors where JAX gives
  ``ShapeDtypeStruct``); ``decode_cache_axes`` and
  ``model_flops_per_token`` equal JAX's for every architecture.
* ``make_production_mesh`` has JAX's shapes, axes and row-major rank
  order (``jax.make_mesh`` on 512 host devices in one subprocess).
* ``build_cell`` on fake tensors: a SOCKET decode cell (llama31-8b's
  smoke config at ``decode_32k``), a prefill cell (gemma3-27b's smoke,
  its local layers windowed, at ``prefill_32k``) and a train cell
  (llama31-8b's smoke at ``train_4k``), each on the 16 x 16 mesh; every
  record has JAX's keys (``compile_s`` as ``trace_s``, with
  ``model_flops`` and ``kernel_calls``), the kernel operators are
  called layers times, and no library is built.  The CLI writes
  llama31-8b's full ``decode_32k`` record the same way.
* The sharded prefill and serve steps on a one-rank mesh equal the
  single-process steps bit for bit (logits and every cache leaf;
  llama31-8b, jamba's Mamba and MoE layers, gemma3's rings).
* On the dry-run route a dense smoke config's counted train FLOPs on a
  (4, 1) mesh are a quarter of (1, 1)'s, and (2, 2)'s equal (2, 1)'s:
  the ``model`` axis shards storage, not compute.
* The counted forward FLOPs of ``forward_train`` equal the products'
  count written out from the config (2 x the projection and head
  weights a token, 4 x hd a kept (query, key) pair), and lie at 0.5 to
  1.0 x ``model_flops_per_token`` x tokens: that count includes the
  embedding table, which a lookup reads without products, and its
  attention term is twice the forward's products.
"""

import re

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices

ARCHS = ["llama31-8b", "stablelm-12b", "gemma3-27b", "minitron-8b",
         "gemma-7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b", "mamba2-780m", "musicgen-medium",
         "internvl2-26b"]
JAX_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "params_b",
                   "opt_state_bits", "grad_accum", "compile_s",
                   "memory_analysis", "hbm_per_device_gb",
                   "collective_bytes", "roofline", "sharding_fallbacks"}
PORT_RECORD_KEYS = JAX_RECORD_KEYS - {"compile_s"} | {
    "trace_s", "model_flops", "kernel_calls"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_build(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("the dry run built a kernel library")
    monkeypatch.setattr(build, "load_library", refuse)


def _dtype_name(dt) -> str:
    name = str(dt).replace("torch.", "")
    return "int32" if name == "uint32" else name


def _jax_layers(cfg, tree, fn):
    """JAX's stacked-group cache tree as the port's per-layer list, each
    leaf through ``fn(leaf, stacked)``."""
    import jax

    def one(t, stacked):
        return jax.tree_util.tree_map(
            lambda x: fn(x, stacked), t,
            is_leaf=lambda x: isinstance(x, tuple) or hasattr(x, "spec"))
    layers = [one(tree["groups"][f"slot_{i}"], True)
              for _ in range(cfg.num_groups)
              for i in range(len(cfg.pattern))]
    layers += [one(tree["remainder"][f"slot_{i}"], False)
               for i in range(len(cfg.remainder))]
    return layers


def _names(log):
    return sorted({re.sub(r"dim \d+ ", "", x) for x in log})


def _both(arch, shape_name):
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.launch import specs as jsp
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import specs as tsp
    from repro_torch.launch.mesh import make_production_mesh
    am = AbstractMesh((16, 16), ("data", "model"))
    tm = make_production_mesh()
    jc = jsp.dryrun_model_config(jget(arch), jsp.SHAPES[shape_name])
    tc = tsp.dryrun_model_config(tget(arch), tsp.SHAPES[shape_name])
    return (jsp, jc, am, jsp.SHAPES[shape_name]), \
        (tsp, tc, tm, tsp.SHAPES[shape_name])


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_specs_match_jax(arch, shape_name):
    (jsp, jc, am, js), (tsp, tc, tm, ts) = _both(arch, shape_name)
    jrules, trules = jsp.arch_rules(jc, js, am), tsp.arch_rules(tc, ts, tm)
    assert trules == jrules
    jlog, tlog = [], []
    jsds, jsh = jsp.cache_specs(jc, js, am, jrules, jlog)
    tsds, tsh = tsp.cache_specs(tc, ts, tm, trules, tlog)

    jshapes = _jax_layers(jc, jsds, lambda x, st: (
        tuple(x.shape[1:] if st else x.shape), _dtype_name(x.dtype)))
    jspecs = _jax_layers(jc, jsh, lambda x, st: tuple(x.spec)[1:] if st
                         else tuple(x.spec))
    assert [{k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in c.items()}
            for c in tsds] == jshapes
    assert all(v.is_meta for c in tsds for v in c.values())
    assert [{k: v.spec for k, v in c.items()} for c in tsh] == jspecs
    jinp, jish = jsp.decode_input_specs(jc, js, am, jrules, jlog)
    tinp, tish = tsp.decode_input_specs(tc, ts, tm, trules, tlog)
    assert (tuple(tinp.shape), _dtype_name(tinp.dtype)) == \
        (tuple(jinp.shape), _dtype_name(jinp.dtype))
    assert tish.spec == tuple(jish.spec) and tinp.is_meta
    assert _names(tlog) == _names(jlog)


def test_input_specs_api():
    from repro_torch.launch.specs import input_specs

    s = input_specs("minitron-8b", "train_4k")
    assert set(s) == {"batch"}
    assert s["batch"]["tokens"].shape == (256, 4096)
    assert all(t.is_meta for t in s["batch"].values())
    s2 = input_specs("stablelm-12b", "decode_32k")
    assert set(s2) == {"caches", "inp", "pos"}
    assert s2["inp"].shape == (128, 1)
    leaves = [t for c in s2["caches"] for t in c.values()]
    assert any(t.dtype == torch.int32 for t in leaves)   # SOCKET bit cache
    assert all(t.is_meta for t in leaves) and s2["pos"].shape == ()
    s3 = input_specs("mamba2-780m", "long_500k")
    assert s3["inp"].shape == (1, 1)
    s4 = input_specs("llama31-8b", "prefill_32k")
    assert set(s4["batch"]) == {"tokens"}
    assert s4["batch"]["tokens"].shape == (32, 32768)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_model_flops_match_jax(arch):
    from repro.configs import get_config as jget
    from repro.models import transformer as jtfm
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as ttfm
    jc, tc = jget(arch), tget(arch)
    for long_context in (False, True):
        want = _jax_layers(jc, jtfm.decode_cache_axes(jc, long_context),
                           lambda ax, st: tuple(ax)[1:] if st
                           else tuple(ax))
        assert ttfm.decode_cache_axes(tc, long_context) == want
    for seq in (4096, 32768, 524288):
        for training in (True, False):
            assert ttfm.model_flops_per_token(tc, seq, training) == \
                pytest.approx(jtfm.model_flops_per_token(jc, seq, training),
                              rel=1e-12)


def test_production_mesh_matches_jax():
    from repro_torch.launch.mesh import make_production_mesh
    out = run_subprocess_devices("""
import jax, json
from repro.launch.mesh import make_production_mesh
res = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    res[str(mp)] = dict(shape=list(m.devices.shape), axes=list(m.axis_names),
                        ids=[d.id for d in m.devices.flat])
print(json.dumps(res))
""", devices=512)
    import json
    res = json.loads(out.strip().splitlines()[-1])
    for mp in (False, True):
        jm = res[str(mp)]
        for rank in (0, 1, 17, 255) + ((256, 300, 511) if mp else ()):
            tm = make_production_mesh(multi_pod=mp, rank=rank)
            assert tm.axis_names == tuple(jm["axes"])
            assert list(tm.shape.values()) == jm["shape"]
            # the device at row-major position ``rank`` of JAX's grid
            pos = jm["ids"].index(rank)
            assert tuple(tm.coords.values()) == tuple(
                int(c) for c in np.unravel_index(pos, jm["shape"]))
    with pytest.raises(RuntimeError, match="build_groups"):
        make_production_mesh().group(("data",))


@pytest.mark.parametrize("arch,shape_name,kernels", [
    ("llama31-8b", "decode_32k", {"socket_score": 2, "flash_decode": 2}),
    ("gemma3-27b", "prefill_32k", {"flash_prefill": 13}),
    ("llama31-8b", "train_4k", {"flash_prefill": 8}),
])
def test_build_cell_on_fake_tensors(arch, shape_name, kernels, no_build):
    from repro_torch.launch import dryrun
    counts, rec = dryrun.build_cell(arch, shape_name, smoke=True)
    assert set(rec) == PORT_RECORD_KEYS
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["kernel_calls"] == kernels
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0 and rec["hbm_per_device_gb"] > 0
    assert rec["collective_bytes"]["total"] == sum(
        v for k, v in rec["collective_bytes"].items() if k != "total") > 0
    assert rec["collective_bytes"]["all-gather"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["roofline"]["flops_per_device"] == counts["flops"] > 0


def test_cli_writes_the_full_size_record(tmp_path, no_build):
    import json

    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "llama31-8b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "llama31-8b__decode_32k__single.json")
                     .read_text())
    assert set(rec) == PORT_RECORD_KEYS | {"status", "wall_s"}
    assert rec["status"] == "ok" and rec["params_b"] > 8.0
    assert rec["kernel_calls"] == {"flash_decode": 32, "socket_score": 32}
    # the rank's 8 rows x 2048 of the 32768 cache rows, K and V in bf16
    kv = 32 * 2 * 8 * 8 * 2048 * 128 * 2
    assert kv < rec["memory_analysis"]["argument_size_in_bytes"] < 1.3 * kv


@pytest.mark.parametrize("arch", ["llama31-8b", "jamba-v0.1-52b",
                                  "gemma3-27b"])
def test_sharded_steps_on_one_rank_are_the_steps(arch):
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    cfg = get_config(arch).smoke()
    params = tfm.init_model(cfg, 0)
    mesh = Mesh(("data", "model"), (1, 1))
    shape = sp.ShapeSpec("one rank", "decode", 64, 2)
    rules = sp.arch_rules(cfg, shape, mesh)
    _, psh = sp.param_specs(cfg, mesh, rules)
    _, csh = sp.cache_specs(cfg, shape, mesh, rules)
    gen = np.random.default_rng(0)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, (2, 16)))
    plain = steps.make_prefill_step(cfg, 64)(params, {"tokens": toks})
    sharded = steps.make_prefill_step(
        cfg, 64, param_shardings=psh, cache_shardings=csh,
        rules=rules)(params, {"tokens": toks})

    def same(a, b):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1])
                   for k in x)
    same(plain, sharded)
    ca, cb = plain[1], sharded[1]
    inp = toks[:, -1:]
    for pos in (16, 17):
        a = steps.make_serve_step(cfg)(params, ca, inp, pos)
        b = steps.make_serve_step(cfg, psh, csh, rules)(params, cb, inp, pos)
        same(a, b)
        ca, cb = a[1], b[1]


def _train_flops(cfg, mesh_shape):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import steps
    mesh = Mesh(("data", "model"), mesh_shape, rank=0)
    ocfg = AdamWConfig()

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True):
        pv, psh = sp.param_specs(cfg, mesh, {})
        osd, osh = sp.opt_specs(ocfg, pv, psh, mesh, {})
        params = dryrun._blocks(pv, psh, zeros)
        opt = dryrun._blocks(osd, osh, zeros)
        batch = {k: torch.zeros((8, 32), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        step = steps.make_train_step(cfg, ocfg, 1, grad_shardings=psh)
        return dryrun.count_step(step, (params, opt, batch), mesh.size)


def test_model_axis_shards_storage_not_compute(no_build):
    from repro_torch.configs import get_config
    cfg = get_config("llama31-8b").smoke()
    counts = {s: _train_flops(cfg, s) for s in ((1, 1), (4, 1), (2, 1),
                                               (2, 2))}
    flops = {s: c["flops"] for s, c in counts.items()}
    assert flops[(4, 1)] * 4 == flops[(1, 1)] > 0
    assert flops[(2, 2)] == flops[(2, 1)] == flops[(1, 1)] // 2
    assert counts[(1, 1)]["collective_bytes"] == {"total": 0}
    assert counts[(2, 2)]["collective_bytes"]["reduce-scatter"] > 0


def test_counted_forward_flops(no_build):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    cfg = get_config("llama31-8b").smoke()
    b, s = 2, 32
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tfm.init_model(cfg, 0, device="meta")
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device="meta")}
        counts = dryrun.count_step(
            lambda p, x: tfm.forward_train(cfg, p, x), (params, batch), 1)
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    products = 2 * b * s * (cfg.num_layers * layer +
                            d * cfg.padded_vocab())
    attention = cfg.num_layers * 4 * hd * b * h * s * (s + 1) // 2
    assert counts["flops"] == products + attention
    assert counts["kernel_calls"] == {"flash_prefill": cfg.num_layers}
    model = tfm.model_flops_per_token(cfg, s, training=False) * b * s
    assert 0.5 <= counts["flops"] / model <= 1.0
