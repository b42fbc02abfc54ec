"""Context-parallel decode through the port's model, held to the JAX
package on the CPU.

* ``run_serve``'s greedy tokens from a ``llama31-8b`` smoke model on 4
  gloo ranks (``decode_cp_axes=("data",)``, one process a rank, one
  intra-op thread each, every rank holding 16 of the 64 cache rows)
  equal JAX's ``run_serve`` under ``activate_mesh`` on 4 host devices,
  with the same weights through ``from_jax_params``; and equal one
  process on a 1x1 mesh holding the whole cache, its CP attend replaced by
  ``context_parallel_socket_attend_ref`` over ``WORLD`` shards.
* Each rank's prefill cache is its block of the single-process cache:
  K/V and value norms equal, hash bits bitwise; the decode steps wrote
  their rows on the rank that owns them only (layer 0's equal to the
  single-process decode's).
* Hybrid SOCKET models (``gemma3-27b``'s local:global layers,
  ``jamba-v0.1-52b``'s attention, Mamba and MoE layers, the all-Mamba
  ``mamba2-780m``; their smoke configs at one group) decode under the
  same mesh: prefill and greedy decode on the 4 ranks against JAX's
  jitted ``make_prefill_step``/``make_serve_step`` under the mesh, greedy
  tokens equal and every step's logits within ``LOGITS_ATOL``; each rank
  holds its block of the global layers' caches and the whole rings and
  Mamba states, those bitwise equal on every rank.
* The ``dense``, ``hard_lsh`` and ``quest`` backends decode
  ``llama31-8b``'s smoke model under the same mesh: prefill, ``STEPS``
  greedy steps and one step at a ragged ``(B,)`` position on the 4 ranks
  against JAX's jitted ``make_prefill_step``/``make_serve_step`` under
  the mesh (where XLA's partitioner gives the global route's result),
  greedy tokens equal and every step's logits within ``LOGITS_ATOL``;
  each rank's prefill cache is its block of one process's (Quest's page
  bounds bitwise), and the decode steps wrote K/V and Quest's bounds on
  the rank that owns the row only, as one process writes them.
* Under an active CP mesh no backend raises (the in-process mesh allots
  each global layer its block), and the continuous engine refuses
  ``decode_cp_axes`` with the JAX engine's message.

The JAX side runs with the kernel flags on, as ``test_torch_model.py``
does; its CP route scores in plain XLA, and the port's through
``socket_score``'s plain version on CPU tensors.  Its mesh is
``repro.launch.mesh.make_test_mesh``'s with ``AxisType.Auto`` axes: this
JAX's ``make_mesh`` makes Explicit axes, on which the JAX package's
``lsc`` (``with_sharding_constraint``) raises.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import SRC

ARCH, BATCH, PLEN, STEPS, WORLD = "llama31-8b", 2, 60, 4, 4
CAP = PLEN + STEPS
HYBRIDS = ("gemma3-27b", "jamba-v0.1-52b", "mamba2-780m")
BACKENDS = ("dense", "hard_lsh", "quest")
# the backends' last step: each request at its own position (its row's
# K/V rewritten there), a ragged length and, for hard LSH, budget
RAGGED = (CAP - 1, CAP - 3)
# chip_smoke.py's end-to-end logits bound (float32, other summation
# orders)
LOGITS_ATOL = 1e-4


def _tcfg(arch=ARCH, **kw):
    from repro_torch.configs import get_config
    cfg = get_config(arch).smoke()
    if arch != ARCH:
        kw = dict(num_groups=1, **kw)
    return cfg.replace(socket=dataclasses.replace(
        cfg.socket, use_score_kernel=True, use_flash_decode=True), **kw)


CP = dict(decode_cp_axes=("data",), decode_cp_batch_axes=())

_JAX_SERVE = r"""
import dataclasses
import jax
import numpy as np
from repro.configs import get_config
from repro.distributed.sharding import activate_mesh
from repro.launch.serve import run_serve

ARCH, PATH, BATCH, PLEN, STEPS, WORLD, HYBRIDS, BACKENDS, RAGGED = ARGS

jc = get_config(ARCH).smoke()
jc = jc.replace(socket=dataclasses.replace(
    jc.socket, use_score_kernel=True, use_flash_decode=True),
    decode_cp_axes=("data",), decode_cp_batch_axes=())
prompt = np.load(PATH + "/prompt.npy")
# launch.mesh.make_test_mesh's mesh with Auto axes (see the docstring)
mesh = jax.make_mesh((WORLD, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
with activate_mesh(mesh):
    toks, _, _ = run_serve(jc, BATCH, PLEN, STEPS, seed=0, prompt=prompt)
np.save(PATH + "/jax_tokens.npy", np.asarray(toks))

import jax.numpy as jnp
from repro.models import param as pm, transformer as tfm
from repro.runtime.steps import make_prefill_step, make_serve_step


def drive(hc, name, ragged):
    hc = hc.replace(socket=dataclasses.replace(
        hc.socket, use_score_kernel=True, use_flash_decode=True),
        decode_cp_axes=("data",), decode_cp_batch_axes=())
    params = pm.unbox(tfm.init_model(hc, jax.random.PRNGKey(0)))
    positions = [jnp.int32(PLEN + t) for t in range(STEPS)]
    if ragged:
        positions.append(jnp.asarray(RAGGED, jnp.int32))
    with activate_mesh(mesh):
        logits, caches = jax.jit(make_prefill_step(hc, PLEN + STEPS))(
            params, {"tokens": jnp.asarray(prompt)})
        serve = jax.jit(make_serve_step(hc))
        logs, toks = [logits[:, -1]], [jnp.argmax(logits[:, -1], -1)[:, None]]
        for pos in positions:
            logits, caches = serve(params, caches, toks[-1], pos)
            logs.append(logits[:, -1])
            toks.append(jnp.argmax(logits[:, -1], -1)[:, None])
    np.savez(PATH + f"/jax_{name}.npz", tokens=np.asarray(
        jnp.concatenate(toks, 1)), logits=np.asarray(jnp.stack(logs)))


for arch in HYBRIDS:
    drive(get_config(arch).smoke().replace(num_groups=1), arch, False)
for backend in BACKENDS:
    drive(get_config(ARCH).smoke().replace(attention_backend=backend),
          backend, True)
print("OK")
"""


def _serve_rank(rank, world, tmp):
    """One gloo rank: ``run_serve`` under the mesh, then its prefill
    caches and the caches after ``STEPS`` decode steps."""
    torch.set_num_threads(1)
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import transformer as tfm
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    params = torch.load(os.path.join(tmp, "params.pt"))
    prompt = torch.from_numpy(np.load(os.path.join(tmp, "prompt.npy")))
    cfg = _tcfg(**CP)
    with activate_mesh(make_test_mesh(world, 1)):
        toks, _, _ = run_serve(cfg, BATCH, PLEN, STEPS, prompt=prompt,
                               params=params, device="cpu")
        _, caches = tfm.prefill(cfg, params, {"tokens": prompt}, CAP)
        prefill = [{k: v.clone() for k, v in c.items()} for c in caches]
        for t in range(STEPS):
            tfm.decode_step(cfg, params, caches, toks[:, t:t + 1], PLEN + t)
    out = {"tokens": toks, "prefill": prefill, "decoded": caches}
    for arch in HYBRIDS:
        hc = _tcfg(arch, **CP)
        hp = torch.load(os.path.join(tmp, f"params_{arch}.pt"))
        with activate_mesh(make_test_mesh(world, 1)):
            out[arch] = _decode(hc, hp, prompt)
    for backend in BACKENDS:
        with activate_mesh(make_test_mesh(world, 1)):
            out[backend] = _decode(_tcfg(attention_backend=backend, **CP),
                                   params, prompt, ragged=True)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _positions(ragged):
    """The decode steps' positions: ``STEPS`` scalar ones, then (where
    ``ragged``) the ``(B,)`` position ``RAGGED``."""
    return [PLEN + t for t in range(STEPS)] + (
        [torch.tensor(RAGGED)] if ragged else [])


def _decode(cfg, params, prompt, ragged=False, teacher=None):
    """Prefill and the greedy steps of :func:`_positions` (``teacher``:
    step t feeds ``teacher[:, t]``): the tokens, each step's
    last-position logits, the prefill's caches and the caches after the
    steps."""
    from repro_torch.models import transformer as tfm
    logits, caches = tfm.prefill(cfg, params, {"tokens": prompt}, CAP)
    prefill = [{k: v.clone() for k, v in c.items()} for c in caches]
    logs = [logits[:, -1]]
    toks = [torch.argmax(logits[:, -1], -1)[:, None]]
    for t, pos in enumerate(_positions(ragged)):
        inp = toks[-1] if teacher is None else teacher[:, t:t + 1]
        logits, caches = tfm.decode_step(cfg, params, caches, inp, pos)
        logs.append(logits[:, -1])
        toks.append(torch.argmax(logits[:, -1], -1)[:, None])
    return {"tokens": torch.cat(toks, 1), "logits": torch.stack(logs),
            "prefill": prefill, "decoded": caches}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX's tokens on 4 host devices and the 4 gloo ranks' results."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import param as pm
    from repro.models import transformer as jtfm
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.weights import from_jax_params
    tmp = str(tmp_path_factory.mktemp("cp_model"))
    jparams = pm.unbox(jtfm.init_model(jget(ARCH).smoke(),
                                       jax.random.PRNGKey(0)))
    params = from_jax_params(_tcfg(),
                             jax.tree_util.tree_map(np.asarray, jparams))
    torch.save(params, os.path.join(tmp, "params.pt"))
    prompt = np.random.default_rng(0).integers(
        0, _tcfg().vocab_size, (BATCH, PLEN)).astype(np.int32)
    np.save(os.path.join(tmp, "prompt.npy"), prompt)
    for arch in HYBRIDS:
        hp = pm.unbox(jtfm.init_model(jget(arch).smoke().replace(
            num_groups=1), jax.random.PRNGKey(0)))
        torch.save(from_jax_params(_tcfg(arch), jax.tree_util.tree_map(
            np.asarray, hp)), os.path.join(tmp, f"params_{arch}.pt"))
    args = (ARCH, tmp, BATCH, PLEN, STEPS, WORLD, HYBRIDS, BACKENDS, RAGGED)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # JAX's run beside the ranks'
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_SERVE.replace("= ARGS",
                                                  "= " + repr(args))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        spawn_ranks(_serve_rank, WORLD, (WORLD, tmp), deadline_s=240)
        _, err = jax_run.communicate(timeout=240)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(WORLD)]
    hybrids = {arch: dict(np.load(os.path.join(tmp, f"jax_{arch}.npz")))
               for arch in HYBRIDS + BACKENDS}
    return params, torch.from_numpy(prompt), \
        np.load(os.path.join(tmp, "jax_tokens.npy")), ranks, hybrids


def test_cp_greedy_tokens_match_jax_on_4_ranks(served):
    _, _, jtoks, ranks, _ = served
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"].numpy(), jtoks)


def test_in_process_mesh_takes_the_plain_route_and_matches(served):
    """One process on a 1x1 mesh holds the whole cache; with its CP attend
    replaced by ``context_parallel_socket_attend_ref`` over ``WORLD``
    shards it gives the ranks' tokens."""
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import run_serve
    params, prompt, jtoks, _, _ = served
    calls = []
    ref = cp.context_parallel_socket_attend_ref

    def plain(cfg, mesh, seq_axes, *a, batch_axes=(), **kw):
        calls.append(a[2].shape[2])
        return ref(cfg, WORLD, *a, **kw)

    cfg = _tcfg(**CP)
    with activate_mesh(Mesh(("data", "model"), (1, 1))), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(cp, "context_parallel_socket_attend", plain)
        toks, _, _ = run_serve(cfg, BATCH, PLEN, STEPS, prompt=prompt,
                               params=params, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    # layers x (warm-up + steps) calls, each over the whole cache
    assert calls == [CAP] * cfg.num_layers * (STEPS + 1)


def test_each_rank_holds_its_block_of_the_cache(served):
    """Prefill: rank r's leaves are rows [16 r, 16 r + 16) of the
    single-process cache.  Decode: the new rows (60..63) are written on
    rank 3 only, layer 0's as the single-process decode writes them."""
    from repro_torch.models import transformer as tfm
    params, prompt, _, ranks, _ = served
    cfg = _tcfg()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, caches = tfm.prefill(cfg, params, {"tokens": prompt}, CAP)
        whole = [{k: v.clone() for k, v in c.items()} for c in caches]
        toks = ranks[0]["tokens"]
        for t in range(STEPS):
            tfm.decode_step(cfg, params, caches, toks[:, t:t + 1], PLEN + t)
    finally:
        torch.set_num_threads(n)
    n_l = CAP // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * n_l, (r + 1) * n_l)
        for layer, (pre, dec) in enumerate(zip(got["prefill"],
                                               got["decoded"])):
            assert set(pre) == set(whole[layer])
            for name, leaf in pre.items():
                assert leaf.shape[2] == n_l, name
                ref = whole[layer][name][:, :, rows]
                if name == "bits":
                    assert torch.equal(leaf, ref)
                else:
                    torch.testing.assert_close(leaf, ref, rtol=1e-5,
                                               atol=1e-5)
            for name in ("k", "v", "vnorm"):
                diff = dec[name] != pre[name]
                written = diff.reshape(*diff.shape[:3], -1).any(-1)
                own = torch.zeros_like(written)
                if r == WORLD - 1:
                    own[:, :, PLEN - rows.start:] = True
                assert torch.equal(written, own), (r, layer, name)
            if r == WORLD - 1 and layer == 0:
                # layer 0's new rows come from the same tokens' embeddings
                # (deeper layers read attention outputs, and the CP
                # route's union of local top-ks differs from the global
                # top-k by design)
                for name in ("k", "v"):
                    torch.testing.assert_close(
                        dec[name][:, :, PLEN - rows.start:],
                        caches[0][name][:, :, PLEN:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", HYBRIDS)
def test_cp_hybrid_decode_matches_jax(served, arch):
    """Greedy tokens equal JAX's under the mesh on every rank, every
    step's logits within LOGITS_ATOL."""
    _, _, _, ranks, hybrids = served
    want = hybrids[arch]
    for r, got in enumerate(ranks):
        got = got[arch]
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"],
                                      err_msg=r)
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                                   rtol=0, atol=LOGITS_ATOL, err_msg=r)


@pytest.mark.parametrize("arch", HYBRIDS)
def test_cp_hybrid_ranks_hold_blocks_rings_and_state(served, arch):
    """Each rank's prefill caches: a global layer's leaves its block of
    ``CAP / WORLD`` rows; a local layer's ring and a Mamba layer's state
    whole (the single-process shapes) and bitwise equal on every rank."""
    from repro_torch.models import transformer as tfm
    _, _, _, ranks, _ = served
    cfg = _tcfg(arch)
    whole = tfm.init_decode_caches(cfg, BATCH, CAP)
    kinds = set()
    for layer, spec in enumerate(cfg.layer_specs):
        glob = spec.kind == "attn" and spec.attn_type == "global"
        kinds.add("global" if glob else spec.kind if spec.kind != "attn"
                  else "local")
        for name, ref in whole[layer].items():
            leaves = [r[arch]["prefill"][layer][name] for r in ranks]
            for leaf in leaves:
                want = list(ref.shape)
                if glob:
                    want[2] = CAP // WORLD
                assert list(leaf.shape) == want, (layer, name)
            if not glob:
                for leaf in leaves[1:]:
                    assert torch.equal(leaf, leaves[0]), (layer, name)
    assert kinds == {"gemma3-27b": {"global", "local"},
                     "jamba-v0.1-52b": {"global", "mamba"},
                     "mamba2-780m": {"mamba"}}[arch]


def test_write_token_writes_only_owned_rows():
    """Scalar and ragged positions, with the batch split too: a rank
    writes the rows and batch rows it owns and nothing else."""
    from repro_torch.distributed.context_parallel import CacheShard
    from repro_torch.models.backends import ContiguousView, LeafSpec
    spec = {"k": LeafSpec(suffix=(2,))}
    value = torch.arange(1, 4 * 3 * 2 + 1, dtype=torch.float32).reshape(
        4, 3, 2)
    for pos in (5, torch.tensor([5, 9, 11, 2])):
        got = {}
        for si in range(2):
            for bi in range(2):
                a = {"k": torch.zeros(2, 3, 6, 2)}
                ContiguousView(a, spec, CacheShard(2, si, 2, bi)).write_token(
                    "k", pos, value)
                got[si, bi] = a["k"]
        whole = torch.zeros(4, 3, 12, 2)
        ContiguousView({"k": whole}, spec).write_token("k", pos, value)
        for (si, bi), leaf in got.items():
            assert torch.equal(
                leaf, whole[2 * bi:2 * bi + 2, :, 6 * si:6 * si + 6])


@pytest.mark.parametrize("arch,backend", [
    ("llama31-8b", "dense"), ("llama31-8b", "quest")])
def test_cp_refuses_other_layers(arch, backend):
    """No backend is refused under an active CP mesh any more: each
    global layer's cache is this rank's block, and the prefill keeps the
    rows the rank owns (rank 0 of an in-process (2, 1) mesh: the first
    half, equal to one process's)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).smoke().replace(attention_backend=backend, **CP)
    params = tfm.init_model(cfg, 0, "cpu")
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    with activate_mesh(Mesh(("data", "model"), (2, 1))):
        caches = tfm.init_decode_caches(cfg, 1, 16)
        _, blocks = tfm.prefill(cfg, params, {"tokens": tokens}, 16)
    # without a mesh the field changes nothing
    whole = tfm.init_decode_caches(cfg, 1, 16)
    _, ref = tfm.prefill(cfg, params, {"tokens": tokens}, 16)
    assert len(caches) == len(whole) == cfg.num_layers
    for got, block, want, full in zip(caches, blocks, whole, ref):
        assert set(got) == set(want)
        for name, leaf in want.items():
            rows = leaf.shape[2] // 2
            assert got[name].shape[2] == block[name].shape[2] == rows
            assert torch.equal(block[name], full[name][:, :, :rows]), name


def _whole_run(backend, ranks):
    """One process holding the whole cache, without CP, fed the ranks'
    tokens: its prefill caches and its caches after the steps."""
    params, prompt = ranks["params"], ranks["prompt"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _decode(_tcfg(attention_backend=backend), params, prompt,
                       ragged=True, teacher=ranks["tokens"])
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cp_backend_decode_matches_jax(served, backend):
    """Greedy tokens equal JAX's under the mesh on every rank (the ragged
    step included), every step's logits within LOGITS_ATOL."""
    _, _, _, ranks, jax_runs = served
    want = jax_runs[backend]
    for r, got in enumerate(ranks):
        got = got[backend]
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"],
                                      err_msg=r)
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                                   rtol=0, atol=LOGITS_ATOL, err_msg=r)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cp_backend_ranks_hold_their_blocks(served, backend):
    """Prefill: rank r's leaves are rows [16 r, 16 r + 16) of one
    process's cache (Quest's page bounds and hard LSH's bits bitwise).
    Decode: the rows the steps write (60..63) change on rank 3 only, and
    its K/V and Quest bounds are one process's (fed the same tokens) at
    those rows: layer 0's bitwise (its new keys come from the tokens'
    embeddings), deeper layers' within 1e-5."""
    params, prompt, _, ranks, _ = served
    whole = _whole_run(backend, dict(params=params, prompt=prompt,
                                     tokens=ranks[0][backend]["tokens"]))
    n_l = CAP // WORLD
    for r, got in enumerate(ranks):
        got = got[backend]
        for layer in range(len(got["prefill"])):
            pre, dec = got["prefill"][layer], got["decoded"][layer]
            assert set(pre) == set(whole["prefill"][layer])
            for name, leaf in pre.items():
                gran = n_l // leaf.shape[2]
                rows = slice(r * n_l // gran, (r + 1) * n_l // gran)
                ref = whole["prefill"][layer][name][:, :, rows]
                if name in ("bits", "kmin", "kmax"):
                    assert torch.equal(leaf, ref), (r, layer, name)
                else:
                    torch.testing.assert_close(leaf, ref, rtol=1e-5,
                                               atol=1e-5)
                diff = dec[name] != leaf
                written = diff.reshape(*diff.shape[:3], -1).any(-1)
                if r < WORLD - 1:
                    assert not bool(written.any()), (r, layer, name)
                    continue
                tail = slice((PLEN - r * n_l) // gran, None)
                assert not bool(written[:, :, :tail.start].any()), name
                want = whole["decoded"][layer][name][:, :, rows][:, :, tail]
                if layer == 0:
                    assert torch.equal(dec[name][:, :, tail], want), name
                else:
                    torch.testing.assert_close(dec[name][:, :, tail], want,
                                               rtol=1e-5, atol=1e-5)


def test_engine_refuses_cp_as_jax_does():
    from repro.configs import get_config as jget
    from repro.serving.engine import ContinuousBatchingEngine as JEngine
    from repro_torch.serving.engine import ContinuousBatchingEngine
    msgs = []
    for engine, cfg in ((JEngine, jget(ARCH).smoke().replace(**CP)),
                        (ContinuousBatchingEngine, _tcfg(**CP))):
        with pytest.raises(NotImplementedError) as e:
            engine._validate(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
