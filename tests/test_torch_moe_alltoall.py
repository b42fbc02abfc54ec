"""Expert-parallel MoE (``moe_dispatch="alltoall"``) and MoE under a data
mesh, held to the JAX package on the CPU.

One spawn of 4 gloo ranks (one process a rank, one intra-op thread each)
on a ``(data 2, model 2)`` mesh, and one subprocess running the JAX
package on 4 host devices (an ``AxisType.Auto`` mesh, as
``test_torch_cp_model.py`` explains), where ``apply_moe`` and the train
step take the JAX ``shard_map`` exchange:

* **``apply_moe``** (d 32, d_ff 64, top-2): each rank holds its data
  block of the rows and the whole weights (the sharded step's layout),
  and then the whole batch (serving's, as a CP prefill runs it); the
  output within 1e-5 and
  the gradients of ``sum(y^2) + 10 (lb + z)`` within 2e-4 (JAX's own
  bounds, ``tests/test_distributed.py``): the expert leaves summed over
  the ranks (each rank's gradient is its own experts' block), the
  router's equal on the two ``model`` ranks and summed over ``data``,
  the input's a rank's rows.  Cases: 4 experts (two a rank, the grouped
  products) dropless (capacity factor 8), with drops (capacity factor
  1.0: the drops show in the output), 2 experts under ``geglu`` at
  ``T % model != 0`` (one expert a rank, the plain product; every
  ``model`` rank routes the whole ``T``), and 3 experts (``E % model !=
  0``, the fall-through to global dispatch).  The exchange's slots and drops
  (``_sort_slots``) equal the JAX body's code on routes with many
  collisions, bit for bit.
* **The sharded train step** of ``mixtral-8x22b.smoke()`` (remat full)
  with ``"alltoall"`` on (2, 2), ``tp`` storage (mixtral's: ``d_ff``
  over ``model``) and ``ep`` (experts over ``model``), 2 steps, against
  JAX's jitted ``make_train_step`` under the mesh: losses and gradient
  norms rtol 1e-5, each rank's parameter blocks within 1e-4 of each
  leaf's largest magnitude (``test_torch_mesh_train.py``'s gates); each
  rank's expert blocks keep their storage shape.  ``"global"`` and
  ``"batch"`` dispatch on (2, 2) against JAX's one-device jitted step
  (what its ``pjit`` computes): the capacity and the aux losses the
  global batch's.
* **The elastic Trainer** with ``"alltoall"`` on a (2, 2) mesh loses 2
  ranks: one rebuild onto (1, 2), whose ``model`` group is a new one,
  and the remaining ranks finish.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import SRC

WORLD, MESH = 4, (2, 2)
ROWS, D = 4, 32
AUX = 10.0
# name -> (ModelConfig fields, T)
MOE_CASES = {
    "e4-dropless": (dict(num_experts=4, capacity_factor=8.0), 16),
    "e4-drops": (dict(num_experts=4, capacity_factor=1.0), 16),
    "e2-t15-geglu": (dict(num_experts=2, capacity_factor=8.0,
                          mlp_activation="geglu"), 15),
    "e3-fallthrough": (dict(num_experts=3, capacity_factor=8.0), 16),
}
GRAD_NAMES = ("w_gate", "w_up", "w_down", "router")
SCHED = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=3)
STEPS, SEQ = 2, 32
# name -> (moe_dispatch, moe_parallelism)
STEP_CASES = {"alltoall-tp": ("alltoall", "tp"),
              "alltoall-ep": ("alltoall", "ep"),
              "global": ("global", "tp"), "batch": ("batch", "tp")}
# routes of 24 assignments over 2 destinations, most of them to one
SLOT_DEST = [0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1,
             1, 1, 1, 1]
SLOT_CAP = 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_fields(kw):
    base = dict(name="t", family="moe", d_model=D, d_ff=64,
                num_experts_per_tok=2, mlp_activation="swiglu",
                moe_dispatch="alltoall", router_z_loss=1e-3)
    base.update(kw)
    return base


def _x(t):
    return np.random.default_rng(1).standard_normal((ROWS, t, D)).astype(
        np.float32)


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.integers(0, 256, (8, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def _step_cfg(mod, name):
    dispatch, par = STEP_CASES[name]
    return mod.get_config("mixtral-8x22b").smoke().replace(
        num_groups=1, remat_policy="full", moe_dispatch=dispatch,
        moe_parallelism=par)


_JAX = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.distributed import sharding as shd
from repro.models import moe, param as pm, transformer as tfm
from repro.optim import adamw, schedule
from repro.runtime.steps import make_train_step

TMP, MOE_CASES, ROWS, D, AUX, SCHED, STEPS, SEQ, SLOTS = ARGS
NAMES = ("alltoall",)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for name, (fields, t) in MOE_CASES.items():
    cfg = ModelConfig(**fields)
    params = pm.unbox(moe.init_moe(cfg, jax.random.PRNGKey(0)))
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (ROWS, t, D)).astype(np.float32))

    def loss(p, xx):
        y, aux = moe.apply_moe(cfg, p, xx)
        return jnp.sum(y ** 2) + AUX * (aux["moe_lb_loss"] +
                                        aux["moe_z_loss"]), y

    with shd.activate_mesh(mesh):
        (_, y), (g, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    out[name + "/y"] = np.asarray(y)
    out[name + "/x"] = np.asarray(gx)
    for k in params:
        out[name + "/g/" + k] = np.asarray(g[k])

# the exchange's slot code, as the JAX body writes it
dest, cap = SLOTS
flat_dest = jnp.asarray(dest, jnp.int32)
order = jnp.argsort(flat_dest)
inv = jnp.argsort(order)
counts = jnp.bincount(flat_dest, length=2)
starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                          jnp.cumsum(counts)[:-1]])
pos = (jnp.arange(len(dest)) - starts[flat_dest[order]])[inv]
keep = pos < cap
out["slots/keep"] = np.asarray(keep)
out["slots/slot"] = np.asarray(jnp.where(keep, pos, cap - 1))

for name in NAMES:
    # ep and tp storage compute alike: the exchange's weights are
    # P("model") blocks either way
    cfg = get_config("mixtral-8x22b").smoke().replace(
        num_groups=1, remat_policy="full", moe_dispatch="alltoall")
    ocfg = adamw.AdamWConfig(schedule=schedule.ScheduleConfig(**SCHED))
    p = pm.unbox(tfm.init_model(cfg, jax.random.PRNGKey(0)))
    s = adamw.init_adamw(ocfg, p)
    with shd.activate_mesh(mesh):
        step = jax.jit(make_train_step(cfg, ocfg))
        for i in range(STEPS):
            rng = np.random.default_rng(100 + i)
            b = {k: jnp.asarray(rng.integers(0, 256, (8, SEQ)).astype(
                np.int32)) for k in ("tokens", "labels")}
            p, s, m = step(p, s, b)
            for k, v in m.items():
                out[f"{name}/m{i}/{k}"] = np.asarray(v)
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        out[f"{name}/final/{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
np.savez(TMP + "/jax.npz", **out)
print("OK")
"""


def _trainer_mesh(ranks):
    from repro_torch.launch.mesh import Mesh
    n = len(ranks)
    return Mesh(("data", "model"), (n // 2, 2), rank=dist.get_rank(),
                ranks=ranks)


def _rank(rank, world, tmp):
    """The ``apply_moe`` cases, the train steps and the elastic Trainer
    on one rank."""
    torch.set_num_threads(1)
    import repro_torch.configs as tconfigs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import DataConfig
    from repro_torch.distributed import fsdp
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    from repro_torch.models import moe
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    mesh = make_test_mesh(*MESH)
    ref = np.load(os.path.join(tmp, "moe_params.npz"))
    d, nb = mesh.coords["data"], ROWS // MESH[0]
    res = {}
    for name, (fields, t) in MOE_CASES.items():
        cfg = ModelConfig(**_moe_fields(fields))
        params = {k: torch.from_numpy(ref[f"{name}/{k}"]).requires_grad_()
                  for k in GRAD_NAMES}
        x = torch.from_numpy(_x(t)[d * nb:(d + 1) * nb]).requires_grad_()
        y, aux = moe.apply_moe(cfg, params, x, split=mesh)
        loss = (y ** 2).sum() + AUX * (aux["moe_lb_loss"] +
                                       aux["moe_z_loss"])
        grads = torch.autograd.grad(loss, [params[k] for k in GRAD_NAMES]
                                    + [x])
        with torch.no_grad(), activate_mesh(mesh):
            # serving's layout: every rank the whole batch
            y_whole, _ = moe.apply_moe(cfg, params, torch.from_numpy(_x(t)))
        res[name] = dict(y=y.detach(), x=grads[-1], y_whole=y_whole,
                         g=dict(zip(GRAD_NAMES, grads[:-1])))
    ocfg = AdamWConfig(schedule=ScheduleConfig(**SCHED))
    whole = torch.load(os.path.join(tmp, "params.pt"), weights_only=True)
    for name in STEP_CASES:
        cfg = _step_cfg(tconfigs, name)
        psds, psh = sp.param_specs(cfg, mesh, {})
        osds, osh = sp.opt_specs(ocfg, psds, psh, mesh, {})
        params = fsdp.shard_tree(whole, fsdp.flat_tree(psh))
        opt = fsdp.zeros_tree(osds, fsdp.flat_tree(osh), "cpu")
        step = make_train_step(cfg, ocfg, grad_shardings=psh)
        metrics = []
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in _batch(i).items()}
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        res[name] = dict(metrics=metrics, params=params)
    # the elastic Trainer: (2, 2) -> (1, 2)
    cfg = get_config("mixtral-8x22b").smoke().replace(
        num_groups=1, moe_dispatch="alltoall")
    tr = Trainer(cfg, AdamWConfig(schedule=ScheduleConfig(**SCHED)),
                 TrainLoopConfig(total_steps=4, checkpoint_every=2),
                 DataConfig(seq_len=16, global_batch=4,
                            vocab_size=cfg.vocab_size),
                 os.path.join(tmp, "ckpt"), device="cpu",
                 mesh_factory=_trainer_mesh,
                 injector=FailureInjector({3: "lose_device:2"}))
    first = (tuple(tr.mesh.shape.values()), tr.mesh.group(("model",)))
    log = tr.run()
    res["elastic"] = dict(
        first=first[0], active=tr.active, step=tr.step,
        rebuilds=tr.rebuild_count, log=log,
        last=tuple(tr.mesh.shape.values()),
        new_group=tr.active and tr.mesh.group(("model",)) is not first[1])
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results (one subprocess on 4 host devices, run beside the
    ranks), the 4 ranks' (one spawn) and the port's one-process steps of
    the global and batch cases."""
    import jax
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import moe as jmoe
    from repro.models import param as jpm
    from repro.models import transformer as jtfm
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.weights import from_jax_params
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.steps import make_train_step
    tmp = str(tmp_path_factory.mktemp("moe_a2a"))
    moe_params = {}
    for name, (fields, _) in MOE_CASES.items():
        jp = jpm.unbox(jmoe.init_moe(JModelConfig(**_moe_fields(fields)),
                                     jax.random.PRNGKey(0)))
        moe_params.update({f"{name}/{k}": np.asarray(v)
                           for k, v in jp.items()})
    np.savez(os.path.join(tmp, "moe_params.npz"), **moe_params)
    # every step case draws the same tensors (dispatch and storage change
    # no value)
    jp = jpm.unbox(jtfm.init_model(_step_cfg(jconfigs, "alltoall-tp"),
                                   jax.random.PRNGKey(0)))
    whole = from_jax_params(_step_cfg(tconfigs, "alltoall-tp"),
                            jax.tree_util.tree_map(np.asarray, jp))
    torch.save(whole, os.path.join(tmp, "params.pt"))
    args = (tmp, {k: (_moe_fields(f), t) for k, (f, t) in MOE_CASES.items()},
            ROWS, D, AUX, SCHED, STEPS, SEQ, (SLOT_DEST, SLOT_CAP))
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX.replace("= ARGS", "= " + repr(args))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        spawn_ranks(_rank, WORLD, (WORLD, tmp), deadline_s=300)
        out, err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, err[-3000:]
    jres = dict(np.load(os.path.join(tmp, "jax.npz")))
    jres.update(moe_params)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    single = {}
    ocfg = AdamWConfig(schedule=ScheduleConfig(**SCHED))
    for name in ("global", "batch"):
        cfg = _step_cfg(tconfigs, name)
        p = {k: v for k, v in torch.load(os.path.join(tmp, "params.pt"),
                                         weights_only=True).items()}
        opt = init_adamw(ocfg, p)
        step = make_train_step(cfg, ocfg)
        metrics = []
        for i in range(STEPS):
            p, opt, m = step(p, opt, {k: torch.from_numpy(v).long()
                                      for k, v in _batch(i).items()})
            metrics.append({k: float(v) for k, v in m.items()})
        single[name] = dict(metrics=metrics, params=p)
    return jres, single, ranks


def _coords(rank):
    return rank // MESH[1], rank % MESH[1]


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_apply_moe_matches_jax(runs, name):
    jres, _, ranks = runs
    nb = ROWS // MESH[0]
    for rank, got in enumerate(ranks):
        d, _ = _coords(rank)
        rows = slice(d * nb, (d + 1) * nb)
        np.testing.assert_allclose(got[name]["y"].numpy(),
                                   jres[name + "/y"][rows], rtol=0,
                                   atol=1e-5, err_msg=(rank, "y"))
        np.testing.assert_allclose(got[name]["x"].numpy(),
                                   jres[name + "/x"][rows], rtol=0,
                                   atol=2e-4, err_msg=(rank, "x"))
    # the all-to-all: each rank's gradient is its own experts' block;
    # the fall-through: every model rank's is the whole leaf's, alike
    fall = MOE_CASES[name][0]["num_experts"] % MESH[1] != 0
    # serving's layout (a CP prefill's): the whole batch on every rank
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[name]["y_whole"].numpy(),
                                   jres[name + "/y"], rtol=0, atol=1e-5,
                                   err_msg=(rank, "y_whole"))
    for k in ("w_gate", "w_up", "w_down"):
        total = sum(r[name]["g"][k] for i, r in enumerate(ranks)
                    if not fall or _coords(i)[1] == 0)
        np.testing.assert_allclose(total.numpy(), jres[f"{name}/g/{k}"],
                                   rtol=0, atol=2e-4, err_msg=k)
    # the router's gradient: alike on a data row's model ranks
    for d in range(MESH[0]):
        a, b = (ranks[d * MESH[1] + m][name]["g"]["router"]
                for m in range(2))
        assert torch.equal(a, b), d
    total = sum(ranks[d * MESH[1]][name]["g"]["router"]
                for d in range(MESH[0]))
    np.testing.assert_allclose(total.numpy(), jres[f"{name}/g/router"],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", [n for n, (f, _) in MOE_CASES.items()
                                  if f["num_experts"] % MESH[1] == 0])
def test_plain_exchange_matches_jax(runs, name):
    """``apply_moe_alltoall_ref`` (every rank's routing, pages and
    experts in one process; ``chip_smoke.py``'s reference) gives JAX's
    output within 1e-5."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    jres, _, _ = runs
    fields, t = MOE_CASES[name]
    params = {k: torch.from_numpy(np.array(jres[f"{name}/{k}"]))
              for k in GRAD_NAMES}
    y, _ = moe.apply_moe_alltoall_ref(ModelConfig(**_moe_fields(fields)),
                                      params, torch.from_numpy(_x(t)),
                                      *MESH)
    np.testing.assert_allclose(y.numpy(), jres[name + "/y"], rtol=0,
                               atol=1e-5)


def test_drops_happen_where_the_capacity_is_one(runs):
    """At capacity factor 1.0 the routes overflow a rank's pages: the
    case's output differs from the dropless one's."""
    jres, _, ranks = runs
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    fields, t = MOE_CASES["e4-drops"]
    cfg = ModelConfig(**_moe_fields(fields))
    params = {k: torch.from_numpy(np.array(jres[f"e4-drops/{k}"]))
              for k in GRAD_NAMES}
    x = torch.from_numpy(_x(t)[:ROWS // MESH[0], :t // MESH[1]])
    top_idx, _, _ = moe._router(cfg, params, x.reshape(-1, D))
    n_l = x.shape[0] * x.shape[1]
    cap = max(int(np.ceil(n_l * 2 / MESH[1] * 1.0)), 8)
    keep, _ = moe._sort_slots((top_idx // 2).reshape(-1), MESH[1], cap)
    assert not bool(keep.all())
    assert not np.allclose(jres["e4-drops/y"], jres["e4-dropless/y"],
                           atol=1e-3)


def test_exchange_slots_equal_jax(runs):
    """``_sort_slots`` (a stable sort) gives the JAX body's slots and
    drops bit for bit on routes with many collisions (a sort that is not
    stable reorders the ties)."""
    from repro_torch.models import moe
    jres, _, _ = runs
    keep, slot = moe._sort_slots(torch.tensor(SLOT_DEST), 2, SLOT_CAP)
    assert np.array_equal(keep.numpy(), jres["slots/keep"])
    assert np.array_equal(slot.numpy(), jres["slots/slot"])
    assert not bool(keep.all())


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


def _jax_final(jres, name, cfg):
    """JAX's final parameters of a step case in the port's layout."""
    from repro_torch.models.weights import from_jax_params
    prefix = f"{name}/final/"
    tree = {}
    for key, v in jres.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].strip("[]'").split("']['")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return from_jax_params(cfg, tree)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_moe_step_matches_jax(runs, name):
    import repro_torch.configs as tconfigs
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    jres, single, ranks = runs
    cfg = _step_cfg(tconfigs, name)
    if name in single:
        want_metrics, want = single[name]["metrics"], single[name]["params"]
    else:
        want_metrics = [{k.split("/")[-1]: float(v) for k, v in jres.items()
                         if k.startswith(f"alltoall/m{i}/")}
                        for i in range(STEPS)]
        want = _jax_final(jres, "alltoall", cfg)
    whole = dict(_flat(want))
    for rank, got in enumerate(ranks):
        got = got[name]
        for i, (m, jm) in enumerate(zip(got["metrics"], want_metrics)):
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-5,
                                           err_msg=(rank, i, k))
        mesh = Mesh(("data", "model"), MESH, rank=rank)
        _, psh = sp.param_specs(cfg, mesh, {})
        block = fsdp.shard_tree(want, fsdp.flat_tree(psh))
        for (path, t), (_, j) in zip(_flat(got["params"]), _flat(block)):
            assert t.shape == j.shape, (rank, path)
            np.testing.assert_allclose(
                t.numpy(), j.numpy(), rtol=0,
                atol=1e-4 * float(whole[path].abs().max()),
                err_msg=(rank, path))


def test_expert_storage_is_a_rank_share(runs):
    """Under ``ep`` a rank stores E / model experts over half the model
    dim (FSDP); under ``tp`` every expert's d_ff shard: a quarter of the
    leaf either way."""
    _, _, ranks = runs
    for name in ("alltoall-ep", "alltoall-tp"):
        w = ranks[0][name]["params"]["layers"][0]["moe"]["w_gate"]
        e, d, ff = 4, 64, 128
        assert w.numel() * 4 == e * d * ff, (name, tuple(w.shape))
        assert tuple(w.shape) == ((2, 32, 128) if name.endswith("ep")
                                  else (4, 32, 64))


def test_elastic_moe_trainer_rebuilds_the_model_group(runs):
    _, _, ranks = runs
    for r, got in enumerate(ranks):
        el = got["elastic"]
        assert el["first"] == (2, 2) and el["rebuilds"] == 1
        if r < 2:
            assert el["active"] and el["step"] == 4
            assert el["last"] == (1, 2) and el["new_group"]
            assert all(np.isfinite(m["loss"]) for m in el["log"])
        else:
            assert not el["active"]


def test_moe_dispatch_without_a_mesh_is_global():
    """``"alltoall"`` without a mesh (or under a mesh where it does not
    apply) is global dispatch, as in the JAX package."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models import param as tpm
    cfg = ModelConfig(**_moe_fields(dict(num_experts=4)))
    params = tpm.unbox(moe.init_moe(cfg, torch.Generator().manual_seed(0)))
    x = torch.from_numpy(_x(16))
    want, _ = moe.apply_moe(cfg.replace(moe_dispatch="global"), params, x)
    got, _ = moe.apply_moe(cfg, params, x)
    assert torch.equal(got, want)
    with shd.activate_mesh(Mesh(("data", "model"), (2, 1))):
        got, _ = moe.apply_moe(cfg, params, x)
    assert torch.equal(got, want)
    assert not moe.alltoall_applies(cfg, Mesh(("data", "model"), (1, 3)))
    assert moe.alltoall_applies(cfg, Mesh(("data", "model"), (1, 2)))

