"""The elastic multi-rank Trainer and ``launch/train.py`` under
``torchrun``, on the CPU.

* **4 -> 2 ranks.** The JAX package's elastic test's settings
  (``minitron-8b.smoke()``, one group, the dense backend; 12 steps, a
  checkpoint every 4, ``lose_device:2`` at step 6) on 4 gloo ranks, one
  process a rank: one rebuild, a mesh of 2 ranks, step 12; the ranks
  that left the mesh stop training (``active`` False) and exit with 0;
  each remaining rank's restored parameters and moments are its block
  of the step-4 checkpoint on the 2-rank mesh, bit for bit.  Every
  step's loss and gradient norm equal a one-process Trainer's given the
  same failure (rtol 1e-5), and the final checkpoint's parameters are
  within 1e-4 of each leaf's largest magnitude of its
  (``test_torch_train_loop.py``'s tolerances).
* **torchrun.** ``python -m torch.distributed.run --standalone
  --nproc-per-node 2 -m repro_torch.launch.train ... --device cpu``
  trains over both ranks (the JSON names them) and leaves its
  checkpoints.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLD = 4
STEPS, EVERY, FAIL_AT, LOST = 12, 4, 6, 2
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(ckpt_dir, **kw):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    class Spy(Trainer):
        """Keeps a copy of what each restore placed on this rank."""

        def _setup(self, restore):
            super()._setup(restore)
            if restore and self.active:
                self.restored = (self.step, {
                    "params": self.params, "opt": self.opt_state})
                self.restored = torch.utils._pytree.tree_map(
                    lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, self.restored)

    cfg = get_config("minitron-8b").smoke().replace(
        num_groups=1, attention_backend="dense")
    ocfg = AdamWConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2,
                                               decay_steps=STEPS))
    loop = TrainLoopConfig(total_steps=STEPS, checkpoint_every=EVERY)
    data = DataConfig(seq_len=32, global_batch=8, vocab_size=cfg.vocab_size)
    return Spy(cfg, ocfg, loop, data, ckpt_dir, device="cpu",
               injector=FailureInjector({FAIL_AT: f"lose_device:{LOST}"}),
               **kw)


def _elastic_rank(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_rank
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    tr = _trainer(os.path.join(tmp, "ckpt"))
    first_mesh = tr.mesh.size
    log = tr.run()
    mesh = tr.mesh
    torch.save(dict(
        first_mesh=first_mesh, active=tr.active, step=getattr(tr, "step"),
        rebuilds=tr.rebuild_count, log=log,
        mesh=None if mesh is None else (mesh.size, list(mesh.ranks)),
        restored=getattr(tr, "restored", None)),
        os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    tmp = str(tmp_path_factory.mktemp("elastic"))
    spawn_ranks(_elastic_rank, WORLD, (WORLD, tmp), deadline_s=300)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    single = _trainer(os.path.join(tmp, "single"))
    single_log = single.run()
    return tmp, ranks, single, single_log


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_elastic_trainer_shrinks_mesh(elastic):
    _, ranks, _, _ = elastic
    for r, got in enumerate(ranks):
        assert got["first_mesh"] == WORLD and got["rebuilds"] == 1
        if r < WORLD - LOST:
            assert got["active"] and got["step"] == STEPS
            assert got["mesh"] == (WORLD - LOST, list(range(WORLD - LOST)))
            assert [m["step"] for m in got["log"]] == \
                list(range(FAIL_AT)) + list(range(EVERY, STEPS))
        else:
            # left the mesh at the rebuild: no step after it
            assert not got["active"] and got["restored"] is None
            assert [m["step"] for m in got["log"]] == list(range(FAIL_AT))


def test_restored_shards_equal_the_saved_tree(elastic):
    """Each remaining rank's restored blocks are its blocks of the step-4
    checkpoint on the 2-rank mesh, bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import fsdp
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import Mesh
    tmp, ranks, single, _ = elastic
    saved = Checkpointer(os.path.join(tmp, "ckpt")).restore(step=EVERY)
    for r in range(WORLD - LOST):
        step, tree = ranks[r]["restored"]
        assert step == EVERY
        mesh = Mesh(("data", "model"), (WORLD - LOST, 1), rank=r,
                    ranks=range(WORLD - LOST))
        psds, psh = sp.param_specs(single.cfg, mesh, {})
        _, osh = sp.opt_specs(single.ocfg, psds, psh, mesh, {})
        want = fsdp.shard_tree(saved["tree"], fsdp.flat_tree(
            {"params": psh, "opt": osh}))
        got, exp = list(_flat(tree)), list(_flat(want))
        assert [p for p, _ in got] == [p for p, _ in exp]
        for (path, t), (_, w) in zip(got, exp):
            assert t.dtype == w.dtype and torch.equal(t, w), (r, path)


def test_elastic_run_equals_one_process(elastic):
    """The ranks' losses and gradient norms equal a one-process Trainer's
    with the same failure, step for step; the final checkpoint (gathered
    from the 2 ranks) its final parameters."""
    from repro_torch.checkpoint import Checkpointer
    tmp, ranks, single, single_log = elastic
    assert single.mesh is None and single.rebuild_count == 1
    for got in ranks[:WORLD - LOST]:
        assert [m["step"] for m in got["log"]] == \
            [m["step"] for m in single_log]
        for m, ref in zip(got["log"], single_log):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(m[k], ref[k], rtol=1e-5,
                                           err_msg=(m["step"], k))
    final = Checkpointer(os.path.join(tmp, "ckpt")).restore()
    assert final["step"] == STEPS
    want = dict(_flat(single.params))
    for path, t in _flat(final["tree"]["params"]):
        ref = want[path]
        np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   err_msg=path)


def test_train_cli_under_torchrun(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "minitron-8b", "--smoke", "--steps", "4", "--batch", "4",
         "--seq", "16", "--checkpoint-every", "2", "--device", "cpu",
         "--ckpt", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["ranks"] == 2 and out["steps"] == 4 and out["device"] == "cpu"
    assert np.isfinite(out["loss_last10"])
    from repro_torch.checkpoint import Checkpointer
    assert Checkpointer(str(tmp_path)).latest_step() == 4
