"""Port parity for the training loop's parts: ``make_train_step`` (3
steps at ``accum`` 1 and 2) against the JAX package's jitted step, the
data pipeline against JAX's batch for batch and bit for bit, the
checkpointer, the Trainer (resume, giving up), the straggler detector,
the retry policy and the ``launch/train.py`` CLI on the CPU.

Tolerances: the train step's loss and gradient norm rtol 1e-5 at each
step, the parameters after 3 steps within 1e-4 of each leaf's largest
magnitude (measured 8e-6: Adam divides by ``sqrt(v)``, which amplifies
the float32 differences of the gradients where ``v`` is small); data
batches, checkpoints and the Trainer's resumed run bit for bit.
"""

import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import data as jdata
from repro.configs import get_config as jget
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro.optim import adamw as jadam
from repro.optim.schedule import ScheduleConfig as JSchedule
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstr
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch import data as tdata
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.models.weights import from_jax_params, opt_state_from_jax
from repro_torch.optim import adamw as tadam
from repro_torch.optim import quantized_state as tq8
from repro_torch.optim.schedule import ScheduleConfig as TSchedule
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import straggler as tstr
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _tiny(mod):
    """The JAX package's runtime-test config (minitron-8b's smoke, one
    group, the dense backend)."""
    return mod("minitron-8b").smoke().replace(num_groups=1,
                                              attention_backend="dense")


# ----------------------------------------------------------- train step

@pytest.mark.parametrize("accum,bits", [(1, 32), (2, 32), (2, 8)])
def test_train_step_matches_jax(accum, bits):
    jc, tc = _tiny(jget), _tiny(tget)
    jp = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(0)))
    sched = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=3)
    jo = jadam.AdamWConfig(state_bits=bits, schedule=JSchedule(**sched))
    to = tadam.AdamWConfig(state_bits=bits, schedule=TSchedule(**sched))
    js = jadam.init_adamw(jo, jp)
    tp = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    ts = opt_state_from_jax(tc, jax.tree_util.tree_map(np.asarray, js))
    jstep = jax.jit(jmake_train_step(jc, jo, accum=accum))
    tstep = make_train_step(tc, to, accum=accum)
    src = jdata.SyntheticLMSource(jdata.DataConfig(
        seq_len=32, global_batch=4, vocab_size=jc.vocab_size, seed=1))
    for i in range(3):
        b = src.batch(0, i, range(4))
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v).long()
                                    for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=(i, k))
    assert int(ts["step"]) == 3
    want = from_jax_params(tc, jax.tree_util.tree_map(np.asarray, jp))
    for (path, t), (_, j) in zip(_leaves(tp), _leaves(want)):
        j = j.numpy()
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * float(np.abs(j).max()),
                                   err_msg=path)


def test_train_step_rejects_a_batch_that_does_not_split():
    tc = _tiny(tget)
    from repro_torch.models import transformer as ttfm
    params = ttfm.init_model(tc, 0)
    step = make_train_step(tc, tadam.AdamWConfig(), accum=3)
    batch = {k: torch.zeros(4, 8, dtype=torch.long)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="microbatches"):
        step(params, tadam.init_adamw(tadam.AdamWConfig(), params), batch)


# ----------------------------------------------------------------- data

def test_synthetic_batches_equal_jax():
    kw = dict(seq_len=64, global_batch=4, vocab_size=1000, seed=7)
    j = jdata.SyntheticLMSource(jdata.DataConfig(**kw))
    t = tdata.SyntheticLMSource(tdata.DataConfig(**kw))
    for epoch, step in ((0, 0), (0, 3), (2, 11)):
        a, b = j.batch(epoch, step, range(4)), t.batch(epoch, step, range(4))
        for k in ("tokens", "labels"):
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k])
    kw = dict(seq_len=512, global_batch=1, vocab_size=1000, seed=1,
              copy_prob=1.0, copy_span=16)
    np.testing.assert_array_equal(
        tdata.SyntheticLMSource(tdata.DataConfig(**kw)).row(0, 0, 0),
        jdata.SyntheticLMSource(jdata.DataConfig(**kw)).row(0, 0, 0))


def test_memmap_source_equals_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.arange(1000, dtype=np.uint32).tofile(path)
    kw = dict(seq_len=64, global_batch=2, vocab_size=2000, seed=0)
    j = jdata.MemmapLMSource(jdata.DataConfig(**kw), path)
    t = tdata.MemmapLMSource(tdata.DataConfig(**kw), path)
    assert t.num_seqs == j.num_seqs
    for epoch, step in ((0, 0), (1, 0), (1, 5)):
        a, b = j.batch(epoch, step, range(2)), t.batch(epoch, step, range(2))
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], a[k])
    small = str(tmp_path / "small.bin")
    np.arange(10, dtype=np.uint32).tofile(small)
    with pytest.raises(ValueError, match="too small"):
        tdata.MemmapLMSource(tdata.DataConfig(**kw), small)


def test_loader_batches_and_resume_equal_jax(tmp_path):
    """The prefetching loader yields JAX's batches; resumed from a state
    dict, the next batches too; host shards partition the batch; a
    memmap source rolls over its epoch as JAX's does."""
    kw = dict(seq_len=32, global_batch=2, vocab_size=500, seed=3)
    jl, tl = jdata.HostDataLoader(jdata.DataConfig(**kw)), \
        tdata.HostDataLoader(tdata.DataConfig(**kw))
    try:
        for _ in range(5):
            a, b = next(jl), next(tl)
            np.testing.assert_array_equal(b["tokens"], a["tokens"])
        state = tl.state_dict()
        assert state == jl.state_dict()
        nxt = [next(tl) for _ in range(3)]
    finally:
        jl.close()
        tl.close()
    resumed = tdata.HostDataLoader(tdata.DataConfig(**kw))
    try:
        resumed.load_state_dict(state)
        for want in nxt:
            np.testing.assert_array_equal(next(resumed)["tokens"],
                                          want["tokens"])
    finally:
        resumed.close()
    cfg = tdata.DataConfig(seq_len=16, global_batch=4, vocab_size=100,
                           seed=5)
    shards = [tdata.HostDataLoader(cfg, process_index=i, num_processes=2)
              for i in (0, 1)]
    try:
        got = np.concatenate([next(s)["tokens"] for s in shards])
    finally:
        for s in shards:
            s.close()
    np.testing.assert_array_equal(
        got, jdata.SyntheticLMSource(jdata.DataConfig(
            seq_len=16, global_batch=4, vocab_size=100, seed=5)).batch(
                0, 0, range(4))["tokens"])
    path = str(tmp_path / "tokens.bin")
    np.arange(300, dtype=np.uint32).tofile(path)
    mk = dict(seq_len=32, global_batch=2, vocab_size=400, seed=0)
    loaders = (jdata.HostDataLoader(jdata.DataConfig(**mk),
                                    jdata.MemmapLMSource(
                                        jdata.DataConfig(**mk), path)),
               tdata.HostDataLoader(tdata.DataConfig(**mk),
                                    tdata.MemmapLMSource(
                                        tdata.DataConfig(**mk), path)))
    try:
        for _ in range(12):                # 9 sequences: epochs roll over
            a, b = (next(x) for x in loaders)
            np.testing.assert_array_equal(b["tokens"], a["tokens"])
        assert loaders[1].state_dict() == loaders[0].state_dict()
    finally:
        for x in loaders:
            x.close()
    with pytest.raises(ValueError, match="divide"):
        tdata.HostDataLoader(tdata.DataConfig(global_batch=3),
                             num_processes=2)


# ---------------------------------------------------------- checkpoints

def _state_tree():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 20, generator=g)
    return {"params": {"w": w.to(torch.bfloat16), "b": torch.randn(
                5, generator=g), "layers": [{"x": torch.arange(4)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": tq8.quantize(w * 1e-3, power=3),
                    "hash": torch.zeros(())}}


def _equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    """bf16 leaves, 8-bit moments, ints, a 0-d placeholder and a list of
    layers come back bit for bit, with the loader's state."""
    ck = Checkpointer(str(tmp_path))
    tree = _state_tree()
    ck.save(10, tree, extra={"loader": {"epoch": 0, "step": 10, "seed": 0}},
            blocking=True)
    rec = ck.restore()
    assert rec["step"] == 10 and rec["extra"]["loader"]["step"] == 10
    _equal(rec["tree"], tree)
    assert isinstance(rec["tree"]["params"]["layers"], list)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """An asynchronous save copies the tensors when it is called: the
    caller's in-place update right after does not reach the file."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones(1000)}
    ck.save(1, tree)
    tree["w"].add_(1.0)
    ck.wait()
    assert torch.equal(ck.restore()["tree"]["w"], torch.ones(1000))


def test_checkpoint_async_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"v": torch.tensor(float(s))})
    ck.wait()
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _state_tree(), blocking=True)
    names = os.listdir(tmp_path)
    assert not any(n.endswith(".tmp") for n in names)
    assert "LATEST" in names


def test_checkpoint_restore_named_step_and_missing(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for s in (1, 2, 3):
        ck.save(s, {"v": torch.tensor(float(s))}, blocking=True)
    assert float(ck.restore(step=2)["tree"]["v"]) == 2.0
    assert float(ck.restore()["tree"]["v"]) == 3.0
    with pytest.raises(FileNotFoundError, match="step 9"):
        ck.restore(step=9)


def test_checkpoint_write_error_is_raised_by_wait(tmp_path):
    """An asynchronous save that fails raises from the next ``wait`` (a
    leaf that cannot be pickled), and leaves no partial step."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"v": torch.tensor(1.0)}, blocking=True)
    ck.save(2, {"v": torch.tensor(2.0), "f": lambda: 0})
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        ck.wait()
    assert ck.all_steps() == [1] and ck.latest_step() == 1


# -------------------------------------------------------------- trainer

def _trainer(tmp_path, steps=10, injector=None, ckpt_every=5, bits=32):
    cfg = _tiny(tget)
    ocfg = tadam.AdamWConfig(state_bits=bits, schedule=TSchedule(
        peak_lr=1e-3, warmup_steps=2, decay_steps=steps))
    loop = TrainLoopConfig(total_steps=steps, checkpoint_every=ckpt_every,
                           log_every=100)
    data = tdata.DataConfig(seq_len=32, global_batch=2,
                            vocab_size=cfg.vocab_size, seed=1)
    return Trainer(cfg, ocfg, loop, data, str(tmp_path), device="cpu",
                   injector=injector)


@pytest.mark.parametrize("bits", [32, 8])
def test_trainer_resume_equals_uninterrupted(tmp_path, bits):
    """A failure at step 7 rolls back to the step-5 checkpoint (params,
    moments, loader); steps 5-9 run again and every loss and the final
    parameters equal an uninterrupted run's bit for bit."""
    t1 = _trainer(tmp_path / "a", bits=bits)
    log1 = t1.run()
    t2 = _trainer(tmp_path / "b", bits=bits, injector=tft.FailureInjector(
        {7: RuntimeError("card fell over")}))
    log2 = t2.run()
    assert t2.rebuild_count == 1 and t2.step == 10
    assert [m["step"] for m in log2] == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
    by_step = {m["step"]: m["loss"] for m in log2}
    assert [by_step[s] for s in range(10)] == [m["loss"] for m in log1]
    assert log1[-1]["loss"] < log1[0]["loss"]
    _equal(t2.params, t1.params)
    _equal(t2.opt_state, t1.opt_state)
    restored = Checkpointer(str(tmp_path / "b")).restore()
    assert restored["step"] == 10
    _equal(restored["tree"]["params"], t1.params)


def test_trainer_restarts_from_init_without_a_checkpoint(tmp_path):
    t = _trainer(tmp_path, steps=4, ckpt_every=100,
                 injector=tft.FailureInjector({2: "lose_device:1"}))
    log = t.run()
    # re-initialised from the seed; the loader runs on, as in JAX
    assert [m["step"] for m in log] == [0, 1, 0, 1, 2, 3]
    assert t.injector.lost_devices == 1


def test_trainer_gives_up_after_repeated_failures(tmp_path):
    class AlwaysFail(tft.FailureInjector):
        def maybe_fail(self, step):
            raise RuntimeError("dead")

    t = _trainer(tmp_path, injector=AlwaysFail())
    t.retry = tft.RetryPolicy(max_consecutive_failures=2)
    with pytest.raises(RuntimeError, match="giving up"):
        t.run()
    t.loader.close()


def test_trainer_on_more_devices_names_its_roadmap_item(tmp_path):
    """A mesh over 2 ranks without an initialised process group raises a
    clear error: the Trainer never drops to one rank quietly."""
    from repro_torch.launch.mesh import Mesh
    cfg = _tiny(tget)
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        Trainer(cfg, tadam.AdamWConfig(), TrainLoopConfig(),
                tdata.DataConfig(vocab_size=cfg.vocab_size), str(tmp_path),
                device="cpu",
                mesh_factory=lambda ranks: Mesh(("data", "model"), (2, 1)))


# --------------------------------------------- straggler, retry, launcher

@pytest.mark.parametrize("mod", [jstr, tstr], ids=["jax", "torch"])
def test_straggler_detector_flags_outliers(mod):
    det = mod.StragglerDetector(threshold_sigma=3.0, warmup_steps=3,
                                patience=2)
    fired = []
    det.on_straggler = lambda step, lat: fired.append(step)
    for s in range(20):
        det.observe(s, 0.1 + 0.001 * (s % 3))
    assert not det.events
    det.observe(20, 2.5)
    det.observe(21, 2.5)
    assert len(det.events) == 2 and fired == [21]
    det.observe(22, 0.1)
    assert det.mean_latency < 0.2


def test_straggler_detector_and_retry_equal_jax():
    """The same latencies give the same flags, events and means; the
    same failures the same retry answers."""
    rng = np.random.default_rng(0)
    lat = np.abs(rng.normal(0.1, 0.01, 200))
    lat[[50, 51, 52, 120]] = 1.0
    dets = [mod.StragglerDetector(patience=2) for mod in (jstr, tstr)]
    for s, x in enumerate(lat):
        assert dets[0].observe(s, float(x)) == dets[1].observe(s, float(x))
    assert dets[0].events == dets[1].events and len(dets[1].events) == 4
    assert dets[0].mean_latency == dets[1].mean_latency
    pols = [mod.RetryPolicy(max_consecutive_failures=2) for mod in
            (jft, tft)]
    for event in "ffsfffsf":
        answers = [p.record_failure() if event == "f" else
                   p.record_success() for p in pols]
        assert answers[0] == answers[1]
    inj = tft.FailureInjector({3: ValueError("x"), 4: "lose_device:2"})
    inj.maybe_fail(2)
    with pytest.raises(ValueError):
        inj.maybe_fail(3)
    with pytest.raises(RuntimeError, match="device loss"):
        inj.maybe_fail(4)
    assert inj.lost_devices == 2


def test_train_cli_on_cpu(tmp_path, capsys):
    """``launch/train.py`` at ``--device cpu``: the JAX launcher's JSON
    keys and the device; with ``--ckpt`` its checkpoints stay."""
    out = tlaunch.main(["--arch", "minitron-8b", "--smoke", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--checkpoint-every",
                        "2", "--state-bits", "8", "--device", "cpu",
                        "--ckpt", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(out) == {"arch", "steps", "loss_first10", "loss_last10",
                        "mean_step_s", "straggler_events", "device"}
    assert out["steps"] == 4 and out["device"] == "cpu"
    assert np.isfinite(out["loss_last10"])
    assert Checkpointer(str(tmp_path)).latest_step() == 4


def test_train_cli_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "minitron-8b", "--smoke", "--steps", "1"])
