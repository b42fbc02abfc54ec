"""Port parity for the serving observability layer's units, held to the
JAX package on the CPU: the event schema and its strict JSON helpers
(the JAX package's own cases run through both packages' functions), the
tracer (each package's trace validates under both validators), the
metrics exposition (snapshot and Prometheus text equal string for
string), the Chrome trace exporter (equal on the same events), the
selection-quality statistics and their sampler, the ``torch.profiler``
window, and the serve CLI's observability flags.

Tolerances: everything equal, but the probe's ``recall``, which is
within 1e-6 of JAX's, or else differs only where the dense attention
mass at the top-``m`` cutoff is tied within TIE_RTOL (float32 rounding:
the two packages sum the same softmax terms in another order).
"""

import contextlib
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import socket as jsk
from repro.models.backends import probe as jprobe
from repro.serving.obs import events as jev
from repro.serving.obs import perfetto as jperfetto
from repro.serving.obs import probe as jsprobe
from repro.serving.obs import validate as jvalidate
from repro.serving.obs.metrics import Registry as JRegistry
from repro.serving.obs.tracing import Tracer as JTracer
from repro_torch.core import socket as sk
from repro_torch.models.backends import probe as bprobe
from repro_torch.serving.obs import Observability, Profiler
from repro_torch.serving.obs import events as ev
from repro_torch.serving.obs import perfetto
from repro_torch.serving.obs import probe as sprobe
from repro_torch.serving.obs import validate
from repro_torch.serving.obs.metrics import Registry
from repro_torch.serving.obs.tracing import Tracer

TIE_RTOL = 1e-6

# ------------------------------------------------------------ event schema


def test_schema_and_version_equal_jax():
    assert ev.SCHEMA_VERSION == jev.SCHEMA_VERSION
    assert ev.EVENT_SCHEMA == jev.EVENT_SCHEMA
    assert ev.EVENT_SCHEMA_V1 == jev.EVENT_SCHEMA_V1
    assert ev.SUPPORTED_SCHEMAS == jev.SUPPORTED_SCHEMAS


def _step(**over):
    base = {"ev": "step", "ts": 0.5, "iter": 0, "kind": "decode",
            "occupancy": 2, "chunk_tokens": 0, "step_s": 0.01,
            "pool_free": 40, "pool_used": 7, "pool_high_water": 9,
            "waiting": 0, "prefilling": 0, "running": 2}
    base.update(over)
    return base


def _no_hwm():
    e = _step()
    del e["pool_high_water"]
    return e


_START = json.dumps({"ev": "trace_start", "ts": 0.0, "schema": 2})
_START_V1 = json.dumps({"ev": "trace_start", "ts": 0.0, "schema": 1})
_HIT = json.dumps({"ev": "cache_hit", "ts": 0.1, "rid": 0,
                   "cached_tokens": 8, "prompt_tokens": 9,
                   "shared_blocks": 1})
_STEP = json.dumps(_step())

# (function name, args, kwargs): the JAX package's cases of
# tests/test_observability.py and the schema generations' edges
CASES = [
    ("sanitize", ({"a": float("nan"), "b": [1.5, float("inf")],
                   "c": {"d": -float("inf"), "e": "NaN"}},), {}),
    ("sanitize", ((1.0, float("nan"), 2),), {}),
    ("strict_dumps", ({"x": float("nan"), "y": 2.0},), {}),
    ("strict_dumps", ({"b": 1, "a": [float("-inf")]},),
     {"indent": 2, "sort_keys": True}),
    ("strict_loads", ('{"x": NaN}',), {}),
    ("strict_loads", ('{"x": Infinity}',), {}),
    ("strict_loads", ('{"x": -Infinity}',), {}),
    ("strict_loads", ('{"x": null, "y": 2.0}',), {}),
    ("validate_event", (_step(),), {}),
    ("validate_event", ({"ev": "trace_start", "ts": 0.0, "schema": 2},), {}),
    ("validate_event", ({"ev": "admit", "ts": 0.1, "rid": 3, "slot": 0,
                         "blocks": 2, "resume": False, "wait_s": 0.2},), {}),
    ("validate_event", ({"ev": "first_token", "ts": 0.1, "rid": 3,
                         "ttft_s": None},), {}),
    ("validate_event", ({"ev": "nope", "ts": 0.0},), {}),
    ("validate_event", ({"ev": "step"},), {}),
    ("validate_event", (_step(kind=None),), {}),
    ("validate_event", (_no_hwm(),), {}),
    ("validate_event", (_step(iter="0"),), {}),
    ("validate_event", (_step(iter=True),), {}),
    ("validate_event", (_step(extra=1),), {}),
    ("validate_event", (json.loads(_HIT),), {}),
    ("validate_event", (json.loads(_HIT),), {"version": 1}),
    ("validate_event", ({"ev": "trace_start", "ts": 0.0, "schema": 1,
                         "prefix_cache": True},), {"version": 1}),
    ("validate_jsonl", ([_START, "", _STEP],), {}),
    ("validate_jsonl", ([_STEP],), {}),
    ("validate_jsonl", ([],), {}),
    ("validate_jsonl", ([json.dumps({"ev": "trace_start", "ts": 0.0,
                                     "schema": 3})],), {}),
    ("validate_jsonl", ([_START_V1, _STEP],), {}),
    ("validate_jsonl", ([_START_V1, _HIT],), {}),
    ("validate_jsonl", ([_START, _HIT],), {}),
    ("validate_jsonl", ([_START, '{"ev": "step", "ts": NaN}'],), {}),
]


def _outcome(fn, args, kwargs):
    try:
        return "ok", fn(*args, **kwargs)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_event_helpers_match_jax(name, args, kwargs):
    """The same outcome, result or ValueError with its message, from
    both packages (the strict-JSON message names its package)."""
    kind, got = _outcome(getattr(ev, name), args, kwargs)
    jkind, want = _outcome(getattr(jev, name), args, kwargs)
    assert kind == jkind, (got, want)
    if kind == "ValueError":
        got = got.replace("repro_torch.", "repro.")
    assert got == want


def _write_trace(tracer_cls, path):
    with tracer_cls(str(path)) as tr:
        tr.ensure_start(arch="llama31-8b", backend="socket",
                        prefill_chunk=16, layers_paged=2, layers_ring=0,
                        layers_state=0, prefix_cache=True)
        run = tr.begin_run(requests=1)
        tr.emit("submit", rid=0, prompt_tokens=5, max_new_tokens=2,
                arrival=0.0)
        tr.emit("cache_miss", rid=0, prompt_tokens=5)
        with pytest.raises(ValueError):          # rejected, not recorded
            tr.emit("step", iter=0)
        tr.end_run(run, requests=1, generated=2, wall_s=float("nan"))
    return tr


def test_traces_validate_under_both_validators(tmp_path):
    for cls, name in ((Tracer, "port"), (JTracer, "jax")):
        path = tmp_path / name / "trace.jsonl"          # dir auto-created
        tr = _write_trace(cls, path)
        lines = path.read_text().splitlines()
        port, jax_ = ev.validate_jsonl(lines), jev.validate_jsonl(lines)
        assert port == jax_ == tr.events
        assert [e["ev"] for e in port] == ["trace_start", "run_start",
                                           "submit", "cache_miss", "run_end"]
        assert port[-1]["wall_s"] is None               # sanitized
    # the file formats agree line for line but the timestamps
    strip = lambda p: [{k: v for k, v in json.loads(s).items() if k != "ts"}
                       for s in p.read_text().splitlines()]  # noqa: E731
    assert strip(tmp_path / "port" / "trace.jsonl") == \
        strip(tmp_path / "jax" / "trace.jsonl")
    assert Tracer(None).events == []


# --------------------------------------------------------------- metrics


def _record(reg):
    reg.counter("serve_tokens_total").inc(5)
    reg.counter("serve_iters_total", kind="mixed").inc(2)
    reg.counter("serve_iters_total", kind="decode").inc(7)
    reg.gauge("pool_blocks_free", pool="kv").set(3)
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(float("inf"))
    reg.histogram("empty_series")
    h = reg.histogram("iter_s")
    for v in (0.0, 0.001, 0.002, 0.004, 0.008, 0.0081, 3.5):
        h.record(v)
    e = reg.histogram("serve_ttft_s", exact=True)
    for v in np.random.default_rng(3).exponential(0.2, 40):
        e.record(float(v))
    reg.histogram("probe_recall", growth=1.1).record(0.75)
    return reg


def test_metrics_exposition_equals_jax():
    port, jax_ = _record(Registry()), _record(JRegistry())
    assert port.prometheus_text() == jax_.prometheus_text()
    assert port.snapshot() == jax_.snapshot()
    assert ev.strict_dumps(port.snapshot(), indent=2, sort_keys=True) == \
        jev.strict_dumps(jax_.snapshot(), indent=2, sort_keys=True)
    snap = port.snapshot()
    assert snap["empty_series"]["values"]["_"]["p99"] is None
    assert snap["serve_iters_total"]["values"]['{kind="mixed"}'] == 2
    lines = port.prometheus_text().splitlines()
    assert 'iter_s_bucket{le="+Inf"} 7' in lines
    assert "nan_gauge NaN" in lines and "inf_gauge +Inf" in lines


# --------------------------------------------------------------- perfetto


def _event_list():
    tr = JTracer(None)
    tr.ensure_start()
    run = tr.begin_run(requests=2)
    for rid in (0, 1):
        tr.emit("submit", rid=rid, prompt_tokens=16, max_new_tokens=4,
                arrival=0.0)
    tr.emit("cache_miss", rid=0, prompt_tokens=16)
    tr.emit("admit", rid=0, slot=0, blocks=2, resume=False)
    tr.emit("chunk_grant", rid=0, start=0, tokens=16, final=True, blocks=2)
    tr.emit("chunk_withheld", rid=1, free_blocks=0)
    tr.emit("compile", fn="mixed", seconds=0.25)
    tr.emit("first_token", rid=0, ttft_s=0.1)
    tr.emit("step", **{k: v for k, v in _step().items()
                       if k not in ("ev", "ts")})
    tr.emit("probe", iter=0, layer=1, requests=1, static_k=16, recall=0.75,
            budget_utilization=0.5, forced_share=0.9, selected_mean=8.0,
            budget_mean=16.0)
    tr.emit("preempt", rid=0, cause="decode_growth", state="decode",
            blocks_freed=2)
    tr.emit("cache_hit", rid=1, cached_tokens=8, prompt_tokens=16,
            shared_blocks=1)
    tr.emit("admit", rid=1, slot=1, blocks=2, resume=False)
    tr.emit("cow_copy", rid=1, block=3, clone=5, keep_tokens=4)
    tr.emit("page_share", rid=1, blocks=2, tail=True)
    tr.emit("cache_evict", blocks=1, remaining_blocks=3)
    tr.emit("finish", rid=1, generated=4, preemptions=0)
    tr.end_run(run, requests=2, generated=4, wall_s=0.5)
    return tr.events


def test_chrome_trace_equals_jax(tmp_path):
    events = _event_list()
    trace = perfetto.chrome_trace(events)
    assert trace == jperfetto.chrome_trace(events)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"queued", "prefill", "decode", "compile mixed", "cow copy",
            "probe_recall_l1", "chunk withheld"} <= names
    path = tmp_path / "t.jsonl"
    path.write_text("".join(ev.strict_dumps(e) + "\n" for e in events))
    out = perfetto.write_chrome_trace(str(path), str(tmp_path / "p.json"))
    assert out == trace
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads(json.dumps(trace))


# ------------------------------------------------- selection statistics

# (B, KVH, G, N, hd, length, budget mode, sparsity)
STATS_CASES = {
    "ragged_dynamic": (3, 2, 4, 96, 16, (96, 41, 7), "dynamic", 4.0),
    "ragged_static": (3, 2, 4, 96, 16, (96, 41, 7), "static", 4.0),
    "scalar_static": (2, 2, 2, 64, 8, 50, "static", 3.0),
    "covers_context": (2, 2, 2, 40, 8, (40, 23), "dynamic", 1.0),
    "tied_keys": (2, 2, 2, 64, 8, (64, 33), "dynamic", 4.0),
    "idle_slot": (3, 1, 4, 48, 8, (48, 0, 17), "dynamic", 2.0),
}


def _stats_inputs(name):
    b, kvh, g, n, hd, length, mode, sparsity = STATS_CASES[name]
    rng = np.random.default_rng(sorted(STATS_CASES).index(name))
    q = rng.standard_normal((b, kvh, g, 1, hd)).astype(np.float32)
    k = rng.standard_normal((b, kvh, n, hd)).astype(np.float32)
    if name == "tied_keys":                   # exact ties in the dense mass
        k[:, :, 1::2] = k[:, :, 0::2]
    scores = rng.standard_normal((b, kvh, n)).astype(np.float32)
    vnorm = rng.uniform(0.5, 2.0, (b, kvh, n)).astype(np.float32)
    jcfg = jsk.SocketConfig(sparsity=sparsity, sink_tokens=4,
                            window_tokens=6, min_k=8)
    kq = jsk.topk_budget(jcfg, n)
    jlen = jnp.asarray(length, jnp.int32)
    budget = jsk.dynamic_topk_budget(jcfg, jlen, kq) \
        if mode == "dynamic" else None
    idx, mask = jsk.value_aware_topk(jcfg, jnp.asarray(scores),
                                     jnp.asarray(vnorm), k=kq, length=jlen,
                                     n_total=n, budget=budget)
    return dict(q=q, k=k, vnorm=vnorm, idx=np.array(idx),
                mask=np.array(mask), length=length, budget=budget,
                kq=kq, jcfg=jcfg, scale=1.0 / math.sqrt(hd))


def _both_stats(name):
    x = _stats_inputs(name)
    jst = jax.device_get(jprobe.selection_stats(
        x["jcfg"], jnp.asarray(x["q"]), jnp.asarray(x["k"]),
        jnp.asarray(x["vnorm"]), jnp.asarray(x["idx"]),
        jnp.asarray(x["mask"]), length=jnp.asarray(x["length"], jnp.int32),
        budget=x["budget"], static_k=x["kq"], scale=x["scale"]))
    tcfg = sk.SocketConfig(sink_tokens=4, window_tokens=6)
    length = torch.tensor(x["length"]) if np.ndim(x["length"]) \
        else x["length"]
    budget = None if x["budget"] is None else \
        torch.from_numpy(np.array(x["budget"]))
    bprobe.drain()
    bprobe.emit(bprobe.selection_stats(
        tcfg, torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
        torch.from_numpy(x["vnorm"]), torch.from_numpy(x["idx"]).long(),
        torch.from_numpy(x["mask"]), length=length, budget=budget,
        static_k=x["kq"], scale=x["scale"]))
    (tst,) = bprobe.drain()
    return x, jst, tst


def _cutoff_tied(x, row):
    """True where, in every KV head of batch row ``row``, the float64
    dense mass at rank m - 1 and rank m (m = the realized selection
    count) agree within TIE_RTOL: the top-m set is then fixed only up to
    float32 rounding."""
    q, k = x["q"][row].astype(np.float64), x["k"][row].astype(np.float64)
    n = k.shape[1]
    length = np.broadcast_to(np.asarray(x["length"]), (x["q"].shape[0],))
    logits = np.einsum("hgtd,hnd->hgtn", q, k) * x["scale"]
    logits[..., np.arange(n) >= length[row]] = -np.inf
    w = np.exp(logits - logits.max(-1, keepdims=True))
    mass = (w / w.sum(-1, keepdims=True)).sum(axis=(1, 2))      # (KVH, N)
    for h in range(mass.shape[0]):
        m = int(x["mask"][row, h].sum())
        s = np.sort(mass[h])[::-1]
        if m < n and not np.isclose(s[m - 1], s[m], rtol=TIE_RTOL, atol=0):
            return False
    return True


@pytest.mark.parametrize("name", sorted(STATS_CASES))
def test_selection_stats_match_jax(name):
    x, jst, tst = _both_stats(name)
    for key in ("budget_utilization", "forced_share", "selected", "budget"):
        np.testing.assert_array_equal(tst[key], np.asarray(jst[key]),
                                      err_msg=key)
        assert tst[key].dtype == np.float32, key
    assert tst["static_k"] == int(jst["static_k"]) == x["kq"]
    diff = np.abs(tst["recall"] - np.asarray(jst["recall"]))
    for row in np.nonzero(diff > 1e-6)[0]:
        assert _cutoff_tied(x, row), (name, row, diff[row])
    if name == "covers_context":
        live = np.asarray(x["length"]) > 0
        np.testing.assert_array_equal(tst["recall"][live], 1.0)


def test_selection_probe_rows_and_summary_match_jax():
    """Both packages' samplers fed the same drained stats (port's) and
    the same active slots give the same rows and summary."""
    port, jax_ = sprobe.SelectionProbe(every=2), \
        jsprobe.SelectionProbe(every=2)
    assert [port.due(i) for i in range(5)] == [jax_.due(i) for i in
                                               range(5)]
    for it, name in enumerate(("ragged_dynamic", "idle_slot")):
        _, jst, tst = _both_stats(name)
        slots = [0, 2]
        assert port.add(it, [tst, tst], slots) == \
            jax_.add(it, [tst, tst], slots)
    assert port.rows == jax_.rows and len(port.rows) == 4
    assert port.summary() == jax_.summary()
    assert sprobe.SelectionProbe().summary() == \
        jsprobe.SelectionProbe().summary()
    assert not sprobe.SelectionProbe(every=0).due(0)


def test_drain_keeps_layer_order_and_empties():
    bprobe.drain()
    assert not bprobe.capturing()
    with bprobe.capture():
        assert bprobe.capturing()
        for layer in range(3):
            bprobe.emit({"recall": torch.full((2,), float(layer)),
                         "static_k": 8})
    assert not bprobe.capturing()
    out = bprobe.drain()
    assert [float(st["recall"][0]) for st in out] == [0.0, 1.0, 2.0]
    assert all(st["static_k"] == 8 for st in out)
    assert isinstance(out[0]["recall"], np.ndarray)
    assert bprobe.drain() == []


# --------------------------------------------------------------- profiler


def test_profiler_window_on_cpu(tmp_path):
    """A 2-iteration window from iteration 1: profile_start/profile_stop
    events, the Chrome trace written with the record_function names that
    fell in the window, a null context outside it, one window a run."""
    tracer = Tracer(None)
    prof = Profiler(str(tmp_path / "prof"), steps=2, start_step=1)
    assert prof.activities() == [torch.profiler.ProfilerActivity.CPU]
    prof.device = torch.device("cuda")        # inferred, never probed for
    assert torch.profiler.ProfilerActivity.CUDA in prof.activities()
    prof.device = torch.device("cpu")
    x = torch.ones(8)
    assert isinstance(prof.annotate("decode"), contextlib.nullcontext)
    for it, name in enumerate(["decode", "mixed", "probe", "decode",
                               "outside"]):
        prof.maybe_start(it, tracer)
        assert prof.active == (it in (1, 2))
        with prof.annotate(name):
            torch.add(x, it)
        prof.maybe_stop(it + 1, tracer)
    prof.stop(tracer)                          # idempotent
    assert [e["ev"] for e in tracer.events] == ["profile_start",
                                                "profile_stop"]
    assert tracer.events[0]["steps"] == 2
    trace = json.loads((tmp_path / "prof" / "engine.trace.json")
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"mixed", "probe"} <= names
    assert not {"decode", "outside"} & names
    prof.maybe_start(10, tracer)               # one window a run
    assert not prof.active


def test_observability_bundle():
    obs = Observability(probe_every=3)
    assert obs.profiler is None and obs.probe.every == 3
    assert obs.tracer.path is None
    assert obs.probe_summary()["rows"] == 0
    with Observability(profile_dir="d", profile_steps=5,
                       profile_start_step=2) as o:
        assert (o.profiler.steps, o.profiler.start_step) == (5, 2)


# -------------------------------------------------------------------- CLI


def test_serve_cli_observability_flags(tmp_path, capsys):
    """The continuous CLI on the CPU writes a trace both validators
    accept, a Chrome trace, strict-JSON and Prometheus metrics and a
    torch.profiler window, and reports the probe summary."""
    from repro_torch.launch.serve import main
    t, p, j, m = (str(tmp_path / n) for n in
                  ("t.jsonl", "p.json", "m.json", "m.prom"))
    main(["--arch", "llama31-8b", "--smoke", "--device", "cpu", "--engine",
          "continuous", "--backend", "socket_fused", "--num-requests", "3",
          "--max-new-tokens", "4", "--trace", t, "--perfetto", p,
          "--metrics-json", j, "--metrics-prom", m, "--probe-every", "2",
          "--profile-dir", str(tmp_path / "prof"), "--profile-steps", "2"])
    report = ev.strict_loads(capsys.readouterr().out)
    assert report["finished"] == 3 and report["probe"]["rows"] > 0
    assert validate.main([t, "--json", j, "--perfetto",
                          str(tmp_path / "p2.json")]) == 0
    assert jvalidate.main([t]) == 0
    out = capsys.readouterr().out
    assert out.count(f"OK {t}: ") == 2
    assert (tmp_path / "prof" / "engine.trace.json").exists()
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "p2.json").read_text())
    assert open(m).read().startswith("# TYPE ")
    assert validate.main([str(tmp_path / "p.json")]) == 1   # not a trace


def _cli_error(call, capsys):
    """The message of the usage error ``call()`` exits with."""
    with pytest.raises(SystemExit) as exc:
        call()
    assert exc.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--engine", "continuous", "--perfetto", "p.json"],
    ["--trace", "t.jsonl"],
    ["--probe-every", "2"],
    ["--metrics-prom", "m.prom", "--engine", "static"],
])
def test_serve_cli_flag_errors_match_jax(argv, monkeypatch, capsys):
    import sys

    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main
    argv = ["--arch", "llama31-8b", "--smoke"] + argv
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)   # JAX's reads it
    assert _cli_error(lambda: main(argv), capsys) == \
        _cli_error(jmain, capsys)


def test_validate_cli_errors_match_jax(monkeypatch, capsys, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"x": NaN}')
    assert validate.main(["--json", str(bad)]) == \
        jvalidate.main(["--json", str(bad)]) == 1
    for argv in ([], ["--perfetto", "out.json", "--json", str(bad)]):
        assert _cli_error(lambda: validate.main(argv), capsys) == \
            _cli_error(lambda: jvalidate.main(argv), capsys)
