"""Port parity for the continuous engine's observability, on the CPU.

* Against the JAX engine (``llama31-8b .smoke()``; ``socket``,
  ``hard_lsh`` and ``quest``, both engines on their plain routes, the
  probe every 2 iterations): with the timestamps, the other timing fields
  and the ``compile`` events dropped, the port's event trace equals the
  JAX engine's event for event and field for field (request ids taken
  by submission order), the probe rows but ``recall`` exactly, ``recall``
  within 1e-6; the ``compile`` tags are the same set; the trace
  validates under both packages' validators.
* On the port alone, for the three fused backends on f32 and int8 pages
  and with the prefix cache on: the probe every iteration leaves the
  greedy tokens and, across each shadow step, the whole pool bitwise as
  they are without it; a sampling engine's tokens and draw indices do
  not move either; a ``torch.profiler`` window records the engine's
  ``mixed``/``decode``/``probe`` spans.
* ``obs=None`` constructs no tracer, probe or profiler; with the budget
  covering the context the probe's recall is exactly 1; the prefix
  cache's events reach the trace.

Tolerances: events equal; ``recall`` within 1e-6 (the dense reference's
float32 softmax sums in another order, see
``tests/test_torch_observability.py``); tokens and pools bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro.serving.obs import Observability as JObservability
from repro.serving.obs import events as jev
from repro.serving.obs import perfetto as jperfetto
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.obs import Observability
from repro_torch.serving.obs import events as ev
from repro_torch.serving.obs import perfetto
from test_torch_engine import _configs, _params

TIMING = {"ts", "step_s", "ttft_s", "wall_s", "seconds", "wait_s"}
PROMPT_LENS = (5, 21, 37)
MAX_NEW = 6


def _prompts(seed=11, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _comparable(events, reqs):
    """The events with the timing fields and ``compile`` events dropped
    and request ids replaced by submission order."""
    order = {r.rid: i for i, r in enumerate(reqs)}
    out = []
    for e in events:
        if e["ev"] == "compile":
            continue
        e = {k: v for k, v in e.items() if k not in TIMING}
        if e.get("rid", -1) != -1:
            e["rid"] = order[e["rid"]]
        out.append(e)
    return out


@pytest.fixture(scope="module", params=["socket", "hard_lsh", "quest"])
def traced_pair(request, tmp_path_factory):
    """The same requests through the JAX engine and the port's, each
    traced to a file with the probe every 2 iterations."""
    jc, tc = _configs("llama31-8b", request.param)
    jparams, tparams = _params(jc, tc)
    prompts = _prompts()
    out = {"backend": request.param}
    tmp = tmp_path_factory.mktemp(f"obs_{request.param}")
    for side, cls, eng, req, cfg, params in (
            ("jax", JObservability, JEngine, JRequest, jc, jparams),
            ("port", Observability, ContinuousBatchingEngine, Request, tc,
             tparams)):
        path = tmp / f"{side}.jsonl"
        obs = cls(str(path), probe_every=2)
        kw = {"device": "cpu"} if side == "port" else {}
        engine = eng(cfg, params=params, obs=obs, **kw)
        reqs = [req(prompt=p, max_new_tokens=MAX_NEW, arrival=0.0)
                for p in prompts]
        metrics = engine.run(reqs, realtime=False)
        obs.close()
        out[side] = dict(path=path, obs=obs, reqs=reqs, metrics=metrics,
                         engine=engine)
    return out


def test_trace_equals_jax_engine(traced_pair):
    j, t = traced_pair["jax"], traced_pair["port"]
    assert [r.generated for r in t["reqs"]] == \
        [r.generated for r in j["reqs"]]
    lines = t["path"].read_text().splitlines()
    events = ev.validate_jsonl(lines)
    assert events == jev.validate_jsonl(lines) == t["obs"].tracer.events
    assert ev.validate_jsonl(j["path"].read_text().splitlines()) == \
        j["obs"].tracer.events
    got = _comparable(events, t["reqs"])
    want = _comparable(j["obs"].tracer.events, j["reqs"])
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    for g, w in zip(got, want):
        if g["ev"] == "probe":
            assert abs(g.pop("recall") - w.pop("recall")) <= 1e-6, (g, w)
        assert g == w
    kinds = {e["ev"] for e in got}
    assert {"trace_start", "run_start", "submit", "admit", "chunk_grant",
            "first_token", "step", "probe", "finish", "run_end"} <= kinds
    assert events[0]["backend"] == traced_pair["backend"]
    assert events[0]["layers_paged"] == len(t["engine"].cfg.layer_specs)
    steps = [e for e in events if e["ev"] == "step"]
    assert [e["iter"] for e in steps] == \
        list(range(t["metrics"].decode_iters))


def test_compile_tags_and_probe_rows_match_jax(traced_pair):
    j, t = traced_pair["jax"], traced_pair["port"]
    tags = lambda o: {e["fn"] for e in o["obs"].tracer.events  # noqa: E731
                      if e["ev"] == "compile"}
    assert tags(t) == tags(j) == {"mixed", "decode", "probe"}
    rows, jrows = t["obs"].probe.rows, j["obs"].probe.rows
    assert len(rows) == len(jrows) > 0
    layers = len(t["engine"].cfg.layer_specs)
    assert {r["layer"] for r in rows} == set(range(layers))
    for r, w in zip(rows, jrows):
        assert abs(r["recall"] - w["recall"]) <= 1e-6
        assert {k: v for k, v in r.items() if k != "recall"} == \
            {k: v for k, v in w.items() if k != "recall"}
        assert 0.0 <= r["recall"] <= 1.0
        assert 0.0 < r["budget_utilization"] <= 1.0
        assert 0 < r["selected_mean"] <= r["budget_mean"] <= r["static_k"]
    summary = t["obs"].probe_summary()
    assert summary["rows"] == len(rows)
    assert abs(summary["recall"] - j["obs"].probe_summary()["recall"]) \
        <= 1e-6
    reg = t["engine"].registry
    assert reg.histogram("probe_recall").count == len(rows)
    assert reg.get("pool_blocks_used").value == 0
    assert reg.prometheus_text().startswith("# TYPE")
    json.dumps(reg.snapshot(), allow_nan=False)
    # the exporter gives JAX's Chrome trace on the port's events
    assert perfetto.chrome_trace(t["obs"].tracer.events) == \
        jperfetto.chrome_trace(t["obs"].tracer.events)


# ------------------------------------------ the probe leaves serving alone


def _pool_bytes(pages):
    return [{k: v.view(torch.uint8).clone() for k, v in layer.items()}
            for layer in pages]


def _assert_pool_equal(a, b, where):
    for i, (la, lb) in enumerate(zip(a, b)):
        for name in la:
            assert torch.equal(la[name], lb[name]), (where, i, name)


def _spy_probe(engine):
    """Wrap ``engine._run_probe``: the whole pool is snapshot before each
    shadow step and must be bitwise the same after it."""
    inner = engine._run_probe
    calls = []

    def run_probe(*args):
        before = _pool_bytes(engine.pages)
        out = inner(*args)
        _assert_pool_equal(before, _pool_bytes(engine.pages),
                           f"probe at iteration {args[0]}")
        calls.append(args[0])
        return out

    engine._run_probe = run_probe
    return calls


INVARIANT = [(b, mode) for b in ("socket_fused", "hard_lsh_fused",
                                 "quest_fused")
             for mode in ("auto", "int8", "prefix")]


def _serve_batches(engine, batches):
    out = []
    for prompts in batches:
        reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW)
                for p in prompts]
        engine.run(reqs, realtime=False)
        assert all(r.state == FINISHED for r in reqs)
        out.append(reqs)
    return out


@pytest.mark.parametrize("backend,mode", INVARIANT,
                         ids=[f"{b}-{m}" for b, m in INVARIANT])
def test_probe_every_step_is_bit_exact(backend, mode, tmp_path):
    """The probe at every iteration: greedy tokens equal an ``obs=None``
    run's and each shadow step leaves the pool bitwise as it found it
    (Quest's page bounds included).  ``prefix``: the prefix cache on, a
    warm engine serving a prompt that extends a finished one past its
    tail page (a hit, and for SOCKET and hard LSH a copy-on-write
    clone)."""
    serving = {"kv_dtype": "int8"} if mode == "int8" else \
        {"prefix_cache": True} if mode == "prefix" else {}
    _, tc = _configs("llama31-8b", backend, **serving)
    batches = [_prompts()]
    if mode == "prefix":
        rng = np.random.default_rng(11)
        first = rng.integers(0, 256, 21).tolist()
        batches = [[first, _prompts(3, (9,))[0]],
                   [first + rng.integers(0, 256, 11).tolist()]]
    bare = ContinuousBatchingEngine(tc, device="cpu")
    want = _serve_batches(bare, batches)
    # the window: iteration 5, the last prompt chunk's mixed step (and a
    # probe), and 6, the first decode-only step
    profile = backend == "socket_fused" and mode == "auto"
    obs = Observability(probe_every=1, profile_steps=2, profile_start_step=5,
                        profile_dir=str(tmp_path / "prof") if profile
                        else None)
    engine = ContinuousBatchingEngine(tc, params=bare.params, device="cpu",
                                      obs=obs)
    calls = _spy_probe(engine)
    got = _serve_batches(engine, batches)
    for g, w in zip(got, want):
        assert [r.generated for r in g] == [r.generated for r in w]
    assert len(calls) == len(obs.probe.rows) // tc.num_layers > 0
    _assert_pool_equal(_pool_bytes(engine.pages), _pool_bytes(bare.pages),
                       "end of run")
    if mode == "prefix":
        reg = engine.registry
        assert reg.value("prefix_cache_hits_total") == 1
        assert reg.value("prefix_cache_cow_total") == \
            (0 if backend == "quest_fused" else 1)
    if profile:
        kinds = [e["ev"] for e in obs.tracer.events]
        assert kinds.count("profile_start") == kinds.count(
            "profile_stop") == 1
        trace = json.loads((tmp_path / "prof" / "engine.trace.json")
                           .read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"mixed", "decode", "probe"} <= names


def test_probe_draws_no_noise():
    """A sampling engine (temperature 0.8, top-p 0.9) with the probe at
    every iteration gives the same tokens at the same draw indices."""
    _, tc = _configs("llama31-8b", "socket_fused")
    runs = []
    for obs in (None, Observability(probe_every=1)):
        engine = ContinuousBatchingEngine(tc, device="cpu",
                                          temperature=0.8, top_p=0.9,
                                          sample_seed=5, obs=obs)
        reqs = [Request(prompt=p, max_new_tokens=MAX_NEW)
                for p in _prompts()]
        engine.run(reqs, realtime=False)
        runs.append([(r.generated, r.sample_key.emitted,
                      r.sample_key.draws) for r in reqs])
        if obs is not None:
            assert obs.probe.rows
    assert runs[0] == runs[1]


# ---------------------------------------------------------- other contracts


def test_disabled_path_constructs_no_tracing_objects(monkeypatch):
    from repro_torch.serving.obs import probe as obs_probe
    from repro_torch.serving.obs import profiling, tracing

    def boom(self, *a, **kw):
        raise AssertionError("tracing object constructed with obs=None")

    monkeypatch.setattr(tracing.Tracer, "__init__", boom)
    monkeypatch.setattr(obs_probe.SelectionProbe, "__init__", boom)
    monkeypatch.setattr(profiling.Profiler, "__init__", boom)
    _, tc = _configs("llama31-8b", "socket_fused")
    engine = ContinuousBatchingEngine(tc, device="cpu")
    reqs = [Request(prompt=_prompts()[0], max_new_tokens=MAX_NEW)]
    engine.run(reqs, realtime=False)
    assert reqs[0].state == FINISHED and len(reqs[0].generated) == MAX_NEW
    assert engine.obs is None


def test_probe_recall_is_one_when_budget_covers_context():
    """sparsity 1: the budget equals the context length, so the
    selection holds every valid position: recall exactly 1, the budget
    fully used."""
    import dataclasses
    _, tc = _configs("stablelm-12b", "socket_fused")
    tc = tc.replace(socket=dataclasses.replace(tc.socket, sparsity=1.0,
                                               min_k=8))
    obs = Observability(probe_every=1)
    engine = ContinuousBatchingEngine(tc, device="cpu", obs=obs)
    engine.run([Request(prompt=p, max_new_tokens=MAX_NEW)
                for p in _prompts(7, (8, 20))], realtime=False)
    assert obs.probe.rows
    for row in obs.probe.rows:
        assert row["recall"] == 1.0, row
        assert row["selected_mean"] == row["budget_mean"], row
        assert row["budget_utilization"] == pytest.approx(
            row["selected_mean"] / row["static_k"], abs=1e-6), row


def test_trace_carries_cache_events_and_validates(tmp_path):
    """The prefix cache's events reach the engine's trace: a hit, a
    miss, shared pages and a copy-on-write clone, in a trace both
    validators accept and the Chrome exporter renders."""
    _, tc = _configs("stablelm-12b", "socket", prefix_cache=True)
    rng = np.random.default_rng(17)
    first = rng.integers(0, tc.vocab_size, size=21).tolist()
    ext = first + rng.integers(0, tc.vocab_size, size=11).tolist()
    path = tmp_path / "trace.jsonl"
    obs = Observability(str(path))
    engine = ContinuousBatchingEngine(tc, device="cpu", obs=obs)
    for prompt in (first, ext):
        engine.run([Request(prompt=prompt, max_new_tokens=5)],
                   realtime=False)
    obs.close()
    lines = path.read_text().splitlines()
    evs = ev.validate_jsonl(lines)
    assert evs == jev.validate_jsonl(lines)
    kinds = {e["ev"] for e in evs}
    assert {"cache_hit", "cache_miss", "page_share", "cow_copy"} <= kinds
    assert evs[0]["prefix_cache"] is True
    assert [e["run"] for e in evs if e["ev"] == "run_start"] == [0, 1]
    assert "cow_clone" in {e["fn"] for e in evs if e["ev"] == "compile"}
    trace = perfetto.write_chrome_trace(str(path), str(tmp_path / "c.json"))
    names = {t.get("name", "") for t in trace["traceEvents"]}
    assert any(n.startswith("cache hit") for n in names)
    assert "cow copy" in names
