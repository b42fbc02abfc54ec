"""Port parity for the continuous engine on Mamba state layers and MoE
layers: greedy tokens of the port's ``ContinuousBatchingEngine`` against
the JAX package's engine on the same weights and prompts.

* jamba's smoke (1:7 attention : Mamba, MoE every other layer) at one
  group with dropless MoE (``capacity_factor = num_experts``, as the JAX
  package's ``test_chunked_prefill.py`` does), through ``socket_fused``
  (the paged SOCKET kernel's plain version here, Pallas interpret mode on
  the JAX side) and ``dense`` (the gather/scatter fallback), chunked and
  legacy whole-prompt prefill;
* mamba2's smoke (state layers only): the pool holds zero blocks;
* mixtral's smoke (MoE on sliding-window ring layers, the ring kernel's
  plain version);
* jamba under forced preemption: resumed requests re-prefill their state
  from zeros and finish token-exact, equal to JAX and to a calm pool.

And the port alone: chunked prefill equal to whole-bucket prefill on
jamba; the prefix cache falling back to no sharing on jamba (state is per
slot, not per page); the selection probe at every iteration leaving a
jamba run's tokens and every state row bitwise unchanged.

Tolerance: greedy tokens equal (argmax of float32 logits that agree to
~1e-6); iteration and chunk counts equal; pool blocks in use exact.
"""

import numpy as np
import pytest

import jax
import torch

from repro.configs import get_config as jget
from repro.launch.serve import apply_backend_arg as japply
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import apply_backend_arg
from repro_torch.models.weights import from_jax_params
from repro_torch.serving import FINISHED, Request, paged
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.obs import Observability

from test_torch_smoke_checks import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _configs(arch, backend, ring=False, **serving):
    jc = japply(jget(arch).smoke(), backend)
    tc = apply_backend_arg(tget(arch).smoke(), backend)
    if arch == "jamba-v0.1-52b":
        jc = jc.replace(num_groups=1, capacity_factor=float(jc.num_experts))
        tc = tc.replace(num_groups=1, capacity_factor=float(tc.num_experts))
    if ring:
        jc, tc = (c.replace(use_ring_kernel=True) for c in (jc, tc))
    if serving:
        jc = jc.replace(serving=jc.serving.replace(**serving))
        tc = tc.replace(serving=tc.serving.replace(**serving))
    return jc, tc


def _params(jc, tc, seed=0):
    jparams = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(seed)))
    return jparams, from_jax_params(
        tc, jax.tree_util.tree_map(np.asarray, jparams))


def _prompts(lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _run(engine, prompts, max_new, cls=Request):
    reqs = [cls(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    return reqs, engine.run(reqs, realtime=False)


def _serve_both(jc, tc, prompts, max_new):
    jparams, tparams = _params(jc, tc)
    jreqs, jm = _run(JEngine(jc, params=jparams), prompts, max_new,
                     JRequest)
    engine = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    treqs, tm = _run(engine, prompts, max_new)
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == max_new
        assert t.generated == j.generated, (t.generated, j.generated)
    assert (tm.decode_iters, tm.prefill_chunks, tm.preemptions) == \
        (jm.decode_iters, jm.prefill_chunks, jm.preemptions)
    assert engine.pool.num_used == 0
    return treqs, tm, engine


JAMBA_CASES = [(b, c) for b in ("socket_fused", "dense") for c in (16, 0)]


@pytest.mark.parametrize("backend,chunk", JAMBA_CASES,
                         ids=[f"{b}-{'chunked' if c else 'legacy'}"
                              for b, c in JAMBA_CASES])
def test_jamba_matches_jax_engine(backend, chunk):
    """Prompts of 5 to 44 tokens (one to three chunks, padded final
    chunks; in legacy mode buckets of 24 to 64, so every prompt runs
    padded), 6 greedy tokens: tokens, iterations and chunks equal the
    JAX engine's; the 7 Mamba layers' state rows are the only state."""
    jc, tc = _configs("jamba-v0.1-52b", backend, prefill_chunk=chunk)
    kinds = [p.kind for p in tc.cache_plan()]
    assert kinds.count("state") == 7 and kinds.count("paged") == 1
    _serve_both(jc, tc, _prompts((5, 21, 44)), 6)


def test_mamba2_matches_jax_engine_with_zero_blocks():
    """State layers only: admission on free decode slots alone, zero pool
    blocks held at every iteration, tokens equal the JAX engine's."""
    jc, tc = _configs("mamba2-780m", "socket_fused")
    used = []
    jparams, tparams = _params(jc, tc)
    engine = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    engine.iter_hook = lambda eng, it: used.append(eng.pool.num_used)
    prompts = _prompts((7, 30, 19, 40, 12))
    treqs, tm = _run(engine, prompts, 5)
    jreqs, jm = _run(JEngine(jc, params=jparams), prompts, 5, JRequest)
    assert engine.scheduler.has_paged_layers is False
    assert used and set(used) == {0}
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.blocks == [] for r in treqs)
    assert tm.decode_iters == jm.decode_iters


def test_mixtral_moe_on_ring_layers_matches_jax_engine():
    """MoE FFNs on sliding-window layers, the rings through the ring
    kernel's plain version, prompts past the 32-token window."""
    jc, tc = _configs("mixtral-8x22b", "socket_fused", ring=True)
    assert {p.kind for p in tc.cache_plan()} == {"ring"}
    _serve_both(jc, tc, _prompts((9, 40, 26)), 8)


@pytest.mark.parametrize("chunk", [16, 0], ids=["chunked", "legacy"])
def test_jamba_preemption_resume_matches_jax(chunk):
    """A pool too small for the working set forces recompute preemption:
    resumed requests re-prefill their Mamba state from zeros and replay
    their tokens, equal to the JAX engine under the same pressure and to
    a calm pool."""
    jc, tc = _configs("jamba-v0.1-52b", "socket_fused", num_blocks=9,
                      max_batch=2, prefill_chunk=chunk)
    prompts = _prompts((16, 16), seed=2)
    treqs, tm, engine = _serve_both(jc, tc, prompts, 24)
    assert tm.preemptions > 0
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=engine.params, device="cpu")
    creqs, cm = _run(calm, prompts, 24)
    assert cm.preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def test_jamba_chunked_equals_whole_bucket():
    """Chunks of ``ssm_chunk`` tokens land on the SSD grid: chunked
    prefill carries the state across chunks as the whole-bucket prefill
    builds it, and the greedy tokens agree."""
    _, tc = _configs("jamba-v0.1-52b", "socket_fused")
    params = ContinuousBatchingEngine(tc, device="cpu").params
    prompts = _prompts((7, 23, 40, 50), seed=4)
    out = []
    for chunk in (16, 0):
        cfg = tc.replace(serving=tc.serving.replace(prefill_chunk=chunk))
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu")
        reqs, m = _run(engine, prompts, 6)
        assert (m.prefill_chunks > 0) == (chunk > 0)
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]


def test_jamba_prefix_cache_falls_back_to_no_sharing():
    """Mamba state is per slot, not per page: the flag stays on, no cache
    is built, and the tokens equal a cache-off run's."""
    _, tc = _configs("jamba-v0.1-52b", "socket_fused", prefix_cache=True)
    engine = ContinuousBatchingEngine(tc, device="cpu")
    assert engine.prefix_cache is None and tc.serving.prefix_cache
    base = _prompts((20,), seed=5)[0]
    prompts = [base, base + [1, 2, 3]]
    reqs, _ = _run(engine, prompts, 5)
    off = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(prefix_cache=False)),
        params=engine.params, device="cpu")
    oreqs, _ = _run(off, prompts, 5)
    assert [r.generated for r in reqs] == [r.generated for r in oreqs]


def _state_bytes(engine):
    return [leaf.view(torch.uint8).clone()
            for leaf in paged.state_leaves(engine.cfg, engine.pages)]


def test_jamba_probe_leaves_tokens_and_state_rows_alone():
    """The selection probe at every iteration on jamba: its shadow step
    moves every Mamba slot row on, and the engine puts them back, so
    each probe leaves every state row bitwise as it found it, and the
    run's tokens and final state rows equal an unprobed run's."""
    _, tc = _configs("jamba-v0.1-52b", "socket_fused")
    prompts = _prompts((9, 30, 21), seed=6)
    bare = ContinuousBatchingEngine(tc, device="cpu")
    want, _ = _run(bare, prompts, 6)
    obs = Observability(probe_every=1)
    engine = ContinuousBatchingEngine(tc, params=bare.params, device="cpu",
                                      obs=obs)
    inner, calls = engine._run_probe, []

    def run_probe(*args):
        before = _state_bytes(engine)
        out = inner(*args)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, _state_bytes(engine)))
        calls.append(args[0])
        return out

    engine._run_probe = run_probe
    got, _ = _run(engine, prompts, 6)
    assert calls and obs.probe.rows
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(torch.equal(a, b) for a, b in
               zip(_state_bytes(engine), _state_bytes(bare)))
