"""Port parity for the continuous-batching engine: greedy tokens of the
port's ``ContinuousBatchingEngine`` against the JAX package's engine on
the same weights and prompts (``stablelm-12b`` and ``llama31-8b``
``.smoke()``; backends ``socket``, ``socket_fused`` and ``dense``), with
mixed prompt lengths and under forced preemption, and against the
port's own static ``run_serve``.  The JAX side's ``socket_fused`` runs
the Pallas paged kernel in interpret mode; the port's runs its plain
version on the CPU.

Tolerance: greedy tokens equal (argmax of float32 logits that agree to
~1e-6).
"""

import json

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
from repro_torch.configs import LayerSpec
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import apply_backend_arg, main, run_serve
from repro_torch.models.weights import from_jax_params
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine

BACKENDS = ["socket", "socket_fused", "dense"]


def _configs(arch, backend, **serving):
    jc = japply(jget(arch).smoke(), backend)
    tc = apply_backend_arg(tget(arch).smoke(), backend)
    if serving:
        jc = jc.replace(serving=jc.serving.replace(**serving))
        tc = tc.replace(serving=tc.serving.replace(**serving))
    return jc, tc


def _params(jc, tc, seed=0):
    jparams = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(seed)))
    return jparams, from_jax_params(
        tc, jax.tree_util.tree_map(np.asarray, jparams))


def _serve_both(jc, tc, prompts, max_new):
    jparams, tparams = _params(jc, tc)
    jreqs = [JRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    jm = JEngine(jc, params=jparams).run(jreqs, realtime=False)
    engine = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    treqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    tm = engine.run(treqs, realtime=False)
    return (jreqs, jm), (treqs, tm), engine


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ["stablelm-12b", "llama31-8b"])
def test_mixed_lengths_match_jax_engine(arch, backend):
    """Prompts of 5 to 50 tokens (one to four chunks of 16, padded final
    chunks, a block boundary mid-decode): every request's greedy tokens,
    the iteration and chunk counts equal the JAX engine's, and no
    iteration co-runs more than one chunk."""
    jc, tc = _configs(arch, backend)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 21, 37, 50)]
    (jreqs, jm), (treqs, tm), engine = _serve_both(jc, tc, prompts, 6)
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == 6
        assert t.generated == j.generated, (t.generated, j.generated)
    assert (tm.decode_iters, tm.prefill_chunks) == (jm.decode_iters,
                                                    jm.prefill_chunks)
    iters = [it for it, *_ in engine.chunk_trace]
    assert len(iters) == len(set(iters)) == tm.prefill_chunks
    assert engine.pool.num_used == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_preemption_matches_jax_engine(backend):
    """A pool too small for the working set (8 usable blocks, two
    requests growing to 5 each) forces recompute preemption; the resumed
    requests replay their recorded tokens and finish token-exact, equal
    to the JAX engine under the same pressure and to an unpressured
    pool."""
    jc, tc = _configs("stablelm-12b", backend, num_blocks=9, max_batch=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, 16).tolist() for _ in range(2)]
    (jreqs, jm), (treqs, tm), engine = _serve_both(jc, tc, prompts, 24)
    assert tm.preemptions > 0 and tm.preemptions == jm.preemptions
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == 24
        assert t.generated == j.generated
    assert engine.pool.num_used == 0
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=engine.params, device="cpu")
    creqs = [Request(prompt=p, max_new_tokens=24) for p in prompts]
    assert calm.run(creqs, realtime=False).preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_matches_own_static_engine(backend):
    """Same-length requests through the paged engine reproduce the port's
    static lockstep engine token for token (the socket_fused static run
    takes the contiguous socket path: the same selection)."""
    jc, tc = _configs("llama31-8b", backend)
    static_cfg = apply_backend_arg(tget("llama31-8b").smoke(), "socket") \
        if backend == "socket_fused" else tc
    _, params = _params(jc, tc)
    prompts = np.random.default_rng(0).integers(0, 256, (3, 24))
    static, _, _ = run_serve(static_cfg, 3, 24, 8, prompt=prompts,
                             params=params, device="cpu")
    engine = ContinuousBatchingEngine(tc, params=params, device="cpu")
    reqs = [Request(prompt=p.tolist(), max_new_tokens=9) for p in prompts]
    engine.run(reqs, realtime=False)
    assert [r.generated for r in reqs] == static.tolist()


def test_engine_raises_for_unported_parts():
    _, tc = _configs("llama31-8b", "socket_fused")
    cases = [
        (tc.replace(serving=tc.serving.replace(prefix_cache=True)), {},
         "item 8"),
        (tc, dict(temperature=0.7), "item 8"),
        (tc, dict(obs=object()), "item 9"),
        (tc.replace(pattern=(LayerSpec(kind="mamba", mlp="none"),)), {},
         "item 7"),
        (tc.replace(pattern=(LayerSpec(attn_type="local", mlp="moe"),)), {},
         "item 7"),
    ]
    for cfg, kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            ContinuousBatchingEngine(cfg, device="cpu", **kw)
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(tc.replace(attention_backend="flashinfer"),
                                 device="cpu")
    # quantized pages are ported; what the dtype matrix refuses raises
    # ValueError at construction, as in the JAX package
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(tc.replace(
            serving=tc.serving.replace(kv_dtype="int4")), device="cpu")
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine(tc.replace(
            attention_backend="dense",
            serving=tc.serving.replace(kv_dtype="fp8")), device="cpu")
    with pytest.raises(ValueError, match="not in"):
        apply_backend_arg(tc, "flashinfer_fused")


def test_engine_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour does "
                    "not apply")
    _, tc = _configs("llama31-8b", "socket_fused")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(tc)


def test_continuous_cli_cpu_rehearsal(capsys):
    main(["--arch", "llama31-8b", "--smoke", "--device", "cpu", "--engine",
          "continuous", "--backend", "socket_fused", "--num-requests", "3",
          "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 3
    assert out["total_generated"] == 12 and out["prefill_chunks"] > 0
    assert out["engine"] == "continuous" and out["device"] == "cpu"


def test_iter_hook_return_ends_the_run():
    """A true return from ``iter_hook`` ends the run after that iteration
    (how ``profile_decode.py`` stops at the full decode batch); the
    requests still in flight keep their state."""
    _, tc = _configs("llama31-8b", "socket_fused")
    engine = ContinuousBatchingEngine(tc, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, 256, n).tolist(),
                    max_new_tokens=8) for n in (5, 21)]
    seen = []

    def hook(eng, it):
        seen.append(it)
        return len(eng.scheduler.running) == len(reqs)

    engine.iter_hook = hook
    m = engine.run(reqs, realtime=False)
    assert seen and seen[-1] == m.decode_iters == len(seen)
    assert all(r.state != FINISHED for r in reqs)
    assert 0 < m.total_generated < 16


def test_card_continuous_case():
    """The continuous case chip_smoke.py and profile_decode.py run on the
    card: socket_fused, 8 requests of 1024-4096 seeded prompt tokens, a
    pool that needs no preemption, and a ValueError where it would."""
    from repro_torch.launch.serve import card_continuous_case
    cfg, reqs = card_continuous_case(tget("llama31-8b"), 0, 64)
    assert cfg.attention_backend == "socket" and cfg.socket.use_paged_kernel
    cfg.serving.validate()
    assert [len(r.prompt) for r in reqs] == [1024, 2048, 3072, 4096] * 2
    assert all(r.max_new_tokens == 64 for r in reqs)
    _, again = card_continuous_case(tget("llama31-8b"), 0, 32)
    assert [r.prompt for r in again] == [r.prompt for r in reqs]
    with pytest.raises(ValueError, match="preemption"):
        card_continuous_case(tget("llama31-8b"), 0, 200)
