"""Port parity for the paper's two baselines through the engines: greedy
tokens of the port's ``ContinuousBatchingEngine`` against the JAX
package's engine on the same weights and prompts (``llama31-8b
.smoke()``; backends ``hard_lsh``, ``hard_lsh_fused``, ``quest`` and
``quest_fused``), with mixed prompt lengths and, for the fused names,
under forced preemption; and the static ``run_serve`` against the JAX
package's for ``hard_lsh`` and ``quest``.  The JAX side's fused names
run the Pallas paged kernels in interpret mode; the port's run their
plain versions on the CPU.

Tolerance: greedy tokens, iteration and chunk counts equal.
"""

import numpy as np
import pytest

from repro.launch.serve import run_serve as j_run_serve
from repro_torch.launch.serve import run_serve
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine
from test_torch_engine import _configs, _params, _serve_both

BACKENDS = ["hard_lsh", "hard_lsh_fused", "quest", "quest_fused"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_lengths_match_jax_engine(backend):
    """Prompts of 5 to 50 tokens (padded final chunks whose pad rows
    enter Quest's page stats, a block boundary mid-decode): every
    request's greedy tokens and the iteration and chunk counts equal the
    JAX engine's."""
    jc, tc = _configs("llama31-8b", backend)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 21, 37, 50)]
    (jreqs, jm), (treqs, tm), engine = _serve_both(jc, tc, prompts, 6)
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == 6
        assert t.generated == j.generated, (t.generated, j.generated)
    assert (tm.decode_iters, tm.prefill_chunks) == (jm.decode_iters,
                                                    jm.prefill_chunks)
    assert engine.pool.num_used == 0


@pytest.mark.parametrize("backend", ["hard_lsh_fused", "quest_fused"])
def test_preemption_matches_jax_engine(backend):
    """A pool too small for the working set forces recompute preemption
    (reused blocks keep their earlier owner's Quest stats until a page
    opens); the resumed requests finish token-exact, equal to the JAX
    engine under the same pressure and to an unpressured pool."""
    jc, tc = _configs("llama31-8b", backend, num_blocks=9, max_batch=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, 16).tolist() for _ in range(2)]
    (jreqs, jm), (treqs, tm), engine = _serve_both(jc, tc, prompts, 24)
    assert tm.preemptions > 0 and tm.preemptions == jm.preemptions
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == 24
        assert t.generated == j.generated
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=engine.params, device="cpu")
    creqs = [Request(prompt=p, max_new_tokens=24) for p in prompts]
    assert calm.run(creqs, realtime=False).preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


@pytest.mark.parametrize("backend", ["hard_lsh", "quest"])
def test_static_serve_matches_jax_and_continuous(backend):
    """The static lockstep path equals the JAX package's ``run_serve``
    token for token, and same-length requests through the port's paged
    engine (plain and fused) reproduce it."""
    jc, tc = _configs("llama31-8b", backend)
    _, params = _params(jc, tc)                     # JAX init_model, seed 0
    prompts = np.random.default_rng(0).integers(0, 256, (3, 24))
    jt, _, _ = j_run_serve(jc, 3, 24, 8, seed=0,
                           prompt=prompts.astype(np.int32))
    static, _, _ = run_serve(tc, 3, 24, 8, prompt=prompts, params=params,
                             device="cpu")
    assert static.tolist() == np.asarray(jt).tolist()
    for name in (backend, backend + "_fused"):
        _, cfg = _configs("llama31-8b", name)
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu")
        reqs = [Request(prompt=p.tolist(), max_new_tokens=9)
                for p in prompts]
        engine.run(reqs, realtime=False)
        assert [r.generated for r in reqs] == static.tolist(), name


@pytest.mark.parametrize("backend", ["hard_lsh_fused", "quest_fused"])
def test_continuous_cli_cpu_rehearsal(backend, capsys):
    import json
    from repro_torch.launch.serve import main
    main(["--arch", "llama31-8b", "--smoke", "--device", "cpu", "--engine",
          "continuous", "--backend", backend, "--num-requests", "3",
          "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 3
    assert out["backend"] == backend and out["total_generated"] == 12
    with pytest.raises(SystemExit):
        main(["--arch", "llama31-8b", "--smoke", "--device", "cpu",
              "--backend", backend])
