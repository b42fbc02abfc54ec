"""Port parity for gemma3's 5:1 local:global layout through the engines:
greedy tokens of the port's static ``run_serve`` and of its
``ContinuousBatchingEngine`` against the JAX package's on the same
weights and prompts (``gemma3-27b .smoke()``; the engine runs at one
group, 5 local + 1 global + 1 local layer, as the JAX package's own
hybrid tests do), for ``socket_fused``, ``socket`` and ``dense``, each
with ``use_ring_kernel`` off and on, under preemption, on a recycled
pool, and on a local-only stack whose generation wraps its 32-token
window.  The JAX side's fused routes run their Pallas kernels in
interpret mode; the port's run their plain versions on the CPU.

Tolerance: greedy tokens, iteration and chunk counts equal.
"""

import numpy as np
import pytest

import jax

from repro.configs import get_config as jget
from repro.launch.serve import apply_backend_arg as japply
from repro.launch.serve import run_serve as j_run_serve
from repro.models import param as pm
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import apply_backend_arg, main, run_serve
from repro_torch.models.weights import from_jax_params
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine


def _configs(backend, ring_kernel=False, groups=1, **serving):
    jc = japply(jget("gemma3-27b").smoke(), backend).replace(
        num_groups=groups, use_ring_kernel=ring_kernel)
    tc = apply_backend_arg(tget("gemma3-27b").smoke(), backend).replace(
        num_groups=groups, use_ring_kernel=ring_kernel)
    if serving:
        jc = jc.replace(serving=jc.serving.replace(**serving))
        tc = tc.replace(serving=tc.serving.replace(**serving))
    return jc, tc


def _local_only(cfg):
    """Two sliding-window layers (gemma3's pattern starts with one)."""
    assert cfg.pattern[0].attn_type == "local"
    return cfg.replace(pattern=(cfg.pattern[0],) * 2, num_groups=1,
                       remainder=())


def _params(jc, tc, seed=0):
    jparams = pm.unbox(jtfm.init_model(jc, jax.random.PRNGKey(seed)))
    return jparams, from_jax_params(
        tc, jax.tree_util.tree_map(np.asarray, jparams))


def _serve_both(jc, tc, prompts, max_new, params=None):
    jparams, tparams = params or _params(jc, tc)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=max_new)
             for p in prompts]
    jm = JEngine(jc, params=jparams).run(jreqs, realtime=False)
    engine = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    treqs = [Request(prompt=list(p), max_new_tokens=max_new)
             for p in prompts]
    tm = engine.run(treqs, realtime=False)
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == max_new
        assert t.generated == j.generated, (t.generated, j.generated)
    assert (tm.decode_iters, tm.prefill_chunks, tm.preemptions) == \
        (jm.decode_iters, jm.prefill_chunks, jm.preemptions)
    return treqs, tm, engine


@pytest.mark.parametrize("backend", ["socket", "dense"])
def test_static_serve_matches_jax(backend):
    """gemma3 smoke at its two groups (13 layers): a 40-token prompt (past
    the 32-token window) and 8 greedy steps equal the JAX package's
    ``run_serve``, socket with both contiguous-path kernel flags on."""
    jc, tc = _configs(backend, groups=2)
    if backend == "socket":
        jc = jc.replace(socket=tc.socket)
    _, params = _params(jc, tc)
    prompts = np.random.default_rng(0).integers(0, 256, (2, 40))
    jt, _, _ = j_run_serve(jc, 2, 40, 8, seed=0,
                           prompt=prompts.astype(np.int32))
    static, _, _ = run_serve(tc, 2, 40, 8, prompt=prompts, params=params,
                             device="cpu")
    assert static.tolist() == np.asarray(jt).tolist()


@pytest.mark.parametrize("window,prompt_len", [(32, 8), (8, 21)])
def test_local_only_ring_wraps_window(window, prompt_len):
    """A local-only stack generating 40 tokens past its prompt wraps the
    ring: the port's static path equals the JAX package's, and the
    continuous engine (a ring of window / 8 pool pages, through the ring
    kernel's plain version) equals both.  The 8-token window's one-page
    ring is shorter than a 16-token chunk, which then wraps it during
    prefill."""
    jc, tc = (_local_only(c).replace(sliding_window=window)
              for c in _configs("socket", ring_kernel=True))
    jparams, tparams = _params(jc, tc)
    prompt = np.random.default_rng(4).integers(0, 256, prompt_len)
    jt, _, _ = j_run_serve(jc, 1, prompt_len, 39, seed=0,
                           prompt=prompt[None].astype(np.int32))
    static, _, _ = run_serve(tc, 1, prompt_len, 39, prompt=prompt[None],
                             params=tparams, device="cpu")
    assert static.tolist() == np.asarray(jt).tolist()
    engine = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    reqs = [Request(prompt=prompt.tolist(), max_new_tokens=40)]
    engine.run(reqs, realtime=False)
    assert reqs[0].generated == static[0].tolist()
    assert engine.scheduler.ring_blocks == window // 8
    assert not engine.scheduler.has_paged_layers


@pytest.mark.parametrize("ring_kernel", [False, True])
@pytest.mark.parametrize("backend", ["socket_fused", "socket", "dense"])
def test_continuous_matches_jax_engine(backend, ring_kernel):
    """Prompts of 5 to 50 tokens (one to four chunks of 16, rings that
    wrap during prefill and decode): every request's greedy tokens and
    the iteration and chunk counts equal the JAX engine's."""
    jc, tc = _configs(backend, ring_kernel)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n) for n in (5, 21, 37, 50)]
    _, _, engine = _serve_both(jc, tc, prompts, 6)
    assert engine.pool.num_used == 0


def test_preemption_matches_jax_engine():
    """A pool too small for the working set (8 usable blocks, two
    requests growing to 5 each) forces recompute preemption; reused ring
    pages keep their earlier owner's rows until a page opens.  The
    resumed requests finish token-exact, equal to the JAX engine under
    the same pressure and to an unpressured pool."""
    jc, tc = _configs("socket_fused", True, num_blocks=9, max_batch=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, 16) for _ in range(2)]
    params = _params(jc, tc)
    treqs, tm, _ = _serve_both(jc, tc, prompts, 24, params=params)
    assert tm.preemptions > 0
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=params[1], device="cpu")
    creqs = [Request(prompt=p.tolist(), max_new_tokens=24) for p in prompts]
    assert calm.run(creqs, realtime=False).preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def test_recycled_pool_matches_fresh_pool():
    """Outputs do not depend on what earlier owners left in recycled
    pool blocks: a second batch on a warm engine, whose freed blocks are
    handed out again, gives the same tokens as on a fresh engine; so
    does a batch on a pool whose ring pages are filled with garbage."""
    _, tc = _configs("socket_fused", True)
    _, params = _params(*_configs("socket_fused", True))
    rng = np.random.default_rng(6)
    batch_a = [rng.integers(0, 256, 12).tolist() for _ in range(2)]
    batch_b = [rng.integers(0, 256, 20).tolist() for _ in range(2)]

    def serve(engine, prompts):
        reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
        engine.run(reqs, realtime=False)
        return [r.generated for r in reqs]

    def fresh():
        return ContinuousBatchingEngine(tc, params=params, device="cpu")

    want_b = serve(fresh(), batch_b)
    warm = fresh()
    serve(warm, batch_a)
    assert warm.pool.num_used == 0
    assert serve(warm, batch_b) == want_b
    poisoned = fresh()
    for spec, layer in zip(tc.layer_specs, poisoned.pages):
        if spec.attn_type == "local":
            for leaf in layer.values():
                leaf.fill_(1e4)
    assert serve(poisoned, batch_b) == want_b


def test_continuous_cli_cpu_rehearsal(capsys):
    import json
    main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu", "--engine",
          "continuous", "--backend", "socket_fused", "--ring-kernel",
          "--num-requests", "3", "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 3
    assert out["arch"] == "gemma3-27b" and out["total_generated"] == 12
    with pytest.raises(SystemExit):
        main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
              "--ring-kernel"])
