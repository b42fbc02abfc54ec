"""Port parity for sampling: ``serving.sampling.sample_tokens`` against
the JAX package's ``sampling.sample_tokens`` fed JAX's own Gumbel noise
for the same keys, and the port's continuous engine at temperature > 0
against the JAX engine with the port's noise streams replaced by JAX's
key chain (``fold_in(PRNGKey(seed), submission)``, then the t-th split's
``gumbel``), on the chunked and the legacy whole-prompt paths; the port's
own streams: deterministic per seed, independent of batch composition and
token-exact across preemption.

Tolerance: tokens equal.  (The engines' logits agree to ~1e-6; a near tie
of ``logits / T + gumbel`` could flip a token, and none does here.)
"""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving import sampling as jsampling
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.launch.serve import main
from repro_torch.serving import FINISHED, Request, sampling
from repro_torch.serving.engine import ContinuousBatchingEngine
from test_torch_engine import _configs, _params
from test_torch_smoke_checks import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _jax_gumbel(key, n):
    """The noise ``jax.random.categorical(key, l)`` adds to a (n,) row."""
    return np.array(jax.random.gumbel(key, (n,), jnp.float32))


class JaxKeyStream(sampling.GumbelStream):
    """A request's noise from the JAX engine's key chain: key ``k_0 =
    fold_in(PRNGKey(seed), submission)``, ``k_{t+1} = split(k_t)[0]``,
    and draw ``t`` is the Gumbel noise of ``split(k_t)[1]``."""

    def __init__(self, seed, submission, device):
        super().__init__(seed, submission, device)
        self.chain = [jax.random.fold_in(jax.random.PRNGKey(seed),
                                         submission)]

    def noise(self, t, n):
        while len(self.chain) <= t:
            self.chain.append(jax.random.split(self.chain[-1])[0])
        return torch.from_numpy(_jax_gumbel(
            jax.random.split(self.chain[t])[1], n))


# ------------------------------------------------------------ the sampler


def _logits(case, rng):
    """(logits (B, V) float32, vocab_size) of one sampler case."""
    if case == "ties_at_cutoff":
        # integer logits: many exact ties, several at any top-p cutoff
        return rng.integers(0, 4, size=(6, 32)).astype(np.float32), 32
    if case == "padded_vocab":
        # vocab 16 padded to 24 with a tail that would win every draw
        base = rng.normal(size=(6, 16)).astype(np.float32)
        return np.pad(base, ((0, 0), (0, 8)), constant_values=50.0), 16
    return (rng.normal(size=(6, 40)) * 2).astype(np.float32), 40


CASES = [("top_p_near_0", 0.7, 1e-9), ("top_p_near_1", 1.3, 0.999),
         ("top_p_1", 1.0, 1.0), ("top_p_0.5", 0.8, 0.5),
         ("padded_vocab", 2.0, 1.0), ("padded_vocab", 0.9, 0.7),
         ("ties_at_cutoff", 1.0, 0.5), ("ties_at_cutoff", 0.6, 0.9)]


@pytest.mark.parametrize("case,temperature,top_p", CASES)
def test_sample_tokens_matches_jax(case, temperature, top_p):
    """``sample_tokens`` fed JAX's Gumbel noise of the keys JAX's sampler
    draws with gives JAX's tokens, over 30 draws of each row."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    logits, vocab = _logits(case, rng)
    b, v = logits.shape
    keys = jsampling.slot_keys(3, b)
    for _ in range(30):
        jtok, new = jsampling.sample_tokens(
            jnp.asarray(logits), keys, temperature=temperature, top_p=top_p,
            vocab_size=vocab)
        use = jax.vmap(jax.random.split)(keys)[:, 1]
        noise = np.stack([_jax_gumbel(k, v) for k in use])
        tok = sampling.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(noise),
            temperature=temperature, top_p=top_p, vocab_size=vocab)
        assert tok.tolist() == np.asarray(jtok).tolist()
        assert int(tok.max()) < vocab
        if case == "top_p_near_0":
            assert tok.tolist() == logits.argmax(-1).tolist()
        keys = new


def test_ties_at_the_cutoff_are_all_kept():
    """Exact ties at the cutoff logit all stay drawable: with noise that
    favours each tied id in turn, each is drawn; ids below the cutoff never
    are."""
    logits = torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0, 0.0]])
    for favoured in range(6):
        noise = torch.zeros(1, 6)
        noise[0, favoured] = 10.0
        tok = sampling.sample_tokens(logits, noise, temperature=1.0,
                                     top_p=0.1, vocab_size=6)
        want = favoured if favoured in (0, 2, 4) else 0
        assert tok.item() == want


def test_categorical_is_gumbel_max():
    """What the port's sampler rests on: ``jax.random.categorical(key, l)``
    is ``argmax(l + gumbel(key, l.shape))`` (50 draws; a JAX upgrade that
    changes it fails here)."""
    rng = np.random.default_rng(0)
    for i in range(50):
        key = jax.random.PRNGKey(i)
        logits = jnp.asarray(rng.normal(size=(97,)) * 3, jnp.float32)
        want = jnp.argmax(logits + jax.random.gumbel(key, logits.shape,
                                                     jnp.float32))
        assert int(jax.random.categorical(key, logits)) == int(want)


def test_gumbel_noise_is_jax_transform():
    """``gumbel_noise`` forms -log(-log(u)) as ``jax.random.gumbel`` does,
    u clamped up to the smallest normal float32 (so u = 0 stays finite)."""
    u = np.array([0.0, 1e-40, 1e-30, 0.25, 0.5, 0.999999], np.float32)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(-jnp.log(-jnp.log(jnp.maximum(jnp.asarray(u), tiny))))
    got = sampling.gumbel_noise(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_gumbel_stream_restarts_and_seeds():
    """A stream's draws are a function of (seed, submission, t): the same
    triple draws the same noise, a restart replays from draw 0, another
    seed or submission draws other noise."""
    a = sampling.GumbelStream(5, 2, "cpu")
    first = [a.draw(64) for _ in range(3)]
    assert a.draws == 3
    a.restart()
    assert a.draws == 0
    assert all(torch.equal(x, a.draw(64)) for x in first)
    b = sampling.GumbelStream(5, 2, "cpu")
    assert torch.equal(b.draw(64), first[0])
    for other in (sampling.GumbelStream(6, 2, "cpu"),
                  sampling.GumbelStream(5, 3, "cpu")):
        assert not torch.equal(other.draw(64), first[0])
    assert sampling.stream_seed(5, 2) != sampling.stream_seed(2, 5)


# ------------------------------------------------------------ the engine


def _prompts(seed=11, lens=(5, 21, 37, 50)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _serve(cfg, params, prompts, steps, engine=None, stream=None,
           **sampler):
    """Serve ``prompts`` on the port's engine at temperature 0.8, top-p
    0.95 (``sampler`` overrides), noise from ``stream`` if given."""
    kw = {**dict(temperature=0.8, top_p=0.95, sample_seed=13), **sampler}
    if engine is None:
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu",
                                          **kw)
    if stream is not None:
        engine.stream_cls = stream
    reqs = [Request(prompt=list(p), max_new_tokens=steps) for p in prompts]
    m = engine.run(reqs, realtime=False)
    assert all(r.state == FINISHED and len(r.generated) == steps
               for r in reqs)
    return engine, reqs, m


def _jserve(cfg, params, prompts, steps, **sampler):
    kw = {**dict(temperature=0.8, top_p=0.95, sample_seed=13), **sampler}
    reqs = [JRequest(prompt=list(p), max_new_tokens=steps) for p in prompts]
    m = JEngine(cfg, params=params, **kw).run(reqs, realtime=False)
    return reqs, m


@pytest.mark.parametrize("mode", ["chunked", "legacy"])
@pytest.mark.parametrize("backend", ["socket", "socket_fused", "quest"])
def test_engine_sampling_matches_jax_engine(backend, mode):
    """Temperature 0.8, top-p 0.95, prompts of 5 to 50 tokens: with JAX's
    key chain as its noise, the port's engine draws the JAX engine's
    tokens, with the same iteration and chunk counts; every draw index of
    an emitted token is its token index."""
    serving = {} if mode == "chunked" else dict(prefill_chunk=0)
    jc, tc = _configs("stablelm-12b", backend, **serving)
    jparams, tparams = _params(jc, tc)
    prompts = _prompts()
    jreqs, jm = _jserve(jc, jparams, prompts, 6)
    _, treqs, tm = _serve(tc, tparams, prompts, 6, stream=JaxKeyStream)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert (tm.decode_iters, tm.prefill_chunks) == (jm.decode_iters,
                                                    jm.prefill_chunks)
    assert all(r.sample_key.emitted == list(range(6)) for r in treqs)
    # the sampled run differs from the greedy one
    greedy = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    greqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    greedy.run(greqs, realtime=False)
    assert [r.generated for r in greqs] != [r.generated for r in treqs]


def test_continuous_engine_sampling_smoke():
    """The JAX package's smoke test on the port: temperature/top-p serving
    is deterministic per seed, sensitive to the seed, ids in-vocab."""
    _, tc = _configs("stablelm-12b", "socket")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tc.vocab_size, size=12).tolist()
    params = ContinuousBatchingEngine(tc, device="cpu").params

    def serve(seed):
        _, reqs, _ = _serve(tc, params, [prompt], 6, sample_seed=seed)
        return reqs[0].generated

    a, b, c = serve(0), serve(0), serve(7)
    assert a == b
    assert a != c
    assert all(0 <= t < tc.vocab_size for t in a)


def test_warmup_draws_nothing():
    """The warm-up runs the step shapes and draws from no stream: a warmed
    engine samples what a cold one does."""
    _, tc = _configs("stablelm-12b", "socket_fused")
    prompts = _prompts(lens=(9, 24))
    eng, cold, _ = _serve(tc, None, prompts, 5)
    warm_eng = ContinuousBatchingEngine(tc, params=eng.params, device="cpu",
                                        temperature=0.8, top_p=0.95,
                                        sample_seed=13)
    warm_eng.warmup()
    _, warm, _ = _serve(tc, None, prompts, 5, engine=warm_eng)
    assert [r.generated for r in warm] == [r.generated for r in cold]


def test_sampled_stream_is_composition_independent():
    """A request's sampled tokens are a function of (seed, submission
    index, token index): alone or beside co-tenants, it draws the same
    tokens."""
    _, tc = _configs("stablelm-12b", "socket")
    rng = np.random.default_rng(6)
    first = rng.integers(0, tc.vocab_size, size=12).tolist()
    others = [rng.integers(0, tc.vocab_size, size=n).tolist()
              for n in (9, 17)]
    eng, alone, _ = _serve(tc, None, [first], 6, temperature=0.9,
                           sample_seed=11)
    _, crowd, _ = _serve(tc, eng.params, [first] + others, 6,
                         temperature=0.9, sample_seed=11)
    assert alone[0].generated == crowd[0].generated


def test_chunked_matches_whole_prompt_prefill_sampled():
    """A stream draws once at the first token whether it comes from the
    final chunk or the whole-prompt prefill, so the chunked and legacy
    engines draw the same tokens."""
    _, tc = _configs("stablelm-12b", "socket")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tc.vocab_size, size=n).tolist()
               for n in (9, 24, 17)]
    eng, chunked, _ = _serve(tc, None, prompts, 6)
    legacy = tc.replace(serving=tc.serving.replace(prefill_chunk=0))
    _, whole, _ = _serve(legacy, eng.params, prompts, 6)
    assert [r.generated for r in chunked] == [r.generated for r in whole]


@pytest.mark.parametrize("mode", ["chunked", "legacy"])
def test_preempting_sampled_run_equals_unpreempted(mode):
    """A pool too small for the working set forces recompute preemption:
    each resumed request restarts its stream, replays its recorded tokens
    (drawing and discarding) and samples on token for token as the
    unpressured run did, every emitted token with the draw index it had
    there; with JAX's key chain, also as the JAX engine under the same
    pressure."""
    serving = dict(num_blocks=9, max_batch=2)
    if mode == "legacy":
        serving["prefill_chunk"] = 0
    jc, tc = _configs("stablelm-12b", "socket", **serving)
    jparams, tparams = _params(jc, tc)
    prompts = _prompts(seed=2, lens=(16, 16))
    _, hot, mh = _serve(tc, tparams, prompts, 24)
    calm_cfg = tc.replace(serving=tc.serving.replace(num_blocks=48))
    _, calm, mc = _serve(calm_cfg, tparams, prompts, 24)
    assert mh.preemptions > 0 and mc.preemptions == 0
    for h, c in zip(hot, calm):
        assert h.generated == c.generated
        assert h.sample_key.emitted == c.sample_key.emitted == \
            list(range(24))
    assert any(r.preemptions for r in hot)
    jhot, jm = _jserve(jc, jparams, prompts, 24)
    _, thot, tm = _serve(tc, tparams, prompts, 24, stream=JaxKeyStream)
    assert tm.preemptions == jm.preemptions > 0
    assert [r.generated for r in thot] == [r.generated for r in jhot]


# ------------------------------------------------------------ the CLI


def test_cli_sampling_rehearsal(capsys):
    main(["--arch", "stablelm-12b", "--smoke", "--device", "cpu",
          "--engine", "continuous", "--backend", "socket_fused",
          "--temperature", "0.8", "--top-p", "0.9", "--num-requests", "3",
          "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 3
    assert out["total_generated"] == 12
    assert (out["temperature"], out["top_p"]) == (0.8, 0.9)


@pytest.mark.parametrize("argv,match", [
    (["--temperature", "0.8"], "--temperature requires --engine continuous"),
    (["--engine", "continuous", "--temperature", "0.8", "--top-p", "0"],
     "--top-p must be in (0, 1]"),
    (["--engine", "continuous", "--top-p", "1.5"], "--top-p must be in"),
])
def test_cli_refuses_sampling_flags_as_jax_does(argv, match, capsys):
    with pytest.raises(SystemExit):
        main(["--arch", "stablelm-12b", "--smoke", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


def test_card_sampling_case_preempts_decoders():
    """The sampling phase's cut pool (``CARD_PREEMPT_BLOCKS``) on the card
    case's traffic (8 prompts of 1K-4K tokens, 32 tokens, chunks of 512),
    at smoke width on the CPU: it preempts, decoders with tokens among the
    victims (their replays draw and discard), and every request samples
    the unpressured run's tokens at the same draw indices."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (CARD_PREEMPT_BLOCKS,
                                          card_continuous_case)
    full = get_config("llama31-8b").smoke()
    runs = []
    for blocks in (None, CARD_PREEMPT_BLOCKS):
        # the schedule depends on the lengths alone, so the cheaper Quest
        # plain version stands in for the card's socket_fused
        cfg, reqs = card_continuous_case(full, 0, 32, "quest_fused",
                                         num_blocks=blocks)
        engine = ContinuousBatchingEngine(cfg, device="cpu", temperature=0.8,
                                          top_p=0.95, sample_seed=0)
        victims = []
        preempt = engine.scheduler.preempt

        def spy(req, cause="manual", _preempt=preempt, _v=victims):
            _v.append((req.state, len(req.generated)))
            _preempt(req, cause)

        engine.scheduler.preempt = spy
        m = engine.run(reqs, realtime=False)
        runs.append((reqs, m, victims))
    (calm, mc, _), (hot, mh, victims) = runs
    assert mc.preemptions == 0 and mh.preemptions == len(victims) > 0
    assert any(state == "decode" and n > 1 for state, n in victims)
    assert [r.generated for r in hot] == [r.generated for r in calm]
    assert [r.sample_key.emitted for r in hot] == \
        [list(range(32))] * len(hot)
