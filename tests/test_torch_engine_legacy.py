"""Port parity for the continuous engine's legacy whole-prompt bucketed
prefill (``serving.prefill_chunk == 0``): greedy tokens of the port's
``ContinuousBatchingEngine`` against the JAX package's engine in the same
mode on the same weights and prompts (``llama31-8b .smoke()`` for
``socket``, ``socket_fused``, ``hard_lsh_fused``, ``quest_fused`` and
``dense``; ``gemma3-27b .smoke()`` at one group with the ring kernel's
plain version), against the port's own chunked engine, under forced
preemption, and the pool's pages after one whole-prompt prefill.  The
prompt attention goes through ``flash_prefill``'s plain version on the
CPU; the JAX side's fused routes run their Pallas kernels in interpret
mode.

Tolerance: greedy tokens, iteration and preemption counts equal.  Pool
pages after one prefill: int8 payloads bit for bit; f32 K/V and the
int8 scales at rtol 2e-6 (float32 projections in another summation
order, a few ulps; the f32 payloads are not bit for bit for the same
reason); SOCKET hash bits bitwise except where the key's projection lies
within float32 rounding of 0; value norms (bf16) within one bf16 ulp.
"""

import json

import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.core import hashing
from repro_torch.launch.serve import card_continuous_case, main
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine
from test_torch_engine import _configs, _params
import test_torch_engine_hybrid as hybrid

LEGACY = dict(prefill_chunk=0, prefill_buckets=(32, 64))
PROMPT_LENS = (5, 21, 37, 50)


def _prompts(seed=11, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _run_both(jc, tc, prompts, max_new, params=None):
    """Both engines on the same weights; every request's greedy tokens
    and the iteration and preemption counts equal.  Returns (JAX engine,
    port engine, port requests, port metrics)."""
    jparams, tparams = params or _params(jc, tc)
    jreqs = [JRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    jeng = JEngine(jc, params=jparams)
    jm = jeng.run(jreqs, realtime=False)
    teng = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    treqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    tm = teng.run(treqs, realtime=False)
    for j, t in zip(jreqs, treqs):
        assert t.state == FINISHED and len(t.generated) == max_new
        assert t.generated == j.generated, (t.generated, j.generated)
    assert (tm.decode_iters, tm.preemptions) == (jm.decode_iters,
                                                 jm.preemptions)
    assert tm.prefill_chunks == 0
    assert teng.pool.num_used == 0
    return jeng, teng, treqs, tm


@pytest.mark.parametrize("backend", ["socket", "socket_fused",
                                     "hard_lsh_fused", "quest_fused",
                                     "dense"])
def test_legacy_matches_jax_engine(backend):
    """Prompts of 5 to 50 tokens padded to buckets of 32 and 64 (the
    logits taken at the last real token, pad rows in Quest's last page
    stats as in the JAX package): tokens and counts equal the JAX
    engine's, one whole-prompt prefill a request."""
    jc, tc = _configs("llama31-8b", backend, **LEGACY)
    _, teng, treqs, _ = _run_both(jc, tc, _prompts(), 6)
    assert [(rid, bucket) for _, rid, bucket, _ in teng.prefill_trace] == \
        [(r.rid, 32 if len(r.prompt) <= 32 else 64) for r in treqs]


def test_legacy_gemma3_ring_matches_jax_engine():
    """gemma3 smoke at one group (5 local, 1 global, 1 local layer; window
    32) with the ring kernel's plain version: the prompts of 37 and 50
    tokens wrap their rings, built at the last real token of a padded
    bucket."""
    jc, tc = hybrid._configs("socket_fused", ring_kernel=True, **LEGACY)
    _run_both(jc, tc, _prompts(), 6)


@pytest.mark.parametrize("backend", ["socket", "dense", "hard_lsh",
                                     "quest"])
def test_legacy_matches_own_chunked_engine(backend):
    """The mixed token-budget step reproduces the whole-bucket engine
    token for token, prompt lengths off every chunk and bucket boundary
    (the JAX package's ``test_chunked_matches_whole_bucket``)."""
    jc, tc = _configs("stablelm-12b", backend)
    _, params = _params(jc, tc)
    prompts = _prompts(0, (9, 24, 17))

    def serve(cfg):
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        m = engine.run(reqs, realtime=False)
        assert all(r.state == FINISHED for r in reqs)
        return [r.generated for r in reqs], m

    chunked, mc = serve(tc)
    whole, mw = serve(tc.replace(serving=tc.serving.replace(**LEGACY)))
    assert mc.prefill_chunks >= len(prompts) and mw.prefill_chunks == 0
    assert whole == chunked


def test_legacy_preemption_replays_token_exact():
    """A pool too small for the working set (8 usable blocks, two
    requests growing to 5 each) preempts; the resumed request re-prefills
    its prompt whole and replays its recorded tokens: equal to the JAX
    engine under the same pressure and to an unpressured pool."""
    jc, tc = _configs("llama31-8b", "socket_fused", num_blocks=9,
                      max_batch=2, **LEGACY)
    jparams, tparams = _params(jc, tc)
    prompts = _prompts(2, (16, 16))
    _, teng, treqs, tm = _run_both(jc, tc, prompts, 24, (jparams, tparams))
    assert tm.preemptions > 0
    assert len(teng.prefill_trace) == len(prompts) + tm.preemptions
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=tparams, device="cpu")
    creqs = [Request(prompt=p, max_new_tokens=24) for p in prompts]
    assert calm.run(creqs, realtime=False).preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def _raw(a):
    """A pool leaf as numpy: one-byte payloads as their raw bytes, bf16 as
    float32."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy()
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return a.astype(np.float32)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _signs_match_outside_zero_band(tbits, jbits, keys, hash_w, l, p):
    """Unpacked hash signs of the port's and the JAX pool rows are equal
    wherever the key's projection on the plane is clear of float32
    rounding (|proj| > 1e-5 * sum |k| |w|)."""
    ts = hashing.unpack_signs(torch.from_numpy(tbits), l, p).numpy()
    js = hashing.unpack_signs(torch.from_numpy(jbits.view(np.int32)), l,
                              p).numpy()
    w = hash_w.double().numpy()
    k = keys.astype(np.float64)
    proj = np.einsum("...d,lpd->...lp", k, w)
    mag = np.einsum("...d,lpd->...lp", np.abs(k), np.abs(w))
    band = np.abs(proj) <= 1e-5 * mag
    np.testing.assert_array_equal(ts[~band], js[~band])
    return int((ts[band] != js[band]).sum())


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_pool_pages_after_one_prefill_match_jax(kv_dtype):
    """One 45-token request per engine: after its whole-prompt prefill
    (both engines allocate the same block ids) every layer's prompt rows
    in the pool, K/V, their scales, SOCKET bits and value norms, against
    the JAX engine's.  The two decode steps of max_new_tokens 3 write
    rows 45 and 46, past the rows compared."""
    n = 45
    jc, tc = _configs("llama31-8b", "socket_fused", kv_dtype=kv_dtype,
                      **LEGACY)
    jparams, tparams = _params(jc, tc)
    prompt = _prompts(4, (n,))[0]
    jeng = JEngine(jc, params=jparams)
    jeng.run([JRequest(prompt=prompt, max_new_tokens=3)], realtime=False)
    teng = ContinuousBatchingEngine(tc, params=tparams, device="cpu")
    blocks = []
    teng.iter_hook = lambda eng, it: blocks or blocks.extend(
        next(iter(eng.scheduler.running.values())).blocks)
    teng.run([Request(prompt=prompt, max_new_tokens=3)], realtime=False)
    assert len(blocks) == -(-(n + 1) // tc.serving.block_size)
    groups = jeng.pages["groups"]
    per = len(tc.pattern)

    def rows(leaf):
        """The prompt's rows in token order, (n, KVH, ...)."""
        a = np.moveaxis(leaf[blocks], 1, 2)          # (nb, bs, KVH, ...)
        return a.reshape(-1, *a.shape[2:])[:n]

    flips = 0
    for i, layer in enumerate(teng.pages):
        t = {name: rows(_raw(a)) for name, a in layer.items()}
        j = {name: rows(_raw(a[i // per])) for name, a in
             groups[f"slot_{i % per}"].items()}
        assert sorted(t) == sorted(j)
        if kv_dtype == "int8":
            for name in ("k", "v"):
                np.testing.assert_array_equal(t[name], j[name])
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(t[name], j[name], rtol=2e-6,
                                           atol=0)
            keys = t["k"].view(np.int8).astype(np.float32) * \
                t["k_scale"][..., None]
        else:
            for name in ("k", "v"):
                np.testing.assert_allclose(t[name], j[name], rtol=2e-6,
                                           atol=1e-6)
            keys = t["k"]
        flips += _signs_match_outside_zero_band(
            t["bits"], j["bits"], keys,
            tparams["layers"][i]["attn"]["hash_w"],
            tc.socket.num_tables, tc.socket.num_planes)
        np.testing.assert_allclose(t["vnorm"], j["vnorm"], rtol=2 ** -7,
                                   atol=0)
    assert flips <= 3, flips


def test_legacy_bucket_and_validate_errors():
    """A prompt beyond the largest bucket raises ValueError; buckets below
    ``max_context`` fail validation (an admitted request could not be
    re-prefilled after preemption)."""
    _, tc = _configs("llama31-8b", "socket_fused", **LEGACY)
    engine = ContinuousBatchingEngine(tc, device="cpu")
    assert engine._bucket_for(33) == 64
    with pytest.raises(ValueError, match="largest prefill bucket"):
        engine._bucket_for(65)
    short = tc.replace(serving=tc.serving.replace(prefill_buckets=(24, 32)))
    with pytest.raises(AssertionError, match="largest prefill bucket"):
        ContinuousBatchingEngine(short, device="cpu")
    # the card's legacy cases: buckets 2048, 4096 and max_context (264 or
    # 392 blocks of 16), so half the prompts or more run padded
    for arch, top, padded in (("llama31-8b", 4224, 4),
                              ("gemma3-27b", 6272, 4)):
        cfg, reqs = card_continuous_case(tget(arch), 0, 32, legacy=True)
        cfg.serving.validate()
        assert cfg.serving.prefill_chunk == 0
        assert cfg.serving.prefill_buckets == (2048, 4096, top)
        assert len(reqs) == 8
        assert sum(min(b for b in (2048, 4096, top) if b >= len(r.prompt))
                   > len(r.prompt) for r in reqs) == padded


def test_legacy_warmup_and_cli_rehearsal(capsys):
    """Warm-up runs the decode step and the buckets the requests hit, one
    whole-prompt prefill each; the CLI serves through the legacy path
    with ``--prefill-chunk 0``."""
    _, tc = _configs("llama31-8b", "socket_fused", **LEGACY)
    engine = ContinuousBatchingEngine(tc, device="cpu")
    engine.warmup([Request(prompt=p, max_new_tokens=2)
                   for p in _prompts(3, (3, 9))])
    assert sorted(engine.warmup_s) == ["decode", "prefill_32"]
    engine.warmup()
    assert sorted(engine.warmup_s) == ["decode", "prefill_32", "prefill_64"]
    main(["--arch", "llama31-8b", "--smoke", "--device", "cpu", "--engine",
          "continuous", "--backend", "socket_fused", "--prefill-chunk", "0",
          "--num-requests", "3", "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["finished"] == out["num_requests"] == 3
    assert out["prefill_chunk"] == 0 and out["prefill_chunks"] == 0
    assert out["total_generated"] == 12
