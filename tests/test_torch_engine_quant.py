"""Port parity for quantized K/V pool pages (``serving.kv_dtype`` bf16,
int8, fp8) through the engines: greedy tokens of the port's
``ContinuousBatchingEngine`` against the JAX package's engine on the same
weights and prompts (``llama31-8b .smoke()`` for every backend the dtype
admits, ``gemma3-27b .smoke()`` at one group with the ring kernel off and
on), under forced preemption, the static ``run_serve`` against the JAX
package's, and the pool's stored leaves after a run.  The JAX side's
fused routes run their Pallas kernels in interpret mode; the port's run
their plain versions on the CPU.

Tolerance: greedy tokens, iteration and chunk counts equal.  After a run
the pool's int8/fp8 payloads equal the JAX engine's bit for bit; its
float32 scales are absmax / qmax of K/V rows that the two frameworks
project with float32 products in another summation order, so they agree
to rtol 2e-6 (measured: 5e-7, a few ulps).
"""

import numpy as np
import pytest
import torch

from repro.launch.serve import run_serve as j_run_serve
from repro.serving import Request as JRequest
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.launch.serve import run_serve
from repro_torch.serving import FINISHED, Request
from repro_torch.serving.engine import ContinuousBatchingEngine
from test_torch_engine import _configs, _params
import test_torch_engine_hybrid as hybrid

# (kv_dtype, backend) the validate() matrix admits on llama31-8b
LLAMA = ([("int8", b) for b in ("socket", "socket_fused", "hard_lsh",
                                "hard_lsh_fused", "quest", "quest_fused",
                                "dense")] +
         [("fp8", b) for b in ("socket_fused", "hard_lsh_fused",
                               "quest_fused")] +
         [("bf16", b) for b in ("socket_fused", "dense")])


def _prompts(seed=11, lens=(5, 21, 37, 50)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


def _run_both(jc, tc, prompts, max_new, params=None):
    """Both engines on the same weights; every request's greedy tokens
    and the iteration, chunk and preemption counts equal.  Returns (JAX
    engine, port engine, port requests, port metrics)."""
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
    assert (tm.decode_iters, tm.prefill_chunks, tm.preemptions) == \
        (jm.decode_iters, jm.prefill_chunks, jm.preemptions)
    assert teng.pool.num_used == 0
    return jeng, teng, treqs, tm


@pytest.mark.parametrize("kv_dtype,backend", LLAMA)
def test_mixed_lengths_match_jax_engine(kv_dtype, backend):
    """Prompts of 5 to 50 tokens (padded final chunks, a block boundary
    mid-decode) on pages stored as ``kv_dtype``: greedy tokens and counts
    equal the JAX engine's, and the pool holds the dtype's leaves."""
    jc, tc = _configs("llama31-8b", backend, kv_dtype=kv_dtype)
    _, engine, _, _ = _run_both(jc, tc, _prompts(), 6)
    want = {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]
    for layer in engine.pages:
        assert layer["k"].dtype == layer["v"].dtype == want
        assert ("k_scale" in layer) == (kv_dtype != "bf16")


@pytest.mark.parametrize("kv_dtype,ring_kernel", [("int8", False),
                                                  ("int8", True),
                                                  ("fp8", True)])
def test_gemma3_matches_jax_engine(kv_dtype, ring_kernel):
    """gemma3's 5:1 layout (rings that wrap during prefill and decode) on
    quantized ring and global pages, socket_fused, the ring kernel off
    (int8: the plain ring route dequantizes the ring view) and on."""
    jc, tc = hybrid._configs("socket_fused", ring_kernel, kv_dtype=kv_dtype)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 21, 37, 50)]
    _run_both(jc, tc, prompts, 6, params=hybrid._params(jc, tc))


def test_int8_preemption_matches_jax_and_calm_run():
    """A pool too small for the working set forces recompute preemption:
    a resumed request quantizes the same prompt rows again and finishes
    token-exact, equal to the JAX engine under the same pressure and to
    an int8 pool that never preempts."""
    jc, tc = _configs("llama31-8b", "socket_fused", num_blocks=9,
                      max_batch=2, kv_dtype="int8")
    prompts = _prompts(seed=2, lens=(16, 16))
    params = _params(jc, tc)
    _, engine, treqs, tm = _run_both(jc, tc, prompts, 24, params=params)
    assert tm.preemptions > 0
    calm = ContinuousBatchingEngine(
        tc.replace(serving=tc.serving.replace(num_blocks=48)),
        params=params[1], device="cpu")
    creqs = [Request(prompt=p, max_new_tokens=24) for p in prompts]
    assert calm.run(creqs, realtime=False).preemptions == 0
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def test_static_serve_int8_matches_jax():
    """The static lockstep path on int8 caches (quantized on write, the
    selected rows dequantized), both contiguous-path kernel flags on,
    equals the JAX package's ``run_serve``."""
    jc, tc = _configs("llama31-8b", "socket", kv_dtype="int8")
    jc = jc.replace(socket=tc.socket)
    _, params = _params(jc, tc)
    prompts = np.random.default_rng(0).integers(0, 256, (3, 24))
    jt, _, _ = j_run_serve(jc, 3, 24, 8, seed=0,
                           prompt=prompts.astype(np.int32))
    static, _, _ = run_serve(tc, 3, 24, 8, prompt=prompts, params=params,
                             device="cpu")
    assert static.tolist() == np.asarray(jt).tolist()


def _raw(a):
    """A pool leaf as numpy: one-byte payloads as their raw bytes."""
    if isinstance(a, torch.Tensor):
        if a.element_size() == 1:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_pool_leaves_after_a_run_match_jax(kv_dtype):
    """After one socket_fused run the pool's ``k``/``v`` payloads equal
    the JAX engine's bit for bit in every layer, trash page included,
    and its ``k_scale``/``v_scale`` rows agree to rtol 2e-6."""
    jc, tc = _configs("llama31-8b", "socket_fused", kv_dtype=kv_dtype)
    jeng, teng, _, _ = _run_both(jc, tc, _prompts(), 6)
    groups = jeng.pages["groups"]
    per = len(tc.pattern)
    for i, layer in enumerate(teng.pages):
        jl = groups[f"slot_{i % per}"]
        for name in ("k", "v"):
            np.testing.assert_array_equal(_raw(layer[name]),
                                          _raw(jl[name][i // per]))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_raw(layer[name]),
                                       _raw(jl[name][i // per]), rtol=2e-6,
                                       atol=0)
