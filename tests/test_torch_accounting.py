"""Port parity for the serving accounting the benchmark reads, host-only.

For every architecture the port registers, at full size and smoke, every
backend name the launchers take, every ``kv_dtype`` and both prefill
modes (chunked, legacy whole-prompt): ``serving.paged``'s
``kv_row_bytes``, ``pool_block_bytes`` and ``gather_footprint``, the
decode backend's ``selected_rows`` and ``fused_paged``, and
``launch.serve.serving_ceiling`` equal the JAX package's (exact
integers; where the JAX function raises, the port raises the same
exception type).  At full gemma-7b geometry int8 pages hold at least
1.8 x the bf16 pool's resident requests.  The same holds at the
deployment numerics (``launch/specs.py``'s ``dryrun_model_config``: bf16
compute, so ``kv_dtype="auto"`` pages are bf16).  ``run_continuous(...,
arrivals=)`` builds the request list the JAX launcher builds for the same
seed (rebuilt here with numpy; no engine runs: the port's engine is
replaced by a stub that records what it is given).
"""

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import backends as jbk
from repro.serving import paged as jpaged
from repro_torch.configs import ARCHITECTURES
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.models import backends as tbk
from repro_torch.serving import paged as tpaged

KV_DTYPES = ("auto", "bf16", "int8", "fp8")


def _both(fn_j, fn_t):
    """(JAX result, port result), or the exception types both raised."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(fn())
        except Exception as e:                       # noqa: BLE001
            out.append(type(e).__name__)
    return out


def _configs(arch, full, backend, kv_dtype, legacy, bf16=False):
    jc, tc = jget(arch), tget(arch)
    if bf16:
        jc = jspecs.dryrun_model_config(jc, jspecs.SHAPES["decode_32k"])
        tc = tspecs.dryrun_model_config(tc, tspecs.SHAPES["decode_32k"])
    if not full:
        jc, tc = jc.smoke(), tc.smoke()
    jc = jserve.apply_kv_dtype(jserve.apply_backend_arg(jc, backend),
                               kv_dtype)
    tc = tserve.apply_kv_dtype(tserve.apply_backend_arg(tc, backend),
                               kv_dtype)
    if legacy:
        jc = jc.replace(serving=jc.serving.replace(prefill_chunk=0))
        tc = tc.replace(serving=tc.serving.replace(prefill_chunk=0))
    return jc, tc


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_accounting_matches_jax(arch, full):
    _accounting_matches_jax(arch, full, bf16=False)


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_accounting_matches_jax_at_bf16_compute(arch, full):
    """The same at ``dryrun_model_config``'s numerics; ``auto`` pages
    take bf16 K/V rows, as ``bf16`` pages do."""
    _accounting_matches_jax(arch, full, bf16=True)
    jc, tc = _configs(arch, full, "socket_fused", "auto", False, bf16=True)
    bc = _configs(arch, full, "socket_fused", "bf16", False)[1]
    assert tpaged.kv_row_bytes(tc) == tpaged.kv_row_bytes(bc)


def _accounting_matches_jax(arch, full, bf16):
    checked = 0
    for backend in tserve.SERVING_BACKENDS:
        for kv_dtype in KV_DTYPES:
            for legacy in (False, True):
                jc, tc = _configs(arch, full, backend, kv_dtype, legacy,
                                  bf16)
                label = (arch, full, backend, kv_dtype, legacy, bf16)
                for name in ("kv_row_bytes", "pool_block_bytes",
                             "gather_footprint"):
                    j, t = _both(lambda: getattr(jpaged, name)(jc),
                                 lambda: getattr(tpaged, name)(tc))
                    assert j == t, (label, name, j, t)
                jb = jbk.get_backend(jc.attention_backend)
                tb = tbk.get_backend(tc.attention_backend)
                assert tb.fused_paged(tc) == jb.fused_paged(jc), label
                for n in (1, 7, 300, tc.serving.max_context, 8192, 131072):
                    assert tb.selected_rows(tc, n) == \
                        jb.selected_rows(jc, n), (label, n)
                assert tserve.serving_ceiling(tc) == \
                    jserve.serving_ceiling(jc), label
                checked += 1
    assert checked == len(tserve.SERVING_BACKENDS) * len(KV_DTYPES) * 2


def test_selected_rows_and_fused_paged_by_backend():
    """SOCKET and hard LSH select ``topk_budget`` rows, Quest whole pages
    of its ``page_budget``, dense every row; only the ``*_fused`` names
    (``use_paged_kernel``) claim the fused paged kernel."""
    base = tget("llama31-8b")
    n = 4096
    rows, fused = {}, {}
    for backend in tserve.SERVING_BACKENDS:
        cfg = tserve.apply_backend_arg(base, backend)
        b = tbk.get_backend(cfg.attention_backend)
        rows[backend], fused[backend] = b.selected_rows(cfg, n), \
            b.fused_paged(cfg)
    # sparsity 10: ceil(4096 / 10) = 410 rows; Quest 410 // 16 = 25 pages
    assert rows["socket"] == rows["hard_lsh_fused"] == 410
    assert rows["quest"] == rows["quest_fused"] == 25 * 16
    assert rows["dense"] == n
    assert {k for k, v in fused.items() if v} == {
        "socket_fused", "hard_lsh_fused", "quest_fused"}
    fp = tpaged.gather_footprint(tserve.apply_backend_arg(base,
                                                          "socket_fused"))
    assert fp["paged_bytes_per_step"] == 0 and fp["fused_paged_kernel"]


def test_gemma7b_int8_pages_hold_1p8x_bf16_residency():
    """The serving benchmark's bar at full gemma-7b geometry: in the
    bf16 pool's byte budget, int8 pages hold >= 1.8 x the resident
    requests (bits and vnorm ride along at full precision: ~1.84x)."""
    cfg = tserve.apply_backend_arg(tget("gemma-7b"), "socket_fused")
    per = {kv: tpaged.pool_block_bytes(tserve.apply_kv_dtype(cfg, kv))[
        "per_block_id"] for kv in KV_DTYPES}
    # a head-row: K/V 2 * 256 * 2 B, 20 bits words (L 60 x P 10 bits in
    # 32-bit words, padded) and a bf16 vnorm
    assert per["bf16"] == 28 * 16 * 16 * (2 * 256 * 2 + 20 * 4 + 2)
    assert per["int8"] == per["fp8"] == 28 * 16 * 16 * (
        2 * (256 + 4) + 20 * 4 + 2)
    sv = cfg.serving
    budget = sv.num_blocks * per["bf16"]
    top = tserve.serving_ceiling(cfg) - 16
    blocks = -(-((max(1, top // 2) + top) // 2 + 16) // sv.block_size)
    bf16 = budget // (blocks * per["bf16"])
    int8 = budget // (blocks * per["int8"])
    assert int8 >= 1.8 * bf16, (int8, bf16)


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_state_and_moe_archs_accounting(full):
    """The four architectures of Mamba and MoE layers (what the serving
    benchmark's ``hybrid_jamba`` row reads): the state terms of
    ``gather_footprint`` (the per-slot state bytes a step moves, the
    state layer count) and ``pool_block_bytes`` equal the JAX package's,
    the state term counted from the pool's own state rows; state layers
    take no bytes of a block id."""
    # arch -> state layers at full size, at smoke (two groups)
    for arch, n_state in (("jamba-v0.1-52b", (28, 14)),
                          ("mamba2-780m", (48, 2)), ("mixtral-8x22b", (0, 0)),
                          ("llama4-maverick-400b-a17b", (0, 0))):
        jc, tc = _configs(arch, full, "socket_fused", "auto", False)
        j, t = jpaged.gather_footprint(jc), tpaged.gather_footprint(tc)
        assert j == t, arch
        assert jpaged.pool_block_bytes(jc) == tpaged.pool_block_bytes(tc)
        state_layers = sum(s.kind == "mamba" for s in tc.layer_specs)
        assert t["num_state_layers"] == state_layers == \
            n_state[0 if full else 1], arch
        assert (t["state_bytes_per_step"] > 0) == (state_layers > 0)
        if not full and state_layers:
            pages = tpaged.init_paged_caches(tc, tc.serving)
            held = sum(leaf.numel() * leaf.element_size()
                       for leaf in tpaged.state_leaves(tc, pages))
            assert held == t["state_bytes_per_step"], arch
        if state_layers == tc.num_layers:
            assert tpaged.pool_block_bytes(tc)["per_block_id"] == 0


def _jax_requests(cfg, num_requests, rate_rps, prompt_lens, max_new, seed,
                  arrivals, prompts):
    """The request list ``repro.launch.serve.run_continuous`` builds,
    rebuilt with numpy as (prompt, max_new_tokens, arrival) tuples."""
    if prompts is not None:
        if arrivals is None:
            rng = np.random.default_rng(seed)
            t, arrivals = 0.0, []
            for _ in range(num_requests):
                t += float(rng.exponential(1.0 / rate_rps))
                arrivals.append(t)
        return [(list(p), max_new, t) for p, t in zip(prompts, arrivals)]
    if arrivals is None:
        rng = np.random.default_rng(seed)
        t, out = 0.0, []
        for _ in range(num_requests):
            t += float(rng.exponential(1.0 / rate_rps))
            plen = int(rng.choice(prompt_lens))
            out.append((rng.integers(0, cfg.vocab_size, size=plen,
                                     dtype=np.int64).tolist(), max_new, t))
        return out
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=prompt_lens[i % len(prompt_lens)]).tolist(),
             max_new, t) for i, t in enumerate(arrivals)]


class _StubEngine:
    """Stands in for the continuous engine: records the requests."""

    def __init__(self, cfg, **kw):
        pass

    def warmup(self, reqs):
        pass

    def run(self, reqs, realtime=True):
        self.reqs = reqs
        return "metrics"


@pytest.mark.parametrize("with_prompts", [False, True],
                         ids=["random prompts", "explicit prompts"])
@pytest.mark.parametrize("with_arrivals", [True, False],
                         ids=["arrivals", "poisson"])
def test_run_continuous_requests_match_jax(monkeypatch, with_arrivals,
                                           with_prompts):
    from repro_torch.serving import engine as tengine
    monkeypatch.setattr(tengine, "ContinuousBatchingEngine", _StubEngine)
    cfg = tget("gemma-7b").smoke()
    n, lens, seed = 5, [7, 30, 12], 3
    arrivals = [0.01 * i for i in range(n)] if with_arrivals else None
    prompts = None
    if with_prompts:
        prompts = [np.random.default_rng(9).integers(0, 256, 4 + i).tolist()
                   for i in range(n)]
    reqs, metrics, engine = tserve.run_continuous(
        cfg, n, 50.0, lens, 6, seed=seed, realtime=False, device="cpu",
        arrivals=arrivals, prompts=prompts)
    assert metrics == "metrics" and engine.reqs is reqs
    want = _jax_requests(cfg, n, 50.0, lens, 6, seed, arrivals, prompts)
    got = [(r.prompt, r.max_new_tokens, r.arrival) for r in reqs]
    assert got == want
    if with_arrivals and not with_prompts:
        # prompt lengths cycle through prompt_lens in order
        assert [len(r.prompt) for r in reqs] == [7, 30, 12, 7, 30]


def test_run_continuous_refuses_wrong_lengths(monkeypatch):
    from repro_torch.serving import engine as tengine
    monkeypatch.setattr(tengine, "ContinuousBatchingEngine", _StubEngine)
    cfg = tget("llama31-8b").smoke()
    with pytest.raises(ValueError, match="arrivals"):
        tserve.run_continuous(cfg, 3, 1.0, [8], 4, device="cpu",
                              arrivals=[0.0, 0.1])
    with pytest.raises(ValueError, match="prompts"):
        tserve.run_continuous(cfg, 3, 1.0, [8], 4, device="cpu",
                              prompts=[[1, 2]])


def test_serving_ceiling_bounds_legacy_prompts():
    """Chunked prefill is bounded by the block table alone; legacy mode
    also by the largest prefill bucket."""
    cfg = tget("llama31-8b").smoke()
    sv = cfg.serving
    assert tserve.serving_ceiling(cfg) == sv.max_context
    legacy = cfg.replace(serving=sv.replace(prefill_chunk=0,
                                            prefill_buckets=(16, 32)))
    assert tserve.serving_ceiling(legacy) == 32 == jserve.serving_ceiling(
        jget("llama31-8b").smoke().replace(serving=jget(
            "llama31-8b").smoke().serving.replace(
                prefill_chunk=0, prefill_buckets=(16, 32))))
