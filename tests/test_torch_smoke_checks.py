"""CPU tests of ``chip_smoke.py``'s SOCKET tie handling.

The continuous phase runs one decode iteration through the fused paged
SOCKET kernel and through the plain paged path and holds their logits to
each other.  ``socket_ties_shared`` pairs each kernel call with the plain
top-k of the same layer: where the two selections differ only at rows
whose plain effective score lies within SCORE_TOL of the top-k threshold
(the kernel check's band), the plain path takes the kernel's selection;
any other difference raises.  Here the kernel's selection is given
directly (no card), on hand-made scores with a tie at the threshold.

The static phase's step-0 gate does the same with ``static_ties_shared``:
the top-k calls of the kernel route (``socket_score``'s scores) keep
their selections, and the plain route's calls pair with them in order.

Phase 9's gates (context-parallel decode) run at smoke size on simulated
ranks, sound and with a wrong ``lo``, a budget of the local rows and a
-inf masked logit.  Phase 9c's (the other backends' CP routes): a rank's
layer-0 selection with one index moved, one mask entry flipped or a
step missing, and Quest bounds off by a key's rounding on a page the
steps did not write or off by more than the tolerance on one they did:
each must fail.

Phase 10's gates (the Trainer's mesh) run on 4 gloo CPU ranks at smoke
width through the phase's own rank body, sound and with a gradient
summed over the ``model`` axis, a global norm that counts a replicated
block once a rank, and a loss over a rank's own valid-token count; and
10a's 8-bit case, sound and with a leaf never updated and with 8-bit
block scales gathered in another rank order (faults that only the
parameter and moment gates see): each fault fails them.  The launch, compression and elastic gates run on
hand-made results.

Phase 11's gates run at smoke width on the CPU, sound and with a planted
fault each must fail: 11a's (the sharded step of ``mixtral-8x22b.smoke()``
with ``"alltoall"`` on (2, 2) against one process's plain exchange at
dropless capacity, the expert leaves' bytes, the drops case against the
plain exchange) in the same spawn of 4 gloo ranks as phase 10's, with the
expert gradients summed over ``model`` and with a slot sort that orders
ties the other way; 11b's (``gpipe_forward`` of 4 stages of 2
``llama31-8b.smoke()`` blocks against the sequential stack) in that spawn
too, with a microbatch lost at a stage boundary; 11c's cache layout gate
on ``gemma3-27b`` and ``jamba-v0.1-52b`` smoke prefills under a CP mesh
computed in this process, with a rank whose ring was sliced and one
whose global cache is whole.

Phase 12's gates: the baselines' (a PQ code moved outside the rounding
band, a bit flipped in a bucket id, a sign flipped clear of rounding, a
baseline's output left on the CPU: each must fail; codes and signs that
part inside the band pass and are counted), its cases (musicgen's
kernel shapes, the static cases of the two embeddings models), and the
whole phase rehearsed at smoke width on the CPU (the wrappers' plain
versions, launches counted around them).

Phase 13's gates (the dry run's rank 0 on the card): a count of a smoke
decode step on fake tensors against the same step with one more
operator call, a peak 20 % from the prediction, a step timed below its
floor, a non-finite logit and a kernel launched once too often: each
must fail, and the sound cases pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
from unittest import mock

import pytest
import torch

from repro_torch.core import socket as sk
from repro_torch.kernels.paged_attention import ops as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N, K = 16, 4


@contextlib.contextmanager
def one_thread():
    """Run the body on one intra-op thread: smoke-width models gain little
    from more, and under a parallel test runner every worker's thread
    pool fighting for the same cores made the card-traffic cases at
    smoke width (tens of thousands of prefill tokens) many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _scores():
    """Effective scores falling from 2 to 0.5 over 16 rows, row 4 within
    2e-7 relative of row 3 (the 4th largest: the threshold at k 4)."""
    scores = torch.linspace(2.0, 0.5, N).reshape(1, 1, N)
    scores[0, 0, 4] = scores[0, 0, 3] * (1 - 2e-7)
    return scores


def _kernel_selecting(rows):
    """A stand-in for the fused kernel that selects ``rows``, in the
    launch's (B, KVH, nb, bs) int32 layout."""
    sel = torch.zeros(1, 1, N, dtype=torch.int32)
    sel[0, 0, rows] = 1

    def kernel(*args, with_selection=False, **kw):
        assert with_selection
        return torch.zeros(1), sel.reshape(1, 1, 2, N // 2)
    return kernel


def _plain_topk(scores):
    cfg = sk.SocketConfig(sink_tokens=0, window_tokens=0)
    idx, mask = sk.value_aware_topk(cfg, scores, torch.ones_like(scores),
                                    k=K, length=torch.tensor([N]),
                                    n_total=N, budget=torch.tensor([K]))
    return sorted(idx[0, 0][mask[0, 0]].tolist())


@pytest.mark.parametrize("rows, want, swapped", [
    ([0, 1, 2, 3], [0, 1, 2, 3], []),     # the same selection: plain's
    ([0, 1, 2, 4], [0, 1, 2, 4], [2]),    # a tie swapped: the kernel's
], ids=["same", "tie"])
def test_plain_topk_takes_the_kernel_selection_inside_the_band(rows, want,
                                                               swapped):
    cs = _chip_smoke()
    got = []
    with mock.patch.object(pa, "paged_socket_attend",
                           _kernel_selecting(rows)):
        with cs.socket_ties_shared(got):
            pa.paged_socket_attend()
            assert _plain_topk(_scores()) == want
    assert got == swapped
    assert _plain_topk(_scores()) == [0, 1, 2, 3]    # unpatched again


def test_a_selection_outside_the_band_fails():
    cs = _chip_smoke()
    with mock.patch.object(pa, "paged_socket_attend",
                           _kernel_selecting([0, 1, 2, 9])):
        with pytest.raises(AssertionError, match="outside the threshold"):
            with cs.socket_ties_shared([]):
                pa.paged_socket_attend()
                _plain_topk(_scores())


@pytest.mark.parametrize("kernel_calls", [0, 2], ids=["no kernel call",
                                                       "a kernel call left"])
def test_calls_must_pair(kernel_calls):
    cs = _chip_smoke()
    with mock.patch.object(pa, "paged_socket_attend",
                           _kernel_selecting([0, 1, 2, 3])):
        with pytest.raises(AssertionError, match="pair with"):
            with cs.socket_ties_shared([]):
                for _ in range(kernel_calls):
                    pa.paged_socket_attend()
                _plain_topk(_scores())


def _kernel_route_scores(row, value):
    """The hand-made scores with ``row`` set to ``value``: what the kernel
    route's ``socket_score`` hands its top-k."""
    scores = _scores()
    scores[0, 0, row] = value
    return scores


@pytest.mark.parametrize("tie, want, swapped", [
    (False, [0, 1, 2, 3], []),            # the same scores: plain's
    (True, [0, 1, 2, 4], [2]),            # a tie swapped: the kernel's
], ids=["same", "tie"])
def test_static_plain_topk_takes_the_kernel_route_selection_inside_the_band(
        tie, want, swapped):
    cs = _chip_smoke()
    got = []
    # the tie: the kernel route ranks row 4 a few ulps above row 3
    kernel_scores = _kernel_route_scores(
        4, float(_scores()[0, 0, 3]) * (1 + 2e-7)) if tie else _scores()
    with cs.static_ties_shared(got) as to_plain:
        assert _plain_topk(kernel_scores) == want
        to_plain()
        assert _plain_topk(_scores()) == want
    assert got == swapped
    assert _plain_topk(_scores()) == [0, 1, 2, 3]    # unpatched again


def test_a_static_selection_outside_the_band_fails():
    """The kernel route selecting row 9 (plain score 1.1, far below the
    threshold 1.7) in place of row 3 fails the gate."""
    cs = _chip_smoke()
    with pytest.raises(AssertionError, match="outside the threshold"):
        with cs.static_ties_shared([]) as to_plain:
            assert _plain_topk(_kernel_route_scores(9, 1.75)) == [0, 1, 2, 9]
            to_plain()
            _plain_topk(_scores())


@pytest.mark.parametrize("kernel_calls", [0, 2], ids=["no kernel call",
                                                       "a kernel call left"])
def test_static_calls_must_pair(kernel_calls):
    cs = _chip_smoke()
    with pytest.raises(AssertionError, match="pair with"):
        with cs.static_ties_shared([]) as to_plain:
            for _ in range(kernel_calls):
                _plain_topk(_scores())
            to_plain()
            _plain_topk(_scores())


# ---------------------------------------------------------- prefix phase


def _prefix_engine(**serving):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import apply_backend_arg
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg = apply_backend_arg(get_config("stablelm-12b").smoke(),
                            "socket_fused")
    cfg = cfg.replace(serving=cfg.serving.replace(prefix_cache=True,
                                                  **serving))
    return ContinuousBatchingEngine(cfg, device="cpu")


def _tail_traffic():
    """A 21-token prompt served alone, then its extension past the tail
    page beside a second extension: tail hits and clones."""
    gen = torch.Generator().manual_seed(3)

    def draw(n):
        return torch.randint(0, 256, (n,), generator=gen).tolist()

    first = draw(21)
    return first, [first + draw(11), first + draw(5)]


def _serve(engine, prompts, steps=4):
    from repro_torch.serving import Request
    reqs = [Request(prompt=list(p), max_new_tokens=steps) for p in prompts]
    engine.run(reqs, realtime=False)
    return [r.generated for r in reqs]


def test_shared_pages_frozen_and_clone_spy_pass_a_warm_run():
    """The prefix phase's checks on a CPU warm run: every shared page held
    bitwise across iterations, every clone's rows past keep at the fill."""
    cs = _chip_smoke()
    engine = _prefix_engine()
    first, rest = _tail_traffic()
    clones = []
    with cs.clone_spy(clones):
        _serve(engine, [first])
        frozen = cs.SharedPagesFrozen(engine)
        engine.iter_hook = frozen
        _serve(engine, rest)
    assert frozen.checked > 0 and frozen.most >= 2
    assert len(clones) == engine.registry.value("prefix_cache_cow_total") \
        >= 1
    assert clones[0]["keep"] == 5
    assert clones[0]["leaves"] == ["bits", "k", "v", "vnorm"]


def test_shared_pages_frozen_catches_a_write_in_place():
    """A write into a page while it is shared fails the CoW check."""
    cs = _chip_smoke()
    engine = _prefix_engine()
    first, rest = _tail_traffic()
    _serve(engine, [first])
    frozen = cs.SharedPagesFrozen(engine)

    def hook(eng, it):
        frozen(eng, it)
        if frozen.frozen:
            eng.pages[1]["v"][min(frozen.frozen), 0, 0, 0] += 1.0

    engine.iter_hook = hook
    with pytest.raises(AssertionError, match="written in place"):
        _serve(engine, rest)


def test_clone_spy_catches_a_clone_without_scrub():
    """A clone that copies the whole page (no scrub past keep) fails."""
    cs = _chip_smoke()
    from repro_torch.serving import paged
    real = paged.clone_block
    engine = _prefix_engine()
    first, rest = _tail_traffic()
    _serve(engine, [first])
    with mock.patch.object(paged, "clone_block",
                           lambda cfg, pages, src, dst, keep:
                           real(cfg, pages, src, dst, 8)):
        with pytest.raises(AssertionError, match="fill"):
            with cs.clone_spy([]):
                _serve(engine, rest)


def test_first_parting():
    cs = _chip_smoke()
    assert cs.first_parting([[1, 2], [3, 4]], [[1, 2], [3, 4]]) is None
    assert cs.first_parting([[1, 2], [3, 4]], [[1, 2], [3, 5]]) == (1, 1)


def test_card_prefix_case_at_smoke_width():
    """The prefix phase's traffic (``card_prefix_case``: 8 prompts of 3072
    tokens sharing 2300, chunks of 512) at smoke width on the CPU, with the
    phase's checks: warm tokens equal cold, 8 hits of 2300 cached tokens,
    one clone a hit (keep 12 of the template's tail page), shared pages
    frozen, no preemption; Quest page-aligns to 2288 and never clones."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import card_prefix_case
    from repro_torch.serving.engine import ContinuousBatchingEngine
    for backend, cached, cow in (("socket_fused", 2300, 8),
                                 ("quest_fused", 2288, 0)):
        cfg, template, prompts = card_prefix_case(
            get_config("llama31-8b").smoke(), 0, 4, backend)
        off = cfg.replace(serving=cfg.serving.replace(prefix_cache=False))
        engine = ContinuousBatchingEngine(cfg, device="cpu")
        clones = []
        with one_thread(), cs.clone_spy(clones):
            cold = _serve(ContinuousBatchingEngine(off, device="cpu"),
                          prompts)
            _serve(engine, [template])
            engine.iter_hook = frozen = cs.SharedPagesFrozen(engine)
            warm = _serve(engine, prompts)
        reg = engine.registry
        assert warm == cold
        assert reg.value("prefix_cache_hits_total") == 8
        assert reg.value("prefix_cache_cached_tokens_total") == 8 * cached
        assert reg.value("prefix_cache_cow_total") == len(clones) == cow
        assert all(c["keep"] == 2300 % 16 for c in clones)
        assert frozen.checked > 0
        assert reg.value("serve_preemptions_total") == 0


# ------------------------------------------------- socket_score equal bits


def _fake_score_ops(c=3, broken_rank=None):
    """``socket_score``'s ops as chip_smoke's equal-bits check calls them,
    on the CPU: the plain version, a plan of C ranks with resident tables,
    and a table dump laid out from the plain split tables on every rank.
    ``broken_rank``: every launch adds 1e-6 to the first key of that
    rank's run (a fault the check must catch)."""
    from types import SimpleNamespace
    from repro_torch.kernels.socket_score import ops
    from repro_torch.kernels.socket_score.ref import (socket_score_ref,
                                                      split_tables)

    def launch(bits, u, vnorm, **kw):
        out = socket_score_ref(bits, u, vnorm, **kw)
        if broken_rank is not None:
            out[:, broken_rank * -(-bits.shape[1] // c)] += 1e-6
        return out

    def table_dump(bits, u, *, num_tables, num_planes, tau):
        t_lo, t_hi = split_tables(u, tau)
        g, n_lo = u.shape[1], t_lo.shape[-1]
        sets = torch.cat([t_lo, t_hi], -1).transpose(1, 2)   # (BH, L, G, .)
        sets = sets.reshape(u.shape[0], 1, num_tables * g, -1)
        stride = -(-sets.shape[-1] // 4) * 4
        dump = torch.nn.functional.pad(sets, (0, stride - sets.shape[-1]))
        assert n_lo == 1 << ((num_planes + 1) // 2)
        out = launch(bits, u, None, num_tables=num_tables,
                     num_planes=num_planes, tau=tau)
        return out, dump.expand(-1, c, -1, -1)

    return SimpleNamespace(
        socket_score_plan=lambda bits, g, **kw: {"C": c, "resident": True},
        key_runs=ops.key_runs, launch_socket_score=launch,
        table_dump=table_dump, tables_of_dump=ops.tables_of_dump)


def _score_inputs(cs):
    gen = torch.Generator().manual_seed(0)
    bits, u, _ = cs.socket_score_case("cpu", gen, bh=2, n=1600, g=2, l=6,
                                      p=4, int8=False, vnorm=False)
    return bits, u, dict(num_tables=6, num_planes=4, tau=0.4)


def test_equal_rows_check_passes_equal_scores(capsys):
    cs = _chip_smoke()
    bits, u, args = _score_inputs(cs)
    cs.equal_rows_check(_fake_score_ops(), bits, u, args)
    assert "score bit-equal" in capsys.readouterr().out


def test_equal_rows_check_reports_then_fails(capsys):
    """A rank whose equal-bit key scores differently fails the check, after
    the report: the key and rank that differ, the relaunches, every rank's
    tables against the plain ones, the card line."""
    cs = _chip_smoke()
    bits, u, args = _score_inputs(cs)
    with one_thread(), pytest.raises(AssertionError,
                                     match="score differently"):
        cs.equal_rows_check(_fake_score_ops(broken_rank=1), bits, u, args)
    out = capsys.readouterr().out
    assert "rank 1 |diff| 1." in out
    assert f"{cs.EQUAL_ROWS_RELAUNCHES} relaunches: 0 differ from the first" \
        in out and f"{cs.EQUAL_ROWS_RELAUNCHES} break the equal rows" in out
    for r in range(3):
        assert f"rank {r}'s tables: equal to rank 0's True, to each set's " \
               "owner's True" in out
    assert "card: " in out


# ------------------------------------------------ observability phase


def _observed_run(tmp_path, every=2):
    """An observed socket_fused run at smoke width: trace, the probe
    every ``every`` iterations, a 3-iteration profiler window from 2."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import apply_backend_arg
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.obs import Observability
    cfg = apply_backend_arg(get_config("llama31-8b").smoke(), "socket_fused")
    obs = Observability(probe_every=every, profile_dir=str(tmp_path),
                        profile_steps=3, profile_start_step=2)
    engine = ContinuousBatchingEngine(cfg, device="cpu", obs=obs)
    gen = torch.Generator().manual_seed(4)
    reqs = [Request(prompt=torch.randint(0, 256, (n,), generator=gen)
                    .tolist(), max_new_tokens=5) for n in (9, 20, 30)]
    m = engine.run(reqs, realtime=False)
    return cfg, obs, reqs, m


def test_observability_checks_pass_an_observed_run(tmp_path):
    """Phase 5c's trace and probe checks pass a CPU run, and the window's
    steps are the profiler's iterations."""
    cs = _chip_smoke()
    cfg, obs, reqs, m = _observed_run(tmp_path)
    evs = obs.tracer.events
    cs.trace_check("cpu", evs, reqs, m.decode_iters)
    cs.probe_rows_check("cpu", obs.probe.rows, evs, cfg.num_layers, 2)
    assert [e["iter"] for e in cs.window_steps(evs)] == [2, 3, 4]


def test_observability_checks_catch_faults(tmp_path):
    cs = _chip_smoke()
    cfg, obs, reqs, m = _observed_run(tmp_path)
    evs, rows = obs.tracer.events, obs.probe.rows
    with pytest.raises(AssertionError, match="first_token"):
        cs.trace_check("cpu", [e for e in evs if e["ev"] != "first_token"],
                       reqs, m.decode_iters)
    with pytest.raises(AssertionError, match="number"):
        cs.trace_check("cpu", evs, reqs, m.decode_iters + 1)
    with pytest.raises(AssertionError, match="probed layers"):
        cs.probe_rows_check("cpu", rows[1:], evs, cfg.num_layers, 2)
    with pytest.raises(AssertionError, match="probed iterations"):
        cs.probe_rows_check("cpu", rows, evs, cfg.num_layers, 4)
    bad = [dict(rows[0], recall=1.5)] + rows[1:]
    with pytest.raises(AssertionError, match="out of range"):
        cs.probe_rows_check("cpu", bad, evs, cfg.num_layers, 2)
    with pytest.raises(AssertionError, match="profile_start"):
        cs.window_steps([e for e in evs if e["ev"] != "profile_stop"])


def test_profiled_kernel_events_counts_device_kernels():
    """On a canned Chrome trace: device kernel events whose demangled or
    mangled name holds the kernel's; CPU ops and launches of that name,
    and other kernels, are not counted."""
    cs = _chip_smoke()
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel",
         "name": "void paged_socket_kernel<(Mode)0, float, 4>(float const*)"},
        {"ph": "X", "cat": "kernel",
         "name": "_Z19paged_socket_kernelIL4Mode0EfLi4EEvPKf"},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "args": {"kernel": "paged_socket_kernel"}},
        {"ph": "X", "cat": "cpu_op", "name": "paged_socket_kernel"},
        {"ph": "X", "cat": "kernel", "name": "void paged_quest_kernel<float>"},
        {"ph": "i", "name": "decode"}]}
    assert cs.profiled_kernel_events(trace, "paged_socket_kernel") == 2
    assert cs.profiled_kernel_events(trace, "paged_ring_kernel") == 0
    assert cs.profiled_kernel_events({}, "paged_socket_kernel") == 0


def test_residency_math_and_bar():
    """Resident requests in the bf16 pool's byte budget, and the 1.8x bar
    int8 pages must clear (floored request counts: 17 of 9 pass, 14 of 8
    do not)."""
    cs = _chip_smoke()
    per = {"bf16": 7927808, "int8": 4315136, "auto": 15267840}
    res = cs.residency(per, 1536, 162)
    assert res == {"bf16": 9, "int8": 17, "auto": 4}
    assert cs.residency_check(res) == 17 / 9
    with pytest.raises(AssertionError, match="below the 1.8x bar"):
        cs.residency_check(cs.residency(per, 1297, 162))


def test_gemma7b_residency_clears_the_bar(capsys):
    """gemma-7b's continuous card case at full width, host-only: the
    pool_block_bytes of each page dtype and the resident requests in its
    1536-block bf16 pool's budget (8 requests of 1K-4K tokens and 32 new:
    162 blocks each) are logged, and int8 holds >= 1.8x bf16."""
    cs = _chip_smoke()
    res = cs.gemma7b_residency(0)
    assert res == {"auto": 4, "bf16": 9, "int8": 17, "fp8": 17}
    assert '"gemma7b_residency"' in capsys.readouterr().out


def test_pool_block_bytes_check_reads_every_leaf():
    """The bytes a block id holds in an engine's pool equal
    ``pool_block_bytes`` (f32 SOCKET pages, int8 pages with scales,
    Quest's page stats, jamba's one paged layer beside its Mamba layers'
    slot rows, mamba2's pool of state rows alone: 0, gemma3's ring
    layers); a pool missing a leaf fails."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import apply_backend_arg, apply_kv_dtype
    from repro_torch.serving.paged import init_paged_caches
    for arch, backend, kv in (("llama31-8b", "socket_fused", "auto"),
                              ("gemma-7b", "socket_fused", "int8"),
                              ("gemma-7b", "quest_fused", "bf16"),
                              ("jamba-v0.1-52b", "socket_fused", "int8"),
                              ("mamba2-780m", "socket_fused", "auto"),
                              ("gemma3-27b", "socket_fused", "fp8")):
        cfg = apply_kv_dtype(apply_backend_arg(get_config(arch).smoke(),
                                               backend), kv)
        cfg = cfg.replace(use_ring_kernel=arch == "gemma3-27b")
        pages = init_paged_caches(cfg, cfg.serving)
        assert (cs.pool_block_bytes_check(cfg, pages) > 0) == \
            (arch != "mamba2-780m")
    del pages[0]["k_scale"]
    with pytest.raises(AssertionError, match="pool_block_bytes"):
        cs.pool_block_bytes_check(cfg, pages)


def test_all_global_cases():
    """The card's gemma-7b and minitron-8b cases: llama31-8b's traffic at
    full depth; the paged kernels' head-dim cases (hd 256 at G 1, hd 160
    at G 4) run on every pool of all three kernels, the hd 256 one
    timed."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CARD_CASES, card_continuous_case
    assert CARD_CASES["gemma-7b"] == CARD_CASES["minitron-8b"] == \
        CARD_CASES["llama31-8b"]
    cfg, reqs = card_continuous_case(get_config("gemma-7b"), 0, 32)
    assert cfg.serving.num_blocks == 1536 and cfg.num_layers == 28
    assert sorted(len(r.prompt) for r in reqs) == sorted(cs.MAIN_LENS)
    for name, cases in cs.PAGED_CASES.items():
        labels = [label for label, _ in cases]
        for label, kw in cs._HEAD_DIM_CASES:
            assert label in labels and label.startswith(cs.STORED_CASES)
        assert cs.GEMMA7B_TIMED in labels
    gemma = dict(cs._HEAD_DIM_CASES)[cs.GEMMA7B_TIMED]
    g7 = get_config("gemma-7b")
    assert (gemma["kvh"], gemma["g"], gemma["hd"]) == (
        g7.num_kv_heads, g7.num_heads // g7.num_kv_heads, g7.head_dim)
    assert cs.STATIC_CASES["gemma-7b"] == (2, 4096, 16)
    # the other kernels' gemma-7b cases are its static path's shapes
    from repro_torch.core import socket as sk
    from repro_torch.kernels.flash_decode.cases import CARD_CASES
    fd = dict(CARD_CASES)[cs.GEMMA7B_TIMED]
    scfg = sk.SocketConfig(sink_tokens=128, window_tokens=128)
    assert (fd["bh"], fd["g"], fd["hd"], fd["k"]) == (
        32, 1, 256, sk.topk_budget(scfg, 4096 + 16))
    prefill = [c for c in cs.PREFILL_CASES if c[0] == cs.GEMMA7B_TIMED]
    assert [c[1:5] for c in prefill] == [(32, 32, 4096, 256)]


@pytest.mark.parametrize("arch,backend,kv_dtype", [
    ("gemma-7b", "quest_fused", "auto"), ("llama31-8b", "socket_fused",
                                          "fp8"),
    ("gemma3-27b", "socket_fused", "int8"),
    ("jamba-v0.1-52b", "socket_fused", "auto")])
def test_compact_pool_decodes_as_the_pool(arch, backend, kv_dtype):
    """The continuous check's snapshot (``compact_pool``: the blocks the
    batch's tables name, renumbered, and every Mamba layer's slot rows
    whole) gives the decode step's logits and writes of the whole pool
    bit for bit, and holds fewer blocks."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import apply_backend_arg, apply_kv_dtype
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.paged import raw_view
    cfg = apply_kv_dtype(apply_backend_arg(get_config(arch).smoke(),
                                           backend), kv_dtype)
    cfg = cfg.replace(use_ring_kernel=arch == "gemma3-27b")
    engine = ContinuousBatchingEngine(cfg, device="cpu")
    seen = {}

    def hook(eng, it):
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) < 2 or any(len(r.blocks) * cfg.serving.block_size
                                   <= r.pos for r in running) or seen:
            return
        tokens, bt, pos = eng._batch_inputs(running)
        pages, cbt = cs.compact_pool(cfg, eng.pages, bt)
        full = [{k: v.clone() for k, v in layer.items()}
                for layer in eng.pages]
        step = make_serve_step(cfg)
        lf, _ = step(eng.params, full, tokens, pos, bt)
        lc, _ = step(eng.params, pages, tokens, pos, cbt)
        att = next(i for i, s in enumerate(cfg.layer_specs)
                   if s.kind == "attn")
        seen.update(blocks=pages[att]["k"].shape[0],
                    pool=full[att]["k"].shape[0], same=torch.equal(lf, lc),
                    state=sum("ssm" in layer for layer in pages))
        ids = torch.unique(torch.cat([torch.zeros(1, dtype=bt.dtype),
                                      bt.flatten()]))
        for a, b in zip(full, pages):
            for name in a:
                rows = slice(None) if name in ("ssm", "conv") else \
                    ids.long()
                assert torch.equal(raw_view(a[name])[rows],
                                   raw_view(b[name])), name

    engine.iter_hook = hook
    rng = torch.Generator().manual_seed(3)
    reqs = [Request(prompt=torch.randint(0, 256, (n,), generator=rng)
                    .tolist(), max_new_tokens=6) for n in (20, 37, 9)]
    with one_thread():
        engine.run(reqs, realtime=False)
    assert seen["same"] and seen["blocks"] < seen["pool"]
    assert seen["state"] == sum(s.kind == "mamba" for s in cfg.layer_specs)


# ------------------------------------------------------ state and MoE

def test_state_carry_check_fails_on_a_zeroed_carry():
    """Phase 5e's mamba2 check at smoke width: each request's last-step
    logits (``last_step_logits``) held to a whole-sequence prefill of its
    prompt and generated tokens pass ``STATE_CARRY_ATOL``; with the carry
    between chunks zeroed (every chunk starting from zero state) they
    fail it."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg = get_config("mamba2-780m").smoke()
    params = tfm.init_model(cfg, 0)
    prompts = [torch.randint(0, 256, (n,), generator=torch.Generator()
                             .manual_seed(n)).tolist() for n in (40, 23)]
    real = tfm.mb.mamba_train

    def zeroed(cfg, params, x, h0=None, conv0=None, **kw):
        return real(cfg, params, x, **kw)

    errs = {}
    for label in ("carried", "zeroed"):
        engine = ContinuousBatchingEngine(cfg, params=params, device="cpu")
        last = cs.last_step_logits(engine)
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        with one_thread(), mock.patch.object(
                tfm.mb, "mamba_train",
                zeroed if label == "zeroed" else real):
            engine.run(reqs, realtime=False)
        assert set(last) == {r.rid for r in reqs}
        if label == "carried":
            errs[label] = cs.state_carry_check(cfg, params, reqs, last)
            assert max(errs[label]) < cs.STATE_CARRY_ATOL / 10
        else:
            with pytest.raises(AssertionError, match="whole-sequence"):
                cs.state_carry_check(cfg, params, reqs, last)


def test_ring_wrap_check_reads_the_chunk_trace():
    """Mixtral's gate: a prompt longer than its ring must have chunks
    ending past the ring's rows; a trace that stops short fails."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CARD_CASES, card_continuous_case
    from repro_torch.serving import Request
    cfg, reqs = card_continuous_case(get_config("mixtral-8x22b"), 0, 32)
    assert cfg.num_layers == 4 and cfg.use_ring_kernel
    assert cfg.ring_geometry() == (256, 4096)
    assert sorted({len(r.prompt) for r in reqs}) == \
        CARD_CASES["mixtral-8x22b"][0]
    rows = 4096

    class Trace:
        chunk_trace = [(0, 0, 0, 512), (1, 0, 4096, 512), (2, 1, 0, 512)]

    long = [Request(prompt=[1] * 6144, max_new_tokens=1),
            Request(prompt=[1] * 100, max_new_tokens=1)]
    long[0].rid, long[1].rid = 0, 1
    assert cs.ring_wrap_check(cfg, Trace, long) == {0: (6144, rows + 512)}
    Trace.chunk_trace = [(0, 0, 0, 512)]
    with pytest.raises(AssertionError, match="did not wrap"):
        cs.ring_wrap_check(cfg, Trace, long)


def test_moe_routes_shared_takes_the_kernel_route_inside_the_band():
    """The static and continuous checks' MoE pairing: where the plain
    route's router sends a token elsewhere only because its k-th and
    (k+1)-th probabilities tie within ROUTE_TOL, it takes the kernel
    route's experts; a difference outside the band raises."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import param as pm
    cfg = get_config("mixtral-8x22b").smoke()
    params = pm.unbox(moe.init_moe(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    # experts 0 and 2 score equally: the kernel route keeps expert 0 (the
    # lower index), the plain route, its column 1e-7 lower, expert 2
    tied = params["router"].clone()
    tied[:, 2] = tied[:, 0]
    flip = tied.clone()
    flip[:, 0] *= 1 - 1e-7
    k_idx, _, _ = moe._router(cfg, dict(params, router=tied), x)
    p_own, _, _ = moe._router(cfg, dict(params, router=flip), x)
    differ = int((k_idx.sort(-1).values != p_own.sort(-1).values)
                 .any(-1).sum())
    assert differ > 0
    swapped = []
    with cs.moe_routes_shared(swapped) as to_plain:
        moe._router(cfg, dict(params, router=tied), x)
        to_plain()
        p_idx, p_probs, _ = moe._router(cfg, dict(params, router=flip), x)
    assert torch.equal(p_idx.sort(-1).values, k_idx.sort(-1).values)
    assert swapped == [differ]
    assert torch.allclose(p_probs.sum(-1), torch.ones(64))
    with pytest.raises(AssertionError, match="probability band"):
        with cs.moe_routes_shared([]) as to_plain:
            moe._router(cfg, params, x)
            to_plain()
            moe._router(cfg, params, -x)


def test_state_and_moe_card_cases():
    """Phase 5e's cases: jamba at 1 of 4 groups (8 layers: 1 attention, 7
    Mamba, 4 MoE; 13.27 B parameters), mamba2 at full depth (48 Mamba
    layers), mixtral at 4 of 56 layers (10.42 B, prompts to 8192 on a
    4096-token window); none preempts at 32 or 64 new tokens; jamba's
    static case as gemma-7b's."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import card_continuous_case
    got = {}
    for arch in ("jamba-v0.1-52b", "mamba2-780m", "mixtral-8x22b"):
        for new in (32, 64):
            cfg, reqs = card_continuous_case(get_config(arch), 0, new)
            cfg.serving.validate()
            assert all(r.max_new_tokens == new for r in reqs)
        kinds = cs.layer_kinds(cfg)
        got[arch] = (cfg.num_layers, kinds.count("mamba"),
                     sum(s.mlp == "moe" for s in cfg.layer_specs),
                     round(cfg.param_count() / 1e9, 2))
    assert got == {"jamba-v0.1-52b": (8, 7, 4, 13.27),
                   "mamba2-780m": (48, 48, 0, 0.86),
                   "mixtral-8x22b": (4, 0, 4, 10.42)}
    assert cs.STATIC_CASES["jamba-v0.1-52b"] == (2, 4096, 16)


def test_profile_decode_span_part():
    """``profile_decode``'s spans: a device kernel belongs to the
    innermost span whose range holds its start, and names its part."""
    from repro_torch.launch import profile_decode as pd
    spans = [("moe", 10.0, 50.0), ("moe_experts", 20.0, 40.0),
             ("mamba", 60.0, 70.0)]
    kernels = [("sm90_gemm", 25.0, 1.5), ("index_put", 12.0, 0.25),
               ("sm90_gemm", 30.0, 1.0), ("elementwise", 61.0, 0.5),
               ("paged_socket_kernel", 80.0, 0.125)]
    by = pd.span_part(kernels, spans)
    parts = {}
    for name, ms in by.items():
        parts[pd.kernel_part(name)] = parts.get(pd.kernel_part(name),
                                                0) + ms
    assert parts == {"moe_experts": 2.5, "moe": 0.25, "mamba": 0.5,
                     "paged_attention": 0.125}


# ------------------------------------------------------ bf16 numerics (5f)

def test_bf16_configs_and_cases():
    """Phase 5f's configs: the deployment numerics of ``launch/specs.py``;
    the plain route the kernels are held to scores from float32 u; the
    float32 yardstick runs every plain version in float32; llama4's card
    case is one group (a dense and an MoE layer, 18.43 B parameters,
    36.9 GB in bf16) with llama31-8b's traffic, no preemption; the
    bf16-query cases name llama4's G 5."""
    cs = _chip_smoke()
    from repro_torch.launch.serve import (CARD_CASES, card_config,
                                          card_continuous_case)
    cfg = card_config("llama31-8b", "bf16")
    assert (cfg.param_dtype, cfg.compute_dtype, cfg.socket.score_dtype,
            cfg.socket.score_chunk, cfg.attn_q_chunk) == (
        "bfloat16", "bfloat16", "bfloat16", 16384, 1024)
    assert card_config("llama31-8b").compute_dtype == "float32"
    assert cs.is_bf16(cfg)
    with cs.paired(cs.moe_routes_shared, cfg, []) as to_plain:
        assert to_plain() is None         # bf16: nothing paired
    f32 = card_config("llama31-8b")
    with cs.paired(cs.moe_routes_shared, f32, []) as to_plain:
        to_plain()                        # f32: the routes paired
    assert cs.kernel_scoring(cfg).socket.score_dtype == "float32"
    fused, _ = card_continuous_case(cfg, 0, 32, "socket_fused")
    ref = cs.f32_reference(fused)
    assert ref.compute_dtype == "float32" and ref.param_dtype == "bfloat16"
    assert not (ref.socket.use_paged_kernel or ref.socket.use_score_kernel
                or ref.socket.use_flash_decode or ref.quest.use_paged_kernel
                or ref.use_ring_kernel)
    llama4 = "llama4-maverick-400b-a17b"
    assert CARD_CASES[llama4][:3] == CARD_CASES["llama31-8b"][:3]
    for new in (32, 64):
        c4, reqs = card_continuous_case(card_config(llama4, "bf16"),
                                        0, new, "socket_fused")
        c4.serving.validate()
    assert c4.num_layers == 2 and c4.uses_moe and c4.num_experts == 128
    assert round(c4.param_count() / 1e9, 2) == 18.43
    assert cs.STATIC_CASES[llama4] == (2, 4096, 16)
    g5 = dict(cs.BF16_Q_EXTRA)["llama4 G 5"]
    assert (g5["kvh"], g5["g"]) == (c4.num_kv_heads,
                                    c4.num_heads // c4.num_kv_heads)
    labels = {name: [label for label, _ in cases + cs.BF16_Q_EXTRA
                     if label.startswith(cs.BF16_Q_CASES)]
              for name, cases in cs.PAGED_CASES.items()}
    assert all(len(v) == 3 for v in labels.values()), labels
    sets = cs.bf16_queries([(torch.ones(2, 3), torch.ones(2))])
    assert sets[0][0].dtype == torch.bfloat16 and \
        sets[0][1].dtype == torch.float32
    assert cs.bound_bf16(3.35e12, 0.0) == (1000.0, "bytes")
    assert cs.bound_bf16(0.0, 989e12) == (1000.0, "operations")


def test_f32_distance_check_holds_the_kernel_route():
    """The bf16 gate: the kernel route's logits no farther from the
    float32 run's than F64_RATIO x the plain route's; a route twice as far
    again fails, as do non-finite logits."""
    cs = _chip_smoke()
    ref = torch.linspace(-3, 3, 64).reshape(2, 1, 32)
    plain = ref + 0.01 * torch.cos(torch.arange(64.0)).reshape(2, 1, 32)
    kernel = ref + 0.015 * torch.sin(torch.arange(64.0)).reshape(2, 1, 32)
    out = cs.f32_distance_check("case", kernel.bfloat16(), plain, ref)
    assert out["kernel_vs_f32"] <= cs.F64_RATIO * out["plain_vs_f32"]
    far = ref + 2.5 * cs.F64_RATIO * (plain - ref)
    with pytest.raises(AssertionError, match="more than"):
        cs.f32_distance_check("case", far, plain, ref)
    with pytest.raises(AssertionError, match="non-finite"):
        cs.f32_distance_check("case", kernel * float("nan"), plain, ref)


@pytest.mark.parametrize("arch", ["llama31-8b",
                                  "llama4-maverick-400b-a17b"])
def test_bf16_decode_iteration_against_f32(arch):
    """Phase 5f's continuous check at smoke width: one captured decode
    iteration of the bf16 engine (``socket_fused``), the kernel route's
    logits (its wrapper's plain version on the CPU, on a bf16 query),
    the plain route scoring from float32 u and the float32 run on the
    widened pool: the distance gate holds, the float32 run's pool leaves
    are float32 K/V beside the same bits, and the kernel and plain
    routes agree as closely as the kernel's plain version does."""
    cs = _chip_smoke()
    from repro_torch.launch.serve import apply_backend_arg, card_config
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg = apply_backend_arg(card_config(arch, "bf16").smoke(),
                            "socket_fused")
    engine = ContinuousBatchingEngine(cfg, device="cpu")
    seen = {}

    def hook(eng, it):
        running = [eng.scheduler.running[s]
                   for s in sorted(eng.scheduler.running)]
        if len(running) < 2 or any(len(r.blocks) * cfg.serving.block_size
                                   <= r.pos for r in running) or seen:
            return
        tokens, bt, pos = eng._batch_inputs(running)
        pages, bt = cs.compact_pool(cfg, eng.pages, bt)
        wide = cs.widened(pages)
        assert wide[0]["k"].dtype == torch.float32
        assert wide[0]["vnorm"].dtype == torch.bfloat16
        assert torch.equal(wide[0]["bits"], pages[0]["bits"])
        live = pos > 0
        plain = cs.kernel_scoring(cfg.replace(socket=dataclasses.replace(
            cfg.socket, use_paged_kernel=False)))
        lf, _ = make_serve_step(cs.f32_reference(cfg))(
            eng.params, wide, tokens, pos, bt)
        clone = [{k: v.clone() for k, v in layer.items()}
                 for layer in pages]
        lk, _ = make_serve_step(cfg)(eng.params, clone, tokens, pos, bt)
        lp, _ = make_serve_step(plain)(eng.params, pages, tokens, pos, bt)
        assert lk.dtype == torch.bfloat16 and lf.dtype == torch.float32
        seen.update(cs.f32_distance_check("smoke", lk[live], lp[live],
                                          lf[live]))

    engine.iter_hook = hook
    rng = torch.Generator().manual_seed(3)
    reqs = [Request(prompt=torch.randint(0, 256, (n,), generator=rng)
                    .tolist(), max_new_tokens=6) for n in (20, 37, 9)]
    with one_thread():
        engine.run(reqs, realtime=False)
    assert 0 < seen["plain_vs_f32"] and seen["kernel_vs_plain"] <= \
        seen["plain_vs_f32"]


# ------------------------------------------------------ phase 8 (train)

def _train_case(cs):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("llama31-8b").smoke()
    params = tfm.init_model(cfg, 0)
    return cfg, params, cs.train_batch(cfg, 2, 64, 0, 0, "cpu")


def _noncausal(q, k, v, *, scale, window=0, softcap=0.0, q_chunk=0):
    """Attention with the causal mask dropped: every query sees every
    key."""
    g = q.shape[0] // k.shape[0]
    kk, vv = (t.float().repeat_interleave(g, 0) for t in (k, v))
    return torch.softmax(q.float() @ kk.transpose(1, 2) * scale, -1) @ vv


def test_train_grad_gate_passes_on_a_sound_route():
    """Phase 8a's gate at smoke width: the op's autograd function (its
    plain forward on the CPU, the chunked backward) against autograd
    through the plain op."""
    cs = _chip_smoke()
    cfg, params, batch = _train_case(cs)
    with one_thread():
        lk, gk, _ = cs.train_route(cfg, params, batch)
        lp, gp, _ = cs.train_route(cfg, params, batch, cs.plain_prefill)
    gate = cs.grad_gate("smoke", (lk, gk), (lp, gp))
    assert gate["grad_rel_max"] <= 1e-6
    assert {"wq", "wk", "wv", "wo", "table"} <= set(gate["grad_rel_by_leaf"])


@pytest.mark.parametrize("fault", ["detached", "no causal mask"])
def test_train_grad_gate_catches_a_faulty_route(fault):
    """A kernel route whose attention output is detached (its projections
    get no gradient) or whose causal mask is dropped fails the gate."""
    from repro_torch.kernels.flash_prefill import ops as fp
    cs = _chip_smoke()
    cfg, params, batch = _train_case(cs)
    real = fp.flash_prefill

    def detached(*a, **kw):
        return real(*a, **kw).detach()

    op = detached if fault == "detached" else _noncausal
    with one_thread():
        with mock.patch.object(fp, "flash_prefill", op):
            lk, gk, _ = cs.train_route(cfg, params, batch)
        lp, gp, _ = cs.train_route(cfg, params, batch, cs.plain_prefill)
    match = "no gradient" if fault == "detached" else "loss|gradient"
    with pytest.raises(AssertionError, match=match):
        cs.grad_gate("smoke", (lk, gk), (lp, gp))


def test_train_step_gate_and_its_faults():
    """Phase 8b/8c's gate after real steps; a leaf that did not move, a
    moved hash plane or a wrong step count fails it."""
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.runtime.steps import make_train_step
    cs = _chip_smoke()
    cfg, params, _ = _train_case(cs)
    ocfg = AdamWConfig(state_bits=8)
    opt = init_adamw(ocfg, params)
    before, hashes = cs._train_snapshot(params)
    step = make_train_step(cfg, ocfg, accum=2)
    log = []
    with one_thread():
        for i in range(2):
            params, opt, m = step(params, opt, cs.train_batch(
                cfg, 2, 32, 0, i, "cpu"))
            log.append({k: float(v) for k, v in m.items()})
    cs.train_step_gate("smoke", params, opt, log, before, hashes, 2)
    with pytest.raises(AssertionError, match="step counter"):
        cs.train_step_gate("smoke", params, opt, log, before, hashes, 3)
    stale = dict(before)
    path = "['layers'][0]['mlp']['w_up']"
    stale[path] = params["layers"][0]["mlp"]["w_up"].reshape(-1)[:4096]
    with pytest.raises(AssertionError, match="did not change"):
        cs.train_step_gate("smoke", params, opt, log, stale, hashes, 2)
    params["layers"][1]["attn"]["hash_w"].add_(1.0)
    with pytest.raises(AssertionError, match="hash planes"):
        cs.train_step_gate("smoke", params, opt, log, before, hashes, 2)


def test_trainer_resume_check_on_the_cpu(tmp_path):
    """Phase 8d's check on two CPU Trainers of its config: passes; a
    resumed run that lost a bit of one parameter fails it."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig
    cs = _chip_smoke()
    cfg = get_config("minitron-8b").smoke().replace(
        num_groups=1, attention_backend="dense")
    ocfg = AdamWConfig(schedule=ScheduleConfig(peak_lr=1e-3, warmup_steps=2,
                                               decay_steps=10))
    loop = TrainLoopConfig(total_steps=10, checkpoint_every=5)
    data = DataConfig(seq_len=64, global_batch=2, vocab_size=cfg.vocab_size,
                      seed=1)
    with one_thread():
        straight = Trainer(cfg, ocfg, loop, data, str(tmp_path / "a"),
                           device="cpu")
        straight.run()
        resumed = Trainer(cfg, ocfg, loop, data, str(tmp_path / "b"),
                          device="cpu", injector=FailureInjector(
                              {7: RuntimeError("injected")}))
        resumed.run()
    cs.trainer_resume_check("smoke", straight, resumed, 7, 5)
    w = resumed.params["layers"][0]["mlp"]["w_down"]
    w.view(torch.int32).reshape(-1)[0] ^= 1
    with pytest.raises(AssertionError, match="differs after the resume"):
        cs.trainer_resume_check("smoke", straight, resumed, 7, 5)
    with pytest.raises(AssertionError, match="rebuilds"):
        cs.trainer_resume_check("smoke", straight, resumed, 6, 5)


def test_train_flops_per_token_is_the_jax_accounting():
    """6 x the active parameters plus the attention term, as the JAX
    package's ``model_flops_per_token(training=True)`` counts it
    (llama31-8b at 4096 tokens; gemma3's windowed layers)."""
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    cfg = get_config("llama31-8b")
    attn = 4 * 32 * 128 * 32 * 2048 * 6
    assert cs.train_flops_per_token(cfg, 4096) == \
        6.0 * cfg.active_param_count() + attn
    g3 = get_config("gemma3-27b")
    spans = [2048 if s.attn_type == "global" else min(g3.sliding_window,
                                                      2048)
             for s in g3.layer_specs]
    assert cs.train_flops_per_token(g3, 4096) == \
        6.0 * g3.active_param_count() + \
        24.0 * g3.num_heads * g3.head_dim * sum(spans)


# ------------------------------------------- phase 9 (context-parallel)

CP_N, CP_SHARDS = 1024, 4
CP_GEO = dict(b=1, kvh=2, g=2, hd=32)


def _cp_case(cs, selection="kvhead"):
    """Phase 9a's inputs at smoke size (sinks and windows of 8 rows), the
    length 3 shards less 40 rows (the last shard holds no valid row)."""
    cfg = cs.cp_socket_config(selection, sink_tokens=8, window_tokens=8,
                              score_chunk=0)
    length = 3 * CP_N // CP_SHARDS - 40
    whole = cs.cp_inputs("cpu", 0, CP_N, CP_SHARDS, CP_GEO, cfg)
    return cfg, length, whole


def _cp_ranks(cs, cfg, length):
    """Each simulated rank's selection and partials, made by the
    functions its attend calls (``socket_score``'s plain version)."""
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.launch.mesh import Mesh
    sels, parts = [], []
    for rank in range(CP_SHARDS):
        mesh = Mesh(("data", "model"), (CP_SHARDS, 1), rank=rank)
        data = cs.cp_inputs("cpu", 0, CP_N, CP_SHARDS, CP_GEO, cfg,
                            mesh.index(("data",)))
        idx, mask = cs.cp_rank_selection(cfg, mesh, ("data",), data, CP_N,
                                         length)
        sels.append((idx, mask))
        parts.append(cp.local_partials(data["q"], data["k"], data["v"],
                                       idx, mask, CP_GEO["hd"] ** -0.5))
    return sels, parts


@pytest.mark.parametrize("selection", ["kvhead", "pooled"])
def test_cp_gates_pass_on_the_sound_route(selection):
    """Phase 9a's gates at smoke size: the ranks' selections, their
    partials (the last shard empty) and the merge against the plain
    single-process version and the global route, dense attention lying
    outside the bound."""
    from repro_torch.core import socket as sk
    from repro_torch.distributed import context_parallel as cp
    cs = _chip_smoke()
    cfg, length, whole = _cp_case(cs, selection)
    with one_thread():
        sels, parts = _cp_ranks(cs, cfg, length)
        assert cs.cp_selection_gate("smoke", cfg, sels, whole, length,
                                    CP_SHARDS) == 0
        cs.cp_partials_check("smoke", parts, length, CP_N)
        args = tuple(whole[k] for k in ("w", "q", "k", "v", "bits",
                                        "vnorm"))
        scale = CP_GEO["hd"] ** -0.5
        ref = cp.context_parallel_socket_attend_ref(
            cfg, CP_SHARDS, *args, length=length, scale=scale)
        glob = sk.socket_attend(cfg, *args[:4], sk.SocketCache(*args[4:]),
                                length=length, scale=scale)
        dense = cs.cp_dense(whole, length, scale)
        gates = cs.cp_merge_gate("smoke", [cp.merge_partials_ref(parts)],
                                 ref, glob, dense)
    assert gates["rel_to_global"] < cs.CP_GLOBAL_REL <= \
        gates["dense_to_global"]


@pytest.mark.parametrize("fault", ["dense attention", "inputs too easy"])
def test_cp_merge_gate_can_fail(fault):
    """Phase 9a's inputs separate the routes: dense attention in place of
    the CP route's output fails the bound to the global route, and inputs
    on which dense attention lies inside the bound fail the gate."""
    from repro_torch.core import socket as sk
    from repro_torch.distributed import context_parallel as cp
    cs = _chip_smoke()
    cfg, length, whole = _cp_case(cs)
    args = tuple(whole[k] for k in ("w", "q", "k", "v", "bits", "vnorm"))
    scale = CP_GEO["hd"] ** -0.5
    with one_thread():
        ref = cp.context_parallel_socket_attend_ref(
            cfg, CP_SHARDS, *args, length=length, scale=scale)
        glob = sk.socket_attend(cfg, *args[:4], sk.SocketCache(*args[4:]),
                                length=length, scale=scale)
        dense = cs.cp_dense(whole, length, scale)
    if fault == "dense attention":
        with pytest.raises(AssertionError, match="distance to the global"):
            cs.cp_merge_gate("smoke", [dense], dense, glob, dense)
    else:
        with pytest.raises(AssertionError, match="do not test"):
            cs.cp_merge_gate("smoke", [ref], ref, glob, glob)


@pytest.mark.parametrize("fault", ["wrong lo", "budget of the local n",
                                   "-inf merge"])
def test_cp_gates_catch_a_faulty_route(fault):
    """A rank whose ``lo`` is 0 or whose budget is that of its own rows
    fails the selection gate; one whose masked logits are -inf (its
    selection sound) fails the partials check on the empty shard."""
    from repro_torch.core import socket as sk
    from repro_torch.distributed import context_parallel as cp
    cs = _chip_smoke()
    cfg, length, whole = _cp_case(cs)
    patch = {
        "wrong lo": mock.patch.object(cp, "shard_lo",
                                      lambda mesh, axes, n_l: 0),
        "budget of the local n": mock.patch.object(
            cp, "local_budget", lambda cfg, n, shards: max(
                cfg.min_k, -(-sk.topk_budget(cfg, n // shards) // shards))),
        "-inf merge": mock.patch.object(cp, "MASKED_LOGIT",
                                        float("-inf")),
    }[fault]
    with one_thread(), patch:
        sels, parts = _cp_ranks(cs, cfg, length)
    if fault == "-inf merge":
        cs.cp_selection_gate("smoke", cfg, sels, whole, length, CP_SHARDS)
        with pytest.raises(AssertionError, match="shard 3's partials"):
            cs.cp_partials_check("smoke", parts, length, CP_N)
    else:
        with pytest.raises(AssertionError, match="selected|selection"):
            cs.cp_selection_gate("smoke", cfg, sels, whole, length,
                                 CP_SHARDS)


def test_cp_model_gates():
    """Phase 9b's launch gate (layers x steps ``socket_score`` and layers
    ``flash_prefill`` launches a rank, nothing else) and logits gate
    (tokens equal, logits within LOGITS_ATOL)."""
    cs = _chip_smoke()
    layers, steps = 4, cs.CP_STEPS
    good = {"socket_score": layers * steps, "flash_prefill": layers,
            "flash_decode": 0, "paged_attention": 0}
    ranks = [{"launches": dict(good)} for _ in range(4)]
    assert cs.cp_launch_gate("smoke", ranks, layers) == {
        "socket_score": 4 * layers * steps, "flash_prefill": 4 * layers}
    for name, wrong in (("socket_score", layers * steps - 1),
                        ("flash_decode", 1), ("flash_prefill", 0)):
        bad = [dict(r, launches=dict(good)) for r in ranks]
        bad[2]["launches"][name] = wrong
        with pytest.raises(AssertionError, match=name):
            cs.cp_launch_gate("smoke", bad, layers)
    toks = torch.tensor([[3, 1, 4]])
    logits = [torch.randn(1, 8) for _ in range(3)]
    assert cs.cp_logits_gate("smoke", toks, logits, toks.clone(),
                             [x.clone() for x in logits]) == 0.0
    with pytest.raises(AssertionError, match="tokens"):
        cs.cp_logits_gate("smoke", toks, logits, torch.tensor([[3, 1, 5]]),
                          logits)
    off = [x.clone() for x in logits]
    off[2][0, 5] += 2 * cs.LOGITS_ATOL
    with pytest.raises(AssertionError, match="logits"):
        cs.cp_logits_gate("smoke", toks, logits, toks, off)


def test_cp_backend_gates():
    """Phase 9c's selection and Quest bounds gates, sound and faulty."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    steps = 3
    ref = [(torch.randperm(40, generator=gen)[:12].reshape(1, 2, 6),
            torch.rand((1, 2, 6), generator=gen) < 0.8)
           for _ in range(steps)]
    runs = [dict(selections=[(i.clone(), m.clone()) for i, m in ref])
            for _ in range(4)]
    cs.cpb_selection_gate("smoke", runs, ref, steps)
    moved = [dict(r) for r in runs]
    moved[1] = dict(selections=[(i.clone(), m.clone()) for i, m in ref])
    moved[1]["selections"][2][0][0, 1, 3] += 1
    flipped = [dict(r) for r in runs]
    flipped[3] = dict(selections=[(i.clone(), m.clone()) for i, m in ref])
    flipped[3]["selections"][0][1][0, 0, 0] ^= True
    short = [dict(r) for r in runs]
    short[0] = dict(selections=runs[0]["selections"][:2])
    for bad, match in ((moved, "step 2"), (flipped, "step 0"),
                       (short, "recorded 2")):
        with pytest.raises(AssertionError, match=match):
            cs.cpb_selection_gate("smoke", bad, ref, steps)
    # Quest bounds: 2 layers, 4 ranks of 3 pages; the steps wrote page 10
    whole = [{k: torch.randn((1, 2, 12, 8), generator=gen)
              for k in ("kmin", "kmax")} for _ in range(2)]
    blocks = [dict(bounds=[{k: v[:, :, 3 * r:3 * r + 3].clone()
                            for k, v in layer.items()} for layer in whole])
              for r in range(4)]
    assert cs.cpb_bounds_gate("smoke", blocks, whole, {10}) == 0.0
    near = [dict(bounds=[{k: v.clone() for k, v in layer.items()}
                         for layer in b["bounds"]]) for b in blocks]
    near[3]["bounds"][1]["kmax"][:, :, 1] += 1e-6
    assert 0 < cs.cpb_bounds_gate("smoke", near, whole, {10}) < 2e-6
    for rank, layer, page, off in ((3, 0, 1, 1e-6), (2, 1, 0, 1e-6),
                                   (3, 1, 1, 1e-3)):
        bad = [dict(bounds=[{k: v.clone() for k, v in lay.items()}
                            for lay in b["bounds"]]) for b in blocks]
        bad[rank]["bounds"][layer]["kmin"][:, :, page] += off
        with pytest.raises(AssertionError, match=f"rank {rank}'s layer "
                                                 f"{layer} kmin"):
            cs.cpb_bounds_gate("smoke", bad, whole, {10})


# ------------------------------------------------------------ phase 10

MESH_FAULTS = ("gradient summed over model", "norm counts replicas",
               "loss over local counts")
# faults of the update, which only the parameter gate sees (step 2's
# update reaches no gated loss), run on mesh (4, 1) with 8-bit moments:
# the head never updated, and an 8-bit moment's block scales gathered in
# another rank order (each rank reads another's scales at step 2)
MESH_UPDATE_FAULTS = ("unchanged leaf", "wrong moment")


def _mesh_smoke_cfg():
    from repro_torch.configs import get_config
    return get_config("llama31-8b").smoke().replace(remat_policy="full")


@contextlib.contextmanager
def _mesh_fault(fault):
    """Phase 10's sharded step with one fault planted: each rank's
    gradient also summed over the ``model`` axis (whose ranks computed the
    same one), the global norm counting a replicated block once a rank,
    or the loss divided by a rank's own valid-token count."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.distributed.sharding import NamedSharding
    if fault is None:
        yield
        return
    if fault == "gradient summed over model":
        orig = fsdp.reduce_grad

        def summed(grad, sharding):
            grad = collectives.all_reduce(
                grad, dist.ReduceOp.SUM, sharding.mesh.group(("model",)))
            return orig(grad, sharding)
        ctx = mock.patch.object(fsdp, "reduce_grad", summed)
    elif fault == "norm counts replicas":
        ctx = mock.patch.object(NamedSharding, "owns", lambda self: True)
    elif fault == "unchanged leaf":
        from repro_torch.optim import adamw
        trainable = adamw.is_trainable_path
        ctx = mock.patch.object(
            adamw, "is_trainable_path",
            lambda path: trainable(path) and path != "['embed']['head']")
    elif fault == "wrong moment":
        from repro_torch.optim import adamw
        gather = adamw._Q8Row._gather

        def rolled(self, t):
            out = gather(self, t)
            return out if out is t else out.roll(t.shape[-1], dims=-1)
        ctx = mock.patch.object(adamw._Q8Row, "_gather", rolled)
    else:
        ctx = mock.patch.object(fsdp, "global_tokens",
                                lambda labels, mesh: (labels >= 0).sum())
    with ctx:
        yield


def _mesh_smoke_rank(rank, world, tmp):
    """Phase 10a's rank body (``mesh_train_run``) at smoke width on a
    gloo CPU rank: the sound step and each planted fault, mesh (2, 2),
    accum 2."""
    torch.set_num_threads(1)
    cs = _chip_smoke()
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    init_rank(rank, world, f"file://{tmp}/init", device="cpu")
    mesh = make_test_mesh(2, 2)
    mesh41 = make_test_mesh(4, 1)
    cfg = _mesh_smoke_cfg()
    params = torch.load(os.path.join(tmp, "params.pt"), weights_only=True)
    batches = [cs.mesh_batch(cfg, 4, 32, 0, i, "cpu") for i in range(2)]
    res = {}
    for fault in (None,) + MESH_FAULTS:
        with _mesh_fault(fault):
            res[fault] = cs.mesh_train_run(cfg, cs.mesh_ocfg(32), mesh, 2,
                                           params, batches, "cpu")
    for fault in (None,) + MESH_UPDATE_FAULTS:
        with _mesh_fault(fault):
            res["8-bit", fault] = cs.mesh_train_run(
                cfg, cs.mesh_ocfg(8), mesh41, 1, params, batches, "cpu")
    # phase 11a: the exchange's sharded step and drops case
    ecfg = _ep_smoke_cfg()
    eparams = torch.load(os.path.join(tmp, "ep_params.pt"),
                         weights_only=True)
    ebatches = [cs.train_batch(ecfg, 4, 16, 0, i, "cpu") for i in range(2)]
    for fault in (None, EP_FAULTS[0]):
        with _ep_fault(fault):
            res["ep", fault] = cs.ep_parity_run(ecfg, mesh, eparams,
                                                ebatches, "cpu")
    drop = cs.ep_drop_case(ecfg, 0, "cpu", rows=2, seq=32)
    for fault in (None, EP_FAULTS[1]):
        with _ep_fault(fault):
            res["drop", fault] = cs.ep_drop_run(*drop, mesh)
    # phase 11b: the pipeline's parity run
    from repro_torch.launch.mesh import Mesh
    stages = Mesh(("stage",), (4,), rank=rank)
    stages.build_groups()
    for fault in (None, PIPE_FAULT):
        with _pipe_fault(fault):
            res["pipe", fault] = cs.pipe_parity_run(
                _pipe_smoke_cfg(), 0, "cpu", stages, seq=PIPE_SEQ)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The ranks' runs (one spawn) and the single-process reference."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_adamw
    from repro_torch.runtime.steps import make_train_step
    cs = _chip_smoke()
    tmp = str(tmp_path_factory.mktemp("mesh10"))
    cfg = _mesh_smoke_cfg()
    params = tfm.init_model(cfg, 7)
    torch.save(params, os.path.join(tmp, "params.pt"))
    torch.save(tfm.init_model(_ep_smoke_cfg(), 9),
               os.path.join(tmp, "ep_params.pt"))
    spawn_ranks(_mesh_smoke_rank, 4, (4, tmp), deadline_s=240)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    init = fsdp.flat_tree(params)
    refs = {}
    for bits, accum, shape in ((32, 2, (2, 2)), (8, 1, (4, 1))):
        ocfg = cs.mesh_ocfg(bits)
        p = tfm.init_model(cfg, 7)
        opt = init_adamw(ocfg, p)
        step = make_train_step(cfg, ocfg, accum)
        metrics = []
        with one_thread():
            for i in range(2):
                p, opt, m = step(p, opt,
                                 cs.mesh_batch(cfg, 4, 32, 0, i, "cpu"))
                metrics.append({k: float(v) for k, v in m.items()})
        refs[bits] = dict(
            metrics=metrics, params=fsdp.flat_tree(p),
            opt=fsdp.flat_tree(opt),
            shardings=[cs.mesh_shardings(cfg, shape, r) for r in range(4)],
            opt_shardings=[cs.mesh_opt_shardings(cfg, shape, r, bits)
                           for r in range(4)])
    return cs, ranks, init, refs


@pytest.fixture(scope="module")
def ep_ref(mesh_runs):
    """Phase 11a's one-process reference at smoke width: the step with
    the plain exchange (``plain_exchange``) at the same (dropless)
    capacity factor, from the ranks' weights and batches; the pipeline's
    sequential stack."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_adamw
    from repro_torch.runtime.steps import make_train_step
    cs = mesh_runs[0]
    cfg = _ep_smoke_cfg()
    ocfg = cs.mesh_ocfg(cs.EP_BITS)
    with one_thread():
        p = tfm.init_model(cfg, 9)
        init = fsdp.flat_tree(tfm.init_model(cfg, 9))
        opt = init_adamw(ocfg, p)
        step = make_train_step(cfg, ocfg, 1)
        metrics = []
        with cs.plain_exchange():
            for i in range(2):
                p, opt, m = step(p, opt, cs.train_batch(cfg, 4, 16, 0, i,
                                                        "cpu"))
                metrics.append({k: float(v) for k, v in m.items()})
        pipe = cs.pipe_reference(_pipe_smoke_cfg(), 0, "cpu", seq=PIPE_SEQ)
    return dict(metrics=metrics, params=fsdp.flat_tree(p), init=init,
                shardings=[cs.ep_shardings(cfg, r) for r in range(4)],
                pipe=pipe)


def _mesh_gates(cs, ranks, fault, init, ref, bits=32):
    got = [r[fault if bits == 32 else ("8-bit", fault)] for r in ranks]
    assert all(g["shapes"] for g in got)
    cs.mesh_metrics_gate("smoke", [g["metrics"] for g in got],
                         ref["metrics"])
    return cs.mesh_params_gate("smoke", [g["params"] for g in got],
                               ref["params"], init, ref["shardings"], bits)


def test_mesh_gates_pass_on_the_sound_step(mesh_runs):
    """Phase 10a's gates at smoke width: the sharded step on 4 gloo ranks
    (mesh (2, 2), accum 2, padding that differs across ranks) against
    the single-process step on the same weights and batches."""
    cs, ranks, init, refs = mesh_runs
    worst = _mesh_gates(cs, ranks, None, init, refs[32])
    assert 0 < worst["update_rel"] <= cs.MESH_UPDATE_RTOL[32]
    assert worst["element_rel"] < 1e-3
    # each rank's valid tokens differ (the loss fault can show)
    batch = cs.mesh_batch(_mesh_smoke_cfg(), 4, 32, 0, 0, "cpu")
    assert len({int((batch["labels"][r] >= 0).sum()) for r in range(4)}) \
        > 1


@pytest.mark.parametrize("fault,gate", [
    ("gradient summed over model", "grad_norm"),
    ("norm counts replicas", "grad_norm"),
    ("loss over local counts", "loss")])
def test_mesh_gates_catch_a_faulty_step(mesh_runs, fault, gate):
    cs, ranks, init, refs = mesh_runs
    with pytest.raises(AssertionError, match=f"step 0 {gate} "):
        _mesh_gates(cs, ranks, fault, init, refs[32])


def test_mesh_gates_pass_on_the_sound_8bit_step(mesh_runs):
    """10a's 8-bit case at smoke width: mesh (4, 1), accum 1, against the
    single-process step; its moments against the reference's
    (``mesh_code_report``): a few codes part, one of them by many (a sign
    flip near 0 at step 2), while every value stays within
    MESH_MOMENT_CODES codes at the top of its block."""
    cs, ranks, init, refs = mesh_runs
    worst = _mesh_gates(cs, ranks, None, init, refs[8], bits=8)
    assert worst["update_rel"] <= cs.MESH_UPDATE_RTOL[8]
    report = cs.mesh_code_report(
        "smoke", [r["8-bit", None]["codes"] for r in ranks], refs[8]["opt"],
        refs[8]["opt_shardings"])
    assert 0 < report["differing"] < 1e-3 * report["codes"]
    assert report["max_code_diff"] > 1
    assert max(report["max_value_diff_codes"].values()) < \
        cs.MESH_MOMENT_CODES


@pytest.mark.parametrize("fault", MESH_UPDATE_FAULTS)
def test_mesh_params_gate_catches_a_wrong_update(mesh_runs, fault):
    """A leaf never updated and a wrong 8-bit moment fail the parameter
    gate.  The wrong moment first reads its scales at step 2, whose update
    reaches no gated loss: it passes the loss and norm gates, and fails
    the moments' gate too (``mesh_code_report``).  (The leaf never
    updated also moves step 2's loss; the parameter gate is held to it
    alone here.)"""
    cs, ranks, init, refs = mesh_runs
    got = [r["8-bit", fault] for r in ranks]
    if fault == "wrong moment":
        cs.mesh_metrics_gate("smoke", [g["metrics"] for g in got],
                             refs[8]["metrics"])
    with pytest.raises(AssertionError, match="of that step's update"):
        cs.mesh_params_gate("smoke", [g["params"] for g in got],
                            refs[8]["params"], init, refs[8]["shardings"], 8)
    if fault == "wrong moment":
        with pytest.raises(AssertionError, match="codes at the top of a "):
            cs.mesh_code_report("smoke", [g["codes"] for g in got],
                                refs[8]["opt"], refs[8]["opt_shardings"])


def test_mesh_launch_compression_and_elastic_gates():
    """Phase 10's launch gate (layers x calls ``flash_prefill`` a rank,
    nothing else), 10d's ``compression_round_check`` and
    ``compression_run`` (sound, a mean off the plain version's, error
    buffers that do not carry) and 10c's
    ``elastic_gate`` (sound, a rank that did not leave, a restored block
    that is not the checkpoint's) on hand-made results."""
    from repro_torch.distributed import compression as cm
    from repro_torch.distributed.sharding import named_sharding
    from repro_torch.launch.mesh import Mesh
    cs = _chip_smoke()
    good = {"flash_prefill": 8, "socket_score": 0}
    assert cs.mesh_launch_gate("smoke", [{"launches": dict(good)}] * 4, 2,
                               4) == 32
    with pytest.raises(AssertionError, match="flash_prefill"):
        cs.mesh_launch_gate("smoke", [{"launches": dict(
            good, flash_prefill=7)}], 2, 4)
    with pytest.raises(AssertionError, match="other kernels"):
        cs.mesh_launch_gate("smoke", [{"launches": dict(
            good, socket_score=1)}], 2, 4)
    # 10d: one round against the plain version, sound and off; a run at
    # world 1 on small shapes, sound and with buffers that never carry
    gen = torch.Generator().manual_seed(0)
    grads = [{"wq": torch.randn(8, 16, generator=gen) * (r + 1),
              "norm": torch.randn(16, generator=gen)} for r in range(4)]
    zero = [cm.init_error_buffers(g) for g in grads]
    mean, errs, _ = cm.compressed_psum_ref(grads, zero)
    worst, new = cs.compression_round_check("smoke", 1, 0, mean, errs[1],
                                            grads, zero)
    assert worst == {"synced": 0.0, "errors": 0.0}
    assert all(torch.equal(new[r][k], errs[r][k]) for r in range(4)
               for k in grads[0])
    with pytest.raises(AssertionError, match="synced wq"):
        cs.compression_round_check("smoke", 1, 0, dict(
            mean, wq=mean["wq"] + 1e-3), errs[1], grads, zero)

    def small(seed, rank, rnd, dev):
        g = torch.Generator().manual_seed(seed + 31 * rnd + rank)
        return {"wq": torch.randn(8, 16, generator=g)}

    with mock.patch.object(cs, "compression_grads", small):
        run = cs.compression_run("smoke", 0, 1, "cpu", 0, None)
        assert len(run["round_s"]) == cs.COMPRESSION_ROUNDS
        psum = cm.compressed_psum
        with mock.patch.object(cm, "compressed_psum", lambda g, e, group: (
                psum(g, e, group)[0], e)), \
                pytest.raises(AssertionError, match="errors wq"):
            cs.compression_run("smoke", 0, 1, "cpu", 0, None)
    # 10c: ranks 0-1 kept, 2-3 left; one leaf sharded over the new mesh
    keep = cs.MESH_WORLD - cs.ELASTIC_LOST
    whole = torch.arange(16.0).reshape(8, 2)
    saved = {"step": cs.ELASTIC_EVERY,
             "tree": {"params": {"w": whole}}}
    shardings = [{"['params']['w']": named_sharding(
        Mesh(("data", "model"), (keep, 1), rank=r, ranks=range(keep)),
        ("embed_w", None), whole.shape)} for r in range(keep)]

    def rank(r):
        if r >= keep:
            return dict(first_mesh=4, rebuilds=1, active=False,
                        restored=None)
        block = shardings[r]["['params']['w']"].shard(whole)
        return dict(first_mesh=4, rebuilds=1, active=True,
                    step=cs.ELASTIC_STEPS, mesh=list(range(keep)),
                    restored=(cs.ELASTIC_EVERY,
                              {"['params']['w']": block}))

    ranks = [rank(r) for r in range(4)]
    cs.elastic_gate("smoke", ranks, saved, shardings)
    stayed = [dict(x) for x in ranks]
    stayed[3] = dict(stayed[3], active=True)
    with pytest.raises(AssertionError, match="leave"):
        cs.elastic_gate("smoke", stayed, saved, shardings)
    wrong = [dict(x) for x in ranks]
    wrong[1] = dict(wrong[1], restored=(cs.ELASTIC_EVERY, {
        "['params']['w']": whole[:4].clone()}))
    with pytest.raises(AssertionError, match="block"):
        cs.elastic_gate("smoke", wrong, saved, shardings)


# ------------------------------------------------------------ phase 11

# 11a's faults: each rank's expert gradients also summed over ``model``
# (whose ranks hold other experts), and a slot sort that orders an id's
# entries last index first (an unstable sort's freedom)
EP_FAULTS = ("expert gradients summed over model", "unstable slot sort")
PIPE_FAULT = "a microbatch lost"
PIPE_SEQ = 16


def _ep_smoke_cfg():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x22b").smoke().replace(
        num_groups=1, moe_dispatch="alltoall", capacity_factor=8.0,
        remat_policy="full")


def _pipe_smoke_cfg():
    from repro_torch.configs import get_config
    return get_config("llama31-8b").smoke().replace(num_groups=8)


@contextlib.contextmanager
def _ep_fault(fault):
    import torch.distributed as dist
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.models import moe
    if fault is None:
        yield
        return
    if fault == EP_FAULTS[0]:
        orig = fsdp._GatherExperts.backward

        def summed(ctx, grad):
            grad = collectives.all_reduce(
                grad.contiguous(), dist.ReduceOp.SUM,
                ctx.mesh.group(("model",)))
            return orig(ctx, grad)
        ctx = mock.patch.object(fsdp._GatherExperts, "backward",
                                staticmethod(summed))
    else:
        sort = moe._sort_slots

        def reversed_ties(ids, count, capacity):
            n = ids.numel()
            back = torch.arange(n - 1, -1, -1, device=ids.device)
            order = torch.argsort(ids * n + back)
            flipped = torch.empty_like(ids)
            flipped[order] = torch.arange(n, device=ids.device)
            keep, slot = sort(ids, count, capacity)
            # the same counts, each id's entries placed last index first
            pos = flipped - (torch.cumsum(torch.bincount(
                ids, minlength=count), 0) - torch.bincount(
                ids, minlength=count))[ids]
            keep = pos < capacity
            return keep, torch.where(keep, pos,
                                     torch.full_like(pos, capacity - 1))
        ctx = mock.patch.object(moe, "_sort_slots", reversed_ties)
    with ctx:
        yield


@contextlib.contextmanager
def _pipe_fault(fault):
    """The third ring shift of the forward delivers zeros: the
    microbatch crossing that stage boundary is lost."""
    from repro_torch.distributed import collectives
    if fault is None:
        yield
        return
    permute, calls = collectives.permute, [0]

    def lossy(t, *args, **kw):
        calls[0] += 1
        out = permute(t, *args, **kw)
        return torch.zeros_like(out) if calls[0] == 3 else out
    with mock.patch.object(collectives, "permute", lossy):
        yield


def _ep_gates(cs, ranks, fault, ref):
    got = [r["ep", fault] for r in ranks]
    assert all(g["shapes"] for g in got)
    worst = cs.mesh_metrics_gate("smoke", [g["metrics"] for g in got],
                                 ref["metrics"])
    perr = cs.mesh_params_gate("smoke", [g["params"] for g in got],
                               ref["params"], ref["init"], ref["shardings"],
                               cs.EP_BITS)
    experts = cs.expert_bytes_gate("smoke", _ep_smoke_cfg(),
                                   [g["stored"] for g in got],
                                   [g["gathered"] for g in got])
    return worst, perr, experts


def test_ep_gates_pass_on_the_sound_exchange(mesh_runs, ep_ref):
    """11a's gates at smoke width: the exchange's sharded step against
    one process's plain exchange (loss, norm, each rank's blocks), each
    rank's stored expert blocks a quarter of the leaf and its gathered
    ones its 2 of 4 experts; the drops case's outputs and drops the
    plain exchange's, which drops some."""
    cs, ranks, _, _ = mesh_runs
    worst, perr, experts = _ep_gates(cs, ranks, None, ep_ref)
    assert perr["update_rel"] <= cs.MESH_UPDATE_RTOL[cs.EP_BITS]
    assert experts["gathered_shape"] == (2, 64, 128)
    drops = cs.ep_drop_gate("smoke", [r["drop", None] for r in ranks],
                            *cs.ep_drop_case(_ep_smoke_cfg(), 0, "cpu",
                                             rows=2, seq=32))
    assert drops["dropped"] > 0 and drops["rel"] <= cs.EP_DROP_REL


def test_ep_gates_catch_expert_gradients_summed_over_model(mesh_runs,
                                                           ep_ref):
    cs, ranks, _, _ = mesh_runs
    with pytest.raises(AssertionError, match="step 0 grad_norm "):
        _ep_gates(cs, ranks, EP_FAULTS[0], ep_ref)


def test_ep_drop_gate_catches_an_unstable_slot_sort(mesh_runs):
    """Ties ordered the other way keep as many assignments but not the
    same ones: the drops count agrees, the outputs do not."""
    cs, ranks, _, _ = mesh_runs
    got = [r["drop", EP_FAULTS[1]] for r in ranks]
    assert sum(g["dropped"] for g in got) == \
        sum(r["drop", None]["dropped"] for r in ranks)
    with pytest.raises(AssertionError, match="from the plain exchange"):
        cs.ep_drop_gate("smoke", got, *cs.ep_drop_case(
            _ep_smoke_cfg(), 0, "cpu", rows=2, seq=32))


def test_pipe_gates(mesh_runs, ep_ref):
    """11b's gates at smoke width: 4 stages of 2 blocks, 8 microbatches,
    against the sequential stack, sound and with a microbatch lost."""
    cs, ranks, _, _ = mesh_runs
    gates = cs.pipe_parity_gates("smoke", [r["pipe", None] for r in ranks],
                                 ep_ref["pipe"])
    assert gates["out_rel"] <= cs.PIPE_OUT_REL
    assert gates["grad_rel"] <= cs.PIPE_GRAD_REL
    with pytest.raises(AssertionError, match="output"):
        cs.pipe_parity_gates("smoke", [r["pipe", PIPE_FAULT] for r in ranks],
                             ep_ref["pipe"])


@pytest.mark.parametrize("arch", ["gemma3-27b", "jamba-v0.1-52b"])
def test_cph_layout_gate(arch):
    """11c's cache layout gate on smoke prefills under a (2, 1) CP mesh
    (a prefill needs no collective): sound, with a rank whose ring (or
    Mamba state) was sliced, and with a rank whose global cache is whole
    (one process's)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    cs = _chip_smoke()
    cfg = get_config(arch).smoke().replace(
        num_groups=1, decode_cp_axes=("data",), decode_cp_batch_axes=())
    params = tfm.init_model(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(0))

    def layout(mesh, cut=None):
        with one_thread(), activate_mesh(mesh):
            _, caches = tfm.prefill(cfg, params, {"tokens": tokens}, 48)
        if cut is not None:
            caches[cut] = {k: v[:, :, :v.shape[2] // 2] if v.ndim > 2
                           else v for k, v in caches[cut].items()}
        return {"layout": cs.cache_layout(cfg, caches)}

    ref = layout(Mesh(("data", "model"), (1, 1)))["layout"]
    ranks = [layout(Mesh(("data", "model"), (2, 1), rank=r))
             for r in range(2)]
    held = cs.cph_layout_gate("smoke", cfg, ranks, ref)
    assert held["global"] > 0 and held["whole"] > 0
    kinds = cs.layer_kinds(cfg)
    whole = kinds.index("local" if "local" in kinds else "mamba")
    sliced = [ranks[0], layout(Mesh(("data", "model"), (2, 1), rank=1),
                               cut=whole)]
    with pytest.raises(AssertionError, match=f"layer {whole} "):
        cs.cph_layout_gate("smoke", cfg, sliced, ref)
    glob = kinds.index("global")
    with pytest.raises(AssertionError, match=f"layer {glob} "):
        cs.cph_layout_gate("smoke", cfg, [ranks[0], {"layout": ref}], ref)


# ------------------------------------------------------------- phase 12

def test_frontend_cases():
    """Phase 12's shapes: musicgen's static path (batch 4 x 24 heads of hd
    64, MHA, 1500 frames + 32 steps: budget 256) in flash_decode's card
    cases and in the prefill cases, its plan one head a unit and 8 lanes
    a row; internvl2 at its trained context; 12c at llama31-8b's
    attention layer at decode_32k."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import cases
    from repro_torch.launch.specs import SHAPES
    mg = get_config("musicgen-medium")
    batch, plen, steps = cs.STATIC_CASES["musicgen-medium"]
    assert (batch, plen, steps) == (4, 1500, 16)
    assert cs.STATIC_CASES["internvl2-26b"] == (2, 8192, 16)
    fd = dict(cases.CARD_CASES)[cs.MUSICGEN_TIMED]
    assert (fd["bh"], fd["g"], fd["hd"], fd["k"]) == (
        batch * mg.num_kv_heads, mg.num_heads // mg.num_kv_heads,
        mg.head_dim, sk.topk_budget(mg.socket, plen + steps))
    assert [c[1:5] for c in cs.PREFILL_CASES if c[0] == cs.MUSICGEN_TIMED
            ] == [(96, 96, 1500, 64)]
    geo = cases.decode_geometry(64, 1, 4)
    plan = dict(cluster=2, smem_bytes=1, clusters_at_once=66, stages=4,
                stage_rows=geo["stage_rows"], lanes_per_row=geo["lanes"],
                heads_per_unit=geo["heads"], units=geo["units"],
                row_stride=geo["stride"])
    assert (geo["lanes"], geo["heads"]) == (8, 1)
    cases.plan_note(plan, cs.MUSICGEN_TIMED, **fd)
    llama = get_config("llama31-8b")
    assert cs.BASELINE_SHAPE == dict(
        kvh=llama.num_kv_heads, n=SHAPES["decode_32k"].seq_len,
        g=llama.num_heads // llama.num_kv_heads, hd=llama.head_dim)
    assert cs.FRONTEND_GATE_DEPTH == {"musicgen-medium": 4,
                                      "internvl2-26b": cs.QUANT_DEPTH}


def test_baseline_gates_catch_faults():
    cs = _chip_smoke()
    from repro_torch.core import hashing
    gen = torch.Generator().manual_seed(0)
    # bucket ids: equal passes, a bit flipped fails
    ids = hashing.signs_to_bucket_ids(
        torch.rand((1, 2, 30, 6, 10), generator=gen) < 0.5)
    cs.equal_gate("ids", ids, ids.clone(), "cpu")
    flipped = ids.clone()
    flipped[0, 1, 7, 3] ^= 1 << 4
    with pytest.raises(AssertionError, match="1 entries"):
        cs.equal_gate("ids", flipped, ids, "cpu")
    # a baseline left on the CPU
    with pytest.raises(AssertionError, match="not on cuda"):
        cs.equal_gate("ids", ids, ids, "cuda")
    with pytest.raises(AssertionError, match="not on cuda"):
        cs.close_gate("scores", ids.float(), ids.float(), cs.SCORE_TOL,
                      "cuda")
    # a dot product near zero: its rounding reads the terms' magnitude
    ref = torch.tensor([1e-3, 5.0])
    mag = torch.tensor([80.0, 80.0], dtype=torch.float64)
    off = ref + torch.tensor([2e-5, 0.0])
    with pytest.raises(AssertionError, match="exceeds"):
        cs.close_gate("dot", off, ref, cs.SCORE_TOL, "cpu")
    cs.close_gate("dot", off, ref, cs.SCORE_TOL, "cpu", mag=mag)
    with pytest.raises(AssertionError, match="terms' magnitude"):
        cs.close_gate("dot", ref + 2e-3, ref, cs.SCORE_TOL, "cpu", mag=mag)
    # signs: a flip clear of rounding fails, one at a zero projection
    # passes and is counted
    w = torch.randn((4, 3, 8), generator=gen)
    x = torch.randn((20, 8), generator=gen)
    x[5] -= (x[5] @ w[2, 1]) / (w[2, 1] @ w[2, 1]) * w[2, 1]
    signs = hashing.hash_keys_signs(w, x)
    assert cs.sign_gate("signs", w, x, signs, signs.clone(), "cpu") == 0
    near = signs.clone()
    near[5, 2, 1] = ~near[5, 2, 1]
    assert cs.sign_gate("signs", w, x, near, signs, "cpu") == 1
    far = signs.clone()
    far[6, 2, 1] = ~far[6, 2, 1]
    with pytest.raises(AssertionError, match="clear of rounding"):
        cs.sign_gate("signs", w, x, far, signs, "cpu")


def test_pq_code_gate_holds_codes_outside_the_band():
    cs = _chip_smoke()
    from repro_torch.baselines import pqcache
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 40, 4), generator=gen)
    books = torch.randn((2, 5, 4), generator=gen)
    books[1, 2] = books[1, 0] + 0.25               # two close centroids
    x[1, 3] = books[1, 0] + 0.125                  # midway: a tie
    codes = pqcache._encode(x, books)
    assert cs.pq_code_gate("codes", x, books, codes, codes.clone(),
                           "cpu")["differ_in_band"] == 0
    tie = codes.clone()
    tie[3, 1] = 2 if int(codes[3, 1]) == 0 else 0
    out = cs.pq_code_gate("codes", x, books, tie, codes, "cpu")
    assert out == dict(in_band=out["in_band"], differ_in_band=1)
    assert out["in_band"] >= 1
    moved = codes.clone()
    moved[9, 0] = (int(codes[9, 0]) + 1) % 5
    with pytest.raises(AssertionError, match="outside the rounding band"):
        cs.pq_code_gate("codes", x, books, moved, codes, "cpu")


def test_phase_frontends_at_smoke_width():
    """Phase 12 end to end on the CPU: the two models' smoke configs at
    their numerics, 12c at a small shape; every gate runs (the card's side
    is the CPU's here) and each run's launches are counted around the
    wrappers."""
    cs = _chip_smoke()
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch import serve as sv
    card_config = sv.card_config

    def smoke(arch, numerics="f32"):
        full = card_config(arch, numerics)
        return full.smoke().replace(
            param_dtype=full.param_dtype, compute_dtype=full.compute_dtype,
            attn_q_chunk=16 if full.attn_q_chunk else 0,
            socket=dataclasses.replace(full.smoke().socket,
                                       score_dtype=full.socket.score_dtype))

    def counting(mod, name):
        real = getattr(mod, name)

        def count(*a, **k):
            mod.LAUNCHES += 1
            return real(*a, **k)
        return mock.patch.object(mod, name, count)

    def noop(*a, **k):
        return 0

    with contextlib.ExitStack() as stack, one_thread():
        for p in (mock.patch.object(sv, "card_config", smoke),
                  counting(ss, "socket_score"), counting(fd, "flash_decode"),
                  counting(fp, "flash_prefill"),
                  mock.patch.object(fp, "launch_flash_prefill",
                                    lambda q, k, v, **kw: flash_prefill_ref(
                                        q, k, v, q_chunk=16, **kw)),
                  mock.patch.dict(cs.STATIC_CASES, {
                      "musicgen-medium": (2, 40, 4),
                      "internvl2-26b": (2, 48, 4)}),
                  mock.patch.object(cs, "BASELINE_SHAPE",
                                    dict(kvh=2, n=256, g=4, hd=32)),
                  mock.patch.dict(cs.FRONTEND_GATE_DEPTH, {
                      "musicgen-medium": 1, "internvl2-26b": 1}),
                  *(mock.patch.object(torch.cuda, name, noop) for name in (
                      "synchronize", "reset_peak_memory_stats",
                      "empty_cache", "max_memory_allocated",
                      "memory_allocated"))):
            stack.enter_context(p)
        out = cs.phase_frontends("cpu", 0, "cpu")
    # 2 attention layers x 5 decode calls (4 steps + the warm-up) and one
    # prefill a layer; the gated internvl2 run at 1 layer
    assert out["socket_score"]["launches"] == {
        "musicgen-medium": 10, "musicgen-medium at 1 layers": 5,
        "internvl2-26b": 10, "internvl2-26b at 1 layers": 5}
    assert out["flash_prefill"]["launches"]["internvl2-26b"] == 2



def test_prefill_socket_checks_hold_each_route_to_its_keys():
    """The free-running prefill's bits check: each route's bits are its
    own keys' signs outside |proj| ~ 0; keys that part across zero (deep
    layers' drift) may give the routes other signs (counted), a bit
    flipped clear of rounding fails."""
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.core import hashing
    cfg = get_config("llama31-8b").smoke()
    gen = torch.Generator().manual_seed(3)
    s = cfg.socket
    w = torch.randn((s.num_tables, s.num_planes, cfg.head_dim),
                    generator=gen)
    keys = torch.randn((1, 2, 12, cfg.head_dim), generator=gen)

    def cache(k):
        return {"k": k, "bits": hashing.pack_signs(
            hashing.hash_keys_signs(w, k))}

    moved = keys.clone()
    proj = keys[0, 1, 5] @ w[3, 2]
    moved[0, 1, 5] -= 1.01 * proj * w[3, 2] / (w[3, 2] @ w[3, 2])
    params = {"layers": [{"attn": {"hash_w": w}}]}
    prompt = torch.zeros((1, 12))
    out = cs.prefill_socket_checks(cfg, params, prompt, [cache(keys)],
                                   [cache(moved)])
    assert out["prefill_bit_flips_by_key_drift"] >= 1
    bad = cache(keys)
    signs = hashing.hash_keys_signs(w, keys)
    signs[0, 0, 2, 1, 0] = ~signs[0, 0, 2, 1, 0]
    bad["bits"] = hashing.pack_signs(signs)
    with pytest.raises(AssertionError, match="plain route's SOCKET bits"):
        cs.prefill_socket_checks(cfg, params, prompt, [cache(keys)], [bad])


def _smoke_decode_counts(extra_call: bool):
    """``count_step`` of llama31-8b's smoke config at ``decode_32k`` on
    rank 0 of the 16 x 16 mesh, on fake tensors; with ``extra_call`` the
    step calls ``flash_decode`` once more."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.launch import dryrun
    plan = dryrun.plan_cell("llama31-8b", "decode_32k", smoke=True)
    step = dryrun.make_step(plan)

    def faulty(*args):
        q = torch.zeros((4, 2, 16), device="meta")
        kv = torch.zeros((4, 9, 16), device="meta")
        fd.flash_decode(q, kv, kv, torch.ones((4, 9), dtype=torch.bool,
                                              device="meta"), scale=0.25)
        return step(*args)

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = dryrun.make_args(plan, "meta")
        return dryrun.count_step(faulty if extra_call else step, args,
                                 plan.chips)


def test_dryrun_gates_catch_faults():
    """Phase 13's gates: sound cases pass; a FLOP count off by one
    operator call, a peak 20 % from the prediction, a step faster than
    its floor allows, a NaN logit and an extra launch each fail."""
    cs = _chip_smoke()
    assert cs.DRYRUN_CELLS == (("llama31-8b", "base"), ("llama31-8b", "opt"),
                               ("gemma-7b", "base"))
    assert cs.DRYRUN_SHAPE == "decode_32k"
    sound = _smoke_decode_counts(False)
    cs.dryrun_count_gate("sound", sound, _smoke_decode_counts(False))
    with pytest.raises(AssertionError, match="flops counted"):
        cs.dryrun_count_gate("one call more", sound,
                             _smoke_decode_counts(True))
    moved = dict(sound, collective_bytes=dict(
        sound["collective_bytes"], total=sound["collective_bytes"]["total"]
        + 2))
    with pytest.raises(AssertionError, match="collective_bytes counted"):
        cs.dryrun_count_gate("bytes moved", sound, moved)

    pred = 7.102
    assert cs.dryrun_peak_gate("sound", 1.04 * pred * 2 ** 30, pred) < 0.05
    for off in (1.2, 0.8):
        with pytest.raises(AssertionError, match="from the dry run's"):
            cs.dryrun_peak_gate("peak off", off * pred * 2 ** 30, pred)

    floor = cs.dryrun_floor_ms(989e12 * 1e-3, 3.35e12 * 2e-3)
    assert floor == pytest.approx(2.0)
    assert cs.dryrun_floor_ms(989e12 * 3e-3, 1.0) == pytest.approx(3.0)
    assert cs.dryrun_floor_gate("sound", [2.0, 40.0], floor) == \
        pytest.approx(1.0)
    with pytest.raises(AssertionError, match="its floor"):
        cs.dryrun_floor_gate("too fast", [40.0, 1.8], floor)

    cs.logits_finite_gate("sound", torch.zeros(2, 1, 8))
    bad = torch.zeros(2, 1, 8)
    bad[1, 0, 3] = float("nan")
    with pytest.raises(AssertionError, match="non-finite"):
        cs.logits_finite_gate("nan", bad)

    launches = dict(socket_score=320, flash_decode=320, flash_prefill=0,
                    paged_attention=0)
    cs.dryrun_launch_gate("sound", launches, 32, 10, True)
    cs.dryrun_launch_gate("cp", dict(launches, flash_decode=0), 32, 10,
                          False)
    for bad_launches, base in ((dict(launches, socket_score=321), True),
                               (launches, False),
                               (dict(launches, flash_prefill=1), True)):
        with pytest.raises(AssertionError, match="launches"):
            cs.dryrun_launch_gate("fault", bad_launches, 32, 10, base)
