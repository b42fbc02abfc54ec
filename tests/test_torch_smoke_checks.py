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
"""

from __future__ import annotations

import contextlib
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
