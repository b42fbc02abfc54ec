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
