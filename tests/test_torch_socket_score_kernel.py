"""The ``socket_score`` CUDA kernel's arithmetic, pinned on the CPU.

``socket_score.cu`` scores a key from split tables of exp(.) per (g, l)
(P <= 16) or from per-key sign-adds (P > 16), summed in one fixed order,
and splits each row's keys over the C ranks of a thread-block cluster.
``ref.split_table_scores`` emulates the arithmetic in plain torch and
``ops.key_runs`` is the host's copy of the split; here the emulation is
held to the JAX package's Pallas kernel (interpret mode) where it takes
the shape, else to its jnp oracle, within SCORE_TOL (rtol 1e-5 / atol
1e-6: exp(a) * exp(b) in place of exp(a + b), float32 in another
order).  The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.core import socket as jsk
from repro.kernels.socket_score import ops as jss
from repro.kernels.socket_score.ref import socket_score_ref as j_score_ref
from repro_torch.kernels.socket_score import ops as tss
from repro_torch.kernels.socket_score.ref import split_table_scores

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(60, 10, 4), (60, 10, 1), (12, 6, 2), (9, 7, 3), (5, 1, 2),
          (3, 20, 2)]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(seed, fmt, l, p, g, *, bh=3, n=97):
    """JAX's and the port's bits (packed words: the same 32 bits, int32
    in the port; or ±1 int8 planes), the query hash u (BH, G, L, P) and
    vnorm, from one numpy generator."""
    rng = np.random.default_rng(seed)
    signs = rng.random((bh, n, l, p)) < 0.5
    if fmt == "packed":
        jbits = np.asarray(jh.pack_signs(jnp.asarray(signs)))
        tbits = jbits.view(np.int32)
    else:
        jbits = tbits = (signs.astype(np.int8) * 2 - 1).reshape(bh, n, l * p)
    u = np.asarray(jsk.soft_hash_query(
        jnp.asarray(rng.standard_normal((l, p, 64)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((bh, g, 64)).astype(np.float32))))
    vnorm = (rng.random((bh, n)) * 3).astype(np.float32)
    return jbits, tbits, u, vnorm


def _jax_scores(jbits, u, vnorm, **kw):
    """The Pallas kernel in interpret mode where it takes the shape (its
    packed view needs W*32 % P == 0), else the jnp oracle."""
    args = (jnp.asarray(jbits), jnp.asarray(u),
            None if vnorm is None else jnp.asarray(vnorm))
    if jbits.dtype == np.int8 or (jbits.shape[-1] * 32) % kw["num_planes"] \
            == 0:
        return np.asarray(jss.socket_score(*args, interpret=True, **kw))
    return np.asarray(j_score_ref(*args, **kw))


@pytest.mark.parametrize("with_vnorm", [False, True], ids=["no-vnorm",
                                                            "vnorm"])
@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("l,p,g", SHAPES)
def test_split_table_emulation_matches_jax(l, p, g, fmt, with_vnorm):
    """The kernel's scores as emulated (split tables for P <= 16, the
    sign-add instance's direct sum at P 20) against the JAX package."""
    jbits, tbits, u, vnorm = _inputs(l * 31 + p * 7 + g, fmt, l, p, g)
    vn = vnorm if with_vnorm else None
    kw = dict(num_tables=l, num_planes=p, tau=0.4)
    got = split_table_scores(_t(tbits), _t(u),
                             None if vn is None else _t(vn), **kw)
    assert got.shape == tbits.shape[:2] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_scores(jbits, u, vn, **kw),
                               **SCORE_TOL)


@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("l,p,g", [(60, 10, 4), (3, 20, 2)])
def test_equal_bit_rows_score_bit_equal(l, p, g, fmt):
    """Keys with equal bits score bit for bit the same, whatever their
    position: the kernel sums every key in the one order emulated here
    (value_aware_topk's tie order relies on it)."""
    _, tbits, u, _ = _inputs(11, fmt, l, p, g, n=200)
    bits = _t(tbits)
    at = [3, 64, 129, 199]
    bits[:, at] = bits[:, at[:1]]
    out = split_table_scores(bits, _t(u), num_tables=l, num_planes=p,
                             tau=0.4)
    assert torch.equal(out[:, at], out[:, at[:1]].expand(-1, len(at)))


@pytest.mark.parametrize("c", range(1, 9))
def test_key_runs_cover_every_key_once(c):
    """The ranks' runs tile [0, N) in rank order, each at most ceil(N / C)
    keys, in tiles of whole warps of at most ``tile`` rows; ragged N, N
    below C (idle ranks) and N 0 included."""
    for tile in (512, 64):
        for n in (0, 1, 3, 7, 31, 100, 513, 1001, 4097, 8224):
            rows, runs = tss.key_runs(n, c, tile)
            assert len(runs) == c
            assert runs[0][0] == 0 and runs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            per = -(-n // c)
            assert all(0 <= r1 - r0 <= per for r0, r1 in runs)
            if n:
                assert 0 < rows <= tile and rows % 32 == 0
                # no run takes more tiles than the most keys a rank needs
                assert all(-(-(r1 - r0) // rows) <= -(-per // tile)
                           for r0, r1 in runs)
            if n < c:
                assert sum(r1 > r0 for r0, r1 in runs) == n


def test_key_runs_main_path_split():
    """The static path's row (N 8224) over the C 6 a one-wave cluster
    takes on an H100: six runs of 1371 keys or fewer, three tiles of 480
    rows each."""
    rows, runs = tss.key_runs(8224, 6)
    assert rows == 480
    assert [r1 - r0 for r0, r1 in runs] == [1371] * 5 + [1369]


@pytest.mark.parametrize("l,p,g,c", [(60, 10, 4, 6), (9, 7, 3, 2),
                                     (5, 1, 2, 1)])
def test_table_dump_layout_reads_back_the_split_tables(l, p, g, c):
    """``ops.tables_of_dump`` reads the diagnostic build's dump layout
    (each rank's table sets, set k = l * G + g at k * stride: T_lo, then
    T_hi, then padding to whole 16-byte words) back into ``(BH, C, G, L,
    entries)`` tables: a dump laid out from ``ref.split_tables`` reads
    back as them on every rank."""
    from repro_torch.kernels.socket_score.ref import split_tables
    _, _, u, _ = _inputs(5, "packed", l, p, g)
    t_lo, t_hi = split_tables(_t(u), 0.4)            # (BH, G, L, 2^k)
    bh = t_lo.shape[0]
    n_lo, n_hi = 1 << ((p + 1) // 2), 1 << (p // 2)
    stride = (n_lo + n_hi + 3) & ~3                  # table_stride<true>
    dump = torch.full((bh, c, g * l, stride), float("nan"))
    for k in range(g * l):
        gg, ll = k % g, k // g
        dump[:, :, k, :n_lo] = t_lo[:, None, gg, ll]
        dump[:, :, k, n_lo:n_lo + n_hi] = t_hi[:, None, gg, ll]
    lo, hi = tss.tables_of_dump(dump, g, p)
    assert lo.shape == (bh, c, g, l, n_lo) and hi.shape == (bh, c, g, l, n_hi)
    for r in range(c):
        assert torch.equal(lo[:, r], t_lo) and torch.equal(hi[:, r], t_hi)
