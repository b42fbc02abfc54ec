"""Port parity: the kernel wrappers' plain PyTorch versions (what a CPU
tensor runs) against the JAX package's Pallas kernels in interpret mode
and against its jnp oracles, on the same numpy inputs.

Tolerances: scores rtol 1e-5 / atol 1e-6 and attention rtol 1e-5 /
atol 1e-5 (float32 in another summation order).  The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import hashing as jh
from repro.core import socket as jsk
from repro.kernels.flash_decode import ops as jfd
from repro.kernels.socket_score import ops as jss
from repro.kernels.socket_score.ref import socket_score_ref as j_score_ref
from repro_torch.kernels.flash_decode import ops as tfd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.socket_score import ops as tss
from repro_torch.kernels.socket_score.ref import socket_score_ref

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _score_inputs(rng, bh, n, g, l, p, fmt):
    signs = rng.random((bh, n, l, p)) < 0.5
    if fmt == "packed":
        jbits = np.asarray(jh.pack_signs(jnp.asarray(signs)))
        tbits = jbits.view(np.int32)
    else:
        jbits = tbits = (signs.astype(np.int8) * 2 - 1).reshape(bh, n, l * p)
    w = rng.standard_normal((l, p, 32)).astype(np.float32)
    q = rng.standard_normal((bh, g, 32)).astype(np.float32)
    u = np.asarray(jsk.soft_hash_query(jnp.asarray(w), jnp.asarray(q)))
    vnorm = (rng.random((bh, n)) * 3).astype(np.float32)
    return jbits, tbits, u, vnorm


@pytest.mark.parametrize("fmt", ["packed", "int8"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("n", [100, 768])
def test_socket_score_plain_matches_pallas_and_oracle(fmt, g, n):
    rng = np.random.default_rng(n + g)
    l, p, tau = 12, 6, 0.4
    jbits, tbits, u, vnorm = _score_inputs(rng, 3, n, g, l, p, fmt)
    kw = dict(num_tables=l, num_planes=p, tau=tau)
    for vn in (None, vnorm):
        out = tss.socket_score(_t(tbits), _t(u),
                               None if vn is None else _t(vn), **kw)
        assert out.shape == (3, n) and out.dtype == torch.float32
        pallas = jss.socket_score(jnp.asarray(jbits), jnp.asarray(u),
                                  None if vn is None else jnp.asarray(vn),
                                  interpret=True, **kw)
        oracle = j_score_ref(jnp.asarray(jbits), jnp.asarray(u),
                             None if vn is None else jnp.asarray(vn), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                                   **SCORE_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(oracle),
                                   **SCORE_TOL)


def test_socket_score_model_layout_and_paper_shapes():
    """(B, KVH, ...) layout at the paper's P=10, L=60 (W=20 words, tables
    straddling words), against the Pallas kernel."""
    rng = np.random.default_rng(7)
    b, kvh, g, n, l, p = 2, 2, 4, 96, 60, 10
    jbits, tbits, u, vnorm = _score_inputs(rng, b * kvh, n, g, l, p,
                                           "packed")
    assert jbits.shape[-1] == 20
    jb4 = jbits.reshape(b, kvh, n, -1)
    u5 = u.reshape(b, kvh, g, l, p)
    vn3 = vnorm.reshape(b, kvh, n)
    kw = dict(num_tables=l, num_planes=p, tau=0.4)
    out = tss.socket_score(_t(jb4.view(np.int32)), _t(u5), _t(vn3), **kw)
    ref = jss.socket_score(jnp.asarray(jb4), jnp.asarray(u5),
                           jnp.asarray(vn3), interpret=True, **kw)
    assert out.shape == (b, kvh, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SCORE_TOL)
    with pytest.raises(ValueError):
        tss.socket_score(_t(jb4.view(np.int32)), _t(u5), num_tables=l,
                         num_planes=p + 1, tau=0.4)


def _decode_inputs(rng, bh, k, g, hd, dead_rows=()):
    q = rng.standard_normal((bh, g, hd)).astype(np.float32)
    kk = rng.standard_normal((bh, k, hd)).astype(np.float32)
    vv = rng.standard_normal((bh, k, hd)).astype(np.float32)
    mask = rng.random((bh, k)) < 0.8
    for r in dead_rows:
        mask[r] = False
    return q, kk, vv, mask


@pytest.mark.parametrize("k,hd", [(40, 16), (600, 32), (823, 160)])
def test_flash_decode_plain_matches_pallas(k, hd):
    """K < block (40), a ragged K tail past one 512-row block (600, 823),
    stablelm's head_dim 160, and a fully masked row, which the kernel
    returns as 0."""
    rng = np.random.default_rng(k)
    q, kk, vv, mask = _decode_inputs(rng, 3, k, 4, hd, dead_rows=(1,))
    scale = 1.0 / np.sqrt(hd)
    out = tfd.flash_decode(_t(q), _t(kk), _t(vv), _t(mask), scale=scale)
    ref = jfd.flash_decode(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                           jnp.asarray(mask), scale=scale, interpret=True)
    assert out.shape == (3, 4, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    np.testing.assert_array_equal(out[1].numpy(), 0.0)


def test_flash_decode_model_layout():
    rng = np.random.default_rng(11)
    b, kvh, g, k, hd = 2, 2, 2, 50, 16
    q, kk, vv, mask = _decode_inputs(rng, b * kvh, k, g, hd)
    q5 = q.reshape(b, kvh, g, 1, hd)
    k4, v4 = kk.reshape(b, kvh, k, hd), vv.reshape(b, kvh, k, hd)
    m3 = mask.reshape(b, kvh, k)
    out = tfd.flash_decode(_t(q5), _t(k4), _t(v4), _t(m3), scale=0.25)
    ref = jfd.flash_decode(jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4),
                           jnp.asarray(m3), scale=0.25, interpret=True)
    assert out.shape == (b, kvh, g, 1, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    # rows with at least one valid key: the same as a plain softmax
    dense = jsk.sparse_attention_over_subset(
        jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4), jnp.asarray(m3),
        scale=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), **ATTN_TOL)


def test_plain_versions_are_the_cpu_route():
    """On CPU tensors the wrappers return their plain versions' results
    exactly and launch nothing."""
    rng = np.random.default_rng(12)
    jbits, tbits, u, vnorm = _score_inputs(rng, 2, 33, 2, 12, 6, "packed")
    kw = dict(num_tables=12, num_planes=6, tau=0.4)
    before = (tss.LAUNCHES, tfd.LAUNCHES)
    torch.testing.assert_close(
        tss.socket_score(_t(tbits), _t(u), _t(vnorm), **kw),
        socket_score_ref(_t(tbits), _t(u), _t(vnorm), **kw), rtol=0, atol=0)
    q, kk, vv, mask = _decode_inputs(rng, 2, 33, 2, 16)
    torch.testing.assert_close(
        tfd.flash_decode(_t(q), _t(kk), _t(vv), _t(mask), scale=0.3),
        flash_decode_ref(_t(q), _t(kk), _t(vv), _t(mask), scale=0.3),
        rtol=0, atol=0)
    assert (tss.LAUNCHES, tfd.LAUNCHES) == before
