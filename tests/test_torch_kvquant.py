"""Port parity for the K/V page quantization (``serving.kv_dtype``):
``repro_torch.models.backends.kvquant`` against
``repro.models.backends.kvquant`` bit for bit (numpy-seeded rows whose
scales span 1e-3 to 50, a zero row, rows whose ``x / scale`` lands above
the grid's maximum before rounding), the bf16 storage cast, the dtype
resolution, the leaves every backend stores, and the config's
``validate()`` matrix case by case against ``repro.configs``.

Tolerance: none — payloads, scales, dequantized rows and the validate
outcomes (raise or pass, and the message) are equal.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.launch.serve import apply_backend_arg as japply
from repro.models.backends import base as jbase
from repro.models.backends import kvquant as jkv
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import SERVING_BACKENDS, apply_backend_arg
from repro_torch.models import backends as tbk
from repro_torch.models.backends import kvquant as tkv

_QMAX = {"int8": 127.0, "fp8": 448.0}


def _rows(seed=0, n=4096, hd=128):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(50.0), (n, 1)))
    x = (rng.standard_normal((n, hd)) * scale).astype(np.float32)
    x[5] = 0.0
    return x


def _bytes(a):
    """The raw bytes of a JAX/numpy or torch array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_and_dequantize_bitwise(kv_dtype):
    x = _rows()
    jq, js = jkv.quantize(jnp.asarray(x), kv_dtype)
    tq, ts = tkv.quantize(torch.from_numpy(x), kv_dtype)
    assert tq.dtype == tkv.storage_dtype(kv_dtype, "float32")
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (x.shape[0],)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    np.testing.assert_array_equal(
        _bytes(tkv.dequantize(tq, ts)), _bytes(jkv.dequantize(jq, js)))
    # the zero row round-trips exactly (scale 0, zero payload)
    assert float(ts[5]) == 0.0
    assert not tkv.dequantize(tq, ts)[5].any()
    # some rows divide past the grid's maximum and round back onto it
    xf = x / np.where(np.asarray(js) > 0, np.asarray(js), 1.0)[:, None]
    qmax = _QMAX[kv_dtype]
    assert (np.abs(xf) > qmax).any()
    assert float(tq.float().abs().max()) == qmax


def test_bf16_storage_cast_bitwise():
    """``kv_dtype='bf16'`` stores a plain cast (no scales), as the JAX
    package's ``astype(bfloat16)``."""
    x = _rows(seed=1, n=512)
    cfg = tget("llama31-8b").smoke()
    cfg = cfg.replace(serving=cfg.serving.replace(kv_dtype="bf16"))
    stored = tbk.quantize_kv(cfg, torch.from_numpy(x), torch.from_numpy(x))
    assert set(stored) == {"k", "v"}
    np.testing.assert_array_equal(
        _bytes(stored["k"].view(torch.int16)),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint8))


def test_resolution_storage_dtypes_and_leaves():
    assert tkv.KV_DTYPES == jkv.KV_DTYPES
    assert tkv.QUANTIZED_KV_DTYPES == jkv.QUANTIZED_KV_DTYPES
    for kvd in tkv.KV_DTYPES:
        assert tkv.is_quantized(kvd) == jkv.is_quantized(kvd)
        for kind in ("paged", "ring", "state"):
            assert tkv.resolve_kv_dtype(kvd, kind) == \
                jkv.resolve_kv_dtype(kvd, kind)
        want = jkv.storage_dtype(kvd, jnp.float32)
        got = tkv.storage_dtype(kvd, torch.float32)
        assert torch.empty((), dtype=got).element_size() == want.itemsize
        assert str(got).replace("torch.", "") == want.name
        # the leaves every backend stores: names, suffixes, dtypes
        jc, tc = (c.replace(serving=c.serving.replace(kv_dtype=kvd))
                  for c in (jget("llama31-8b").smoke(),
                            tget("llama31-8b").smoke()))
        jspec, tspec = jbase.kv_leaf_specs(jc), tbk.kv_leaf_specs(tc)
        assert set(jspec) == set(tspec)
        for name, s in jspec.items():
            assert tspec[name].suffix == s.suffix
            assert tspec[name].granularity == s.granularity
            jdt = s.leaf_dtype(jnp.float32)
            tdt = tspec[name].leaf_dtype(torch.float32)
            assert str(tdt).replace("torch.", "") == jnp.dtype(jdt).name
    assert tkv.scale_dtype() == torch.float32
    for bad in (lambda: tkv.resolve_kv_dtype("int4", "paged"),
                lambda: tkv.storage_dtype("int4", "float32")):
        with pytest.raises(ValueError, match="int4"):
            bad()


def _matrix():
    """(arch, backend, kv_dtype, ring kernel, stats_from_quantized)."""
    cases = []
    for arch in ("llama31-8b", "gemma3-27b"):
        for backend in SERVING_BACKENDS:
            for kvd in ("auto", "bf16", "int8", "fp8", "int4"):
                for ring in ((False,) if arch == "llama31-8b"
                             else (False, True)):
                    cases.append((arch, backend, kvd, ring, True))
    for backend in ("quest", "quest_fused"):
        for kvd in ("bf16", "int8", "fp8"):
            cases.append(("llama31-8b", backend, kvd, False, False))
    return cases


def _outcome(cfg):
    try:
        cfg.validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("arch,backend,kv_dtype,ring,stats", _matrix(),
                         ids=lambda v: str(v))
def test_validate_matrix_matches_jax(arch, backend, kv_dtype, ring, stats):
    """Each configuration raises (with the same message) or passes as the
    JAX package's ``ModelConfig.validate()`` does, and a passing one
    resolves every layer's cache plan to the same kind and dtype."""
    def build(get, apply):
        cfg = apply(get(arch).smoke(), backend)
        return cfg.replace(
            use_ring_kernel=ring,
            serving=cfg.serving.replace(kv_dtype=kv_dtype),
            quest=dataclasses.replace(cfg.quest,
                                      stats_from_quantized=stats))
    jc, tc = build(jget, japply), build(tget, apply_backend_arg)
    want = _outcome(jc)
    assert _outcome(tc) == want
    if want is None:
        assert [(p.kind, p.kv_dtype) for p in tc.cache_plan()] == \
            [(p.kind, p.kv_dtype) for p in jc.cache_plan()]
