"""The port's roofline (``repro_torch.roofline``) and its kernel operators.

* The JAX package's ``test_roofline_terms_math`` and
  ``test_dominant_selection`` at ``HW``'s H100 rates (bf16 989 TFLOP/s,
  HBM 3.35 TB/s, 50 GB/s a link).
* ``collective_bytes`` sums ``(kind, bytes)`` records by kind, with
  ``total`` (the JAX package's ``parse_collective_bytes`` contract).
* Each kernel operator's FLOP formula, read through ``FlopCounterMode``
  on ``meta`` tensors, equals the operation count of the bound in
  ``PERF.md``'s table (``chip_smoke.py``'s ``socket_score_row``,
  ``flash_decode_rows`` with every row kept, ``prefill_cost``) at that
  row's shapes, written out here on its own.
* Each wrapper on ``meta`` tensors goes through its operator's fake
  implementation and returns the CUDA route's shapes and dtypes: those
  of the plain version on the CPU for the same inputs.
* Fake tensors and calls under a counting mode take the operator
  (``kernels.build.dispatch_free``).
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.flash_prefill import ops as fp
from repro_torch.kernels.socket_score import ops as ss
from repro_torch.roofline import (HW, RooflineTerms, collective_bytes,
                                  roofline_from_counts)


def test_hw_is_the_h100_sheet():
    assert HW["peak_flops"] == 989e12 and HW["tf32_flops"] == 495e12
    assert HW["fp32_flops"] == 67e12 and HW["hbm_bw"] == 3.35e12
    assert HW["link_bw"] == 50e9


def test_roofline_terms_math():
    rt = RooflineTerms(flops_per_device=989e12, hbm_bytes_per_device=3.35e12,
                       collective_bytes_per_device=50e9, chips=256)
    assert abs(rt.compute_s - 1.0) < 1e-9
    assert abs(rt.memory_s - 1.0) < 1e-9
    assert abs(rt.collective_s - 1.0) < 1e-9
    d = rt.as_dict()
    assert d["dominant"] in ("compute", "memory", "collective")
    assert set(d) == {"flops_per_device", "hbm_bytes_per_device",
                      "collective_bytes_per_device", "chips", "compute_s",
                      "memory_s", "collective_s", "dominant"}


def test_dominant_selection():
    rt = RooflineTerms(1.0, 1e15, 0.0, chips=1)
    assert rt.dominant == "memory"
    rt = RooflineTerms(1e30, 1.0, 0.0, chips=1)
    assert rt.dominant == "compute"
    rt = RooflineTerms(1.0, 1.0, 1e12, chips=1)
    assert rt.dominant == "collective"
    assert rt.bound_s == rt.collective_s


def test_collective_bytes_sums_by_kind():
    out = collective_bytes([("all-gather", 128 * 256 * 2),
                            ("all-reduce", 1024 * 4), ("all-gather", 10),
                            ("reduce-scatter", 64 * 64 * 4),
                            ("all-to-all", 64), ("collective-permute", 512)])
    assert out == {"all-gather": 128 * 256 * 2 + 10, "all-reduce": 4096,
                   "reduce-scatter": 16384, "all-to-all": 64,
                   "collective-permute": 512,
                   "total": 65536 + 10 + 4096 + 16384 + 64 + 512}
    assert collective_bytes([]) == {"total": 0}
    rt = roofline_from_counts({"flops": 2.0, "bytes": 3.0,
                               "collective_bytes": out}, chips=4)
    assert rt.collective_bytes_per_device == out["total"]
    assert (rt.flops_per_device, rt.hbm_bytes_per_device) == (2.0, 3.0)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# PERF.md's table rows: the static path's shapes (llama31-8b, batch 2 x
# 8 KV heads), gemma-7b's and musicgen-medium's
@pytest.mark.parametrize("bh,n,g", [(16, 8224, 4), (32, 4112, 1),
                                    (96, 1516, 1)])
def test_socket_score_formula_is_the_bound_count(bh, n, g):
    l, p = 60, 10
    bits = _meta(bh, n, 19, dtype=torch.int32)
    u = _meta(bh, g, l, p)
    flops = _counted(lambda: ss.socket_score(bits, u, num_tables=l,
                                             num_planes=p, tau=0.4))
    assert flops == bh * n * g * l * 2


@pytest.mark.parametrize("bh,k,g,hd", [(16, 823, 4, 128), (32, 412, 1, 256),
                                       (96, 256, 1, 64)])
def test_flash_decode_formula_is_the_bound_count(bh, k, g, hd):
    q, kv = _meta(bh, g, hd), _meta(bh, k, hd)
    mask = _meta(bh, k, dtype=torch.bool)
    flops = _counted(lambda: fd.flash_decode(q, kv, kv, mask, scale=0.1))
    assert flops == k * bh * g * (4 * hd + 4)


@pytest.mark.parametrize("bh,bkv,s,hd,window", [
    (64, 16, 8192, 128, 0), (32, 16, 4096, 256, 0), (96, 96, 1500, 64, 0),
    (32, 16, 4096, 128, 1024), (8, 8, 300, 64, 512)])
def test_flash_prefill_formula_is_the_bound_count(bh, bkv, s, hd, window):
    q, kv = _meta(bh, s, hd), _meta(bkv, s, hd)
    flops = _counted(lambda: fp.flash_prefill(q, kv, kv, scale=0.1,
                                              window=window))
    keys = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    assert flops == 4 * hd * bh * keys


def _same_layout(meta_out, cpu_out):
    assert meta_out.device.type == "meta"
    assert meta_out.shape == cpu_out.shape
    assert meta_out.dtype == cpu_out.dtype


@pytest.mark.parametrize("model_layout", [False, True])
def test_fake_outputs_have_the_cuda_routes_layout(model_layout):
    """Every wrapper on ``meta`` tensors: the operator's fake
    implementation, the plain version's shapes and dtypes."""
    gen = torch.Generator().manual_seed(0)
    b, kvh, g, n, hd, l, p = 2, 3, 4, 40, 16, 6, 5
    bits = torch.randint(-2 ** 31, 2 ** 31, (b, kvh, n, 1), generator=gen,
                         dtype=torch.int32)
    u = torch.randn((b, kvh, g, l, p), generator=gen)
    vn = torch.rand((b, kvh, n), generator=gen)
    q = torch.randn((b, kvh, g, 1, hd), generator=gen, dtype=torch.bfloat16)
    k = torch.randn((b, kvh, n, hd), generator=gen, dtype=torch.bfloat16)
    mask = torch.rand((b, kvh, n), generator=gen) > 0.5
    if not model_layout:
        bits, u, vn = bits.flatten(0, 1), u.flatten(0, 1), vn.flatten(0, 1)
        q, k, mask = q[:, :, :, 0].flatten(0, 1), k.flatten(0, 1), \
            mask.flatten(0, 1)
    kw = dict(num_tables=l, num_planes=p, tau=0.4)
    cpu = ss.socket_score(bits, u, vn, **kw)
    _same_layout(ss.socket_score(bits.to("meta"), u.to("meta"),
                                 vn.to("meta"), **kw), cpu)
    cpu = fd.flash_decode(q, k, k, mask, scale=0.25)
    _same_layout(fd.flash_decode(q.to("meta"), k.to("meta"), k.to("meta"),
                                 mask.to("meta"), scale=0.25), cpu)
    qp = torch.randn((b * kvh * 2, 24, hd), generator=gen)
    kp = torch.randn((b * kvh, 24, hd), generator=gen)
    cpu = fp.flash_prefill(qp, kp, kp, scale=0.25, window=8)
    _same_layout(fp.flash_prefill(qp.to("meta"), kp.to("meta"),
                                  kp.to("meta"), scale=0.25, window=8), cpu)


def test_fake_calls_build_nothing_and_count_no_launch(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a fake call built a kernel library")
    monkeypatch.setattr(build, "load_library", refuse)
    before = (ss.LAUNCHES, fd.LAUNCHES, fp.LAUNCHES)
    ss.socket_score(_meta(4, 9, 2, dtype=torch.int32), _meta(4, 1, 6, 5),
                    num_tables=6, num_planes=5, tau=0.4)
    fd.flash_decode(_meta(4, 2, 16), _meta(4, 9, 16), _meta(4, 9, 16),
                    _meta(4, 9, dtype=torch.bool), scale=0.1)
    fp.flash_prefill(_meta(4, 9, 16), _meta(4, 9, 16), _meta(4, 9, 16),
                     scale=0.1)
    assert (ss.LAUNCHES, fd.LAUNCHES, fp.LAUNCHES) == before


def test_fake_and_counted_calls_take_the_operator():
    """``build.dispatch_free`` keeps the operator wherever a run counts or
    fakes: a fake tensor that says ``cuda`` (inside its mode and out of
    it), any tensor under ``FlopCounterMode``, and ``meta`` or CPU
    tensors; only a plain CUDA tensor with no mode skips it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.build import dispatch_free
    with FakeTensorMode() as mode:
        fake = torch.empty(4, device="cuda")
        assert fake.is_cuda and not dispatch_free(fake)
    assert mode is not None and not dispatch_free(fake)
    plain = torch.empty(4)
    with FlopCounterMode(display=False):
        assert not dispatch_free(plain)
    assert not dispatch_free(plain) and not dispatch_free(plain.to("meta"))
