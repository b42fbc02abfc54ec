"""Card-only tests of the port: each Hopper kernel against its plain
PyTorch version on the card, the static serve path through the prefill
kernel and the two contiguous-path kernels, and the continuous engine
through each fused paged kernel (SOCKET, hard LSH, Quest) and, on
gemma3's local:global layout, through the sliding-window ring kernel,
with chunked prefill and with the legacy whole-prompt prefill.  They skip with a reason where
there is no CUDA card; on the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: scores rtol 1e-5 / atol 1e-6, attention rtol 1e-4 /
atol 1e-5 (float32 in another summation order); the prefill kernel
atol 1e-5, bf16 inputs too (both sides compute in f32 from the same
values).  The paged kernel's
selection equals the plain version's except at rows whose plain
effective score lies within the score tolerance of the threshold, and
bit for bit where the scores tie exactly; the hard-LSH and Quest
kernels' selections equal their plain versions' bit for bit.  The
SOCKET and hard-LSH kernel and the Quest kernel split each (request,
head) over a thread-block cluster; ``CLUSTER_CASES`` exercise it (32K
contexts, ties across ranks, idle ranks and, but for Quest, pooled
selection) on f32 pools here, and on stored pools too in
``chip_smoke.py``.  ``flash_decode``'s card cases
(``kernels/flash_decode/cases.py``) must each plan what their label
names (a cluster split, empty ranks, several waves).  The ring
kernel must skip the NaN rows its cases put in dead slots, and each ring
case's launch plan must exercise what its label names (a cluster split
at B 1 and B 2, empty ranks, padded rows).  On pools
stored as bf16, int8 or fp8 (``serving.kv_dtype``) each kernel is held
to its plain version on the same stored pages, SOCKET's and hard LSH's
selections to the kernel's own on the f32 pages, and the engine on
quantized pages to its CPU run.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

from repro_torch.kernels.flash_decode.cases import CARD_CASES as FD_CASES
from repro_torch.kernels.paged_attention.cases import RING_CASES

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)


def _to(tree, dev):
    """A parameter tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("fmt,g,n,l,p,bh", [
    ("packed", 4, 8224, 60, 10, 6), ("packed", 1, 1001, 60, 10, 6),
    ("packed", 2, 77, 12, 6, 6), ("int8", 4, 513, 60, 10, 6),
    # pooled G 1 at the main path; odd G and P; P 1; P 20 (the sign-add
    # instance); BH 256 (C 1, several waves); tables in chunks (P 16 split
    # tables, P 24 sign-add with L 600)
    ("packed", 1, 8224, 60, 10, 16), ("packed", 3, 300, 9, 7, 6),
    ("int8", 3, 300, 9, 7, 6), ("packed", 2, 300, 5, 1, 6),
    ("packed", 2, 300, 3, 20, 6), ("packed", 4, 513, 60, 10, 256),
    ("packed", 4, 700, 60, 16, 4), ("packed", 4, 300, 600, 24, 2)])
def test_socket_score_kernel_matches_plain(dev, fmt, g, n, l, p, bh):
    from repro_torch.kernels.socket_score import ops
    from repro_torch.kernels.socket_score.ref import socket_score_ref
    gen = torch.Generator(device=dev).manual_seed(n)
    bits, u, vnorm = _score_inputs(dev, gen, fmt, bh, g, n, l, p)
    kw = dict(num_tables=l, num_planes=p, tau=0.4)
    for vn in (None, vnorm):
        before = ops.LAUNCHES
        out = ops.socket_score(bits, u, vn, **kw)
        assert ops.LAUNCHES == before + 1
        torch.testing.assert_close(out, socket_score_ref(bits, u, vn, **kw),
                                   **SCORE_TOL)


def _score_inputs(dev, gen, fmt, bh, g, n, l, p):
    from repro_torch.core import hashing, socket as sk
    if fmt == "int8":
        bits = torch.randint(0, 2, (bh, n, l * p), generator=gen, device=dev,
                             dtype=torch.int8) * 2 - 1
    else:
        bits = torch.randint(-2 ** 31, 2 ** 31,
                             (bh, n, hashing.num_words(l, p)), generator=gen,
                             device=dev, dtype=torch.int32)
    u = sk.soft_hash_query(torch.randn((l, p, 64), generator=gen, device=dev),
                           torch.randn((bh, g, 64), generator=gen,
                                       device=dev))
    vnorm = torch.rand((bh, n), generator=gen, device=dev)
    return bits, u, vnorm


@pytest.mark.parametrize("fmt", ["packed", "int8"])
def test_socket_score_equal_rows_score_bit_equal(dev, fmt):
    """Keys with equal bits on different ranks of the cluster (and in
    different tiles of a rank) score bit for bit the same."""
    from repro_torch.kernels.socket_score import ops
    gen = torch.Generator(device=dev).manual_seed(5)
    bh, n, g, l, p = 16, 8224, 4, 60, 10
    bits, u, _ = _score_inputs(dev, gen, fmt, bh, g, n, l, p)
    c = ops.socket_score_plan(bits, g, num_tables=l, num_planes=p)["C"]
    rows, runs = ops.key_runs(n, c)
    assert c > 1 and sum(r1 > r0 for r0, r1 in runs) > 1
    at = [r0 + k for r0, r1 in runs if r1 > r0 for k in (0, rows + 3)
          if r0 + k < r1]
    bits[:, at] = bits[:, at[:1]]
    out = ops.socket_score(bits, u, num_tables=l, num_planes=p, tau=0.4)
    assert torch.equal(out[:, at], out[:, at[:1]].expand(-1, len(at)))


@pytest.mark.parametrize("k,hd,dtype", [
    (823, 128, torch.float32), (823, 160, torch.float32),
    (77, 128, torch.float32), (9, 64, torch.bfloat16)])
def test_flash_decode_kernel_matches_plain(dev, k, hd, dtype):
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    gen = torch.Generator(device=dev).manual_seed(k + hd)
    bh, g = 5, 4
    q = torch.randn((bh, g, hd), generator=gen, device=dev)
    kk = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    vv = torch.randn((bh, k, hd), generator=gen, device=dev).to(dtype)
    mask = torch.rand((bh, k), generator=gen, device=dev) < 0.9
    mask[3] = False
    scale = 1.0 / math.sqrt(hd)
    before = ops.LAUNCHES
    out = ops.flash_decode(q, kk, vv, mask, scale=scale)
    assert ops.LAUNCHES == before + 1
    torch.testing.assert_close(out, flash_decode_ref(q, kk, vv, mask,
                                                     scale=scale), **ATTN_TOL)
    assert out[3].abs().max().item() == 0.0


@pytest.mark.parametrize("label", [lab for lab, _ in FD_CASES])
def test_flash_decode_card_cases(dev, label):
    """Every card case of ``flash_decode``: one launch, within ATTN_TOL of
    the plain version, a fully masked row exactly 0, and a launch plan
    that exercises what the label names (a cluster split, empty ranks,
    several waves, head groups, 2-byte rows)."""
    from repro_torch.kernels.flash_decode import cases, ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    kw = dict(FD_CASES)[label]
    gen = torch.Generator(device=dev).manual_seed(len(label))
    q, kk, vv, mask = cases.card_case(gen, **kw)
    scale = 1.0 / math.sqrt(kw["hd"])
    before = ops.LAUNCHES
    out = ops.flash_decode(q, kk, vv, mask, scale=scale)
    assert ops.LAUNCHES == before + 1
    torch.testing.assert_close(out, flash_decode_ref(q, kk, vv, mask,
                                                     scale=scale), **ATTN_TOL)
    if kw.get("dead_row") is not None:
        assert out[kw["dead_row"]].abs().max().item() == 0.0
    cases.plan_note(ops.flash_decode_plan(q, kk), label, **kw)


def test_wrappers_raise_on_unsupported_cuda_inputs(dev):
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.socket_score import ops as ss
    with pytest.raises(TypeError):
        ss.socket_score(torch.zeros((2, 8, 3), dtype=torch.uint8, device=dev),
                        torch.zeros((2, 1, 12, 6), device=dev),
                        num_tables=12, num_planes=6, tau=0.4)
    with pytest.raises(ValueError):
        fd.flash_decode(torch.zeros((2, 4, 16), device=dev),
                        torch.zeros((2, 8, 16), device=dev),
                        torch.zeros((2, 8, 16), device=dev),
                        torch.ones((2, 8), dtype=torch.uint8, device=dev),
                        scale=0.25)


def test_static_serve_on_card_matches_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.launch.serve import apply_backend_arg, run_serve
    from repro_torch.models import transformer as tfm
    cfg = apply_backend_arg(get_config("llama31-8b").smoke(), "socket")
    params = tfm.init_model(cfg, seed=0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    cpu, _, _ = run_serve(cfg, 2, 40, 6, prompt=prompt, params=params,
                          device="cpu")
    before = (ss.LAUNCHES, fd.LAUNCHES, fp.LAUNCHES)
    card_params = _to(params, dev)
    card, _, _ = run_serve(cfg, 2, 40, 6, prompt=prompt, params=card_params,
                           device=dev)
    calls = cfg.num_layers * 7                 # 6 steps + the warm-up
    assert (ss.LAUNCHES - before[0], fd.LAUNCHES - before[1],
            fp.LAUNCHES - before[2]) == (calls, calls, cfg.num_layers)
    assert torch.equal(card.cpu(), cpu)


# (bh, bkv, s, hd, window, softcap, dtype): GQA at G 4, ragged last
# tiles, the window mode, the score cap, every head dim the port's
# configs use, bf16 inputs
FLASH_PREFILL_CASES = {
    "hd128 G4 ragged": (8, 2, 300, 128, 0, 0.0, torch.float32),
    "hd128 window 100": (4, 2, 1000, 128, 100, 0.0, torch.float32),
    "hd128 softcap 2 window 100": (8, 2, 500, 128, 100, 2.0, torch.float32),
    "hd160 G4": (8, 2, 257, 160, 0, 0.0, torch.float32),
    "hd256 G1": (2, 2, 129, 256, 0, 0.0, torch.float32),
    "hd16 smoke window": (4, 2, 40, 16, 32, 0.0, torch.float32),
    "hd32 S 1": (4, 1, 1, 32, 0, 0.0, torch.float32),
    "hd64 bf16": (4, 4, 200, 64, 0, 0.0, torch.bfloat16),
    # ragged edges of the tensor-core tiles (128 queries x 48 keys at hd
    # 128: S 9 and 4100 = 85 x 48 + 20 = 32 x 128 + 4, where V's
    # zero-filled rows meet P's zeros), a window whose first key is off
    # the key tiles, hd 256's 64 x 16 tiles at G 4 (S 300 = 18 x 16 + 12
    # = 4 x 64 + 44), bf16 (exact TF32 operands) with a window
    "hd128 G4 ragged S 9": (8, 2, 9, 128, 0, 0.0, torch.float32),
    "hd128 G4 ragged S 4100": (8, 2, 4100, 128, 0, 0.0, torch.float32),
    "hd128 window 1000 S 2100": (4, 2, 2100, 128, 1000, 0.0, torch.float32),
    "hd256 G4": (8, 2, 300, 256, 0, 0.0, torch.float32),
    "hd128 bf16 window 200": (8, 2, 700, 128, 200, 0.0, torch.bfloat16),
    "hd160 bf16 window 70": (8, 2, 333, 160, 70, 0.0, torch.bfloat16),
    "hd256 bf16 G2": (4, 2, 200, 256, 0, 0.0, torch.bfloat16),
}


@pytest.mark.parametrize("label", list(FLASH_PREFILL_CASES))
def test_flash_prefill_kernel_matches_plain(dev, label):
    from repro_torch.kernels.flash_prefill import ops
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    bh, bkv, s, hd, window, cap, dtype = FLASH_PREFILL_CASES[label]
    gen = torch.Generator(device=dev).manual_seed(s + hd)
    q, k, v = (torch.randn((n, s, hd), generator=gen, device=dev).to(dtype)
               for n in (bh, bkv, bkv))
    kw = dict(scale=1.0 / math.sqrt(hd), window=window, softcap=cap)
    before = ops.LAUNCHES
    out = ops.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    # bf16 too: both sides read the same bf16 values and compute in f32
    torch.testing.assert_close(
        out, flash_prefill_ref(q, k, v, q_chunk=128, **kw), rtol=0,
        atol=1e-5)


def test_flash_prefill_wrapper_raises_on_unsupported_cuda_inputs(dev):
    from repro_torch.kernels.flash_prefill import ops
    x = torch.zeros((4, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_prefill(x, x[:2], x[:2], scale=0.1)
    x = torch.zeros((4, 8, 64), device=dev)
    with pytest.raises(TypeError):
        ops.flash_prefill(x, x[:2].half(), x[:2].half(), scale=0.1)
    with pytest.raises(ValueError, match="multiple of BKV"):
        ops.flash_prefill(x, x[:3], x[:3], scale=0.1)


# The cluster split of paged_attention.cu and paged_quest.cu (C ranks a
# (request, head)):
# 32K contexts (several tiles a rank), selected ties across ranks
# (sparsity 2), requests shorter than one rank's range (idle ranks),
# pooled selection (GS 1).  name -> (lengths, nb, paged_case keywords)
CLUSTER_CASES = {
    "32K": ([32768, 9000, 20000], 2048, {}),
    "ties-across-ranks": ([600, 1500, 333], 200,
                          dict(ties=True, sparsity=2.0)),
    "idle-ranks": ([5, 3000, 17], 264, {}),
    "pooled": ([1024, 3000, 2048, 4096], 264, dict(pooled=True)),
}


def _paged_lengths(case):
    """(lengths, nb, keywords) of a paged SOCKET / hard-LSH case."""
    if case in CLUSTER_CASES:
        return CLUSTER_CASES[case]
    if case == "ragged":
        return [1024, 3000, 2048, 4096], 264, {}
    if case == "edges":         # length 1, budget above the valid rows
        return [1, 5, 300, 257], 40, {}
    return [700, 1500], 100, dict(ties=True)


@pytest.mark.parametrize("case", ["ragged", "edges", "ties",
                                  *CLUSTER_CASES])
def test_paged_attention_kernel_matches_plain(dev, case):
    from repro_torch.kernels.paged_attention import cases, ops
    lengths, nb, extra = _paged_lengths(case)
    gen = torch.Generator(device=dev).manual_seed(len(lengths) + nb)
    (args,), kw = cases.paged_case(gen, lengths, nb=nb, kvh=2, hd=64,
                                   sink=16, window=16, **extra)
    q, kp, vp, bits, vnorm, u, bt, length, budget = args
    before = ops.LAUNCHES
    out, sel = ops.paged_socket_attend(q, kp, vp, bits, vnorm, u, bt,
                                       length=length, budget=budget,
                                       with_selection=True, **kw)
    assert ops.LAUNCHES == before + 1
    torch.cuda.synchronize()
    cases.check_paged(out, sel, args, kw, ties=extra.get("ties", False),
                      attn_tol=ATTN_TOL, score_tol=SCORE_TOL)
    c = ops.paged_attention_plan(q, kp, bits, u, bt)["cluster"]
    if case == "ties-across-ranks":
        eff = cases.plain_eff(args, kw).cpu()
        assert cases.tie_ranks(eff, sel.reshape(eff.shape).cpu(),
                               length.cpu(), budget.cpu(), bs=16, c=c) >= 2
    if case == "idle-ranks":
        assert c > 1 and cases.cta_ranges(5, 16, c)[-1] == (5, 5)


@pytest.mark.parametrize("case", ["ragged", "edges", "ties",
                                  "unaligned-tables", *CLUSTER_CASES])
def test_paged_hard_lsh_kernel_matches_plain(dev, case):
    from repro_torch.kernels.paged_attention import cases, ops
    kw = dict(kvh=2, hd=64, sink=16, window=16)
    if case == "unaligned-tables":
        lengths, nb, kw = [300, 31], 24, dict(kw, l=37)
    else:
        lengths, nb, extra = _paged_lengths(case)
        kw = dict(kw, **extra)
    gen = torch.Generator(device=dev).manual_seed(len(lengths) + nb)
    (args,), akw = cases.hard_lsh_case(gen, lengths, nb=nb, **kw)
    q, kp, vp, bits, vnorm, u_signs, bt, length, budget = args
    before = ops.HARD_LSH_LAUNCHES
    out, sel = ops.paged_hard_lsh_attend(q, kp, vp, bits, vnorm, u_signs,
                                         bt, length=length, budget=budget,
                                         with_selection=True, **akw)
    assert ops.HARD_LSH_LAUNCHES == before + 1
    torch.cuda.synchronize()
    cases.check_hard_lsh(out, sel, args, akw, attn_tol=ATTN_TOL)


@pytest.mark.parametrize("case", ["ragged", "edges", "ties", "ppb2",
                                  *list(CLUSTER_CASES)[:3]])
def test_paged_quest_kernel_matches_plain(dev, case):
    from repro_torch.kernels.paged_attention import cases, ops
    kw = dict(kvh=2, hd=64, sink=16, window=16)
    if case in CLUSTER_CASES:
        lengths, nb, extra = CLUSTER_CASES[case]
        kw = dict(kw, **extra)
        if case == "ties-across-ranks":   # 520 pages: C >= 2; a request
            lengths, nb = [600, 1500, 5800, 333], 520  # past the budget
    elif case == "ragged":
        lengths, nb = [1024, 3000, 2048, 4096], 264
    elif case == "edges":       # length 1, page budget above the live pages
        lengths, nb = [1, 5, 300, 257], 40
    elif case == "ties":
        lengths, nb, kw = [700, 1500], 100, dict(kw, ties=True)
    else:                       # two 8-token pages a 16-token block
        lengths, nb, kw = [333, 1000], 80, dict(kw, ps=8)
    gen = torch.Generator(device=dev).manual_seed(len(lengths) + nb)
    (args,), akw = cases.quest_case(gen, lengths, nb=nb, **kw)
    before = ops.QUEST_LAUNCHES
    out, sel = ops.paged_quest_attend(*args[:6], length=args[6],
                                      page_budget=args[7],
                                      with_selection=True, **akw)
    assert ops.QUEST_LAUNCHES == before + 1
    torch.cuda.synchronize()
    cases.check_quest(out, sel, args, akw, attn_tol=ATTN_TOL)
    c = ops.paged_quest_plan(args[0], args[1], args[5],
                             page_size=akw["page_size"])["cluster"]
    if case == "ragged":
        assert c > 1
    if case == "ties-across-ranks":
        ps, length = akw["page_size"], args[6].cpu()
        eff = cases.quest_page_eff(args, akw).cpu()
        pages = cases.quest_page_selection(sel.cpu(), ps)
        assert cases.tie_ranks(eff, pages, (length + ps - 1) // ps,
                               args[7].cpu(), bs=16 // ps, c=c) >= 2
        assert cases.ties_cut(eff, pages)
    if case == "idle-ranks":
        assert c > 1 and cases.cta_ranges(5, 16, c)[-1] == (5, 5)


@pytest.mark.parametrize("label", [c[0] for c in RING_CASES])
def test_paged_ring_kernel_matches_plain(dev, label):
    from repro_torch.kernels.paged_attention import cases, ops
    kw = dict(cases.RING_CASES)[label]
    gen = torch.Generator(device=dev).manual_seed(len(label))
    (case,), akw = cases.ring_case(gen, **kw)
    before = ops.RING_LAUNCHES
    out = ops.paged_ring_attend(*case[:4], pos=case[4], **akw)
    assert ops.RING_LAUNCHES == before + 1
    torch.cuda.synchronize()
    cases.check_ring(out, case, akw, attn_tol=ATTN_TOL)


@pytest.mark.parametrize("label", [c[0] for c in RING_CASES])
def test_paged_ring_plan_exercises_its_case(dev, label):
    """The launch plan of each ring case (``ops.paged_ring_plan``) is the
    fold's geometry and exercises what the label names: C >= 2 at B 1
    and B 2, empty ranks at pos < C, a window from inside a page, padded
    rows at hd 80."""
    from repro_torch.kernels.paged_attention import cases, ops
    kw = dict(cases.RING_CASES)[label]
    gen = torch.Generator(device=dev).manual_seed(len(label))
    (case,), akw = cases.ring_case(gen, **kw)
    plan = ops.paged_ring_plan(case[0], case[1], case[3],
                               window=akw["window"])
    cases.ring_plan_note(plan, case, akw, label)


def test_paged_ring_check_catches_wrong_position_or_window(dev):
    from repro_torch.kernels.paged_attention import cases, ops
    gen = torch.Generator(device=dev).manual_seed(3)
    (case,), akw = cases.ring_case(gen, [40, 700, 2000, 3001], window=1000)
    q, kp, vp, bt, pos = case
    for wrong in (dict(akw, window=990), dict(akw, pos=pos + 1)):
        bad = ops.paged_ring_attend(q, kp, vp, bt, **dict(dict(pos=pos),
                                                          **wrong))
        torch.cuda.synchronize()
        with pytest.raises(AssertionError, match="paged_ring"):
            cases.check_ring(bad, case, akw, attn_tol=ATTN_TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["socket", "hard_lsh", "quest", "ring"])
def test_paged_kernels_on_stored_pools_match_plain(dev, kind, kv_dtype):
    from repro_torch.kernels.paged_attention import cases, ops
    gen = torch.Generator(device=dev).manual_seed(len(kind + kv_dtype))
    common = dict(kvh=2, hd=64, sink=16, window=16)
    if kind == "ring":
        sets, akw = cases.ring_case(gen, [40, 700, 2000, 3001], window=1000)
        (case,), scales = cases.store_kv(sets, kv_dtype)
        before = ops.RING_LAUNCHES
        out = ops.paged_ring_attend(*case[:4], pos=case[4], **akw, **scales)
        assert ops.RING_LAUNCHES == before + 1
        torch.cuda.synchronize()
        cases.check_ring(out, case, akw, attn_tol=ATTN_TOL, scales=scales)
        return
    if kind == "quest":
        sets, akw = cases.quest_case(gen, [1024, 3000, 2048, 5], nb=264,
                                     **common)
        (case,), scales = cases.store_kv(sets, kv_dtype, quest=True)
        before = ops.QUEST_LAUNCHES
        out, sel = ops.paged_quest_attend(*case[:6], length=case[6],
                                          page_budget=case[7],
                                          with_selection=True, **akw,
                                          **scales)
        assert ops.QUEST_LAUNCHES == before + 1
        torch.cuda.synchronize()
        cases.check_quest(out, sel, case, akw, attn_tol=ATTN_TOL,
                          scales=scales)
        return
    build = cases.paged_case if kind == "socket" else cases.hard_lsh_case
    fn = (ops.paged_socket_attend if kind == "socket"
          else ops.paged_hard_lsh_attend)
    sets, akw = build(gen, [1024, 3000, 2048, 5], nb=264, **common)
    _, sel32 = fn(*sets[0][:7], length=sets[0][7], budget=sets[0][8],
                  with_selection=True, **akw)
    (case,), scales = cases.store_kv(sets, kv_dtype)
    out, sel = fn(*case[:7], length=case[7], budget=case[8],
                  with_selection=True, **akw, **scales)
    torch.cuda.synchronize()
    assert torch.equal(sel, sel32)
    if kind == "socket":
        cases.check_paged(out, sel, case, akw, ties=False, attn_tol=ATTN_TOL,
                          score_tol=SCORE_TOL, scales=scales)
    else:
        cases.check_hard_lsh(out, sel, case, akw, attn_tol=ATTN_TOL,
                             scales=scales)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", list(CLUSTER_CASES))
@pytest.mark.parametrize("kind", ["socket", "hard_lsh"])
def test_paged_cluster_cases_on_stored_pools_match_plain(dev, kind, case,
                                                         kv_dtype):
    """The cluster split's cases on pools stored as bf16, int8 or fp8:
    held to the plain version on the same stored pages, the selection
    equal to the kernel's own on the f32 pages."""
    from repro_torch.kernels.paged_attention import cases, ops
    lengths, nb, extra = CLUSTER_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(kind + case))
    build = cases.paged_case if kind == "socket" else cases.hard_lsh_case
    fn = (ops.paged_socket_attend if kind == "socket"
          else ops.paged_hard_lsh_attend)
    sets, akw = build(gen, lengths, nb=nb, kvh=2, hd=64, sink=16, window=16,
                      **extra)
    _, sel32 = fn(*sets[0][:7], length=sets[0][7], budget=sets[0][8],
                  with_selection=True, **akw)
    (stored,), scales = cases.store_kv(sets, kv_dtype)
    out, sel = fn(*stored[:7], length=stored[7], budget=stored[8],
                  with_selection=True, **akw, **scales)
    torch.cuda.synchronize()
    assert torch.equal(sel, sel32)
    if kind == "socket":
        cases.check_paged(out, sel, stored, akw,
                          ties=extra.get("ties", False), attn_tol=ATTN_TOL,
                          score_tol=SCORE_TOL, scales=scales)
    else:
        cases.check_hard_lsh(out, sel, stored, akw, attn_tol=ATTN_TOL,
                             scales=scales)


def _engine_on_card_matches_cpu(dev, backend, arch="llama31-8b",
                                ring_kernel=False, kv_dtype="auto",
                                legacy=False):
    """Greedy tokens of the continuous engine at smoke size with
    ``backend`` on K/V pages stored as ``kv_dtype`` (``legacy``:
    whole-prompt bucketed prefill): on the card (through its fused
    kernels) equal to the CPU run (through the kernels' plain versions).
    Returns the launches of the SOCKET, hard-LSH, Quest and ring
    kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch.serve import apply_backend_arg
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg = apply_backend_arg(get_config(arch).smoke(), backend).replace(
        use_ring_kernel=ring_kernel)
    cfg = cfg.replace(serving=cfg.serving.replace(kv_dtype=kv_dtype))
    if legacy:
        cfg = cfg.replace(serving=cfg.serving.replace(prefill_chunk=0))
    params = tfm.init_model(cfg, seed=0)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (8, 21, 37)]

    def serve(device, p):
        eng = ContinuousBatchingEngine(cfg, params=p, device=device)
        reqs = [Request(prompt=pr, max_new_tokens=6) for pr in prompts]
        eng.run(reqs, realtime=False)
        return [r.generated for r in reqs]

    cpu = serve("cpu", params)
    card_params = _to(params, dev)
    counters = ("LAUNCHES", "HARD_LSH_LAUNCHES", "QUEST_LAUNCHES",
                "RING_LAUNCHES")
    before = [getattr(ops, c) for c in counters]
    assert serve(dev, card_params) == cpu
    return [getattr(ops, c) - b for c, b in zip(counters, before)]


def test_continuous_engine_fused_kernel_matches_cpu(dev):
    socket, hard, quest, ring = _engine_on_card_matches_cpu(dev,
                                                            "socket_fused")
    assert socket > 0 and hard == quest == ring == 0


@pytest.mark.parametrize("backend", ["hard_lsh_fused", "quest_fused"])
def test_continuous_engine_baseline_kernels_match_cpu(dev, backend):
    socket, hard, quest, ring = _engine_on_card_matches_cpu(dev, backend)
    assert socket == ring == 0
    assert (hard > 0, quest > 0) == (backend == "hard_lsh_fused",
                                     backend == "quest_fused")


def test_continuous_engine_ring_kernel_matches_cpu(dev):
    """gemma3 smoke (11 local, 2 global layers): the ring kernel on every
    local layer, the paged SOCKET kernel on the global ones."""
    socket, hard, quest, ring = _engine_on_card_matches_cpu(
        dev, "socket_fused", arch="gemma3-27b", ring_kernel=True)
    assert 2 * ring == 11 * socket > 0 and hard == quest == 0


@pytest.mark.parametrize("backend,kv_dtype", [
    ("socket_fused", "int8"), ("socket_fused", "fp8"),
    ("hard_lsh_fused", "fp8"), ("quest_fused", "int8")])
def test_continuous_engine_quantized_kernels_match_cpu(dev, backend,
                                                       kv_dtype):
    counts = dict(zip(("socket_fused", "hard_lsh_fused", "quest_fused",
                       "ring"),
                      _engine_on_card_matches_cpu(dev, backend,
                                                  kv_dtype=kv_dtype)))
    assert counts.pop(backend) > 0 and not any(counts.values())


@pytest.mark.parametrize("arch", ["llama31-8b", "gemma3-27b"])
def test_continuous_engine_legacy_prefill_matches_cpu(dev, arch):
    """The legacy whole-prompt bucketed prefill: flash_prefill on every
    layer of every prefill, then the fused decode kernels, equal to the
    CPU run."""
    from repro_torch.kernels.flash_prefill import ops as fp
    before = fp.LAUNCHES
    socket, hard, quest, ring = _engine_on_card_matches_cpu(
        dev, "socket_fused", arch=arch, ring_kernel=True, legacy=True)
    assert socket > 0 and hard == quest == 0 and fp.LAUNCHES > before


def test_continuous_engine_ring_kernel_fp8_matches_cpu(dev):
    """gemma3 smoke on fp8 pages: the ring kernel and the paged SOCKET
    kernel, both in their fp8 mode."""
    socket, hard, quest, ring = _engine_on_card_matches_cpu(
        dev, "socket_fused", arch="gemma3-27b", ring_kernel=True,
        kv_dtype="fp8")
    assert 2 * ring == 11 * socket > 0 and hard == quest == 0
