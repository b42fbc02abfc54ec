"""The context-parallel routes of the ``hard_lsh``, ``quest`` and
``dense`` backends, in one process, with no ranks.

* The global selection put together from the blocks of 2, 3 and 4 ranks
  (each block's values at its global positions, the blocks concatenated
  in rank order as ``Frame.gather`` does) equals ``value_aware_topk`` and
  Quest's ``select_tokens`` on the whole cache bit for bit: with a
  budget, a ragged length, ties (hard collision counts are small
  integers) and a block with no valid row.
* ``flash_decode``'s softmax partials (its plain version here) over each
  block's share of a selection, merged by ``merge_partials_ref``, equal
  ``flash_decode`` over the whole selection within ``ATTN_TOL``; the
  output with the partials is the output without them.
* ``rmw_token`` on a rank's block writes only the rows it owns, at their
  local rows, as the whole cache's ``rmw_token`` writes them.
* Quest under a context-parallel mesh refuses a capacity whose rank rows
  are not whole pages, naming both numbers.
"""

import dataclasses

import pytest
import torch

from repro_torch.baselines import quest as qm
from repro_torch.core import socket as sk
from repro_torch.distributed import context_parallel as cp

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
B, KVH, G, HD = 2, 3, 4, 16
SHARDS = (2, 3, 4)

SCFG = sk.SocketConfig(num_planes=6, num_tables=12, tau=0.4, sparsity=4.0,
                       sink_tokens=4, window_tokens=4, min_k=8)
QCFG = qm.QuestConfig(page_size=4, sparsity=4.0, sink_tokens=4,
                      window_tokens=4, min_pages=2)

# (label, length, budget): the whole cache; a ragged batch under a
# per-request budget; a length that leaves the last block of every split
# without a valid row (and the last but one of the 4-way split too)
N = 48
CASES = [("whole", N, None),
         ("ragged, budget", torch.tensor([N - 5, 29]), "dynamic"),
         ("empty block", 22, None)]


def _blocks(n, shards):
    n_l = n // shards
    return [slice(i * n_l, (i + 1) * n_l) for i in range(shards)]


def _budget(length, k):
    if isinstance(length, torch.Tensor):
        return sk.dynamic_topk_budget(SCFG, length, k)
    return None


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("label,length,budget", CASES,
                         ids=[c[0] for c in CASES])
def test_hard_lsh_selection_from_blocks_is_global(shards, label, length,
                                                  budget):
    gen = torch.Generator().manual_seed(shards)
    # collision counts summed over the group: small integers, many ties
    scores = torch.randint(0, 3 * G, (B, KVH, N), generator=gen).float()
    vnorm = torch.randint(1, 4, (B, KVH, N), generator=gen).to(
        torch.bfloat16)
    k = sk.topk_budget(SCFG, N)
    bud = _budget(length, k) if budget else None
    want = sk.value_aware_topk(SCFG, scores, vnorm, k=k, length=length,
                               n_total=N, budget=bud)
    whole = sk.value_aware_scores(SCFG, scores, vnorm, length=length)
    eff = torch.cat([sk.value_aware_scores(SCFG, scores[..., s], vnorm[..., s],
                                           length=length, lo=s.start)
                     for s in _blocks(N, shards)], dim=-1)
    assert torch.equal(eff, whole)
    got = sk.top_of_scores(eff, k=k, budget=bud)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if label == "empty block":
        assert not bool((eff[..., _blocks(N, shards)[-1]] > -1e29).any())


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("label,length,budget", CASES,
                         ids=[c[0] for c in CASES])
def test_quest_selection_from_blocks_is_global(shards, label, length,
                                               budget):
    del budget
    gen = torch.Generator().manual_seed(10 + shards)
    keys = torch.randn((B, KVH, N, HD), generator=gen)
    # two pages with equal bounds: a tie the stable sort must break alike
    keys[:, :, 12:16] = keys[:, :, 20:24]
    q = torch.randn((B, KVH, G, 1, HD), generator=gen)
    state = qm.build(QCFG, None, keys, None)
    want = qm.select_tokens(QCFG, state, q, length=length, n=N)
    ps = QCFG.page_size
    eff = torch.cat([qm.group_page_scores(
        QCFG, qm.QuestState(kmin=state.kmin[:, :, s.start // ps:s.stop // ps],
                            kmax=state.kmax[:, :, s.start // ps:s.stop // ps]),
        q, length, first_page=s.start // ps) for s in _blocks(N, shards)],
        dim=-1)
    # the float64 bounds round to the same f32 whatever the block shape
    assert torch.equal(eff, qm.group_page_scores(QCFG, state, q, length))
    got = qm.select_pages(QCFG, eff, k_pages=qm.page_budget(
        QCFG, eff.shape[-1], N), length=length, n=N)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shards", SHARDS)
def test_flash_decode_partials_merge_to_the_whole(shards):
    """Each block attends the selected rows it holds (the rest masked);
    the merged partials give the whole selection's output."""
    from repro_torch.kernels.flash_decode import ops as fd
    gen = torch.Generator().manual_seed(20 + shards)
    k_cache = torch.randn((B, KVH, N, HD), generator=gen)
    v_cache = torch.randn((B, KVH, N, HD), generator=gen)
    q = torch.randn((B, KVH, G, 1, HD), generator=gen)
    idx = torch.stack([torch.randperm(N, generator=gen)[:20]
                       for _ in range(B * KVH)]).reshape(B, KVH, 20)
    # no selected row in the last block for (0, 0): its partials merge
    # to nothing
    n_l = N // shards
    idx[0, 0] = torch.arange(20) % (N - n_l)
    sel = torch.rand((B, KVH, 20), generator=gen) < 0.8
    scale = HD ** -0.5
    rows = idx[..., None].expand(*idx.shape, HD)
    want = fd.flash_decode(q, torch.gather(k_cache, 2, rows),
                           torch.gather(v_cache, 2, rows), sel, scale=scale)
    parts = []
    for s in _blocks(N, shards):
        fr = dataclasses.replace(_FakeFrame(), lo=s.start, n_l=n_l)
        loc, own = fr.owned(idx, sel)
        lrows = loc[..., None].expand(*loc.shape, HD)
        o, m, l = fd.flash_decode(q, torch.gather(k_cache[:, :, s], 2, lrows),
                                  torch.gather(v_cache[:, :, s], 2, lrows),
                                  own, scale=scale, partials=True)
        out = fd.flash_decode(q, torch.gather(k_cache[:, :, s], 2, lrows),
                              torch.gather(v_cache[:, :, s], 2, lrows), own,
                              scale=scale)
        assert torch.equal(o, out)
        if s.start == N - n_l:
            assert bool((m[0, 0] == -1e30).all()) and \
                bool((l[0, 0] == 0).all())
        parts.append((m, l, o))
    torch.testing.assert_close(cp.merge_partials_ref(parts), want,
                               **ATTN_TOL)


@dataclasses.dataclass(frozen=True)
class _FakeFrame:
    """``Frame.owned`` alone, without a mesh."""

    lo: int = 0
    n_l: int = 0

    owned = cp.Frame.owned


def test_rmw_token_writes_only_owned_rows():
    """Scalar and ragged positions, with the batch split too; ``fn``
    reads whole-batch tensors, as Quest's ``append`` does."""
    from repro_torch.distributed.context_parallel import CacheShard
    from repro_torch.models.backends import ContiguousView, LeafSpec
    spec = {"kmin": LeafSpec(suffix=(2,), granularity=4)}
    new = torch.arange(1, 4 * 3 * 2 + 1, dtype=torch.float32).reshape(
        4, 3, 2) - 12
    first = torch.tensor([True, False, False, True])[:, None, None]

    def fn(old):
        return torch.where(first, new, torch.minimum(old, new))

    for pos in (21, torch.tensor([5, 22, 11, 2])):
        start = torch.randn(4, 3, 6, 2, generator=torch.Generator()
                            .manual_seed(0))
        whole = start.clone()
        ContiguousView({"kmin": whole}, spec).rmw_token("kmin", pos, fn)
        for si in range(2):
            for bi in range(2):
                a = {"kmin": start[2 * bi:2 * bi + 2, :,
                                   3 * si:3 * si + 3].clone()}
                ContiguousView(a, spec, CacheShard(2, si, 2, bi)).rmw_token(
                    "kmin", pos, fn)
                assert torch.equal(
                    a["kmin"], whole[2 * bi:2 * bi + 2, :, 3 * si:3 * si + 3])


def test_quest_page_size_must_divide_rank_rows():
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    cfg = get_config("llama31-8b").smoke().replace(
        attention_backend="quest", decode_cp_axes=("data",),
        decode_cp_batch_axes=())
    assert cfg.quest.page_size == 8
    with activate_mesh(Mesh(("data", "model"), (4, 1))):
        with pytest.raises(ValueError, match="page_size 8 does not divide "
                                             "a rank's 12 cache rows"):
            tfm.init_decode_caches(cfg, 1, 48)
        caches = tfm.init_decode_caches(cfg, 1, 64)
    assert caches[0]["kmin"].shape[2] == 2 and caches[0]["k"].shape[2] == 16
