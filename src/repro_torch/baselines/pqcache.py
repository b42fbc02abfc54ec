"""PQCache-lite: product-quantization scorer [55].

Port of ``repro.baselines.pqcache``.  Keys are split into ``m``
sub-vectors; each sub-space is clustered by Lloyd's k-means into
``2**nbits`` centroids over the prefix keys (every leading axis flattened
into one set), and a key stores its ``m`` code indices.  A query scores
keys by asymmetric distance computation (ADC): per-subspace inner
products with the codebooks, gathered by each key's codes.

The build is *data-dependent* (k-means over the prefix), the TTFT cost
that the paper's fig. 3a sets against SOCKET's random projections.  The
initial centroids are drawn by :func:`_init_indices` (one draw a
sub-space, from an explicit ``torch.Generator``); :func:`_quantize` runs
the iterations from given indices, so a test can hand it the JAX
package's draw.  A cluster left empty keeps its old centroid.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PQConfig", "build", "score"]


@dataclasses.dataclass(frozen=True)
class PQConfig:
    num_subspaces: int = 16     # m
    nbits: int = 4              # 2**4 = 16 centroids per subspace
    kmeans_iters: int = 8
    sparsity: float = 10.0

    @property
    def num_centroids(self) -> int:
        return 1 << self.nbits

    @property
    def bits_per_token(self) -> int:
        return self.num_subspaces * self.nbits


@dataclasses.dataclass
class PQState:
    codebooks: torch.Tensor  # (m, C, dsub)
    codes: torch.Tensor      # (..., N, m) int32


def _init_indices(gen: torch.Generator, n: int, c: int,
                  m: int) -> torch.Tensor:
    """Each sub-space's ``c`` initial centroids as point indices ``(m,
    c)``: distinct points (with replacement only when ``n < c``)."""
    if n < c:
        return torch.randint(0, n, (m, c), generator=gen, device=gen.device)
    return torch.stack([torch.randperm(n, generator=gen,
                                       device=gen.device)[:c]
                        for _ in range(m)])


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """``sum((x - c)^2)`` of points ``(m, N, dsub)`` to centroids ``(m,
    C, dsub)``: ``(m, N, C)``."""
    return torch.sum((x[:, :, None] - cent[:, None]) ** 2, dim=-1)


def _subspaces(keys2d: torch.Tensor, m: int) -> torch.Tensor:
    """Keys ``(N, d)`` as ``m`` sub-spaces of points ``(m, N, d / m)``."""
    n, d = keys2d.shape
    return keys2d.reshape(n, m, d // m).transpose(0, 1)


def _lloyd_step(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration on every sub-space at once: points ``(m, N,
    dsub)``, centroids ``(m, C, dsub)`` -> the clusters' means (an empty
    cluster keeps its centroid)."""
    assign = torch.argmin(_sq_dists(x, cent), dim=-1)          # (m, N)
    one_hot = torch.nn.functional.one_hot(assign, cent.shape[1]).to(x.dtype)
    size = one_hot.sum(1)                                      # (m, C)
    new = (one_hot.transpose(1, 2) @ x) / torch.clamp(size, min=1.0)[..., None]
    return torch.where((size > 0)[..., None], new, cent)


def _kmeans(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd's algorithm on points ``(m, N, dsub)`` from the centroids
    ``x[s, idx[s]]`` -> ``(m, C, dsub)``."""
    cent = torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    for _ in range(iters):
        cent = _lloyd_step(x, cent)
    return cent


def _encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Each point's nearest centroid a sub-space: int32 codes ``(N,
    m)``."""
    return torch.argmin(_sq_dists(x, codebooks), dim=-1).T.to(torch.int32)


def _quantize(keys2d: torch.Tensor, idx: torch.Tensor, m: int,
              iters: int):
    """Codebooks ``(m, C, dsub)`` and codes ``(N, m)`` int32 of keys
    ``(N, d)`` from the initial indices ``idx`` ``(m, C)``."""
    sub = _subspaces(keys2d, m)
    codebooks = _kmeans(sub, idx.to(keys2d.device), iters)
    return codebooks, _encode(sub, codebooks)


def build(cfg: PQConfig, rng: torch.Generator, keys: torch.Tensor,
          values: torch.Tensor) -> PQState:
    del values
    *lead, n, d = keys.shape
    if d % cfg.num_subspaces:
        raise ValueError(f"d={d} not divisible by m={cfg.num_subspaces}")
    keys2d = keys.reshape(-1, d).float()
    idx = _init_indices(rng, keys2d.shape[0], cfg.num_centroids,
                        cfg.num_subspaces)
    codebooks, codes = _quantize(keys2d, idx, cfg.num_subspaces,
                                 cfg.kmeans_iters)
    return PQState(codebooks=codebooks,
                   codes=codes.reshape(*lead, n, cfg.num_subspaces))


def score(state: PQState, cfg: PQConfig, q: torch.Tensor) -> torch.Tensor:
    """ADC inner-product estimate ``(..., N)`` for query ``(..., d)``."""
    m, c, dsub = state.codebooks.shape
    qs = q.reshape(*q.shape[:-1], m, dsub).float()
    lut = torch.einsum("...md,mcd->...mc", qs, state.codebooks.float())
    n = state.codes.shape[-2]
    lead = torch.broadcast_shapes(lut.shape[:-2], state.codes.shape[:-2])
    lut = lut[..., None, :, :].expand(*lead, n, m, c)
    codes = state.codes.expand(*lead, n, m)[..., None].long()
    return torch.gather(lut, -1, codes)[..., 0].sum(-1)
