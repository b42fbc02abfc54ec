"""Sparse-attention baselines the paper compares SOCKET against
(Section 6), ports of ``repro.baselines``.

Every baseline exposes the JAX package's scorer interface, with a
``torch.Generator`` where JAX takes a key:

    build(cfg, rng, keys, values)  -> state  (prefill-time index)
    score(state, [cfg,] q)         -> (..., N) float32 scores

* :mod:`.hard_lsh`   — hard LSH collision counting (Tables 2, 3, 7);
  the engine's decode backend is ``models/backends/hard_lsh.py``.
* :mod:`.quest`      — Quest page-level min/max bounds [43]; the
  ``quest`` decode backend's selection.
* :mod:`.oracle`     — exact q.k scores and dense attention (the
  ``dense`` decode backend's).
* :mod:`.hash_attn`  — HashAttention-style Hamming scorer [13] (random
  signed projections in place of learned ones).
* :mod:`.magicpig`   — MagicPig-style LSH importance sampling [8].
* :mod:`.pqcache`    — PQCache-lite product quantization [55] (k-means
  codebooks: the build-time gap of fig. 3a).
"""

from repro_torch.baselines import (hard_lsh, hash_attn, magicpig, oracle,
                                   pqcache, quest)

__all__ = ["hard_lsh", "hash_attn", "magicpig", "oracle", "pqcache", "quest"]
