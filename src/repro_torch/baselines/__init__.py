"""Sparse-attention baselines the paper compares SOCKET against.

The port carries Quest (:mod:`.quest`), the page-level baseline its
``quest`` decode backend runs; the others (hard-LSH's standalone scorer,
magicpig, pqcache, hash_attn, oracle) come with ROADMAP.md queue 1 item
11.
"""
