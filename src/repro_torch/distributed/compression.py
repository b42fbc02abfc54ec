"""Int8 error-feedback gradient compression for a slow data-parallel axis.

Port of ``repro.distributed.compression``.  The multi-pod mesh's ``pod``
axis crosses a link an order of magnitude slower than the links inside a
pod; int8 payloads cut the bytes a gradient all-reduce moves over it,
and error feedback (Seide et al. 2014) carries each rank's rounding
error into its next round:

    e_t      : persistent per-leaf error buffer (same shape as the grad)
    compress : q = quantize(g + e);  e' = (g + e) - dequantize(q)
    sync     : sum over the ranks of q * scale
    result   : that sum / ranks

:func:`compressed_psum` runs on one rank over a process group (JAX's
runs inside ``shard_map`` over a named axis); :func:`compressed_psum_ref`
is its plain single-process version, a loop over the ranks' gradients,
which the tests and ``chip_smoke.py`` hold it to.  As in the JAX
package, nothing on the Trainer's path calls either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives

__all__ = ["compress_leaf", "decompress_leaf", "init_error_buffers",
           "compressed_psum", "compressed_psum_ref"]


def compress_leaf(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-tensor absmax int8 quantization (one scale a leaf: per-block
    scales would double the scale traffic)."""
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0
    scale_safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xf / scale_safe), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def decompress_leaf(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    return c["q"].to(torch.float32) * c["scale"]


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


def init_error_buffers(grads: Any) -> Any:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def _compress(g: torch.Tensor, e: torch.Tensor):
    """(this rank's contribution ``q * scale``, its new error buffer, the
    payload)."""
    corrected = g.to(torch.float32) + e
    c = compress_leaf(corrected)
    new_e = corrected - decompress_leaf(c)
    return c["q"].to(torch.float32) * c["scale"], new_e, c


def compressed_psum(grads: Any, errors: Any, group) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce over ``group`` (``None``: this rank
    alone).  Returns (the ranks' mean of the dequantized payloads, float32;
    the new error buffers)."""
    n = 1 if group is None else dist.get_world_size(group)

    def leaf(g, e):
        contrib, new_e, _ = _compress(g, e)
        total = collectives.all_reduce(contrib, dist.ReduceOp.SUM, group)
        return total / n, new_e

    return _split_pairs(_map(leaf, grads, errors))


def _split_pairs(tree):
    """A tree of (a, b) leaves as the trees of its a's and its b's."""
    if isinstance(tree, dict):
        parts = {k: _split_pairs(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    if isinstance(tree, list):
        parts = [_split_pairs(v) for v in tree]
        return [p[0] for p in parts], [p[1] for p in parts]
    return tree


def compressed_psum_ref(grads: Sequence[Any], errors: Sequence[Any]
                        ) -> Tuple[Any, List[Any], List[Any]]:
    """:func:`compressed_psum` in one process: ``grads[r]`` and
    ``errors[r]`` are rank ``r``'s trees.  Returns (the mean every rank
    receives, each rank's new error buffers, each rank's payloads
    ``{"q", "scale"}``); the contributions are summed in rank order."""
    n = len(grads)
    per_rank = [_map(_compress, g, e) for g, e in zip(grads, errors)]

    def total(*parts):
        acc = parts[0][0].clone()
        for p in parts[1:]:
            acc = acc + p[0]
        return acc / n

    mean = _map(total, *per_rank)
    new_errors = [_map(lambda p: p[1], t) for t in per_rank]
    payloads = [_map(lambda p: p[2], t) for t in per_rank]
    return mean, new_errors, payloads
