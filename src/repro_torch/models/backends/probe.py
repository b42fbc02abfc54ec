"""Selection-quality probe capture for sparse decode backends.

The port's counterpart of ``repro.models.backends.probe``.  The serving
engine's sampled probe (see :mod:`repro_torch.serving.obs.probe`)
answers "is the kernel still selecting the right tokens under serving
pressure?" by re-running one decode step as a **shadow step** inside
:func:`capture`.  While the capture flag is up (a plain module flag read
at call time; the production step runs with it down and does no probe
work), the sparse backends' ``attend``:

* takes the plain selection route even where the fused paged kernel is
  on (the fused pass never materializes its selection).  For hard LSH
  and Quest the plain selection is the fused kernel's bit for bit; for
  SOCKET it is too, except for rows whose effective scores lie within
  float rounding of the top-k threshold, which the two may order
  differently (the kernel sums the same fp32 terms in another order);
* computes :func:`selection_stats` — budget utilization, selection
  recall against the exact dense attention-mass top-k, and the forced
  sink/window share — and :func:`emit` appends the small per-request
  tensors, one dict per attention layer, in call order (= layer order).

The engine drains them (:func:`drain`) after the shadow step: one move to the
host for the whole step, not one synchronization per layer.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from repro_torch.core import socket as sk

__all__ = ["capture", "capturing", "drain", "emit", "selection_stats"]

_CAPTURING = False
_SINK: List[Dict] = []


def capturing() -> bool:
    """True while a probe shadow step runs."""
    return _CAPTURING


@contextlib.contextmanager
def capture():
    """Raise the capture flag for the duration of a shadow step."""
    global _CAPTURING
    prev, _CAPTURING = _CAPTURING, True
    try:
        yield
    finally:
        _CAPTURING = prev


def emit(stats: Dict[str, torch.Tensor]) -> None:
    """Record one probed attention layer's ``stats`` (a dict of small
    device tensors); call order identifies the layer."""
    _SINK.append(stats)


def drain() -> List[Dict]:
    """Pop everything recorded since the last drain, in layer order, with
    each tensor moved to the host as a numpy array: one transfer for all
    layers' stats, not one synchronization per layer."""
    out, _SINK[:] = list(_SINK), []
    if not out:
        return out
    keys = [k for k, v in out[0].items() if isinstance(v, torch.Tensor)]
    host = torch.stack([torch.stack([st[k] for k in keys])
                        for st in out]).cpu().numpy()   # (layers, keys, B)
    return [dict(st, **dict(zip(keys, rows))) for st, rows in zip(out, host)]


def selection_stats(scfg, q: torch.Tensor, k_full: torch.Tensor,
                    vnorm: Optional[torch.Tensor], idx: torch.Tensor,
                    sel_mask: torch.Tensor, *, length,
                    budget: Optional[torch.Tensor], static_k: int,
                    scale: float) -> Dict[str, torch.Tensor]:
    """Per-request selection-quality stats for one layer's decode step.

    The dense reference is the exact attention mass each key would
    receive under full (non-sparse) attention: ``softmax(q·k)`` summed
    over the query group — its top-``m`` set (``m`` = the request's
    realized selection count) is what a perfect selector with the same
    budget would pick.  Recall is the fraction of that reference set the
    selection actually covered.  The top-``m`` set is a stable
    descending sort, so tied masses keep the lowest index first, as
    ``jax.lax.top_k`` does.

    Args:
      scfg:     a config carrying ``sink_tokens`` and ``window_tokens``
                (``SocketConfig`` or ``QuestConfig``).
      q:        ``(B, KVH, G, 1, hd)`` this step's queries.
      k_full:   ``(B, KVH, N, hd)`` the logical key view (probe-only
                materialization — the production path never does this).
      vnorm:    ``(B, KVH, N)`` value norms or None (kept for parity with
                the JAX package's signature; unused).
      idx:      ``(B, KVH, K)`` selected logical indices.
      sel_mask: ``(B, KVH, K)`` selection validity (budget applied).
      length:   int or ``(B,)`` live context lengths.
      budget:   per-request dynamic budgets ``(B,)`` or None (static).
      static_k: the static selection width K.
      scale:    attention logit scale.

    Returns a dict of ``(B,)`` float32 tensors: ``recall``,
    ``budget_utilization`` (selected / static K), ``forced_share``
    (fraction of selections that were force-included sink/window
    tokens), ``selected`` and ``budget`` (counts, KVH-averaged), and
    ``static_k`` as an int (known on the host: nothing to transfer).
    Inactive slots (length 0) report garbage the engine masks out.
    """
    del vnorm
    dev = k_full.device
    b, kvh, n = k_full.shape[0], k_full.shape[1], k_full.shape[2]
    pos = torch.arange(n, device=dev)
    length_b = torch.as_tensor(length, device=dev).long().expand(b)
    valid = pos[None] < length_b[:, None]                     # (B, N)

    # exact dense attention mass per key, summed over the query group
    logits = torch.einsum("bhgtd,bhnd->bhgtn", q.float(),
                          k_full.float()) * scale
    logits = torch.where(valid[:, None, None, None, :], logits, sk.NEG_INF)
    mass = torch.softmax(logits, dim=-1).sum(dim=(2, 3))      # (B,KVH,N)

    m = sel_mask.sum(dim=-1)                                  # (B, KVH)
    dense_idx = torch.sort(mass, dim=-1, descending=True,
                           stable=True)[1][..., :static_k]    # (B,KVH,K)
    bidx = torch.arange(b, device=dev)[:, None, None]
    hidx = torch.arange(kvh, device=dev)[None, :, None]
    dense_keep = (torch.arange(static_k, device=dev)[None, None, :]
                  < m[:, :, None]) & valid[bidx, dense_idx]

    def onehot(indices, keep):
        base = torch.zeros((b, kvh, n), dtype=torch.int32, device=dev)
        base.index_put_((bidx.expand_as(indices), hidx.expand_as(indices),
                         indices), keep.to(torch.int32), accumulate=True)
        return base > 0

    sel_set = onehot(idx, sel_mask)
    dense_set = onehot(dense_idx, dense_keep)
    inter = (sel_set & dense_set).sum(dim=-1)                 # (B, KVH)
    denom = dense_set.sum(dim=-1).clamp(min=1)
    recall = (inter / denom).mean(dim=1)                      # (B,)

    forced = (pos[None] < scfg.sink_tokens) | \
        (pos[None] >= (length_b[:, None] - scfg.window_tokens))
    forced_sel = forced[bidx, idx]                            # (B,KVH,K)
    n_forced = (sel_mask & forced_sel).sum(dim=-1)
    forced_share = (n_forced / m.clamp(min=1)).mean(dim=1)

    selected = m.float().mean(dim=1)                          # (B,)
    if budget is None:
        budget_b = torch.full((b,), float(static_k), device=dev)
    else:
        budget_b = torch.as_tensor(budget, device=dev).float().expand(b)
    return {
        "recall": recall.float(),
        "budget_utilization": selected / float(static_k),
        "forced_share": forced_share.float(),
        "selected": selected,
        "budget": budget_b,
        "static_k": int(static_k),
    }
