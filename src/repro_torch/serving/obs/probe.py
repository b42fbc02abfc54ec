"""Engine-side sampler for the sparse-selection quality probe.

A copy of ``repro.serving.obs.probe`` (numpy only).  Every ``every``
decode iterations the engine re-runs the current decode batch through a
shadow step (see :meth:`~repro_torch.serving.engine
.ContinuousBatchingEngine._run_probe`) whose sparse layers record
:func:`repro_torch.models.backends.probe.selection_stats`, then hands
the drained per-layer, per-slot stats here.  This class reduces them
over the *active* slots (padded slots carry garbage) into one row per
probed layer, accumulates the rows for the bench JSON, and keeps a
running summary.

Cost model: one probe step ≈ one decode step through the plain route
plus a dense ``(B, KVH, N)`` attention-mass reference per probed layer
(the thing SOCKET exists to avoid — this is why the probe is sampled,
not always-on).  ``every=0`` disables the probe.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["SelectionProbe"]

# stats reduced by mean over active slots -> row field name
_MEANS = (("recall", "recall"),
          ("budget_utilization", "budget_utilization"),
          ("forced_share", "forced_share"),
          ("selected", "selected_mean"),
          ("budget", "budget_mean"))


class SelectionProbe:
    """Sampling policy + reduction + accumulation for probe stats."""

    def __init__(self, every: int = 0):
        self.every = int(every)
        self.rows: List[Dict] = []          # one dict per (iteration, layer)

    def due(self, iteration: int) -> bool:
        return self.every > 0 and iteration % self.every == 0

    def add(self, iteration: int, layer_stats: Sequence[Dict],
            slots: Sequence[int]) -> List[Dict]:
        """Reduce one shadow step's drained stats (one dict of ``(B,)``
        arrays per probed layer, execution order) over the active
        ``slots``; returns the new rows (also retained on ``rows``)."""
        sel = np.asarray(list(slots), np.int32)
        new: List[Dict] = []
        for layer, st in enumerate(layer_stats):
            row = {"iter": iteration, "layer": layer,
                   "requests": int(sel.size),
                   "static_k": int(np.asarray(st["static_k"]))}
            for key, name in _MEANS:
                vals = np.asarray(st[key], np.float64)[sel]
                row[name] = round(float(np.mean(vals)), 6) if sel.size \
                    else None
            new.append(row)
        self.rows.extend(new)
        return new

    def summary(self) -> Dict:
        """Row-count + per-field means over everything sampled so far
        (strict-JSON-safe; None when nothing was sampled)."""
        out: Dict = {"probe_steps": len({r["iter"] for r in self.rows}),
                     "rows": len(self.rows)}
        for _, name in _MEANS:
            vals = [r[name] for r in self.rows if r[name] is not None]
            out[name] = round(float(np.mean(vals)), 6) if vals else None
        return out
