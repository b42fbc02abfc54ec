"""Streaming metrics registry: counters, gauges, log-bucket histograms.

A copy of the ``Counter``, ``Gauge``, ``Histogram`` and ``Registry``
classes of ``repro.serving.obs.metrics`` (numpy only), the part of the
observability layer that the continuous engine and the scheduler read:
the engine derives its end-of-run :class:`~repro_torch.serving.engine
.ServeMetrics` from the run's registry.  The exposition formats
(Prometheus text, strict-JSON snapshots) and the rest of ``obs`` come
with the observability slice (ROADMAP.md queue 1 item 9).

Histograms are **log-bucketed**: values land in geometric buckets
``growth^i``, so p50/p99 stream without retaining samples, with relative
error bounded by ``growth - 1`` (default 5%).  ``exact=True`` also keeps
the raw samples, so the engine's percentiles equal a direct
``np.percentile`` over the recorded series.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def to_json(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def to_json(self):
        return self.value


class Histogram:
    """Log-bucket streaming histogram (positive values).

    Bucket ``i`` covers ``(growth^(i-1), growth^i]``; zero and negative
    values land in a dedicated underflow bucket.  ``percentile`` walks
    the cumulative counts and answers with the bucket's geometric
    midpoint — relative error ≤ ``growth - 1`` — while count/sum/min/max
    are tracked exactly.  ``exact=True`` additionally retains the raw
    samples for :meth:`percentile_exact` / :meth:`mean_exact` (use only
    for run-bounded series)."""

    kind = "histogram"

    def __init__(self, growth: float = 1.05, exact: bool = False):
        assert growth > 1.0, growth
        self.growth = growth
        self._log_growth = math.log(growth)
        self.buckets: Dict[int, int] = {}   # bucket index -> count
        self.underflow = 0                  # values <= 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: Optional[List[float]] = [] if exact else None

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.underflow += 1
        else:
            i = math.ceil(math.log(v) / self._log_growth)
            self.buckets[i] = self.buckets.get(i, 0) + 1
        if self.samples is not None:
            self.samples.append(v)

    # ---- streaming estimates (no samples retained) -----------------------
    def percentile(self, q: float) -> float:
        """Nearest-rank percentile from the log buckets (NaN if empty)."""
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(q / 100.0 * self.count))
        if rank <= self.underflow:
            return min(self.vmin, 0.0)
        seen = self.underflow
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                # geometric midpoint of (growth^(i-1), growth^i],
                # clamped into the exactly-tracked value range
                mid = self.growth ** (i - 0.5)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    # ---- exact views (exact=True only) -----------------------------------
    def percentile_exact(self, q: float) -> float:
        assert self.samples is not None, "histogram not exact"
        return float(np.percentile(np.asarray(self.samples), q)) \
            if self.samples else float("nan")

    def mean_exact(self) -> float:
        assert self.samples is not None, "histogram not exact"
        return float(np.mean(self.samples)) if self.samples \
            else float("nan")

    def max_exact(self) -> float:
        assert self.samples is not None, "histogram not exact"
        return max(self.samples) if self.samples else float("nan")

    def to_json(self):
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "p50": self.percentile(50) if self.count else None,
            "p99": self.percentile(99) if self.count else None,
        }


class Registry:
    """Named instrument registry with labels.

    ``counter/gauge/histogram(name, **labels)`` create-or-return the
    instrument for that (name, labels) pair; all instruments under one
    name must share a kind.  One registry instance covers one engine run
    (the engine creates a fresh one per ``run()``), so it is run-scoped
    like :class:`~repro_torch.serving.engine.ServeMetrics`."""

    def __init__(self):
        # name -> (kind, {labels_key -> instrument})
        self._families: Dict[str, Tuple[str, Dict[LabelKey, object]]] = {}

    def _get(self, name: str, factory, labels: Dict[str, str]):
        key = _labels_key(labels)
        fam = self._families.get(name)
        if fam is None:
            inst = factory()
            self._families[name] = (inst.kind, {key: inst})
            return inst
        kind, children = fam
        inst = children.get(key)
        if inst is None:
            inst = factory()
            if inst.kind != kind:
                raise ValueError(
                    f"{name} is a {kind}, not a {inst.kind}")
            children[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def histogram(self, name: str, *, growth: float = 1.05,
                  exact: bool = False, **labels) -> Histogram:
        return self._get(
            name, lambda: Histogram(growth=growth, exact=exact), labels)

    def value(self, name: str) -> float:
        """Sum of a counter/gauge family across labels (0 if absent)."""
        fam = self._families.get(name)
        if fam is None:
            return 0
        return sum(inst.value for inst in fam[1].values())

    def get(self, name: str, **labels):
        """The existing instrument, or None."""
        fam = self._families.get(name)
        return None if fam is None else fam[1].get(_labels_key(labels))
