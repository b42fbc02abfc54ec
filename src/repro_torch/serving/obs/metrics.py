"""Streaming metrics registry: counters, gauges, log-bucket histograms.

A copy of ``repro.serving.obs.metrics`` (numpy only).  Pure host
Python, cheap enough to stay always-on in the serving hot loop: the
engine derives its end-of-run :class:`~repro_torch.serving.engine
.ServeMetrics` from the run's registry.

Histograms are **log-bucketed**: values land in geometric buckets
``growth^i``, so p50/p99 stream without retaining samples, with relative
error bounded by ``growth - 1`` (default 5%).  ``exact=True`` also keeps
the raw samples, so the engine's percentiles equal a direct
``np.percentile`` over the recorded series.

Exposition: :meth:`Registry.prometheus_text` (text format 0.0.4) and
:meth:`Registry.snapshot` (strict JSON — NaN never appears; see
:mod:`repro_torch.serving.obs.events`); both equal the JAX package's
string for string on the same series.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _labels_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


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

    def prometheus_buckets(self):
        """Cumulative ``(le, count)`` pairs for text exposition."""
        out = []
        cum = self.underflow
        if self.underflow:
            out.append((0.0, cum))
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            out.append((self.growth ** i, cum))
        out.append((math.inf, self.count))
        return out


class Registry:
    """Named instrument registry with labels.

    ``counter/gauge/histogram(name, **labels)`` create-or-return the
    instrument for that (name, labels) pair; all instruments under one
    name must share a kind.  One registry instance covers one engine run
    (the engine creates a fresh one per ``run()``), so snapshots are
    run-scoped like :class:`~repro_torch.serving.engine.ServeMetrics`."""

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

    # ---- exposition ------------------------------------------------------
    def snapshot(self) -> Dict:
        """Strict-JSON-safe nested dict of every instrument."""
        from repro_torch.serving.obs.events import sanitize
        out = {}
        for name, (kind, children) in sorted(self._families.items()):
            fam = {}
            for key, inst in sorted(children.items()):
                fam[_labels_str(key) or "_"] = inst.to_json()
            out[name] = {"kind": kind, "values": fam}
        return sanitize(out)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, (kind, children) in sorted(self._families.items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, inst in sorted(children.items()):
                ls = _labels_str(key)
                if kind in ("counter", "gauge"):
                    lines.append(f"{name}{ls} {_fmt(inst.value)}")
                    continue
                for le, cum in inst.prometheus_buckets():
                    le_s = "+Inf" if math.isinf(le) else _fmt(le)
                    blabels = dict(key)
                    blabels["le"] = le_s
                    lines.append(
                        f"{name}_bucket{_labels_str(_labels_key(blabels))}"
                        f" {cum}")
                lines.append(f"{name}_sum{ls} {_fmt(inst.total)}")
                lines.append(f"{name}_count{ls} {inst.count}")
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, float) and not math.isfinite(v):
        # prometheus text allows +Inf/-Inf/NaN spellings
        return "+Inf" if v == math.inf else ("-Inf" if v == -math.inf
                                             else "NaN")
    return repr(v) if isinstance(v, float) else str(v)
