"""Serving observability: for now only the metrics registry the engine
and the scheduler read (:mod:`.metrics`)."""

from repro_torch.serving.obs.metrics import Counter, Gauge, Histogram, Registry

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]
