"""Serving observability: event tracing, metrics, probes, profiling.

The port's copy of ``repro.serving.obs``.  Four decoupled pieces:

* :mod:`~repro_torch.serving.obs.events` +
  :mod:`~repro_torch.serving.obs.tracing` — versioned, strictly-validated
  JSONL event trace of request lifecycles and per-iteration step records
  (the JAX package's schema and version);
* :mod:`~repro_torch.serving.obs.metrics` — streaming counters / gauges /
  log-bucket histograms with Prometheus text and strict-JSON snapshot
  exposition (always on: the engine derives its end-of-run
  ``ServeMetrics`` from this registry);
* :mod:`~repro_torch.serving.obs.probe` — sampled selection-quality probe
  (recall vs dense top-k, budget utilization, forced share);
* :mod:`~repro_torch.serving.obs.profiling` — ``torch.profiler`` capture
  around a window of engine steps.

:class:`Observability` bundles the opt-in pieces.  The engine takes
``obs=None`` by default and then holds **no tracer, no probe and no
profiler at all** — the disabled hot loop allocates zero tracing objects
per step (pinned by ``tests/test_torch_observability.py``).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.serving.obs.events import (EVENT_SCHEMA, SCHEMA_VERSION,
                                            sanitize, strict_dumps,
                                            strict_loads, validate_event,
                                            validate_jsonl)
from repro_torch.serving.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.serving.obs.perfetto import chrome_trace, write_chrome_trace
from repro_torch.serving.obs.probe import SelectionProbe
from repro_torch.serving.obs.profiling import Profiler
from repro_torch.serving.obs.tracing import Tracer

__all__ = ["Observability", "Tracer", "Registry", "Counter", "Gauge",
           "Histogram", "SelectionProbe", "Profiler", "chrome_trace",
           "write_chrome_trace", "validate_event", "validate_jsonl",
           "sanitize", "strict_dumps", "strict_loads", "EVENT_SCHEMA",
           "SCHEMA_VERSION", "warn_once"]

_WARNED: set = set()


def warn_once(key: str, message: str) -> None:
    """Emit ``message`` as a :class:`UserWarning` the first time ``key``
    is seen in this process — for hot-path fallbacks (a serving step
    that silently reroutes should say so exactly once, not per step)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    import warnings
    warnings.warn(message, UserWarning, stacklevel=3)


class Observability:
    """Opt-in observability bundle handed to the serving engine.

    Constructing one enables tracing; the pieces are individually
    optional on top:

    * ``trace_path`` — stream the event trace to a JSONL file (events
      are always kept in memory on ``tracer.events``);
    * ``probe_every`` — sample the selection-quality probe every N
      engine iterations (0 = never);
    * ``profile_dir`` — capture a ``torch.profiler`` trace of
      ``profile_steps`` iterations starting at ``profile_start_step``
      (exported to ``profile_dir/engine.trace.json``).
    """

    def __init__(self, trace_path: Optional[str] = None, *,
                 probe_every: int = 0,
                 profile_dir: Optional[str] = None,
                 profile_steps: int = 20,
                 profile_start_step: int = 0):
        self.tracer = Tracer(trace_path)
        self.probe = SelectionProbe(every=probe_every)
        self.profiler = Profiler(
            profile_dir, steps=profile_steps,
            start_step=profile_start_step) if profile_dir else None

    def probe_summary(self):
        return self.probe.summary()

    def close(self) -> None:
        self.tracer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
