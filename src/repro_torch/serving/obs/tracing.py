"""Structured event tracer: validated events to memory and/or JSONL.

A copy of ``repro.serving.obs.tracing`` (the same epoch, validation at
emit time and line-buffered file).

One :class:`Tracer` serves one engine's lifetime (it may span several
``run()`` calls; the trace opens with one ``trace_start`` version
handshake and each run is bracketed by ``run_start``/``run_end``).
Timestamps are seconds since the tracer's epoch (``time.perf_counter``
based — monotonic, sub-μs).

Every event is validated against :data:`~repro_torch.serving.obs.events
.EVENT_SCHEMA` at emit time and serialized strictly (non-finite floats
become ``null``), so a written trace is schema-valid by construction;
``python -m repro_torch.serving.obs.validate`` re-validates the file.

The tracer is only ever constructed when observability is requested:
the engine's disabled path holds no tracer at all and allocates zero
event objects per step (asserted in ``tests/test_torch_observability.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from repro_torch.serving.obs import events as ev

__all__ = ["Tracer"]


class Tracer:
    """Event bus writing validated events to an in-memory list (always —
    the Perfetto exporter and tests consume it) and, when ``path`` is
    given, streaming them to a JSONL file (line-buffered, so a crashed
    run still leaves a readable trace)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[Dict] = []
        self._t0 = time.perf_counter()
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._file = open(path, "w", buffering=1) if path else None
        self._runs = 0
        self._started = False

    def now(self) -> float:
        """Seconds since the tracer epoch."""
        return time.perf_counter() - self._t0

    def emit(self, event_type: str, **fields) -> Dict:
        event = {"ev": event_type, "ts": round(self.now(), 6)}
        event.update(ev.sanitize(fields))
        ev.validate_event(event)
        self.events.append(event)
        if self._file is not None:
            self._file.write(ev.strict_dumps(event) + "\n")
        return event

    def ensure_start(self, **meta) -> None:
        """Emit the ``trace_start`` version handshake once per tracer
        (the engine calls this before its first event — warmup compiles
        included)."""
        if not self._started:
            self._started = True
            self.emit("trace_start", schema=ev.SCHEMA_VERSION, **meta)

    def begin_run(self, *, requests: int) -> int:
        """Open a run: emits ``run_start`` with a per-tracer run
        ordinal; returns the ordinal."""
        self.ensure_start()
        run = self._runs
        self._runs += 1
        self.emit("run_start", run=run, requests=requests)
        return run

    def end_run(self, run: int, *, requests: int, generated: int,
                wall_s: float) -> None:
        self.emit("run_end", run=run, requests=requests,
                  generated=generated, wall_s=wall_s)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
