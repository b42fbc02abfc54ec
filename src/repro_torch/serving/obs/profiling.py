"""Profiler hooks: ``torch.profiler`` capture around K engine steps.

The port's counterpart of ``repro.serving.obs.profiling`` (which wraps
``jax.profiler``).  ``--profile-dir`` wires a :class:`Profiler` into the
engine loop: the capture starts at iteration ``start_step``, runs for
``steps`` iterations, and stops (also force-stopped at run end if the
run is shorter); at the stop the window is exported as a Chrome trace,
``engine.trace.json`` in ``profile_dir``.  The engine wraps each step
inside the window in a ``torch.profiler.record_function`` named after
the step kind (``mixed``/``decode``/``probe``), so the timeline
attributes host and device time to engine phases.

The activities are the CPU's, plus CUDA's when the engine runs on a
CUDA device (``device``, set by the engine; the card is never probed
for): the device's kernels then appear in the trace under their own
names.

Start/stop are mirrored into the event trace (``profile_start`` /
``profile_stop``) so the JSONL timeline and the profiler window can be
aligned.  Outside the window :meth:`annotate` is a null context —
profiling adds nothing to un-profiled steps.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.profiler

__all__ = ["Profiler", "TRACE_FILE"]

TRACE_FILE = "engine.trace.json"


class Profiler:
    """Window-of-K-steps ``torch.profiler`` capture for the engine loop."""

    def __init__(self, profile_dir: str, steps: int = 20,
                 start_step: int = 0):
        assert steps > 0, steps
        self.profile_dir = profile_dir
        self.steps = int(steps)
        self.start_step = int(start_step)
        self.active = False
        self.device: Optional[torch.device] = None   # set by the engine
        self._prof = None
        self._done = False                  # one window per run

    @property
    def trace_path(self) -> str:
        """The Chrome trace the window is exported to."""
        return os.path.join(self.profile_dir, TRACE_FILE)

    def activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def maybe_start(self, iteration: int, tracer=None) -> None:
        if self._done or self.active or iteration < self.start_step:
            return
        self._prof = torch.profiler.profile(activities=self.activities())
        self._prof.start()
        self.active = True
        self._stop_at = iteration + self.steps
        if tracer is not None:
            tracer.emit("profile_start", dir=self.profile_dir,
                        steps=self.steps)

    def maybe_stop(self, iteration: int, tracer=None) -> None:
        """Stop after the window's last step has run (called with the
        next iteration number)."""
        if self.active and iteration >= self._stop_at:
            self.stop(tracer)

    def stop(self, tracer=None) -> None:
        """Force-stop (run end) and export the window; idempotent."""
        if not self.active:
            return
        self._prof.stop()                   # synchronizes the device
        os.makedirs(self.profile_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.active = False
        self._done = True
        if tracer is not None:
            tracer.emit("profile_stop", dir=self.profile_dir)

    def annotate(self, name: str):
        """Named ``record_function`` inside the window, null context
        outside."""
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()
