"""Straggler detection for fleet-scale training.

A copy of ``repro.runtime.straggler`` (host logic only).

At thousands of chips, tail-latency hosts (thermal throttling, failing
HBM, network congestion) silently stretch every synchronous step.  The
detector keeps an EWMA + EW-variance of step latencies and flags steps
beyond ``threshold`` sigmas; sustained flags trigger a mitigation callback
(in a real deployment: demote the host, re-slice the ring, or swap in a
hot spare — here: logged + surfaced to the supervisor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

__all__ = ["StragglerDetector"]


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA coefficient
    threshold_sigma: float = 4.0
    patience: int = 3           # consecutive flags before mitigation
    warmup_steps: int = 5       # ignore compile/cache warmup
    on_straggler: Optional[Callable[[int, float], None]] = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _consecutive: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, latency_s: float) -> bool:
        """Record a step latency; returns True if flagged as straggling."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # prime the statistics without flagging
            if self._n == 1:
                self._mean = latency_s
            else:
                self._mean += self.alpha * (latency_s - self._mean)
                self._var = max(self._var, (latency_s - self._mean) ** 2)
            return False

        sigma = math.sqrt(self._var) if self._var > 0 else self._mean * 0.1
        flagged = latency_s > self._mean + self.threshold_sigma * sigma

        if flagged:
            self._consecutive += 1
            self.events.append({"step": step, "latency_s": latency_s,
                                "mean_s": self._mean, "sigma_s": sigma})
            if (self._consecutive >= self.patience
                    and self.on_straggler is not None):
                self.on_straggler(step, latency_s)
                self._consecutive = 0
        else:
            self._consecutive = 0
            # only track healthy steps in the baseline
            delta = latency_s - self._mean
            self._mean += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var +
                                            self.alpha * delta * delta)
        return flagged

    @property
    def mean_latency(self) -> float:
        return self._mean
