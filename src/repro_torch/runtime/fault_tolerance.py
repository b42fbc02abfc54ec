"""Failure handling for the training supervisor.

A copy of ``repro.runtime.fault_tolerance`` (host logic only):

* **detect**: any exception escaping a step (a CUDA error or an
  out-of-memory on the card; an injectable :class:`FailureInjector` for
  deterministic tests) marks the step failed.
* **restore**: the supervisor rolls back to the newest checkpoint; the
  data loader's state is restored from the same checkpoint, so no batch
  is skipped or repeated.
* **give up** after ``max_consecutive_failures`` failures in a row.

``lose_device:<n>`` actions count lost devices as the JAX package's do;
the port's Trainer runs on one device, and rebuilding a smaller mesh from
the survivors comes with ROADMAP.md queue 1 item 11's ``distributed/``
step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["FailureInjector", "RetryPolicy"]


class FailureInjector:
    """Deterministic fault injection for tests and chaos drills.

    ``schedule`` maps step -> exception to raise (or "lose_device:<n>" to
    simulate shrinking the fleet by n devices before the raise).
    """

    def __init__(self, schedule: Optional[dict] = None):
        self.schedule = dict(schedule or {})
        self.lost_devices = 0

    def maybe_fail(self, step: int):
        action = self.schedule.pop(step, None)
        if action is None:
            return
        if isinstance(action, str) and action.startswith("lose_device"):
            n = int(action.split(":")[1]) if ":" in action else 1
            self.lost_devices += n
            raise RuntimeError(
                f"injected device loss at step {step} (-{n} devices)")
        if isinstance(action, BaseException):
            raise action
        raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class RetryPolicy:
    max_consecutive_failures: int = 3
    backoff_s: float = 0.0      # no real sleep in tests

    def __post_init__(self):
        self._consecutive = 0

    def record_success(self):
        self._consecutive = 0

    def record_failure(self) -> bool:
        """Returns True if training should keep retrying."""
        self._consecutive += 1
        return self._consecutive <= self.max_consecutive_failures
