"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``: the same float32 arithmetic on a
step tensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ScheduleConfig", "learning_rate"]


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    end_lr_frac: float = 0.1
    kind: str = "cosine"     # "cosine" | "linear" | "constant"


def learning_rate(cfg: ScheduleConfig, step) -> torch.Tensor:
    """The rate at ``step`` (an int or a tensor) as a float32 scalar
    tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps) /
                           max(cfg.decay_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.kind == "cosine":
            decay = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        elif cfg.kind == "linear":
            decay = 1.0 - (1.0 - cfg.end_lr_frac) * frac
        else:
            raise ValueError(cfg.kind)
    return cfg.peak_lr * warm * decay
