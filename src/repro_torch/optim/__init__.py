"""Optimizers: AdamW (+8-bit states) and LR schedules."""

from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
from repro_torch.optim.schedule import ScheduleConfig, learning_rate

__all__ = ["AdamWConfig", "ScheduleConfig", "adamw_update", "init_adamw",
           "learning_rate"]
