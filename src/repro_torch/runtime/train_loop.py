"""Fault-tolerant, straggler-aware training supervisor on one device.

Port of ``repro.runtime.train_loop``.  The Trainer owns the parameters
and the optimizer state on its device, the train step, the data loader,
asynchronous checkpointing, failure recovery and straggler detection.

Recovery path (exercised in tests with injected failures):

    step fails -> RetryPolicy -> Checkpointer.restore(device=)
    -> data loader state restored -> resume at the last checkpointed step
    (no checkpoint yet: start again from the seed's initialisation)

The JAX Trainer also rebuilds a mesh over the healthy devices
(``default_mesh_factory``) and reshards the restored state onto it; the
port runs on one device, and asking for more raises until ROADMAP.md
queue 1 item 11's ``distributed/`` step.  Step times are taken after
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, HostDataLoader
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.runtime.fault_tolerance import FailureInjector, RetryPolicy
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["TrainLoopConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    accum: int = 1
    keep_checkpoints: int = 3
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, ocfg: AdamWConfig,
                 loop: TrainLoopConfig, data_cfg: DataConfig,
                 checkpoint_dir: str, device="cuda", num_devices: int = 1,
                 injector: Optional[FailureInjector] = None,
                 retry: Optional[RetryPolicy] = None):
        if num_devices != 1:
            raise NotImplementedError(
                f"num_devices={num_devices}: training across devices "
                "comes with ROADMAP.md queue 1 item 11 (distributed/)")
        self.cfg, self.ocfg, self.loop = cfg, ocfg, loop
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.injector = injector or FailureInjector()
        self.retry = retry or RetryPolicy()
        self.ckpt = Checkpointer(checkpoint_dir, keep=loop.keep_checkpoints)
        self.straggler = StragglerDetector()
        self.loader = HostDataLoader(data_cfg)
        self.metrics_log: List[Dict] = []
        self.rebuild_count = 0
        self._step_fn = make_train_step(cfg, ocfg, accum=loop.accum)
        self._setup(restore=self.ckpt.latest_step() is not None)

    # ------------------------------------------------------------- setup
    def _setup(self, restore: bool):
        self.params = self.opt_state = None     # free the failed state
        if restore:
            rec = self.ckpt.restore(device=self.device)
            self.params = rec["tree"]["params"]
            self.opt_state = rec["tree"]["opt"]
            self.step = rec["step"]
            self.loader.load_state_dict(rec["extra"]["loader"])
        else:
            self.params = tfm.init_model(self.cfg, self.loop.seed,
                                         self.device)
            self.opt_state = init_adamw(self.ocfg, self.params)
            self.step = 0

    # ------------------------------------------------------------- steps
    def _save(self, blocking: bool = False):
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"loader": self.loader.state_dict()},
                       blocking=blocking)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one_step(self) -> Dict:
        batch = {k: torch.as_tensor(v, device=self.device).long()
                 for k, v in next(self.loader).items()}
        self.injector.maybe_fail(self.step)
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch)
        return {k: float(v) for k, v in metrics.items() if v.ndim == 0}

    def run(self) -> List[Dict]:
        while self.step < self.loop.total_steps:
            self._sync()
            t0 = time.perf_counter()
            try:
                metrics = self._one_step()
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                if not self.retry.record_failure():
                    raise RuntimeError(
                        f"giving up after repeated failures: {e}") from e
                self.rebuild_count += 1
                # restore the newest checkpoint and resume (none yet:
                # start again from the initialisation)
                self.ckpt.wait()
                self._setup(restore=self.ckpt.latest_step() is not None)
                continue
            self.retry.record_success()
            self._sync()
            dt = time.perf_counter() - t0
            self.straggler.observe(self.step, dt)
            metrics.update(step=self.step, wall_s=dt)
            self.metrics_log.append(metrics)
            self.step += 1
            if self.step % self.loop.checkpoint_every == 0:
                self._save()
        self._save(blocking=True)
        self.loader.close()
        return self.metrics_log
