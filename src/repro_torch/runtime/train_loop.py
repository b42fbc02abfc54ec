"""Fault-tolerant, elastic, straggler-aware training supervisor.

Port of ``repro.runtime.train_loop``.  The Trainer owns the mesh (built
by ``mesh_factory`` from the ranks still healthy), the placement of the
parameters and the optimizer state on it, the train step, the data
loader, asynchronous checkpointing, failure recovery and straggler
detection.

Recovery path (exercised in tests with injected failures):

    step fails -> RetryPolicy -> rebuild the mesh from mesh_factory(ranks)
    -> re-make the step -> Checkpointer.restore(shardings=new placement)
    -> data loader state restored -> resume at the last checkpointed step
    (no checkpoint yet: start again from the seed's initialisation)

One rank is one process.  The ranks are those of the initialised
``torch.distributed`` process group (one when there is none), less the
``lose_device:<n>`` count of the failure injector, the first ones kept,
as the JAX Trainer keeps the first healthy devices.  On a mesh each rank
holds only its blocks of the parameters and moments (``launch/specs.py``,
``distributed/fsdp.py``) and runs the sharded step; it draws its blocks
a unit of the model at a time (``fsdp.init_shards``), and a checkpoint
gathers a leaf at a time, the writing rank alone keeping the host copy,
so no rank holds the whole model on the card.  When the mesh
shrinks, every rank of the old world joins the collective
``dist.new_group`` calls of the new mesh, and the ranks off it leave the
loop (``active`` False).  A rank that left cannot join a later rebuild's
``new_group``, so a second shrink raises.  A mesh of more than one rank
without an initialised process group raises: the Trainer never drops to
one rank quietly.  Step times are taken after
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, HostDataLoader
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import default_mesh_factory
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.runtime.fault_tolerance import FailureInjector, RetryPolicy
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["TrainLoopConfig", "Trainer", "default_mesh_factory"]


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
                 checkpoint_dir: str, device="cuda",
                 mesh_factory: Callable = default_mesh_factory,
                 injector: Optional[FailureInjector] = None,
                 retry: Optional[RetryPolicy] = None):
        self.cfg, self.ocfg, self.loop = cfg, ocfg, loop
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.mesh_factory = mesh_factory
        self.injector = injector or FailureInjector()
        self.retry = retry or RetryPolicy()
        self.ckpt = Checkpointer(checkpoint_dir, keep=loop.keep_checkpoints)
        self.straggler = StragglerDetector()
        self.loader = HostDataLoader(data_cfg)
        self.metrics_log: List[Dict] = []
        self.rebuild_count = 0
        self.mesh = None
        self.active = True           # False once this rank left the mesh
        self._setup(restore=self.ckpt.latest_step() is not None)

    # ------------------------------------------------------------- setup
    def _world(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def _ranks(self) -> List[int]:
        world = self._world()
        return list(range(world))[:max(1, world - self.injector.lost_devices)]

    def _setup(self, restore: bool):
        self.params = self.opt_state = None     # free the failed state
        ranks = self._ranks()
        if self.mesh is not None and self.mesh.size < self._world():
            raise RuntimeError(
                f"the mesh over ranks {self.mesh.ranks} cannot shrink again: "
                "the ranks that left it cannot join the new mesh's "
                "dist.new_group calls")
        self.mesh = self.mesh_factory(ranks)
        self._shardings = None
        if self.mesh is not None:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a mesh over {self.mesh.size} ranks needs an "
                    "initialised torch.distributed process group "
                    "(launch.mesh.init_rank, or torchrun's environment)")
            self.mesh.build_groups()     # collective over the whole world
            if not self.mesh.member:
                self.active = False
                return
            with shd.activate_mesh(self.mesh):
                params_sds, params_sh = sp.param_specs(self.cfg, self.mesh, {},
                                                       [])
                opt_sds, opt_sh = sp.opt_specs(self.ocfg, params_sds,
                                               params_sh, self.mesh, {}, [])
            self._shardings = {"params": params_sh, "opt": opt_sh}
        elif dist.is_initialized() and dist.get_rank() not in ranks:
            self.active = False
            return
        if restore:
            rec = self.ckpt.restore(device=self.device,
                                    shardings=self._shardings)
            self.params = rec["tree"]["params"]
            self.opt_state = rec["tree"]["opt"]
            self.step = rec["step"]
            self.loader.load_state_dict(rec["extra"]["loader"])
        elif self.mesh is None:
            self.params = tfm.init_model(self.cfg, self.loop.seed,
                                         self.device)
            self.opt_state = init_adamw(self.ocfg, self.params)
            self.step = 0
        else:
            # each unit of the model drawn, cut to this rank's blocks and
            # dropped: the whole model is never on the device
            self.params = fsdp.init_shards(self.cfg, self.loop.seed,
                                           fsdp.flat_tree(params_sh),
                                           self.device)
            self.opt_state = fsdp.zeros_tree(
                opt_sds, fsdp.flat_tree(opt_sh), self.device)
            self.step = 0
        self._step_fn = make_train_step(
            self.cfg, self.ocfg, accum=self.loop.accum,
            grad_shardings=None if self.mesh is None else params_sh)

    # ------------------------------------------------------------- steps
    def _save(self, blocking: bool = False):
        # on a mesh: gathered by every rank, written by its first
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"loader": self.loader.state_dict()},
                       blocking=blocking, shardings=self._shardings,
                       write=self.mesh is None or
                       self.mesh.rank == self.mesh.ranks[0])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _barrier(self):
        """Every rank of the mesh here (the first rank's checkpoint
        written) before any reads it."""
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))

    def _one_step(self) -> Dict:
        batch = {k: torch.as_tensor(v, device=self.device).long()
                 for k, v in next(self.loader).items()}
        self.injector.maybe_fail(self.step)
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch)
        return {k: float(v) for k, v in metrics.items() if v.ndim == 0}

    def run(self) -> List[Dict]:
        while self.active and self.step < self.loop.total_steps:
            self._sync()
            t0 = time.perf_counter()
            try:
                metrics = self._one_step()
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                if not self.retry.record_failure():
                    raise RuntimeError(
                        f"giving up after repeated failures: {e}") from e
                self.rebuild_count += 1
                # elastic recovery: rebuild the mesh over the ranks left,
                # restore the newest checkpoint onto it and resume (none
                # yet: start again from the initialisation)
                self.ckpt.wait()
                self._barrier()
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
        if self.active:
            self._save(blocking=True)
        self.loader.close()
        return self.metrics_log
