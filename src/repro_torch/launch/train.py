"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --smoke --steps 200 --batch 8 --seq 512 --device cpu

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch minitron-8b --smoke --steps 20 --batch 8 --seq 128

The JAX package's flags, plus ``--device`` (default ``cuda``; with no
card it raises unless ``--device cpu`` is given).  ``--smoke`` shrinks
the architecture to its reduced config (same family and pattern) so a
run fits on the CPU; without it the full config is used.  The loop is
the fault-tolerant Trainer (checkpoint / restore, straggler detection).
``--ckpt`` names the checkpoint directory; without it the run uses a
temporary one, removed at the end.  Prints the JAX launcher's JSON keys
and the device.

Started by ``torchrun`` (``WORLD_SIZE`` above 1) each process joins the
process group from torchrun's environment (``launch.mesh.init_rank``:
NCCL with a card a rank when the cards cover the ranks, else gloo) and
the Trainer trains over all of them on its ``(ranks, 1)`` mesh, each
holding its shards; the first rank prints the JSON.  There is no new
flag.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import init_rank
from repro_torch.launch.serve import device_name
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig


def run(args, ckpt_dir: str, device=None) -> dict:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    ocfg = AdamWConfig(
        state_bits=args.state_bits,
        schedule=ScheduleConfig(peak_lr=args.lr, warmup_steps=20,
                                decay_steps=args.steps))
    loop = TrainLoopConfig(total_steps=args.steps,
                           checkpoint_every=args.checkpoint_every,
                           accum=args.accum)
    data = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    trainer = Trainer(cfg, ocfg, loop, data, ckpt_dir,
                      device=device or args.device)
    log = trainer.run()
    first = [m["loss"] for m in log[:10]]
    last = [m["loss"] for m in log[-10:]]
    return {
        "arch": cfg.name, "steps": len(log),
        "loss_first10": sum(first) / max(len(first), 1),
        "loss_last10": sum(last) / max(len(last), 1),
        "mean_step_s": trainer.straggler.mean_latency,
        "straggler_events": len(trainer.straggler.events),
        "device": device_name(trainer.device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--state-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card unless cpu)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        return _main_ranks(args, world)
    if args.ckpt is None:
        with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
            out = run(args, d)
    else:
        out = run(args, args.ckpt)
    print(json.dumps(out, indent=2))
    return out


def _main_ranks(args, world: int):
    """One rank of a ``torchrun`` launch: join the group, train, and on
    the first rank print the JSON."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    _, dev = init_rank(rank, world, "env://", args.device)
    try:
        # one checkpoint directory for all ranks: the first rank's
        d = [args.ckpt or (tempfile.mkdtemp(prefix="repro_torch_ckpt_")
                           if rank == 0 else None)]
        dist.broadcast_object_list(d, src=0)
        out = run(args, d[0], device=dev)
        dist.barrier()
        if rank == 0:
            if args.ckpt is None:
                shutil.rmtree(d[0], ignore_errors=True)
            out["ranks"] = world
            print(json.dumps(out, indent=2))
        return out
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
