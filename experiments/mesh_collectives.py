#!/usr/bin/env python3
"""The mesh collectives of four ranks on one card.

    python3 experiments/mesh_collectives.py [--mb 16 512 2048]

Needs a CUDA card.  Spawns 4 ranks on ``cuda:0`` under gloo (as
``launch.mesh.init_rank`` places them when the cards do not cover the
ranks) and times ``distributed/collectives.py``'s ``all_gather`` and
``reduce_scatter`` of float32 tensors of each size (the whole gathered
tensor, the whole tensor each rank reduces) over the ``("data",)`` axis
of a (4, 1) mesh, card to card through the ranks' mailboxes (the one
route of CUDA tensors under gloo).  Each result is checked: the gather
bit for bit against the blocks every rank drew, the reduce-scatter
against the sum of every rank's tensor in the members' order.  Prints
the card and one line a size: the median of 5 calls' host seconds on
rank 0 (every call started together on all ranks and ended with the
card's work) and GB/s of the tensor's bytes.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

WORLD = 4
CALLS = 5


def _draw(rank: int, numel: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    return torch.randn(numel, generator=gen, device=dev)


def _timed(fn, dev):
    import torch.distributed as dist
    times, out = [], None
    for _ in range(CALLS + 1):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]), out


def _rank(rank, world, tmp, sizes_mb):
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    _, dev = init_rank(rank, world, f"file://{tmp}/init", "cuda")
    mesh = make_test_mesh(world, 1)
    lines = []
    for mb in sizes_mb:
        numel = mb * 2 ** 20 // 4 // world * world
        block = _draw(rank, numel // world, dev)
        whole = torch.cat([_draw(r, numel // world, dev)
                           for r in range(world)])
        full = _draw(100 + rank, numel, dev)
        want = None
        for r in range(world):
            part = _draw(100 + r, numel, dev).narrow(
                0, rank * (numel // world), numel // world)
            want = part.clone() if want is None else want.add_(part)
        g_s, got = _timed(lambda: collectives.all_gather(
            block, mesh, ("data",), 0), dev)
        if not torch.equal(got, whole):
            raise AssertionError(f"all_gather of {mb} MB differs")
        r_s, red = _timed(lambda: collectives.reduce_scatter(
            full, mesh, ("data",), 0), dev)
        if not torch.equal(red, want):
            rel = float((red - want).abs().max() / want.abs().max())
            raise AssertionError(f"reduce_scatter of {mb} MB: {rel:.3e} "
                                 "from the ordered sum")
        nbytes = numel * 4
        lines.append(f"{mb} MB card: all_gather {g_s:.4f} s "
                     f"({nbytes / g_s / 1e9:.2f} GB/s), reduce_scatter "
                     f"{r_s:.4f} s ({nbytes / r_s / 1e9:.2f} GB/s)")
        del block, whole, full, want
        torch.cuda.empty_cache()
    if rank == 0:
        print("\n".join(lines), flush=True)
    collectives.close_mailboxes()
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, nargs="+", default=[16, 512, 2048])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_collectives: needs a CUDA card")
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.serve import card_line
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank, WORLD, (WORLD, tmp, args.mb), deadline_s=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
