#!/usr/bin/env python3
"""Start and tear down four ranks on one card, many times, and count the
ranks that abort.

    python3 experiments/mailbox_churn.py [--starts 30] [--src PATH]
        [--teardown close|exit]

Needs a CUDA card.  Each start launches 4 processes, gloo ranks all on
``cuda:0`` (as ``launch.mesh.init_rank`` places them when the cards do
not cover the ranks), so every collective of a CUDA tensor goes card to
card through the ranks' CUDA IPC mailboxes
(``distributed/collectives.py``).  Each rank grows its mailboxes through
collectives of rising size, on a (4, 1) mesh and then on the groups of
a (2, 2) mesh, checks every result bit for bit, and ends as
``chip_smoke.py``'s ranks do (``--teardown close``: ``close_mailboxes``,
a barrier, the group destroyed) or with the group destroyed and the
mailboxes left to the process's exit (``--teardown exit``).  A start
fails when a rank exits with another code than 0 or does not end within
``RANK_TIMEOUT_S``; each failure's exit codes and the last lines of its
ranks' error output are kept, and so are the ``torch_*`` files that each
start left in ``/dev/shm`` (the CUDA IPC reference-count files of
``torch.multiprocessing``) and the ranks' warnings that a producer ended
before the CUDA tensors it shared were released.

``--src`` names the ``src`` directory whose ``repro_torch`` the ranks
import (default: this checkout's), so one call can count a tree and its
parent (``git archive`` into a git-ignored directory).  Prints the
card's name and power limit and one summary line; writes every start to
``chiprun_out/mailbox_churn[_<label>].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RANK_TIMEOUT_S = 180
# bytes of the tensors a rank posts, rising: each one grows the mailboxes
SIZES = [4096 * 4 ** i for i in range(8)]       # 4 KB .. 64 MB


def _shm_files() -> set:
    try:
        return {p for p in os.listdir("/dev/shm") if p.startswith("torch_")}
    except OSError:
        return set()


def _rank(rank: int, world: int, init: str, teardown: str) -> None:
    """One rank: the mailboxes grown on both meshes' groups, every result
    checked, then torn down as ``teardown`` says."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import init_rank, make_test_mesh
    _, dev = init_rank(rank, world, init, "cuda")
    for shape in ((4, 1), (2, 2)):
        mesh = make_test_mesh(*shape)
        for nbytes in SIZES:
            numel = nbytes // 4
            for axes in (("data",), ("model",)):
                if mesh.extent(axes) == 1:
                    continue
                mine = torch.full((numel,), float(rank + 1), device=dev)
                got = collectives.all_gather(mine, mesh, axes, 0)
                want = torch.cat([torch.full((numel,), float(r + 1),
                                             device=dev)
                                  for r in mesh.members(axes)])
                if not torch.equal(got, want):
                    raise AssertionError(f"all_gather {axes} {nbytes} B")
                tot = collectives.all_reduce(
                    mine, dist.ReduceOp.SUM, mesh.group(axes), mesh, axes)
                if float(tot[0]) != float(sum(r + 1 for r in
                                              mesh.members(axes))):
                    raise AssertionError(f"all_reduce {axes} {nbytes} B")
    if teardown == "close":
        collectives.close_mailboxes()
        dist.barrier()
    dist.destroy_process_group()


def _start(src: str, i: int, teardown: str) -> dict:
    """One start of ``WORLD`` rank processes; their exit codes, seconds
    and error tails, and the ``/dev/shm`` files they left."""
    before = _shm_files()
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, errs = [], []
        for r in range(WORLD):
            err = open(os.path.join(tmp, f"err{r}"), "w+")
            errs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r),
                 "--init", f"file://{tmp}/init", "--teardown", teardown],
                env=env,
                stdout=subprocess.DEVNULL, stderr=err))
        codes = []
        for p in procs:
            left = RANK_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                codes.append(p.wait(timeout=max(left, 1)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                codes.append("timeout")
        for p in procs:
            p.wait()
        tails, producer = [], 0
        for err in errs:
            err.seek(0)
            text = err.read()
            producer += text.count("Producer process has been terminated")
            tails.append(text[-1500:])
            err.close()
    seconds = time.perf_counter() - t0
    failed = any(c != 0 for c in codes)
    return dict(start=i, codes=codes, seconds=seconds, failed=failed,
                unlink=any("could not unlink" in t for t in tails),
                producer_warnings=producer,
                left_in_shm=sorted(_shm_files() - before),
                errors=tails if failed else [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--starts", type=int, default=30)
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--teardown", choices=["close", "exit"],
                    default="close")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, WORLD, args.init, args.teardown)
        return 0
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mailbox_churn: needs a CUDA card")
    from repro_torch.launch.serve import card_line
    print(card_line(), flush=True)
    src = str(Path(args.src).resolve())
    t0 = time.perf_counter()
    runs = [_start(src, i, args.teardown) for i in range(args.starts)]
    summary = dict(src=src, teardown=args.teardown, starts=len(runs),
                   failed=sum(r["failed"] for r in runs),
                   unlink_aborts=sum(r["unlink"] for r in runs),
                   starts_with_producer_warnings=sum(
                       bool(r["producer_warnings"]) for r in runs),
                   starts_leaving_shm_files=sum(bool(r["left_in_shm"])
                                                for r in runs),
                   seconds=time.perf_counter() - t0,
                   start_seconds=[round(r["seconds"], 2) for r in runs])
    out = REPO / "chiprun_out" / (
        "mailbox_churn" + (f"_{args.label}" if args.label else "") + ".json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(summary, runs=runs), indent=1))
    print("mailbox_churn " + json.dumps(summary), flush=True)
    for r in runs:
        if r["failed"]:
            print(f"  start {r['start']}: codes {r['codes']}; "
                  + " | ".join(t.strip().splitlines()[-1]
                               for t in r["errors"] if t.strip()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
