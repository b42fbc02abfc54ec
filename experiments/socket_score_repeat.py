#!/usr/bin/env python3
"""Run-to-run determinism of the port's ``socket_score`` kernel on one card.

    python3 experiments/socket_score_repeat.py [--launches N]

Needs a CUDA card and nvcc, like ``chip_smoke.py``.  Draws the static
path's case exactly as ``chip_smoke.py``'s kernel phase does (BH 16,
N 8224, G 4, L 60, P 10, packed words, the generator seeded 0), launches
the kernel N times and counts the launches whose scores differ bit for
bit from the first; then the same for pooled G 1 and for int8 planes
with vnorm (N / 4 launches each).  Prints the card, the first launch's
largest distance from the plain version, and the counts.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402


def differing(launch, first, n: int):
    """(launches of ``n`` whose output differs from ``first``, the largest
    difference, the rows where any differed)."""
    bad, worst, rows = 0, 0.0, set()
    for _ in range(n):
        d = (launch() - first).abs()
        if bool((d > 0).any()):
            bad += 1
            worst = max(worst, d.max().item())
            rows |= set(torch.nonzero(d.amax(1) > 0).flatten().tolist())
    torch.cuda.synchronize()
    return bad, worst, sorted(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import socket_score_case
    from repro_torch.kernels.socket_score import ops as ss
    from repro_torch.kernels.socket_score.ref import socket_score_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(num_tables=60, num_planes=10, tau=0.4)
    main_case = dict(bh=16, n=8224, g=4, l=60, p=10, int8=False,
                     vnorm=False)
    for label, case, n in (
            ("main path", main_case, args.launches),
            ("pooled G=1", dict(main_case, g=1), args.launches // 4),
            ("int8 planes + vnorm", dict(main_case, int8=True, vnorm=True),
             args.launches // 4)):
        bits, u, vn = socket_score_case(dev, gen, **case)
        first = ss.launch_socket_score(bits, u, vn, **kw)
        torch.cuda.synchronize()
        err = (first.double() -
               socket_score_ref(bits, u, vn, **kw).double()).abs().max()
        bad, worst, rows = differing(
            lambda: ss.launch_socket_score(bits, u, vn, **kw), first, n)
        print(f"socket_score [{label}]: first launch max|err| "
              f"{err.item():.3e} from the plain version; {bad} of {n} "
              f"launches differ from it bit for bit (largest {worst:.3e}, "
              f"rows {rows[:16]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
