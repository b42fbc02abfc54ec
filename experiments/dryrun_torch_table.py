"""Print the port's dry-run records as one markdown table: a row an
architecture, a column a shape, each entry its ``base`` cell and then
its ``opt`` cell (or "opt equal" where the two read the same).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --variant opt
    python experiments/dryrun_torch_table.py [--dir experiments/dryrun_torch]

Each cell reads ``GiB a device (of the card's 80 GB) · GFLOP a device ·
collective GB · compute / memory / collective s · dominant``, computed
from the H100 SXM data sheet's rates (``repro_torch.roofline.HW``), not
measured; a failed cell reads its error's type.
"""

import argparse
import glob
import json
import os

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(rec) -> str:
    if rec is None:
        return "not run"
    if rec.get("status") != "ok":
        return "fail: " + rec.get("error", "?").split(":")[0]
    rl = rec["roofline"]
    return (f"{rec['hbm_per_device_gb']:.2f} · "
            f"{rl['flops_per_device'] / 1e9:.0f} · "
            f"{rec['collective_bytes']['total'] / 1e9:.1f} · "
            f"{rl['compute_s']:.4f} / {rl['memory_s']:.4f} / "
            f"{rl['collective_s']:.4f} · {rl['dominant']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    recs = {}
    for path in glob.glob(os.path.join(args.dir, "*.json")):
        parts = os.path.basename(path)[:-5].split("__")
        if parts[2] != args.mesh:
            continue
        variant = parts[3] if len(parts) > 3 else "base"
        with open(path) as f:
            recs[(parts[0], parts[1], variant)] = json.load(f)
    archs = sorted({a for a, _, _ in recs})
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in archs:
        entries = []
        for shape in SHAPES:
            base = cell(recs.get((arch, shape, "base")))
            opt = cell(recs.get((arch, shape, "opt")))
            entries.append(base + ("; opt equal" if opt == base
                                   else f"; opt {opt}"))
        print(f"| {arch} | " + " | ".join(entries) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
