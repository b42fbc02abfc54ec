"""Trace + artifact validator CLI.

A copy of ``repro.serving.obs.validate``: the same checks, exit codes and
output lines.

Usage::

    python -m repro_torch.serving.obs.validate TRACE.jsonl \
        [--json artifact.json ...] [--perfetto out.trace.json]

* ``TRACE.jsonl`` — validated line by line against the strict event
  schema (version handshake, field presence/types, no unknown fields,
  no non-strict NaN/Infinity tokens); prints an event-count summary.
* ``--json FILE`` (repeatable) — the file must parse as **strict** JSON
  (``NaN``/``Infinity`` tokens are rejected; a metrics or bench artifact
  containing them would break every compliant consumer).
* ``--perfetto OUT`` — additionally export the trace to Chrome
  trace-event JSON loadable at https://ui.perfetto.dev.

Exit status 0 iff every check passes.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from typing import List, Optional

from repro_torch.serving.obs import events as ev
from repro_torch.serving.obs import perfetto


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.obs.validate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", nargs="?", default=None,
                    help="serving trace (JSONL) to validate")
    ap.add_argument("--json", action="append", default=[], metavar="FILE",
                    help="artifact that must parse as strict JSON "
                         "(repeatable)")
    ap.add_argument("--perfetto", default=None, metavar="OUT",
                    help="also export the trace to Chrome trace-event "
                         "JSON")
    args = ap.parse_args(argv)
    if args.trace is None and not args.json:
        ap.error("nothing to validate: give a trace and/or --json files")
    if args.perfetto and not args.trace:
        ap.error("--perfetto needs a trace")

    failed = False
    if args.trace:
        try:
            with open(args.trace) as f:
                events = ev.validate_jsonl(f)
        except (OSError, ValueError) as e:
            print(f"FAIL {args.trace}: {e}", file=sys.stderr)
            return 1
        counts = Counter(e["ev"] for e in events)
        summary = " ".join(f"{k}={counts[k]}" for k in sorted(counts))
        print(f"OK {args.trace}: {len(events)} events "
              f"(schema v{events[0]['schema']}) {summary}")
        if args.perfetto:
            trace = perfetto.write_chrome_trace(events, args.perfetto)
            print(f"OK {args.perfetto}: {len(trace['traceEvents'])} "
                  "trace events")
    for path in args.json:
        try:
            with open(path) as f:
                ev.strict_loads(f.read())
            print(f"OK {path}: strict JSON")
        except (OSError, ValueError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
