"""Chrome ``trace_event`` exporter: open a serving run in Perfetto.

A copy of ``repro.serving.obs.perfetto``: on the same events its output
equals the JAX package's.

Converts a schema-valid serving trace (list of events or a JSONL file)
into the Chrome trace-event JSON format that https://ui.perfetto.dev and
``chrome://tracing`` load directly:

* one **thread per request** (pid 1) with complete-span ("X") events for
  its lifecycle phases — ``queued`` (submit→admit, and preempt→re-admit),
  ``prefill`` (admit→first token) and ``decode`` (first token→finish) —
  plus instant markers for preemptions and withheld chunk grants;
* **counter tracks** (pid 0) from the per-iteration step records: pool
  occupancy (free/used blocks) and batch occupancy
  (running/prefilling/waiting);
* instant events for compiles and the probe's per-layer recall rows.

Timestamps are microseconds (the trace-event unit) from the tracer epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serving.obs import events as ev_schema

__all__ = ["chrome_trace", "write_chrome_trace"]

_US = 1e6


def _span(name, ts, dur, pid, tid, args=None) -> Dict:
    out = {"name": name, "ph": "X", "ts": ts * _US, "dur": max(dur, 0.0)
           * _US, "pid": pid, "tid": tid}
    if args:
        out["args"] = args
    return out


def _instant(name, ts, pid, tid, args=None) -> Dict:
    out = {"name": name, "ph": "i", "s": "t", "ts": ts * _US, "pid": pid,
           "tid": tid}
    if args:
        out["args"] = args
    return out


def _counter(name, ts, values: Dict) -> Dict:
    return {"name": name, "ph": "C", "ts": ts * _US, "pid": 0, "tid": 0,
            "args": values}


def chrome_trace(events: List[Dict]) -> Dict:
    """Build the ``{"traceEvents": [...]}`` object from parsed events."""
    out: List[Dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "engine"}},
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "requests"}},
    ]
    # ---- per-request lifecycle threads ----------------------------------
    per_rid: Dict[int, List[Dict]] = {}
    for e in events:
        if "rid" in e:
            per_rid.setdefault(e["rid"], []).append(e)
    for rid in sorted(per_rid):
        tid = rid + 1
        out.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": f"req {rid}"}})
        open_name: Optional[str] = None
        open_ts = 0.0
        last_ts = 0.0
        for e in per_rid[rid]:
            kind, ts = e["ev"], e["ts"]
            last_ts = ts
            if kind == "submit":
                open_name, open_ts = "queued", ts
            elif kind == "admit":
                if open_name:
                    out.append(_span(open_name, open_ts, ts - open_ts, 1,
                                     tid))
                open_name, open_ts = "prefill", ts
            elif kind == "first_token":
                if open_name:
                    out.append(_span(open_name, open_ts, ts - open_ts, 1,
                                     tid, {"ttft_s": e["ttft_s"]}))
                open_name, open_ts = "decode", ts
            elif kind == "preempt":
                if open_name:
                    out.append(_span(open_name, open_ts, ts - open_ts, 1,
                                     tid))
                out.append(_instant(f"preempt ({e['cause']})", ts, 1, tid,
                                    {"blocks_freed": e["blocks_freed"]}))
                open_name, open_ts = "queued", ts
            elif kind == "finish":
                if open_name:
                    out.append(_span(open_name, open_ts, ts - open_ts, 1,
                                     tid, {"generated": e["generated"]}))
                open_name = None
            elif kind == "chunk_grant":
                out.append(_instant(
                    f"chunk +{e['tokens']}", ts, 1, tid,
                    {"start": e["start"], "final": e["final"]}))
            elif kind == "chunk_withheld":
                out.append(_instant("chunk withheld", ts, 1, tid,
                                    {"free_blocks": e["free_blocks"]}))
            elif kind == "cache_hit":
                out.append(_instant(
                    f"cache hit +{e['cached_tokens']}", ts, 1, tid,
                    {"cached_tokens": e["cached_tokens"],
                     "prompt_tokens": e["prompt_tokens"],
                     "shared_blocks": e["shared_blocks"]}))
            elif kind == "page_share":
                out.append(_instant(f"share {e['blocks']}p", ts, 1, tid,
                                    {"tail": e["tail"]}))
            elif kind == "cow_copy":
                out.append(_instant("cow copy", ts, 1, tid,
                                    {"block": e["block"],
                                     "clone": e["clone"],
                                     "keep_tokens": e["keep_tokens"]}))
        if open_name:                    # run ended mid-phase
            out.append(_span(open_name, open_ts, last_ts - open_ts, 1,
                             tid))
    # ---- engine counters + instants -------------------------------------
    for e in events:
        kind, ts = e["ev"], e["ts"]
        if kind == "step":
            out.append(_counter("pool_blocks", ts,
                                {"free": e["pool_free"],
                                 "used": e["pool_used"]}))
            out.append(_counter("batch", ts,
                                {"running": e["running"],
                                 "prefilling": e["prefilling"],
                                 "waiting": e["waiting"]}))
        elif kind == "compile":
            out.append(_span(f"compile {e['fn']}",
                             ts - e["seconds"], e["seconds"], 0, 0))
        elif kind == "probe":
            out.append(_counter(f"probe_recall_l{e['layer']}", ts,
                                {"recall": e["recall"]}))
        elif kind == "cache_evict":
            out.append(_instant(f"cache evict {e['blocks']}p", ts, 0, 0,
                                {"remaining_blocks":
                                 e["remaining_blocks"]}))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events_or_path, out_path: str) -> Dict:
    """Export to ``out_path``; accepts parsed events or a JSONL path."""
    if isinstance(events_or_path, str):
        with open(events_or_path) as f:
            events = ev_schema.validate_jsonl(f)
    else:
        events = list(events_or_path)
    trace = chrome_trace(events)
    with open(out_path, "w") as f:
        f.write(ev_schema.strict_dumps(trace))
    return trace
