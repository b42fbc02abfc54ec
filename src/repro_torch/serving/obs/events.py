"""Versioned event schema for the serving trace (JSONL, one event/line).

A copy of ``repro.serving.obs.events``: the schema and its version are
the JAX package's, field for field, so a trace written by either
package validates under the other's validator.

Every event is a flat JSON object with two implicit fields — ``ev`` (the
event type) and ``ts`` (seconds since the tracer's epoch, float) — plus
the per-type fields tabulated in :data:`EVENT_SCHEMA`.  The first line
of every trace is a ``trace_start`` event carrying
:data:`SCHEMA_VERSION`; consumers must refuse traces whose version they
do not understand.  One trace covers one engine's lifetime (warmup
compiles included); each ``run()`` is bracketed by ``run_start`` /
``run_end``.

The schema is **strict** both ways: :func:`validate_event` rejects
missing fields, wrong types, and unknown fields, so an emitted trace and
the schema can never drift apart silently (the tracer validates every
event at emit time, and CI re-validates the written file).

JSON is strict too: ``NaN``/``Infinity`` are not JSON — floats that are
not finite are serialized as ``null`` (:func:`sanitize`), and the
loaders here reject the non-strict tokens outright
(:func:`strict_loads`).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List

__all__ = ["SCHEMA_VERSION", "SUPPORTED_SCHEMAS", "EVENT_SCHEMA",
           "EVENT_SCHEMA_V1", "validate_event", "validate_jsonl",
           "sanitize", "strict_dumps", "strict_loads"]

SCHEMA_VERSION = 2

# Field type specs: int / float / str / bool.  ``float`` accepts ints
# (JSON has one number type) and ``None`` (a sanitized non-finite value);
# every other type is exact.  ``?`` prefix marks the field optional.
#
# This dict is the CURRENT (v2) schema; v1 — before the prefix-cache
# events — is frozen below as :data:`EVENT_SCHEMA_V1`, and
# :func:`validate_jsonl` checks each trace against the schema its
# handshake declares, so both generations of traces stay readable.
EVENT_SCHEMA: Dict[str, Dict[str, type]] = {
    # one per trace file — version handshake + engine metadata (warmup
    # compiles may precede the first run, so runs are bracketed by
    # run_start/run_end instead)
    "trace_start": {"schema": int, "?arch": str, "?backend": str,
                    "?prefill_chunk": int, "?layers_paged": int,
                    "?layers_ring": int, "?layers_state": int,
                    "?prefix_cache": bool},
    "run_start": {"run": int, "requests": int},
    "run_end": {"run": int, "requests": int, "generated": int,
                "wall_s": float},
    # ---- request lifecycle ------------------------------------------------
    "submit": {"rid": int, "prompt_tokens": int, "max_new_tokens": int,
               "arrival": float},
    "admit": {"rid": int, "slot": int, "blocks": int, "resume": bool,
              "?wait_s": float},
    "chunk_grant": {"rid": int, "start": int, "tokens": int, "final": bool,
                    "blocks": int},
    "chunk_withheld": {"rid": int, "free_blocks": int},
    "preempt": {"rid": int, "cause": str, "state": str,
                "blocks_freed": int},
    "first_token": {"rid": int, "ttft_s": float},
    "finish": {"rid": int, "generated": int, "preemptions": int},
    # ---- per-iteration step record ---------------------------------------
    "step": {"iter": int, "kind": str, "occupancy": int,
             "chunk_tokens": int, "step_s": float, "pool_free": int,
             "pool_used": int, "pool_high_water": int, "waiting": int,
             "prefilling": int, "running": int},
    # first execution of a jitted shape (trace + compile + first run)
    "compile": {"fn": str, "seconds": float},
    # ---- sampled selection-quality probe (one event per probed layer) ----
    "probe": {"iter": int, "layer": int, "requests": int, "static_k": int,
              "recall": float, "budget_utilization": float,
              "forced_share": float, "selected_mean": float,
              "budget_mean": float},
    # ---- profiler lifecycle ----------------------------------------------
    "profile_start": {"dir": str, "steps": int},
    "profile_stop": {"dir": str},
    # ---- prefix cache (v2) -----------------------------------------------
    # admission-time match result (one per admission when the cache is on)
    "cache_hit": {"rid": int, "cached_tokens": int, "prompt_tokens": int,
                  "shared_blocks": int},
    "cache_miss": {"rid": int, "prompt_tokens": int},
    # a request's committed pages adopted by the radix index
    "page_share": {"rid": int, "blocks": int, "tail": bool},
    # copy-on-write un-share: ``block`` cloned into ``clone``, first
    # ``keep_tokens`` rows kept, the rest scrubbed to init fill
    "cow_copy": {"rid": int, "block": int, "clone": int,
                 "keep_tokens": int},
    # LRU reclamation of tree-only pages (the first eviction tier)
    "cache_evict": {"blocks": int, "remaining_blocks": int},
}

_V2_EVENTS = ("cache_hit", "cache_miss", "page_share", "cow_copy",
              "cache_evict")

# v1, frozen: no prefix-cache events, no trace_start.prefix_cache field.
EVENT_SCHEMA_V1: Dict[str, Dict[str, type]] = {
    ev: dict(fields) for ev, fields in EVENT_SCHEMA.items()
    if ev not in _V2_EVENTS}
EVENT_SCHEMA_V1["trace_start"] = {
    k: v for k, v in EVENT_SCHEMA["trace_start"].items()
    if k != "?prefix_cache"}

SUPPORTED_SCHEMAS: Dict[int, Dict[str, Dict[str, type]]] = {
    1: EVENT_SCHEMA_V1, 2: EVENT_SCHEMA}


def sanitize(obj: Any) -> Any:
    """Recursively replace non-finite floats with ``None`` (JSON has no
    NaN/Infinity; the non-strict tokens Python emits by default are
    rejected by every compliant parser)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def strict_dumps(obj: Any, **kw) -> str:
    """``json.dumps`` with non-finite floats as ``null`` — never the
    non-strict ``NaN``/``Infinity`` tokens."""
    return json.dumps(sanitize(obj), allow_nan=False, **kw)


def _reject_constant(tok: str):
    raise ValueError(
        f"non-strict JSON token {tok!r} (NaN/Infinity must be serialized "
        "as null — see repro_torch.serving.obs.events.sanitize)")


def strict_loads(s: str) -> Any:
    """``json.loads`` rejecting the non-strict ``NaN``/``Infinity`` tokens."""
    return json.loads(s, parse_constant=_reject_constant)


def _type_ok(value: Any, spec: type) -> bool:
    if spec is float:
        # JSON has one number type; None is a sanitized non-finite float
        return value is None or (isinstance(value, (int, float))
                                 and not isinstance(value, bool))
    if spec is int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, spec)


def validate_event(event: Dict[str, Any], version: int = SCHEMA_VERSION,
                   ) -> None:
    """Raise ``ValueError`` unless ``event`` conforms to the schema of
    ``version`` (the current one by default — what the tracer enforces
    at emit time)."""
    schema = SUPPORTED_SCHEMAS[version]
    ev = event.get("ev")
    if ev not in schema:
        raise ValueError(f"unknown event type {ev!r} (schema v{version})")
    if not _type_ok(event.get("ts"), float) or event.get("ts") is None:
        raise ValueError(f"{ev}: missing/invalid ts: {event.get('ts')!r}")
    fields = schema[ev]
    known = {"ev", "ts"}
    for name, spec in fields.items():
        optional = name.startswith("?")
        name = name[1:] if optional else name
        known.add(name)
        if name not in event:
            if optional:
                continue
            raise ValueError(f"{ev}: missing field {name!r}")
        if not _type_ok(event[name], spec):
            raise ValueError(
                f"{ev}: field {name!r} expected {spec.__name__}, got "
                f"{event[name]!r}")
    extra = set(event) - known
    if extra:
        raise ValueError(f"{ev}: unknown fields {sorted(extra)}")


def validate_jsonl(lines: Iterable[str]) -> List[Dict[str, Any]]:
    """Validate a trace (an iterable of JSONL lines); returns the parsed
    events.  The first event must be a ``trace_start`` carrying a known
    schema version; every event then validates against **that** version's
    schema — a v1 trace stays valid, a v1 trace containing v2-only
    events does not.  Parsing is strict (no NaN tokens)."""
    events = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            event = strict_loads(line)
        except ValueError as e:
            raise ValueError(f"line {i + 1}: {e}") from None
        events.append(event)
    if not events:
        raise ValueError("empty trace")
    head = events[0]
    if head.get("ev") != "trace_start":
        raise ValueError(
            f"trace must open with trace_start, got {head.get('ev')!r}")
    version = head.get("schema")
    if version not in SUPPORTED_SCHEMAS:
        raise ValueError(
            f"unsupported trace schema {version} (this reader "
            f"understands {sorted(SUPPORTED_SCHEMAS)})")
    for event in events:
        validate_event(event, version=version)
    return events
