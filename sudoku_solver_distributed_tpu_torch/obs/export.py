"""Trace export: the span ring as Chrome trace-event JSON (Perfetto).

A copy of ``sudoku_solver_distributed_tpu/obs/export.py``. The flight
recorder holds the last N finished request spans as flat records with a
wall anchor, a total, and per-stage cumulative milliseconds. This module
assembles them into the Chrome trace-event format (the JSON Perfetto and
chrome://tracing load directly):

  * every span is a complete ("ph": "X") event on its own track;
  * its stages (cache → queue → coalesce → device → verify → fallback)
    render as child events laid out SEQUENTIALLY from the span's start in
    stage order — the record keeps durations, not start offsets, and the
    serving pipeline runs the stages in exactly that order, so the
    reconstruction is faithful for the common path and clearly labeled
    as stage spans either way;
  * spans sharing a ``trace_id`` share a track (tid), so spans of one
    request tree line up under one timeline;
  * request spans render under pid 1 ("serving"); pid 2
    ("farm-workers") holds ``farm-task`` spans, which only a node with
    peers records.

Timestamps are the records' wall-clock anchors in microseconds.

Served at ``GET /debug/trace`` (net/http_api.trace_export_route) and
embedded in every flight-recorder dump (obs/flight.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .trace import STAGES

_SERVING_PID = 1
_FARM_PID = 2


def span_events(record: dict, tid: int) -> List[dict]:
    """One span record → its trace events (parent + stage children)."""
    pid = _FARM_PID if record.get("route") == "farm-task" else _SERVING_PID
    ts0 = float(record.get("t") or 0.0) * 1e6  # wall seconds → us
    total_us = float(record.get("total_ms") or 0.0) * 1e3
    args = {
        "trace_id": record.get("trace_id"),
        "status": record.get("status"),
        "bucket": record.get("bucket"),
        "batch_id": record.get("batch_id"),
        "degraded": record.get("degraded"),
        "fallback": record.get("fallback"),
        "farmed": record.get("farmed"),
    }
    events = [
        {
            "name": record.get("route") or "?",
            "cat": "request",
            "ph": "X",
            "ts": ts0,
            "dur": total_us,
            "pid": pid,
            "tid": tid,
            "args": args,
        }
    ]
    cursor = ts0
    for stage in STAGES:
        dur_us = float(record.get(f"{stage}_ms") or 0.0) * 1e3
        if dur_us <= 0.0:
            continue
        events.append(
            {
                "name": stage,
                "cat": "stage",
                "ph": "X",
                "ts": cursor,
                "dur": dur_us,
                "pid": pid,
                "tid": tid,
                "args": {"trace_id": record.get("trace_id")},
            }
        )
        cursor += dur_us
    return events


def build_trace(
    spans: List[dict], trace_id: Optional[str] = None
) -> dict:
    """Assemble span records into one trace-event JSON document.

    ``trace_id`` filters to a single request tree; default is the whole
    ring. Spans sharing a trace id share a tid, so a master span and its
    farmed-cell spans nest visually; process/thread name metadata rows
    make the Perfetto sidebar readable.
    """
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    tids: Dict[str, int] = {}
    events: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": _SERVING_PID,
            "tid": 0,
            "args": {"name": "serving"},
        },
        {
            "name": "process_name",
            "ph": "M",
            "pid": _FARM_PID,
            "tid": 0,
            "args": {"name": "farm-workers"},
        },
    ]
    seen_tids = set()
    for record in spans:
        tr = str(record.get("trace_id") or "?")
        tid = tids.setdefault(tr, len(tids) + 1)
        pid = (
            _FARM_PID
            if record.get("route") == "farm-task"
            else _SERVING_PID
        )
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tr},
                }
            )
        events.extend(span_events(record, tid))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "sudoku_solver_distributed_tpu_torch obs/export.py",
            "spans": len(spans),
            "traces": len(tids),
        },
    }
