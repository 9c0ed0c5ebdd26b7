"""Prometheus text exposition (format 0.0.4) for the /metrics surface.

A copy of ``sudoku_solver_distributed_tpu/obs/prom.py``. One renderer,
called through the shared route core (net/http_api.metrics_prom_payload),
so ``GET /metrics.prom`` and ``GET /metrics?format=prom`` are
byte-identical.

Mapping rules (deterministic: insertion-order walk of the same dict the
JSON ``/metrics`` body serializes, so the two expositions agree by
construction):

  * top-level keys starting with "/" are the per-route blocks
    (obs/histo.RouteMetrics.summary): numeric fields become
    ``<prefix>_route_<field>{route="/solve"}``;
  * every other numeric leaf flattens by path:
    ``{"admission": {"pending": 3}}`` → ``<prefix>_admission_pending 3``
    (booleans render 1/0);
  * string leaves become info-style gauges:
    ``{"health": {"state": "degraded"}}`` →
    ``<prefix>_health_state_info{value="degraded"} 1`` — the state is a
    label, so a scrape can alert on it without parsing free text;
  * lists (transition logs, bucket ladders) are skipped: they are debug
    detail, not time series;
  * stage histograms (obs/histo.StageMetrics.histograms) render as real
    Prometheus histograms: cumulative ``_bucket{stage=...,le=...}``
    rows, ``_sum`` and ``_count``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _name(*parts: str) -> str:
    out = "_".join(_NAME_BAD.sub("_", p).strip("_") or "x" for p in parts)
    if out[0].isdigit():
        out = "_" + out
    return out


def _label(value: str) -> str:
    """Escape a label value per the exposition format."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _num(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def _walk(lines, path, value):
    if isinstance(value, bool) or isinstance(value, (int, float)):
        lines.append(f"{_name(*path)} {_num(value)}")
    elif isinstance(value, str):
        lines.append(f'{_name(*path)}_info{{value="{_label(value)}"}} 1')
    elif isinstance(value, dict):
        for k, v in value.items():
            _walk(lines, path + (str(k),), v)
    # lists / None: not a time series — skipped on purpose


def render(
    body: dict,
    histograms: Optional[Dict[str, dict]] = None,
    prefix: str = "sudoku",
) -> str:
    """Render the ``/metrics`` JSON body (+ optional stage histograms)
    as Prometheus text. Ends with a newline, as the format requires."""
    lines: list = []
    for key, value in body.items():
        if key.startswith("/") and isinstance(value, dict):
            route = _label(key)
            for field, v in value.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lines.append(
                        f'{prefix}_route_{_name(field)}'
                        f'{{route="{route}"}} {_num(v)}'
                    )
        else:
            _walk(lines, (prefix, str(key)), value)
    if histograms:
        family = f"{prefix}_stage_latency_ms"
        lines.append(f"# TYPE {family} histogram")
        for stage, snap in histograms.items():
            label = _label(stage)
            cum = 0
            for bound, count in zip(snap["bounds_ms"], snap["counts"]):
                cum += count
                lines.append(
                    f'{family}_bucket{{stage="{label}",le="{bound:g}"}} {cum}'
                )
            cum += snap["counts"][-1]
            lines.append(
                f'{family}_bucket{{stage="{label}",le="+Inf"}} {cum}'
            )
            lines.append(
                f'{family}_sum{{stage="{label}"}} {_num(snap["sum_ms"])}'
            )
            lines.append(
                f'{family}_count{{stage="{label}"}} {snap["count"]}'
            )
    return "\n".join(lines) + "\n"
