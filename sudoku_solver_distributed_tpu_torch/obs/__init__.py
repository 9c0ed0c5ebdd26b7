"""Observability plane: request spans, device cost, SLOs, incident records.

The port of ``sudoku_solver_distributed_tpu/obs/``, each module a copy of
the JAX package's:

  trace.py   request-lifecycle spans (cache → queue → coalesce → device →
             verify → fallback), the ``X-Timing`` header's source
  histo.py   one latency-recording machinery for routes and stages
  cost.py    per-bucket and per-segment device cost (``engine.cost``)
  slo.py     declarative latency objectives as multi-window burn rates
  flight.py  the always-on incident flight recorder
  export.py  the span ring as Perfetto-loadable trace-event JSON
  prom.py    Prometheus text exposition of the ``/metrics`` body
  cluster.py the fleet view: each node's telemetry digest on the stats
             gossip (``TelemetryPublisher``) and ``/metrics/cluster``

On by default in the CLI (net/cli.py; ``--no-obs`` turns the tracer, the
flight recorder and the SLO engine off — the ``X-Request-Id`` header
stays).
"""

from .cost import CostAccounting
from .flight import FlightRecorder
from .histo import Histogram, LatencyWindow, RouteMetrics, StageMetrics
from .slo import SloEngine, SloObjective, parse_slo
from .trace import (
    STAGES,
    RequestTrace,
    Tracer,
    current_trace,
    new_request_id,
    valid_request_id,
)

__all__ = [
    "CostAccounting",
    "FlightRecorder",
    "Histogram",
    "LatencyWindow",
    "RouteMetrics",
    "SloEngine",
    "SloObjective",
    "StageMetrics",
    "STAGES",
    "RequestTrace",
    "Tracer",
    "current_trace",
    "new_request_id",
    "parse_slo",
    "valid_request_id",
]
