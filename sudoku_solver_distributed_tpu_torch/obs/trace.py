"""Request-lifecycle spans: where each millisecond of a request went.

A copy of ``sudoku_solver_distributed_tpu/obs/trace.py``. A
``RequestTrace`` opens at transport ingress (net/http_api.py) and is
carried through the serving stack by a *thread-local*, not by threading a
parameter through every signature: the handler thread that opens the span
is the thread that submits to the coalescer, runs inline/fallback/verify
work, and awaits the future — so ``current_trace()`` is correct
everywhere the request's own code runs, and the coalescer's threads
(which are NOT the request's thread) stamp batch-level stages through the
explicit ``trace`` slot each queued request carries
(parallel/coalescer.py).

Stages (all cumulative milliseconds in the finished record):

  cache_ms     front-door answer-cache consult (canonicalize + lookup)
  queue_ms     coalescer-queue wait, submit → batch formation
  coalesce_ms  batch formation: stack/pad + device enqueue
  device_ms    device dispatch → rows on the host, host clock (the same
               span the engine's cost plane bills as ``device_s``)
  verify_ms    host-side answer verification (serving/health.py contract)
  fallback_ms  host-oracle fallback solve while DEGRADED/LOST
  total_ms     ingress → response composed

Write-visibility contract: coalescer threads stamp a request's stages
strictly BEFORE resolving its future, and the handler thread reads them
strictly AFTER the future resolves — the future is the happens-before
edge, so ``finish`` never reads a half-written stage.

``Tracer.finish`` is the single folding point: stage histograms
(obs/histo.StageMetrics → ``/metrics`` JSON + Prometheus), the flight
recorder ring (obs/flight.py), and the record returned to the transport
for the opt-in ``X-Timing`` response header. Cost per request is a dict,
a handful of float subtractions, and a few locked int ops.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import threading
import time
from typing import Optional

from .histo import RouteMetrics, StageMetrics

logger = logging.getLogger(__name__)

# stage keys every finished record carries (absent stages render 0.0 so
# the X-Timing header and flight-recorder rows have a fixed shape).
# "cache" leads because the front-door answer-cache consult
# (net/http_api.py) happens before a request ever queues — the export
# timeline lays stages in this order
STAGES = ("cache", "queue", "coalesce", "device", "verify", "fallback")

# the fixed field order of a finished span record — the flight recorder
# stores records as flat tuples in THIS order (a tuple of atomics is
# untracked by CPython's GC, so a 2048-deep ring adds zero objects to
# every gen2 collection; a ring of dicts measurably stalls the serving
# path at transport rates) and rebuilds dicts only at dump time
RECORD_FIELDS = (
    "trace_id", "route", "t", "status", "total_ms",
    "cache_ms", "queue_ms", "coalesce_ms", "device_ms", "verify_ms",
    "fallback_ms",
    "bucket", "batch_id", "degraded", "fallback", "farmed", "segments",
)

_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")

_tls = threading.local()

# id minting: a per-process random prefix + a monotone counter. One
# urandom read per process instead of per request (an os.urandom syscall
# is ~10 us — measurable serving cost at the rates the transport reaches)
# while staying collision-safe across processes and unguessable enough
# for correlation ids (they are identifiers, not secrets). count() is a
# single C-level step — safe under concurrent transport workers.
_ID_PREFIX = os.urandom(6).hex()
_ID_SEQ = itertools.count(1)


def current_trace() -> Optional["RequestTrace"]:
    """The span opened by this thread's in-flight request, or None.

    The seam every instrumented layer reads (coalescer submit, engine
    verify/device marks, supervisor fallback marks) — zero-cost when no
    tracer is attached, because nothing ever set it.
    """
    return getattr(_tls, "trace", None)


def new_request_id() -> str:
    """Process-unique hex id: 12 random chars + an 8-hex sequence —
    header/wire-safe by construction, sub-microsecond to mint."""
    return f"{_ID_PREFIX}{next(_ID_SEQ) & 0xFFFFFFFF:08x}"


def valid_request_id(raw) -> Optional[str]:
    """A client-supplied ``X-Request-Id`` (or wire-carried trace id),
    sanitized: 1-64 chars of [A-Za-z0-9._-], else None. The charset
    bound is the header-injection/wire-ingress guard — a hostile id must
    never carry CR/LF into a response head or garbage into the ring."""
    if isinstance(raw, bytes):
        try:
            raw = raw.decode("ascii")
        except UnicodeDecodeError:
            return None
    if isinstance(raw, str) and _ID_RE.fullmatch(raw):
        # fullmatch, not match-with-$: '$' accepts a trailing newline,
        # which would defeat exact-id correlation and the injection guard
        return raw
    return None


class RequestTrace:
    """One request's span: monotonic anchor, stage accumulators, tags."""

    __slots__ = (
        "trace_id", "route", "t0", "t_wall", "stages",
        "bucket", "batch_id", "degraded", "fallback", "farmed", "segments",
    )

    def __init__(self, trace_id: str, route: str):
        self.trace_id = trace_id
        self.route = route
        self.t0 = time.monotonic()
        self.t_wall = time.time()  # timeline anchor for the flight record
        self.stages: dict = {}
        self.bucket: Optional[int] = None
        self.batch_id: Optional[int] = None
        self.degraded = False
        self.fallback = False
        # continuous-batching segments this request's device stage spans:
        # the coalescer's segment loop increments it per
        # boundary and device_ms accumulates across them (mark() sums),
        # so one request's device span legitimately covers many segments
        self.farmed = False
        self.segments = 0

    def mark(self, stage: str, seconds: float) -> None:
        """Accumulate stage time (a /solve_batch span sums its chunks'
        device calls; a retried stage sums its attempts)."""
        if seconds < 0.0:
            seconds = 0.0
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds


class Tracer:
    """Factory + sink for request spans.

    Args:
      recorder: optional obs/flight.FlightRecorder — every finished span
        lands in its ring, and 429s feed its shed-storm trigger.
      window / bounds_ms: stage-metrics sizing (obs/histo.StageMetrics).

    ``routes`` is the per-route request recorder (the ``/metrics`` route
    blocks) — the node's ``metrics`` attribute points AT it when the
    tracing plane is on (net/cli.py), so route latency and stage latency
    share one recording machinery instead of two parallel ones.
    """

    def __init__(self, *, recorder=None, window: int = 1024, bounds_ms=None):
        from .histo import DEFAULT_BOUNDS_MS

        self.recorder = recorder
        self.stages = StageMetrics(
            window=window, bounds_ms=bounds_ms or DEFAULT_BOUNDS_MS
        )
        self.routes = RouteMetrics()
        # SLO burn-rate engine (obs/slo.py): when attached,
        # finish() drives its rate-limited sampler — the engine needs a
        # heartbeat that exists exactly when requests do, and all but ~1
        # call per second return on a monotonic compare
        self.slo = None
        # benign int races, like the coalescer's high-water marks: these
        # are monotone counters read only by /metrics, and a lock here
        # would sit on every request's hot path purely to make a debug
        # number exact
        self.started = 0
        self.finished = 0

    # -- span lifecycle ----------------------------------------------------
    def start(self, route: str, trace_id: Optional[str] = None) -> RequestTrace:
        """Open a span and install it as this thread's current trace.
        ``trace_id`` is the (already validated) client/wire id; absent →
        a fresh one."""
        trace = RequestTrace(trace_id or new_request_id(), route)
        _tls.trace = trace
        self.started += 1  # benign race (see __init__)
        return trace

    def finish(
        self,
        trace: Optional[RequestTrace],
        status: int = 200,
        *,
        degraded: bool = False,
    ) -> Optional[dict]:
        """Close a span: fold stage times into the histograms, append the
        record to the flight-recorder ring, clear the thread-local, and
        return the record (the transport's X-Timing source). None in,
        None out — transports call this unconditionally."""
        if trace is None:
            return None
        if getattr(_tls, "trace", None) is trace:
            _tls.trace = None
        total_s = time.monotonic() - trace.t0
        if degraded:
            trace.degraded = True
        # snapshot the stage dict ONCE: a starved-then-fallback-served
        # request can be finished by its handler while the coalescer's
        # completer belatedly stamps the hung call's device time (the
        # stamp-before-resolve ordering only covers delivered futures) —
        # iterating the live dict there would be a concurrent-mutation
        # crash; with a snapshot the late stamp is simply not recorded
        stages = dict(trace.stages)
        # insertion order MUST stay RECORD_FIELDS order: the flight
        # recorder flattens this dict positionally (record_span)
        record = {
            "trace_id": trace.trace_id,
            "route": trace.route,
            "t": round(trace.t_wall, 6),
            "status": int(status),
            "total_ms": round(total_s * 1e3, 3),
        }
        for stage in STAGES:
            record[f"{stage}_ms"] = round(stages.get(stage, 0.0) * 1e3, 3)
        record["bucket"] = trace.bucket
        record["batch_id"] = trace.batch_id
        record["degraded"] = trace.degraded
        record["fallback"] = trace.fallback
        record["farmed"] = trace.farmed
        record["segments"] = trace.segments
        self.stages.observe_span(stages, total_s)
        self.finished += 1  # benign race (see __init__)
        if self.recorder is not None:
            self.recorder.record_span(record)
            if status == 429:
                self.recorder.note_shed()
        if self.slo is not None:
            try:
                self.slo.maybe_tick()
            except Exception:  # noqa: BLE001 — SLO eval must never fail a request
                logger.exception("SLO tick failed")
        return record

    # -- observability of the observability --------------------------------
    def snapshot(self) -> dict:
        """The ``obs`` block of ``GET /metrics``."""
        return {
            "started": self.started,
            "finished": self.finished,
            "stages": self.stages.summary(),
        }
