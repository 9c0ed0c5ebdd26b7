"""Latency recording surfaces: percentile windows and fixed-bucket histograms.

A copy of ``sudoku_solver_distributed_tpu/obs/histo.py``: one recording
machinery for every latency number the node exposes (``utils/profiling.
RequestMetrics`` is an alias of ``RouteMetrics``):

  * ``LatencyWindow`` — bounded ring of recent samples with percentile
    summaries (p50/p95/p99/max). Percentiles need raw samples; the ring
    bounds memory. Every mutation AND every read of the shared window
    happens under the owner's lock — the window deques are shared across
    the HTTP handler threads, and an unlocked ``sorted(deque)`` while
    another thread appends is a shared-mutable hazard.
  * ``Histogram`` — fixed log-spaced cumulative buckets, the Prometheus
    exposition shape (``_bucket{le=...}`` / ``_sum`` / ``_count``). O(1)
    memory, mergeable by scrape, no sorting on any path.
  * ``RouteMetrics`` — per-route request recorder (count/errors/shed +
    a LatencyWindow), the ``/metrics`` JSON route blocks.
  * ``StageMetrics`` — per-stage recorder (window + histogram under one
    lock) for the request-lifecycle tracer (obs/trace.py): cache, queue,
    coalesce, device, verify, fallback, total.

All critical sections are a few list/int ops — no I/O, no device work,
no sleeps under any lock.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

# Log-spaced defaults in milliseconds: sub-ms coalescer waits through
# multi-second degraded-fallback solves all land in a resolvable bucket.
DEFAULT_BOUNDS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


def pct(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class LatencyWindow:
    """Bounded sample ring. NOT self-locking: the owner serializes access
    (RouteMetrics/StageMetrics hold one lock across their whole record or
    summary step, so window append and window sort can never interleave)."""

    __slots__ = ("_vals",)

    def __init__(self, window: int = 2048):
        self._vals: deque = deque(maxlen=window)

    def add(self, seconds: float) -> None:
        self._vals.append(seconds)

    def __len__(self) -> int:
        return len(self._vals)

    def summary_ms(self) -> Dict[str, float]:
        vals = sorted(self._vals)
        return {
            "p50_ms": round(pct(vals, 0.50) * 1e3, 3),
            "p95_ms": round(pct(vals, 0.95) * 1e3, 3),
            "p99_ms": round(pct(vals, 0.99) * 1e3, 3),
            "max_ms": round((vals[-1] if vals else 0.0) * 1e3, 3),
        }


class Histogram:
    """Prometheus-shaped fixed-bucket histogram (bounds in ms). NOT
    self-locking, same owner contract as LatencyWindow."""

    __slots__ = ("bounds_ms", "counts", "sum_ms", "count")

    def __init__(self, bounds_ms: Tuple[float, ...] = DEFAULT_BOUNDS_MS):
        self.bounds_ms = bounds_ms
        self.counts = [0] * (len(bounds_ms) + 1)  # last = +Inf
        self.sum_ms = 0.0
        self.count = 0

    def add(self, seconds: float) -> None:
        ms = seconds * 1e3
        # first bound >= ms (one C-level bisect, not a Python scan —
        # this runs several times per request on the serving path)
        self.counts[bisect_left(self.bounds_ms, ms)] += 1
        self.sum_ms += ms
        self.count += 1

    def snapshot(self) -> dict:
        """{"bounds_ms", "counts" (per-bucket, not cumulative), "sum_ms",
        "count"} — obs/prom.py renders the cumulative form."""
        return {
            "bounds_ms": list(self.bounds_ms),
            "counts": list(self.counts),
            "sum_ms": round(self.sum_ms, 3),
            "count": self.count,
        }

    def quantile_ms(self, q: float) -> float:
        """Bucket-interpolated quantile (the Prometheus histogram_quantile
        estimate): O(buckets), no sample sort, so a reader on an event
        loop never sorts a sample window. Resolution is bucket-width; the
        exact window percentiles stay on the pull-based ``/metrics``
        route."""
        if self.count == 0:
            return 0.0
        rank = max(0.0, min(1.0, q)) * self.count
        cum = 0
        lower = 0.0
        for i, upper in enumerate(self.bounds_ms):
            prev = cum
            cum += self.counts[i]
            if cum >= rank and self.counts[i]:
                frac = (rank - prev) / self.counts[i]
                return round(lower + (upper - lower) * frac, 3)
            lower = upper
        # +Inf bucket has no upper edge: clamp to the largest finite bound
        return round(self.bounds_ms[-1], 3)


class RouteMetrics:
    """Per-route latency recorder — the ``/metrics`` route blocks.

    ``utils/profiling.RequestMetrics`` is an alias of this class. The
    percentile window and counters sit behind ONE lock for both mutation
    and read under the HTTP handler threads.
    """

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self._lat: Dict[str, LatencyWindow] = {}
        self._count: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}

    def record(
        self,
        route: str,
        seconds: float,
        error: bool = False,
        shed: bool = False,
    ) -> None:
        """``shed`` marks an admission 429 (serving/admission.py): counted
        separately from ``errors`` — a shed is the overload control plane
        WORKING, and lumping it with malformed-body 400s would make the
        error rate useless as an alarm exactly when traffic is heaviest.
        Shed replies still land in the latency window (they are real
        responses the client waited for — microseconds, which is the
        point)."""
        with self._lock:
            if route not in self._lat:
                self._lat[route] = LatencyWindow(self._window)
                self._count[route] = 0
                self._errors[route] = 0
                self._shed[route] = 0
            self._lat[route].add(seconds)
            self._count[route] += 1
            if error:
                self._errors[route] += 1
            if shed:
                self._shed[route] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{route: {count, errors, shed, p50_ms, p95_ms, p99_ms, max_ms}}."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for route, window in self._lat.items():
                entry: Dict[str, float] = {
                    "count": self._count[route],
                    "errors": self._errors[route],
                    "shed": self._shed[route],
                }
                entry.update(window.summary_ms())
                out[route] = entry
            return out

    def counts(self) -> Dict[str, Dict[str, int]]:
        """{route: {count, errors, shed}} — counters only, NO window
        sort: a reader on an event loop needs just these sums, and
        ``summary()`` sorts every route's window."""
        with self._lock:
            return {
                route: {
                    "count": self._count[route],
                    "errors": self._errors[route],
                    "shed": self._shed[route],
                }
                for route in self._count
            }


class StageMetrics:
    """Per-stage latency recorder for the request-lifecycle tracer: each
    stage owns a percentile window (the ``/metrics`` JSON block) and a
    fixed-bucket histogram (the Prometheus exposition) fed by the same
    ``observe`` call, under one lock."""

    def __init__(
        self,
        window: int = 1024,
        bounds_ms: Tuple[float, ...] = DEFAULT_BOUNDS_MS,
    ):
        self._lock = threading.Lock()
        self._window = window
        self._bounds_ms = bounds_ms
        self._win: Dict[str, LatencyWindow] = {}
        self._hist: Dict[str, Histogram] = {}

    def observe(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._observe_locked(stage, seconds)

    def observe_span(self, stages: dict, total_s: float) -> None:
        """Fold one finished span's whole stage dict plus its total under
        ONE lock acquisition — the tracer's per-request hot path (five
        separate observe() round trips measurably contend at transport
        rates)."""
        with self._lock:
            self._observe_locked("total", total_s)
            for stage, seconds in stages.items():
                self._observe_locked(stage, seconds)

    def _observe_locked(self, stage: str, seconds: float) -> None:
        w = self._win.get(stage)
        if w is None:
            w = self._win[stage] = LatencyWindow(self._window)
            self._hist[stage] = Histogram(self._bounds_ms)
        w.add(seconds)
        self._hist[stage].add(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, sum_ms, p50_ms, p95_ms, p99_ms, max_ms}} — the
        ``obs.stages`` block of ``GET /metrics``."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for stage in sorted(self._win):
                h = self._hist[stage]
                entry: Dict[str, float] = {
                    "count": h.count,
                    "sum_ms": round(h.sum_ms, 3),
                }
                entry.update(self._win[stage].summary_ms())
                out[stage] = entry
            return out

    def histograms(self) -> Dict[str, dict]:
        """{stage: Histogram.snapshot()} for the Prometheus renderer."""
        with self._lock:
            return {s: h.snapshot() for s, h in sorted(self._hist.items())}

    def digest_quantiles(
        self, stage: str, qs: Sequence[float] = (0.5, 0.99)
    ) -> Tuple[float, ...]:
        """Histogram-estimated quantiles (ms) for one stage. O(buckets)
        per quantile and no window sort; an unseen stage reads as
        all-zeros."""
        with self._lock:
            h = self._hist.get(stage)
            if h is None:
                return tuple(0.0 for _ in qs)
            return tuple(h.quantile_ms(q) for q in qs)
