"""SLO burn-rate engine: is the latency objective holding RIGHT NOW?

A copy of ``sudoku_solver_distributed_tpu/obs/slo.py``. It evaluates
declarative objectives against the tracer's stage histograms the way an
SRE alert would — multi-window burn rates — instead of leaving the
operator to eyeball p99 graphs.

An objective is declared as ``NAME=THRESHOLD_MS@OBJECTIVE_PCT``
(CLI ``--slo``, repeatable)::

    latency_p99_ms=500@99.9        # 99.9% of requests under 500 ms
    device_latency_p99_ms=50@99    # 99% of requests' device stage < 50 ms

``NAME`` is ``[<stage>_]latency_p<anything>_ms``; the stage prefix picks
the StageMetrics histogram ("total" when absent). The error budget is
``1 - objective`` (99.9% → 0.1%). The engine samples each stage
histogram's (total, over-threshold) cumulative counts on a rate-limited
tick (Tracer.finish drives it — at most once per ``tick_interval_s``, a
monotonic compare per request otherwise), and a window's burn rate is::

    burn = (bad_delta / total_delta) / error_budget

i.e. burn 1.0 = spending budget exactly at the sustainable rate; burn
14.4 over 5 minutes = the classic "2% of a 30-day budget in one hour"
page. **Fast burn** fires when BOTH the short (5 m) and long (1 h)
windows exceed ``fast_burn_threshold`` — the standard multi-window
guard against paging on one bad scrape. (With less history than a
window, the window is whatever history exists: early in a run a
sustained breach still fires rather than waiting an hour to be
sure.) A fast-burn RISING EDGE records a flight-recorder event and
triggers the flight recorder's incident auto-dump — rate-limited exactly like
breaker trips — so the recorder becomes alert-triggered, not just
crash-triggered, and the dump carries the offending spans.

Over-threshold counts are read from the histogram's fixed buckets: a
request is counted "good" when it landed in a bucket whose upper bound
is ≤ the threshold — i.e. the threshold is effectively rounded DOWN to
a bucket bound, the conservative direction (never under-reports
burn). Choose thresholds on bucket bounds (obs/histo.DEFAULT_BOUNDS_MS)
for exact accounting.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .trace import STAGES as _SPAN_STAGES

logger = logging.getLogger(__name__)

_SLO_RE = re.compile(
    r"^(?:(?P<stage>[a-z]+)_)?latency_p[0-9.]+_ms"
    r"=(?P<threshold>[0-9.]+)@(?P<objective>[0-9.]+)$"
)

# the stages Tracer.finish actually records (obs/trace.STAGES) plus the
# whole-span "total" — the only histogram keys an objective can bind to
_KNOWN_STAGES = frozenset(_SPAN_STAGES) | {"total"}

# multi-window pair (seconds) and the page threshold: the Google SRE
# workbook's 5m/1h fast-burn alert shape
DEFAULT_WINDOWS_S = (300.0, 3600.0)
DEFAULT_FAST_BURN = 14.4


@dataclass(frozen=True)
class SloObjective:
    name: str           # the declaration string's left-hand side
    stage: str          # StageMetrics histogram key ("total", "device", …)
    threshold_ms: float
    objective_pct: float

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.objective_pct / 100.0)


def parse_slo(spec: str) -> SloObjective:
    """``latency_p99_ms=500@99.9`` → SloObjective. ValueError on
    malformed specs (the CLI surfaces it at startup, not mid-window)."""
    m = _SLO_RE.match(spec.strip())
    if m is None:
        raise ValueError(
            f"malformed --slo {spec!r} (want "
            f"[stage_]latency_pNN_ms=THRESHOLD_MS@OBJECTIVE_PCT, e.g. "
            f"latency_p99_ms=500@99.9)"
        )
    threshold = float(m.group("threshold"))
    objective = float(m.group("objective"))
    if not 0.0 < objective < 100.0:
        raise ValueError(
            f"--slo objective must be in (0, 100), got {objective}"
        )
    if threshold <= 0.0:
        raise ValueError(f"--slo threshold must be positive, got {threshold}")
    stage = m.group("stage") or "total"
    if stage not in _KNOWN_STAGES:
        # a typo'd stage ("devcie_") would otherwise boot cleanly and
        # read an empty histogram forever — an alerting plane that can
        # never fire. Malformed specs fail the BOOT, not a later run.
        raise ValueError(
            f"--slo stage {stage!r} is not a span stage "
            f"(known: {sorted(_KNOWN_STAGES)})"
        )
    return SloObjective(
        name=spec.split("=", 1)[0],
        stage=stage,
        threshold_ms=threshold,
        objective_pct=objective,
    )


def good_bad_counts(hist_snap: dict, threshold_ms: float) -> Tuple[int, int]:
    """(total, bad) from one Histogram.snapshot(): ``bad`` = requests in
    buckets whose upper bound exceeds the threshold (threshold rounded
    down to a bound — conservative, see module docstring)."""
    bounds = hist_snap["bounds_ms"]
    counts = hist_snap["counts"]
    k = bisect_right(bounds, threshold_ms)
    good = sum(counts[:k])
    total = hist_snap["count"]
    return total, total - good


class SloEngine:
    """Evaluates objectives against a StageMetrics' histograms over
    rolling sample windows.

    Args:
      stages: the tracer's obs/histo.StageMetrics (cumulative histograms).
      objectives: parsed SloObjective list.
      recorder: optional obs/flight.FlightRecorder — fast-burn rising
        edges land in its event ring and trigger the incident auto-dump
        (rate-limited there, exactly like breaker trips).
      windows_s: (short, long) burn windows; fast burn requires BOTH.
      fast_burn_threshold: the page bar (x budget rate).
      tick_interval_s: sample cadence floor — Tracer.finish calls
        ``maybe_tick`` per request; all but ~1/s return on a monotonic
        compare.
    """

    def __init__(
        self,
        stages,
        objectives: List[SloObjective],
        *,
        recorder=None,
        windows_s: Tuple[float, float] = DEFAULT_WINDOWS_S,
        fast_burn_threshold: float = DEFAULT_FAST_BURN,
        tick_interval_s: float = 1.0,
    ):
        if not objectives:
            raise ValueError("SloEngine needs at least one objective")
        self.stages = stages
        self.objectives = list(objectives)
        self.recorder = recorder
        self.windows_s = tuple(sorted(windows_s))
        self.fast_burn_threshold = fast_burn_threshold
        self.tick_interval_s = tick_interval_s
        self._lock = threading.Lock()
        # (t_monotonic, ((total, bad), ...) per objective); ring sized to
        # cover the long window at the tick cadence with slack
        depth = int(self.windows_s[-1] / max(tick_interval_s, 0.1)) + 16
        self._samples: deque = deque(maxlen=depth)
        self._next_tick = 0.0
        self._active: Dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self.ticks = 0
        self.fast_burn_events = 0
        # burn-edge listeners: ``fn(active: bool)`` called
        # OUTSIDE the engine lock on every ANY-objective fast-burn edge
        # — rising AND falling — so control loops (the autopilot's
        # burn-aware admission tightening) are event-driven instead of
        # sampling the gauge and missing a short excursion
        self._listeners: List = []
        self._global_active = False

    def add_burn_listener(self, fn) -> None:
        """Register ``fn(active: bool)`` for fast-burn edges (both
        directions). Called outside the engine lock — a listener may
        take its own lock (the autopilot does); never call back into
        this engine from one."""
        with self._lock:
            self._listeners.append(fn)

    def remove_burn_listener(self, fn) -> None:
        """Unregister a burn listener (Autopilot.close — a retired
        control loop must stop steering admission; idempotent)."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    # -- sampling ------------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> None:
        """Rate-limited sample+evaluate — the Tracer.finish hook. All but
        one call per ``tick_interval_s`` cost a monotonic read and a
        float compare."""
        now = time.monotonic() if now is None else now
        if now < self._next_tick:
            return
        self.tick(now)

    def tick(self, now: Optional[float] = None) -> None:
        """Take one sample of every objective's (total, bad) cumulative
        counts and re-evaluate burn rates."""
        now = time.monotonic() if now is None else now
        hists = self.stages.histograms()
        counts = tuple(
            good_bad_counts(
                hists.get(
                    o.stage,
                    {"bounds_ms": (), "counts": [0], "count": 0},
                ),
                o.threshold_ms,
            )
            for o in self.objectives
        )
        fired: List[dict] = []
        edge: Optional[bool] = None
        listeners: List = []
        with self._lock:
            self._next_tick = now + self.tick_interval_s
            self._samples.append((now, counts))
            self.ticks += 1
            for i, obj in enumerate(self.objectives):
                burns = {
                    w: self._burn_locked(i, obj, w, now)
                    for w in self.windows_s
                }
                fast = all(
                    b is not None and b >= self.fast_burn_threshold
                    for b in burns.values()
                )
                was = self._active[obj.name]
                self._active[obj.name] = fast
                if fast and not was:
                    self.fast_burn_events += 1
                    fired.append(
                        {
                            "slo": obj.name,
                            "stage": obj.stage,
                            "threshold_ms": obj.threshold_ms,
                            "objective_pct": obj.objective_pct,
                            "burn": {
                                f"{int(w)}s": round(b, 2)
                                for w, b in burns.items()
                                if b is not None
                            },
                            "fast_burn_threshold": (
                                self.fast_burn_threshold
                            ),
                        }
                    )
            now_active = any(self._active.values())
            if now_active != self._global_active:
                self._global_active = now_active
                edge = now_active
                listeners = list(self._listeners)
        # recorder work OUTSIDE the engine lock (trigger_incident takes
        # the recorder's own lock)
        for detail in fired:
            logger.warning("SLO fast burn: %s", detail)
            if self.recorder is not None:
                self.recorder.note_event("slo-fast-burn", detail)
                self.recorder.trigger_incident("slo-fast-burn")
        if edge is not None:
            # burn-edge listeners, also outside the lock (they take
            # their own locks — the autopilot tightens admission here)
            for fn in listeners:
                try:
                    fn(edge)
                except Exception:  # a control hook must not kill sampling
                    logger.exception("slo burn listener failed")

    def _burn_locked(
        self, idx: int, obj: SloObjective, window_s: float, now: float
    ) -> Optional[float]:
        """Burn rate over the window ending now, or None with <2 samples.
        With less history than the window, the whole history IS the
        window (see module docstring)."""
        if len(self._samples) < 2:
            return None
        newest_t, newest = self._samples[-1]
        anchor = None
        for t, counts in self._samples:
            if t >= now - window_s:
                anchor = (t, counts)
                break
        if anchor is None or anchor[0] >= newest_t:
            anchor = self._samples[0]
            if anchor[0] >= newest_t:
                return None
        d_total = newest[idx][0] - anchor[1][idx][0]
        d_bad = newest[idx][1] - anchor[1][idx][1]
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / obj.error_budget

    # -- reporting -----------------------------------------------------------
    def fast_burn_active(self) -> bool:
        with self._lock:
            return any(self._active.values())

    def snapshot(self) -> dict:
        """The ``slo`` block of ``GET /metrics`` (numbers flatten into
        prom gauges via obs/prom.render): per-objective burn rates per
        window, the fast-burn gauge, and cumulative totals."""
        self.maybe_tick()  # a scrape gets a fresh evaluation
        now = time.monotonic()
        with self._lock:
            out: dict = {
                "fast_burn_threshold": self.fast_burn_threshold,
                "windows_s": list(self.windows_s),
                "ticks": self.ticks,
                "fast_burn_events": self.fast_burn_events,
                "fast_burn_active": any(self._active.values()),
                "objectives": {},
            }
            newest = self._samples[-1] if self._samples else None
            for i, obj in enumerate(self.objectives):
                entry: dict = {
                    "stage": obj.stage,
                    "threshold_ms": obj.threshold_ms,
                    "objective_pct": obj.objective_pct,
                    "fast_burn": self._active[obj.name],
                }
                if newest is not None:
                    total, bad = newest[1][i]
                    entry["total"] = total
                    entry["bad"] = bad
                for w in self.windows_s:
                    b = self._burn_locked(i, obj, w, now)
                    entry[f"burn_{int(w)}s"] = (
                        round(b, 3) if b is not None else None
                    )
                out["objectives"][obj.name] = entry
            return out
