"""Load estimation for the overload control plane: event rates and the
adaptive coalescer wait policy they drive.

Two consumers (serving/admission.py, parallel/coalescer.py) need the same
cheap signal: "how fast are events happening right now?". ``EwmaRate`` is
that signal — an exponentially-weighted interarrival estimator updated in
O(1) under a lock held for a few float ops. Decay is applied at READ time
from the silence since the last event, so a stream that stops reports a
falling rate without any background timer thread.

``AdaptiveWaitPolicy`` scales the coalescer's three wait budgets
(max-wait, quiescence, burst cap) by one load factor derived from the
measured arrival rate:

  factor = min(1, expected arrivals within the configured max-wait)
         = min(1, arrival_rate × max_wait_cap)

  * idle (no co-rider expected inside the full budget): factor → 0, a lone
    request dispatches almost immediately;
  * loaded (≥1 co-rider expected): factor → 1, the full configured budgets
    apply and the burst-absorb machinery fills buckets as in fixed mode.

The factor is monotone non-decreasing in the observed rate, so turning
load up can only stretch the wait toward the cap, never oscillate it.

A stdlib-only copy of ``sudoku_solver_distributed_tpu/serving/load.py``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Tuple


class EwmaRate:
    """Event-rate estimator: EWMA of interarrival gaps + idle decay.

    ``observe()`` per event; ``rate()`` returns events/sec. Both O(1). The
    gap EWMA uses a time-constant weighting (older gaps decay by
    ``exp(-dt/tau)``), so one long pause doesn't need many subsequent
    events to be believed. While no events arrive, ``rate()`` blends the
    growing silence into the estimate, so the reported rate falls toward
    zero instead of freezing at the last busy-period value.
    """

    def __init__(self, tau_s: float = 1.0):
        if tau_s <= 0:
            raise ValueError("tau_s must be > 0")
        self.tau_s = tau_s
        self._lock = threading.Lock()
        self._gap_s: Optional[float] = None  # EWMA interarrival; None=no data
        self._last: Optional[float] = None   # monotonic time of last event

    def observe(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last is None:
                self._last = now
                return
            dt = max(now - self._last, 1e-9)
            self._last = now
            if self._gap_s is None:
                self._gap_s = dt
            else:
                alpha = 1.0 - math.exp(-dt / self.tau_s)
                self._gap_s += alpha * (dt - self._gap_s)

    def rate(self, now: Optional[float] = None, decay: bool = True) -> float:
        """Events per second (0.0 until two events have been seen).

        ``decay=True`` blends the silence since the last event into the
        estimate — right for ARRIVAL rates, where a stopped stream must
        read as idle. ``decay=False`` freezes the last busy-period value —
        right for CAPACITY estimates, where completions pause BECAUSE of
        shedding and a decaying denominator would turn one conservative
        decision into a self-sustaining shed storm."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._gap_s is None or self._last is None:
                return 0.0
            gap = self._gap_s
            if decay:
                # the silence since the last event is a lower bound on the
                # current gap: a stopped stream must read as a falling rate
                gap = max(gap, now - self._last)
            return 1.0 / gap


class WindowRate:
    """Two-bucket sliding-window event rate: counts, not gaps.

    Gap-EWMA estimators (EwmaRate) under-read bursty streams badly: a
    coalesced batch fans out its completions microseconds apart, and the
    time-constant weighting all but ignores the tiny gaps while fully
    believing the long inter-batch gap. Counting events per window is
    burst-exact and still O(1): the current bucket plus a linearly-faded
    previous bucket give a smooth sliding estimate.

    ``rate(frozen=True)`` is the CAPACITY read: it returns at least the
    slowly-decaying PEAK rate ever observed (half-life ``peak_half_life_s``)
    rather than the instantaneous estimate. The instantaneous completion
    rate tracks min(capacity, admitted rate) — once a controller starts
    shedding, completions trickle BECAUSE of the shedding, and a projection
    that followed the trickle would lock itself into shedding. The held
    peak is what the system has proven it can do; if capacity genuinely
    drops, the peak decays within minutes and the batch-formation expiry
    backstop bounds the optimism meanwhile.

    Cold start reads divide by the time actually covered, not the full
    window — 40 completions in the first 100 ms must read ~400/s, not
    40/window.
    """

    def __init__(self, window_s: float = 2.0, peak_half_life_s: float = 60.0):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.window_s = window_s
        self.peak_half_life_s = peak_half_life_s
        self._lock = threading.Lock()
        self._start: Optional[float] = None  # current bucket's epoch
        self._cur = 0
        self._prev = 0
        self._have_prev = False  # a full window has rolled at least once
        self._peak = 0.0
        self._peak_t: Optional[float] = None

    def _roll(self, now: float) -> None:
        if self._start is None:
            self._start = now
            return
        elapsed = now - self._start
        if elapsed < self.window_s:
            return
        # one whole window elapsed: the current bucket becomes history;
        # two or more: history is empty too
        self._prev = self._cur if elapsed < 2 * self.window_s else 0
        self._have_prev = True
        self._cur = 0
        self._start = now - (elapsed % self.window_s)

    def observe(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            self._roll(now)
            self._cur += 1

    def reanchor(self) -> None:
        """Forget everything — peak-hold included — and re-learn from the
        next events. The peak-hold exists so a shed storm can't decay the
        capacity estimate (see ``rate``); but when the capacity REGIME
        changes — the supervisor reroutes serving onto the host-oracle
        fallback, or re-admits the repaired device — the held peak is a
        measurement of hardware that is no longer serving, and waiting
        out its half-life means minutes of shedding against (or
        over-admitting into) a phantom device. The cold-start span
        normalization below re-reads the new regime within ~100 ms of
        traffic."""
        with self._lock:
            self._start = None
            self._cur = 0
            self._prev = 0
            self._have_prev = False
            self._peak = 0.0
            self._peak_t = None

    def _est(self, now: float) -> float:
        if self._start is None:
            # no events yet: a read must not set the epoch
            return 0.0
        self._roll(now)
        frac = (now - self._start) / self.window_s
        if not self._have_prev:
            # cold start: normalize by the span actually covered (floored
            # to dodge a divide-by-~zero burst right after the first event)
            span = max(now - self._start, 0.05 * self.window_s)
            return self._cur / span
        return (self._prev * (1.0 - frac) + self._cur) / self.window_s

    def rate(self, now: Optional[float] = None, frozen: bool = False) -> float:
        if now is None:
            now = time.monotonic()
        with self._lock:
            est = self._est(now)
            if est > 0.0 and (
                self._peak_t is None
                or est
                >= self._peak
                * 0.5 ** ((now - self._peak_t) / self.peak_half_life_s)
            ):
                self._peak = est
                self._peak_t = now
            if not frozen:
                return est
            peak = (
                self._peak
                * 0.5 ** ((now - self._peak_t) / self.peak_half_life_s)
                if self._peak_t is not None
                else 0.0
            )
            return max(est, peak)


class AdaptiveWaitPolicy:
    """Scales the coalescer's wait budgets with the measured arrival rate.

    Args:
      max_wait_s / quiescence_s / burst_wait_s: the CAPS — the same three
        knobs fixed mode uses, reached only under load (burst_wait_s
        defaults to 10× max_wait_s, the fixed-mode convention).
      tau_s: EWMA time constant for the arrival-rate estimator.

    ``on_arrival()`` is called by the coalescer once per submit;
    ``budgets()`` once per batch formation. Both are a few float ops.
    """

    def __init__(
        self,
        *,
        max_wait_s: float = 0.002,
        quiescence_s: float = 0.001,
        burst_wait_s: Optional[float] = None,
        tau_s: float = 1.0,
    ):
        if max_wait_s < 0 or quiescence_s < 0:
            raise ValueError("wait budgets must be >= 0")
        self.max_wait_s = max_wait_s
        self.quiescence_s = quiescence_s
        if burst_wait_s is None:
            burst_wait_s = 10.0 * max_wait_s
        self.burst_wait_s = max(burst_wait_s, max_wait_s)
        self.arrivals = EwmaRate(tau_s=tau_s)
        # last computed budget, for the stats block — written by the single
        # dispatcher thread, read racily by stats scrapes (staleness is
        # harmless)
        self.current_max_wait_s = 0.0

    def on_arrival(self) -> None:
        self.arrivals.observe()

    def load_factor(self, rate_hz: Optional[float] = None) -> float:
        """min(1, expected co-arrivals within the max-wait cap) — monotone
        non-decreasing in the arrival rate, 0 when idle."""
        if self.max_wait_s <= 0:
            return 0.0
        if rate_hz is None:
            rate_hz = self.arrivals.rate()
        return min(1.0, max(0.0, rate_hz) * self.max_wait_s)

    def budgets(self, queue_depth: int = 0) -> Tuple[float, float, float]:
        """(max_wait_s, quiescence_s, burst_wait_s) for the next batch.

        ``queue_depth`` rides along for future shaping; today the arrival
        rate alone sets the factor (a deep queue dispatches immediately
        anyway — the coalescer breaks as soon as a bucket fills).
        """
        f = self.load_factor()
        out = (
            f * self.max_wait_s,
            f * self.quiescence_s,
            f * self.burst_wait_s,
        )
        self.current_max_wait_s = out[0]
        return out
