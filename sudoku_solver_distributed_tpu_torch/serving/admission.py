"""Deadline-aware admission control and load shedding for the serving path.

Without admission, every request is accepted: under open-loop overload
(arrivals faster than the device drains them) the coalescer's queue grows
without bound and every client eventually gets an answer arbitrarily late.

``AdmissionController`` sits between transport and engine:

  * **bounded pending budget** (``capacity``): at most this many admitted
    requests may be in flight (queued or solving); excess arrivals are
    shed at the door with ``429 Too Many Requests`` + ``Retry-After``.
  * **per-request deadlines**: each request carries a latency budget
    (``X-Deadline-Ms`` header, or ``default_deadline_ms``). A request
    whose PROJECTED queue wait (pending ÷ measured completion rate)
    already exceeds its budget is shed at arrival — it could only expire
    in the queue, so answering 429 now is kinder than answering it late
    and cheaper than computing it. A request admitted in time but
    overtaken by load is dropped at batch-formation time instead
    (parallel/coalescer.py): the device never solves a board nobody is
    waiting for. A request whose batch is already on the device when its
    deadline passes is delivered normally — the deadline guards queue
    wait; service time already paid is never thrown away.

The completion rate observes only requests that actually finished
solving (expired drops and rejected bodies are excluded), so a burst of
cheap 429s or 400s cannot inflate the measured capacity and talk the
controller into admitting a queue it cannot drain.

A stdlib-only copy of ``sudoku_solver_distributed_tpu/serving/
admission.py`` with the hooks of the answer cache (``note_rejected``,
``note_cache_hit``), of engine supervision (``reanchor``) and of the
autopilot (``budget_scale``, ``set_budget_scale``). A node
constructed without an AdmissionController (the default) serves as if this
module did not exist.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .load import EwmaRate, WindowRate


class DeadlineExceeded(RuntimeError):
    """An admitted request's deadline passed while it waited in the queue.

    Raised out of the solve future when the coalescer drops the request at
    batch-formation time; the HTTP layer maps it to 429 (net/http_api.py).
    """


class Decision:
    """Outcome of one ``try_admit`` call.

    ``admitted`` True → ``deadline_s`` is the request's ABSOLUTE monotonic
    deadline (or None for no deadline); the caller MUST call ``release``
    exactly once when the request finishes, however it finishes.
    ``admitted`` False → ``reason`` ("capacity" | "deadline") and
    ``retry_after_s`` (the shed reply's Retry-After hint).
    """

    __slots__ = ("admitted", "deadline_s", "retry_after_s", "reason")

    def __init__(self, admitted, deadline_s=None, retry_after_s=None, reason=None):
        self.admitted = admitted
        self.deadline_s = deadline_s
        self.retry_after_s = retry_after_s
        self.reason = reason


class AdmissionController:
    """Bounded-pending, deadline-aware admission for the /solve path.

    Args:
      capacity: max admitted-and-unfinished requests; <= 0 means
        unbounded (deadline projection still applies).
      default_deadline_ms: latency budget for requests that don't carry
        an ``X-Deadline-Ms`` header; <= 0 means no default deadline.
      tau_s: EWMA time constant for the arrival/completion estimators.

    Thread-safety: one small lock guards the pending count and counters;
    every critical section is a handful of int/float ops.
    """

    def __init__(
        self,
        capacity: int = 0,
        *,
        default_deadline_ms: float = 0.0,
        tau_s: float = 1.0,
    ):
        self.capacity = int(capacity)
        self.default_deadline_s: Optional[float] = (
            default_deadline_ms / 1e3 if default_deadline_ms > 0 else None
        )
        self._lock = threading.Lock()
        self.pending = 0
        self.admitted = 0
        self.shed_capacity = 0
        self.shed_deadline = 0
        self.completed = 0
        self.expired = 0   # admitted but dropped/expired before completing
        self.rejected = 0  # admitted but finished without engine service
        self.reanchors = 0   # supervisor regime changes (reanchor)
        self.cache_hits = 0  # answered by the answer cache before admission
        # burn-aware tightening (serving/autopilot.py): the fraction of
        # each request's deadline budget the projected-wait shed may
        # consume. 1.0, the default and the value every escape hatch
        # restores, sheds as if there were no autopilot; the autopilot
        # lowers it on an SLO fast-burn rising edge and raises it back
        # with hysteresis. It scales only the shed projection: the
        # client's real deadline (Decision.deadline_s) is never shortened.
        self.budget_scale = 1.0
        self.arrivals = EwmaRate(tau_s=tau_s)
        # count-based, NOT gap-based: completions fan out in bursts (a
        # coalesced batch resolves its futures at once) and a gap EWMA
        # under-reads bursty streams by the batch width (load.WindowRate)
        self._completions = WindowRate(window_s=max(2.0 * tau_s, 1.0))

    # -- internals ---------------------------------------------------------
    def _projected_wait_s(self) -> float:
        """Expected queue wait for a request arriving NOW: the pending
        backlog over the measured completion rate, read frozen (see
        load.WindowRate). 0 while the completion rate is still unknown
        (cold start admits optimistically; the batch-formation drop is the
        backstop if that optimism was wrong)."""
        rate = self._completions.rate(frozen=True)
        if rate <= 0.0:
            return 0.0
        return self.pending / rate

    def _retry_after_s(self, projected_s: float) -> float:
        """How long until the backlog plausibly has room again. Floor 1 s:
        a finer hint just synchronizes the retry stampede."""
        return max(1.0, projected_s)

    # -- client surface ----------------------------------------------------
    def try_admit(self, deadline_ms: Optional[float] = None) -> Decision:
        """Admit or shed one arriving request.

        ``deadline_ms`` is the request's RELATIVE latency budget (the
        ``X-Deadline-Ms`` header value); None falls back to the
        configured default. A non-positive budget is already expired at
        arrival and sheds immediately.
        """
        now = time.monotonic()
        budget_s = (
            deadline_ms / 1e3 if deadline_ms is not None
            else self.default_deadline_s
        )
        with self._lock:
            self.arrivals.observe(now)
            projected = self._projected_wait_s()
            if self.capacity > 0 and self.pending >= self.capacity:
                self.shed_capacity += 1
                return Decision(
                    False,
                    retry_after_s=self._retry_after_s(projected),
                    reason="capacity",
                )
            if budget_s is not None and (
                budget_s <= 0 or projected > budget_s * self.budget_scale
            ):
                self.shed_deadline += 1
                return Decision(
                    False,
                    retry_after_s=self._retry_after_s(projected),
                    reason="deadline",
                )
            self.pending += 1
            self.admitted += 1
        deadline_s = now + budget_s if budget_s is not None else None
        return Decision(True, deadline_s=deadline_s)

    def retry_hint_s(self) -> float:
        """Retry-After hint for a reply shed AFTER admission (a request
        that expired in the queue) — same projection as an arrival shed."""
        with self._lock:
            return self._retry_after_s(self._projected_wait_s())

    def reanchor(self) -> None:
        """Re-anchor the capacity estimator on the CURRENT serving
        regime. Wired to the engine supervisor's state transitions
        (serving/health.py via net/cli.py): when the device is lost the
        projection must measure the host-oracle fallback's throughput —
        not keep admitting against a dead device's held peak rate — and
        when the device is re-admitted the fallback's slow rate must not
        shed traffic the repaired device could serve. The batch-formation
        expiry backstop bounds the brief optimism while the estimator
        re-learns (load.WindowRate.reanchor)."""
        with self._lock:
            self.reanchors += 1
            self._completions.reanchor()

    def set_budget_scale(self, scale: float) -> None:
        """Set the burn-aware shed tightening factor (serving/autopilot.py
        drives this), clamped to [0.05, 1.0]: a control-law bug must never
        be able to shed everything or loosen past the deadline."""
        with self._lock:
            self.budget_scale = min(1.0, max(0.05, float(scale)))

    def note_rejected(self) -> None:
        """A request rejected BEFORE admission ran (the cache front door
        parses bodies ahead of ``try_admit``): keep the arrivals EWMA and
        the ``rejected`` counter faithful so a malformed-body flood stays
        visible on the operator surface, without a pending-count round
        trip (nothing was admitted)."""
        now = time.monotonic()
        with self._lock:
            self.arrivals.observe(now)
            self.rejected += 1

    def note_cache_hit(self) -> None:
        """One request answered by the canonical-form answer cache
        (cache/) BEFORE admission accounting. Deliberately a bare gauge: a
        hit never touches ``pending`` and never feeds the completion-rate
        estimator — a hot-set storm answers in microseconds, and folding
        those into the measured completion rate would inflate the
        projected device capacity and over-admit device-bound work."""
        with self._lock:
            self.cache_hits += 1

    def release(self, *, expired: bool = False, served: bool = True) -> None:
        """One admitted request finished (solved, failed, or expired).

        Only requests that actually consumed service feed the completion
        rate. ``expired`` — dropped at batch formation. ``served`` False —
        finished without ever reaching the engine (a malformed body
        answered 400 at parse time).
        """
        now = time.monotonic()
        with self._lock:
            self.pending = max(0, self.pending - 1)
            if expired:
                self.expired += 1
            elif not served:
                self.rejected += 1
            else:
                self.completed += 1
                self._completions.observe(now)

    def snapshot(self) -> dict:
        """Operator view of the controller's counters and estimates."""
        with self._lock:
            projected = self._projected_wait_s()
            return {
                "capacity": self.capacity,
                "pending": self.pending,
                "admitted": self.admitted,
                "completed": self.completed,
                "shed_capacity": self.shed_capacity,
                "shed_deadline": self.shed_deadline,
                "expired": self.expired,
                "rejected": self.rejected,
                "reanchors": self.reanchors,
                "cache_hits": self.cache_hits,
                "budget_scale": self.budget_scale,
                "default_deadline_ms": round(
                    (self.default_deadline_s or 0.0) * 1e3, 3
                ),
                "arrival_rate_hz": round(self.arrivals.rate(), 3),
                # frozen: the value the projection divides by
                "completion_rate_hz": round(
                    self._completions.rate(frozen=True), 3
                ),
                "projected_wait_ms": round(projected * 1e3, 3),
            }
