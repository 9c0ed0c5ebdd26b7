"""Incident flight recorder: the node's always-on black box.

A copy of ``sudoku_solver_distributed_tpu/obs/flight.py``. A fixed-size
ring of recent request-span records (obs/trace.py) plus
supervision/admission events, dumped atomically to JSON when something
goes wrong — the answer to "what were the last 2048 requests doing when
the node went DEGRADED" without anyone having had DEBUG logging on.

Triggers:

  * **breaker trip / watchdog hang** — ``attach_supervisor`` registers a
    transition callback (serving/health.EngineSupervisor): every state
    transition lands in the event ring, and a transition INTO
    DEGRADED/LOST schedules an incident dump a short beat later
    (``incident_delay_s``) so the very request that tripped the breaker
    has finished its span and is IN the dump — dumping synchronously
    inside the transition would race the triggering span's finish.
  * **shed storm** — ``note_shed`` (fed by Tracer.finish on every 429):
    ``shed_storm_threshold`` sheds inside ``shed_storm_window_s`` dumps
    once per ``min_auto_interval_s``.
  * **SLO fast burn** — obs/slo.py triggers an incident on a crossing.
  * **operator** — SIGUSR2 (net/cli.py) and ``POST /debug/flightrecord``
    dump on demand, never rate-limited.

Dumps are atomic (tmp + ``os.replace``) so a crash mid-dump can never
leave a half-written incident file, and the payload is built under the
ring lock but WRITTEN outside it (file I/O under the lock every
request's span append takes would stall the serving path for the
write's syscall time).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)


class FlightRecorder:
    """Bounded span/event rings + incident dump machinery.

    Args:
      capacity: span-ring depth (the "last N requests" of the dump).
      event_capacity: supervision/admission event-ring depth.
      dump_dir: where incident JSON files land (created on first dump).
        None → no files; ``dump()`` still returns the payload (the HTTP
        debug route serves it inline).
      shed_storm_threshold / shed_storm_window_s: N 429s within the
        window auto-dump (the overload-incident trigger).
      min_auto_interval_s: floor between AUTOMATIC dumps (breaker churn
        or a sustained shed storm must not write a dump per tick);
        operator-triggered dumps bypass it.
      incident_delay_s: grace between an incident trigger and its dump so
        in-flight spans (the poisoned batch itself) finish into the ring.
    """

    def __init__(
        self,
        *,
        capacity: int = 2048,
        event_capacity: int = 256,
        dump_dir: Optional[str] = None,
        shed_storm_threshold: int = 64,
        shed_storm_window_s: float = 1.0,
        min_auto_interval_s: float = 5.0,
        incident_delay_s: float = 0.25,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.dump_dir = dump_dir
        self.shed_storm_threshold = shed_storm_threshold
        self.shed_storm_window_s = shed_storm_window_s
        self.min_auto_interval_s = min_auto_interval_s
        self.incident_delay_s = incident_delay_s
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=event_capacity)
        self._sheds: deque = deque(maxlen=max(1, shed_storm_threshold))
        self._seq = itertools.count(1)
        self._last_auto_dump = 0.0
        self._incident_timer: Optional[threading.Timer] = None
        self.dumps = 0
        self.dump_errors = 0
        self.last_dump_reason: Optional[str] = None
        self.last_dump_path: Optional[str] = None

    # -- feeds -------------------------------------------------------------
    def record_span(self, record: dict) -> None:
        """Append one finished span record (Tracer.finish).

        Stored as a flat value tuple in ``trace.RECORD_FIELDS`` order: a
        tuple of atomics is GC-untracked, so a full ring adds nothing to
        gen2 collections on the serving path (a ring of 2048 dicts
        does); ``dump`` rebuilds the dicts on the rare path."""
        with self._lock:
            self._spans.append(tuple(record.values()))

    def spans(self) -> list:
        """The span ring rebuilt as dicts (RECORD_FIELDS order) — the
        trace-export route's source (obs/export.py). Rare-path cost,
        same rationale as dump()."""
        from .trace import RECORD_FIELDS

        with self._lock:
            rows = list(self._spans)
        return [dict(zip(RECORD_FIELDS, row)) for row in rows]

    def note_event(self, kind: str, detail: Optional[dict] = None) -> None:
        """Append one control-plane event (supervisor transition, shed
        storm, dump marker) to the event ring."""
        event = {"t": round(time.time(), 6), "kind": kind}
        if detail:
            event.update(detail)
        with self._lock:
            self._events.append(event)

    def note_shed(self) -> None:
        """One 429 left the node. A full threshold-window of sheds inside
        ``shed_storm_window_s`` is an overload incident."""
        now = time.monotonic()
        storm = False
        with self._lock:
            self._sheds.append(now)
            if (
                len(self._sheds) == self._sheds.maxlen
                and now - self._sheds[0] <= self.shed_storm_window_s
            ):
                self._sheds.clear()  # re-arm: the NEXT full window re-triggers
                storm = True
        if storm:
            self.note_event(
                "shed-storm",
                {
                    "sheds": self.shed_storm_threshold,
                    "window_s": self.shed_storm_window_s,
                },
            )
            self.trigger_incident("shed-storm")

    # -- supervisor hookup -------------------------------------------------
    def attach_supervisor(self, supervisor) -> None:
        """Record every state transition and dump on a breaker trip
        (→ DEGRADED, which covers watchdog hangs and bad results too) or
        an escalation to LOST."""
        supervisor.add_transition_callback(self._on_transition)

    def _on_transition(self, old_state: str, new_state: str) -> None:
        self.note_event(
            "supervisor-transition", {"from": old_state, "to": new_state}
        )
        if new_state in ("degraded", "lost"):
            self.trigger_incident(f"breaker-{new_state}")

    # -- incident machinery ------------------------------------------------
    def trigger_incident(self, reason: str) -> None:
        """Schedule an automatic dump ``incident_delay_s`` out, rate-
        limited to one per ``min_auto_interval_s`` — the delay lets the
        triggering request's own span finish into the ring first."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_auto_dump < self.min_auto_interval_s:
                return
            if self._incident_timer is not None:
                return  # a dump for an earlier trigger is already pending
            self._last_auto_dump = now
            t = threading.Timer(
                self.incident_delay_s, self._incident_fire, (reason,)
            )
            t.daemon = True
            self._incident_timer = t
        t.start()

    def _incident_fire(self, reason: str) -> None:
        with self._lock:
            self._incident_timer = None
        try:
            self.dump(reason=reason)
        except Exception:  # noqa: BLE001 — the black box must never crash serving
            logger.exception("flight-recorder incident dump failed")

    # -- dumps -------------------------------------------------------------
    def dump(self, reason: str = "manual") -> dict:
        """Write (when ``dump_dir`` is set) and return the flight record.

        Returns {"reason", "t", "seq", "path" (or None), "spans",
        "events", "payload"} — ``payload`` is the full record (the same
        object serialized to disk), so callers without a dump dir (tests,
        the HTTP debug route on a dir-less node) still get the black box.
        """
        from .trace import RECORD_FIELDS

        with self._lock:
            seq = next(self._seq)
            spans = list(self._spans)
            events = list(self._events)
        payload = {
            "reason": reason,
            "t": round(time.time(), 6),
            "seq": seq,
            "capacity": self.capacity,
            # rebuild span dicts from the ring's flat tuples (see
            # record_span) — dump time, never request time
            "spans": [dict(zip(RECORD_FIELDS, row)) for row in spans],
            "events": events,
        }
        try:
            # the incident as a picture: the same spans
            # assembled as Perfetto-loadable trace-event JSON, embedded
            # so a dump file opens in a trace viewer with zero extra
            # tooling. Best-effort — the black box's primary record must
            # survive an export bug.
            from .export import build_trace

            payload["trace"] = build_trace(payload["spans"])
        except Exception:  # noqa: BLE001 — export is additive evidence
            logger.exception("flight-record trace export failed")
        path = None
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir,
                    f"flightrecord-{seq:04d}-{reason}.json",
                )
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1)
                    f.write("\n")
                os.replace(tmp, path)
            except OSError:
                logger.exception(
                    "flight-recorder dump to %s failed", self.dump_dir
                )
                path = None
                with self._lock:
                    self.dump_errors += 1
        with self._lock:
            self.dumps += 1
            self.last_dump_reason = reason
            self.last_dump_path = path
        logger.warning(
            "flight recorder dumped (%s): %d spans, %d events -> %s",
            reason,
            len(payload["spans"]),
            len(payload["events"]),
            path or "<in-memory>",
        )
        return {
            "reason": reason,
            "t": payload["t"],
            "seq": seq,
            "path": path,
            "spans": len(payload["spans"]),
            "events": len(payload["events"]),
            "payload": payload,
        }

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """The ``obs.flight`` block of ``GET /metrics``."""
        with self._lock:
            return {
                "spans": len(self._spans),
                "events": len(self._events),
                "capacity": self.capacity,
                "dumps": self.dumps,
                "dump_errors": self.dump_errors,
                "last_dump_reason": self.last_dump_reason,
                "last_dump_path": self.last_dump_path,
                "dump_dir": self.dump_dir,
            }
