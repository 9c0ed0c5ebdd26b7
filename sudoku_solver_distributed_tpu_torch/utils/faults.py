"""Deterministic fault injection for chaos-testing the serving stack.

Two failure domains, two injectors:

``FaultInjector`` — the *wire* seam. The reference's failure story is
graceful-only — a lost or delayed datagram simply stalls it
(fire-and-forget UDP, no acks/retries, reference node.py:177-191), and it
ships no tooling to provoke that situation (SURVEY.md §5: "no fault
injection tooling"). This injector sits on a node's *outbound* transport
seam (``P2PNode.send``) and drops, delays, or duplicates selected message
types under a seeded RNG, so tests can prove the recovery machinery —
task deadlines + requeue, heartbeat crash detection, deletion flooding —
actually recovers, deterministically. Outbound-only is sufficient: a
datagram dropped by the sender is indistinguishable to the cluster from
one dropped in flight or by the receiver.

``EngineFaultInjector`` — the *engine/device* seam. The class
of partial failure the wire injector cannot provoke: a device call that
raises (lost device, poisoned runtime), a device call that hangs (a stuck
driver or kernel), or a kernel that returns a wrong answer (bit-rot, a
bad build). It plugs into ``engine.SolverEngine`` at the bucket-dispatch
seam (``_dispatch_padded`` / ``_finalize_padded``) and the segment seam
(``dispatch_segment`` / ``finalize_segment``) so every
``serving/health.EngineSupervisor`` transition — watchdog trip, breaker
open, half-open probe failure — is deterministically testable.

Both expose thread-safe counters (``counts()``); the engine injector's
are the body of ``POST /debug/faults`` when a node arms it
(``--chaos-injector``, net/http_api.py), so chaos runs are observable
without log scraping.

A copy of ``sudoku_solver_distributed_tpu/utils/faults.py``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple


class FaultInjector:
    """Plan wire faults per outgoing message, deterministically.

    Args:
      drop: ``{msg_type: probability}`` — drop matching messages with the
        given probability (seeded RNG, so a fixed seed gives a fixed drop
        sequence).
      drop_first: ``{msg_type: n}`` — drop the first ``n`` messages of that
        type unconditionally, *before* the probabilistic rule applies. The
        fully deterministic knob for tests ("lose the first two task
        dispatches").
      delay_s: ``{msg_type: seconds}`` — deliver matching messages late
        (reordering simulation: later sends of other types overtake them).
      duplicate: ``{msg_type: probability}`` — send matching messages twice
        (UDP duplicates; receivers must be idempotent, as the reference's
        stale-answer handling already assumes).
      seed: RNG seed shared by the probabilistic rules.

    A message type absent from every rule passes through untouched. Counters
    (``dropped``/``delayed``/``duplicated`` per type) are thread-safe and
    readable at any time.
    """

    def __init__(
        self,
        drop: Optional[Dict[str, float]] = None,
        drop_first: Optional[Dict[str, int]] = None,
        delay_s: Optional[Dict[str, float]] = None,
        duplicate: Optional[Dict[str, float]] = None,
        seed: int = 0,
    ):
        self.drop = dict(drop or {})
        self.delay_s = dict(delay_s or {})
        self.duplicate = dict(duplicate or {})
        self._drop_first = dict(drop_first or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.dropped: Dict[str, int] = {}
        self.delayed: Dict[str, int] = {}
        self.duplicated: Dict[str, int] = {}

    def plan(self, msg: dict) -> List[Tuple[dict, float]]:
        """The (message, delay_seconds) sends to actually perform for
        ``msg`` — ``[]`` when dropped, two entries when duplicated."""
        mtype = msg.get("type", "")
        with self._lock:
            remaining = self._drop_first.get(mtype, 0)
            if remaining > 0:
                self._drop_first[mtype] = remaining - 1
                self.dropped[mtype] = self.dropped.get(mtype, 0) + 1
                return []
            if self._rng.random() < self.drop.get(mtype, 0.0):
                self.dropped[mtype] = self.dropped.get(mtype, 0) + 1
                return []
            delay = self.delay_s.get(mtype, 0.0)
            if delay > 0:
                self.delayed[mtype] = self.delayed.get(mtype, 0) + 1
            out = [(msg, delay)]
            if self._rng.random() < self.duplicate.get(mtype, 0.0):
                self.duplicated[mtype] = self.duplicated.get(mtype, 0) + 1
                out.append((msg, delay))
            return out

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Snapshot of per-type fault counters (for tests and operators)."""
        with self._lock:
            return {
                "dropped": dict(self.dropped),
                "delayed": dict(self.delayed),
                "duplicated": dict(self.duplicated),
            }


class InjectedEngineFault(RuntimeError):
    """A device call failed because ``EngineFaultInjector`` said so."""


class EngineFaultInjector:
    """Plan engine/device-seam faults per bucket dispatch, deterministically.

    Three fault shapes, matching the three ways a device fails in
    production (and the three supervisor detections — serving/health.py):

      * ``arm_fail_next(n)`` — the next ``n`` device calls raise
        ``InjectedEngineFault`` at dispatch time (a lost device / dead
        runtime; the breaker's consecutive-failure food).
      * ``set_delay(seconds)`` — every device fetch sleeps this long
        before returning (a hung device call; trips the supervisor watchdog
        when the delay exceeds its budget — the call DOES eventually
        finish, exactly like a driver stall that resolves).
      * ``poison_bucket(width)`` — results fetched from that bucket width
        come back corrupted (first two grid cells forced equal) while
        still claiming SOLVED: the silent-wrong-answer failure the
        supervisor's host-side verification must catch.

    ``clear()`` disarms everything (the "faults clear, breaker closes"
    half of every chaos test). Counters (``calls`` / ``failed`` /
    ``delayed`` / ``poisoned``) are thread-safe; ``counts()`` snapshots
    them for tests and the ``POST /debug/faults`` reply.
    """

    def __init__(
        self,
        *,
        fail_next: int = 0,
        delay_s: float = 0.0,
        poison_buckets: Optional[Tuple[int, ...]] = None,
    ):
        self._lock = threading.Lock()
        self._fail_next = int(fail_next)
        self._delay_s = float(delay_s)
        self._poison = set(poison_buckets or ())
        self.calls = 0
        self.failed = 0
        self.delayed = 0
        self.poisoned = 0

    # -- arming ------------------------------------------------------------
    def arm_fail_next(self, n: int) -> None:
        with self._lock:
            self._fail_next = int(n)

    def set_delay(self, delay_s: float) -> None:
        with self._lock:
            self._delay_s = float(delay_s)

    def poison_bucket(self, width: int) -> None:
        with self._lock:
            self._poison.add(int(width))

    def clear(self) -> None:
        """Disarm every fault (counters keep their history)."""
        with self._lock:
            self._fail_next = 0
            self._delay_s = 0.0
            self._poison.clear()

    # -- the engine seam (engine._dispatch_padded / _finalize_padded) ------
    def on_device_call(self, bucket: int) -> None:
        """Called once per bucket dispatch, before the device call; raises
        ``InjectedEngineFault`` while a fail-next budget remains."""
        with self._lock:
            self.calls += 1
            if self._fail_next > 0:
                self._fail_next -= 1
                self.failed += 1
                raise InjectedEngineFault(
                    f"injected device-call failure (bucket {bucket})"
                )

    def on_fetch(self, bucket: int) -> None:
        """Called at the device→host fetch point; sleeps the armed delay
        (the sleep happens OUTSIDE the injector lock — a long injected
        hang must stall only this call, never the other seam hooks)."""
        with self._lock:
            delay = self._delay_s
            if delay > 0:
                self.delayed += 1
        if delay > 0:
            time.sleep(delay)

    def corrupt(self, bucket: int, packed):
        """Given one fetched packed host batch (rows [grid | solved |
        status | guesses | validations]), return it poisoned when this
        bucket width is armed: the first two grid cells are forced equal,
        so the grid violates the sudoku rules while every status field
        still claims success — the exact shape of a silently-wrong
        kernel."""
        with self._lock:
            if int(bucket) not in self._poison:
                return packed
            self.poisoned += 1
        packed = packed.copy()
        packed[:, 0] = packed[:, 1]
        return packed

    def counts(self) -> Dict[str, int]:
        """Snapshot for tests and the ``POST /debug/faults`` reply."""
        with self._lock:
            return {
                "calls": self.calls,
                "failed": self.failed,
                "delayed": self.delayed,
                "poisoned": self.poisoned,
                "armed_fail_next": self._fail_next,
                "armed_delay_ms": round(self._delay_s * 1e3, 3),
                "armed_poison_buckets": sorted(self._poison),
            }
