"""Failure-domain supervision for the engine/device plane.

``EngineSupervisor`` wraps every device dispatch of the engine — the
bucket path (``_dispatch_padded``/``_finalize_padded``, the DFS kernel)
and the segment path (``dispatch_segment``/``finalize_segment``, the
segment kernels) open and close a supervision token around each call —
and drives an explicit state machine:

    WARMING ──first verified success / engine warm──▶ HEALTHY
    HEALTHY ──failure, hang, or wrong answer────────▶ DEGRADED
    DEGRADED ──breaker_threshold consecutive────────▶ LOST
    DEGRADED/LOST ──half-open probe: one device round
                    trip verified against the host
                    oracle (models/oracle.py)───────▶ HEALTHY

  * **watchdog** — a daemon thread bounds device-call wall time: a call
    past ``watchdog_budget_s`` is declared hung, its bucket quarantined
    (``engine._bucket_for`` routes around quarantined widths), and the
    breaker records a failure — withOUT waiting for the call to return
    (a host thread blocked on a CUDA event cannot be interrupted; a
    stalled call that eventually finishes is counted as a late success
    but cannot close the breaker).
  * **circuit breaker** — consecutive failures (dispatch exceptions,
    hangs, host-verification failures) drive DEGRADED at the first and
    LOST at ``breaker_threshold``; any successful *verified* half-open
    probe closes it.
  * **degraded-mode serving** — while DEGRADED/LOST the single-board
    serving path reroutes through ``fallback_solve``: the trusted
    host-side oracle (models/oracle.py) under a bounded-concurrency
    semaphore, so the node keeps answering *correctly* (slower, flagged
    with an ``X-Degraded`` response header) instead of hanging or
    erroring.
  * **half-open probes + rebuild** — while unhealthy, a probe thread
    periodically runs one real device solve through the guarded seam
    (the DFS kernel at the smallest bucket) and verifies the answer
    host-side; on LOST it first re-warms the engine (``engine.warmup``)
    once per LOST episode. Only a probe that *proves a correct round
    trip* re-admits the device. A sticky CUDA fault (an illegal address
    breaks the process's context) keeps every probe failing: the node
    stays LOST and serves correct answers from the oracle, which is the
    intended behaviour — nothing here resets the device.

Health propagates outward: the supervisor state string rides the
stats-gossip heartbeat (net/wire.stats_msg ``health`` key), and
registered transition callbacks let the admission plane re-anchor its
capacity estimator on the new regime
(serving/admission.AdmissionController.reanchor) instead of shedding
against a dead device's stale rate.

Everything defaults off: an engine without a supervisor attached serves
exactly as it would without this module.

A copy of ``sudoku_solver_distributed_tpu/serving/health.py``, falling
back to this package's own oracle. The flight recorder (obs/flight.py)
registers through ``add_transition_callback``; the fallback stamps the
request span's ``fallback`` stage (obs/trace.py).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ..models.oracle import (
    OracleBudgetExceeded,
    oracle_is_valid_solution,
    oracle_solve,
)
from ..obs.trace import current_trace

logger = logging.getLogger(__name__)

# state-machine states (lower-case strings: they ride the stats-gossip
# wire and the /metrics health block verbatim)
WARMING = "warming"
HEALTHY = "healthy"
DEGRADED = "degraded"
LOST = "lost"


class _Token:
    """One in-flight supervised device call (dispatch → finalized).

    ``budget_scale`` sizes THIS call's hang budget as a multiple of the
    global ``watchdog_budget_s``: a pipelined speculative
    segment is dispatched while the segment ahead of it is still
    running, so its dispatch→fetch span legitimately covers ~two
    segments — declared at token-open time by the caller that knows the
    pipeline depth, so an overlapped dispatch can never read as a hung
    call while a genuinely stuck one still trips at a bounded (2×)
    horizon."""

    __slots__ = ("bucket", "t0", "hung", "budget_scale")

    def __init__(self, bucket: int, budget_scale: float = 1.0):
        self.bucket = bucket
        self.budget_scale = max(1.0, float(budget_scale))
        self.t0 = time.monotonic()
        self.hung = False


class EngineSupervisor:
    """Watchdog + circuit breaker + degraded-mode fallback for one engine.

    Args:
      engine: the SolverEngine to supervise; ``engine.supervisor`` is set
        to this object (the engine's dispatch seam and bucket selection
        consult it; ``None`` — the default — costs nothing).
      watchdog_budget_s: wall-time budget per device call; a call past it
        is declared hung (bucket quarantined, breaker fed) even though
        the thread inside it cannot be interrupted — detection plus
        rerouting is the recovery, not thread murder.
      breaker_threshold: consecutive failures before DEGRADED escalates
        to LOST (probe failures count — a node that cannot pass its own
        probe IS lost).
      probe_interval_s: how often the half-open probe re-tries the device
        while DEGRADED/LOST.
      fallback_concurrency: max concurrent host-oracle fallback solves;
        callers past it queue on the semaphore (bounded concurrency, not
        unbounded host-CPU fan-out — the fallback exists to keep
        answering, not to pretend the host is a GPU).
      fallback_budget_s: wall-time budget per host-oracle fallback solve
        (default 30 s). The MRV oracle's worst case is exponential —
        an adversarial 16×16/25×25 board could pin a host core for
        minutes while DEGRADED — so a budgeted solve raises
        ``OracleBudgetExceeded`` past it and the HTTP surface answers a
        clean 503 (net/http_api.py) instead of holding a request thread
        hostage. None disables the budget.
      auto_rebuild: on LOST, re-warm the engine once per episode before
        probing (``engine.warmup``) — a restarted device needs its
        kernels built and launched once before a probe can prove
        anything.

    Thread-safety: one lock guards state, counters, quarantine, and the
    in-flight token table; every critical section is a few dict/int ops
    (no device work, no oracle work, no sleeps under the lock). Probes
    and rebuilds run on their own daemon threads so a hung probe can
    never stall the watchdog that would detect it.
    """

    def __init__(
        self,
        engine,
        *,
        watchdog_budget_s: float = 30.0,
        breaker_threshold: int = 3,
        probe_interval_s: float = 2.0,
        fallback_concurrency: int = 2,
        fallback_budget_s: Optional[float] = 30.0,
        auto_rebuild: bool = True,
    ):
        if watchdog_budget_s <= 0:
            raise ValueError("watchdog_budget_s must be > 0")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if fallback_concurrency < 1:
            raise ValueError("fallback_concurrency must be >= 1")
        if fallback_budget_s is not None and fallback_budget_s <= 0:
            raise ValueError("fallback_budget_s must be > 0 (or None)")
        self._engine = engine
        self.watchdog_budget_s = watchdog_budget_s
        self.breaker_threshold = breaker_threshold
        self.probe_interval_s = probe_interval_s
        self.fallback_concurrency = fallback_concurrency
        self.fallback_budget_s = fallback_budget_s
        self.auto_rebuild = auto_rebuild

        self._lock = threading.Lock()
        self.state = HEALTHY if getattr(engine, "warmed", False) else WARMING
        self.consecutive_failures = 0
        self._quarantined: set = set()
        self._inflight: dict = {}
        self._token_ids = itertools.count(1)
        self._transitions: deque = deque(maxlen=16)
        self._since = time.monotonic()
        self._callbacks: list = []
        # counters (all under _lock)
        self.failures = 0          # dispatch/finalize exceptions
        self.hangs = 0             # watchdog trips
        self.bad_results = 0       # host-verification failures
        self.late_successes = 0    # declared-hung calls that finished OK
        self.fallback_served = 0
        self.fallback_budget_trips = 0  # budgeted oracle solves cut off
        self.probes = 0
        self.probe_failures = 0
        self.rebuilds = 0
        # half-open machinery
        self._probe_due = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._probe_epoch = 0
        self.probes_abandoned = 0
        # quarantine bypass scoped to the PROBE'S OWN thread (a global
        # flag would route concurrent serving traffic into the
        # quarantined width during every probe window)
        self._probe_tls = threading.local()
        self._rebuilt_this_episode = True  # no LOST episode yet
        # widths that have completed at least one supervised call: hang
        # declaration applies only to these (plus engine-warmed widths) —
        # a width's FIRST call may legitimately include the kernel
        # library's build (nvcc, seconds) and first launch, and declaring
        # a building kernel hung would quarantine healthy hardware (the
        # breaker still catches builds that ERROR; only silence during a
        # first call is excused)
        self._seen_widths: set = set()
        # bounded fallback concurrency; acquired OUTSIDE _lock always
        self._fallback_sem = threading.Semaphore(fallback_concurrency)

        self._shutdown = False
        # tick fast enough that tests with millisecond budgets see the
        # trip promptly, slow enough to be free in production
        self._tick_s = max(0.005, min(watchdog_budget_s / 4.0, 0.25))
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name="engine-watchdog", daemon=True
        )
        engine.supervisor = self
        self._watch_thread.start()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the watchdog (tests; engines close it via engine.close)."""
        self._shutdown = True

    def add_transition_callback(self, fn) -> None:
        """``fn(old_state, new_state)`` after every transition — called
        OUTSIDE the supervisor lock (the admission re-anchor hook takes
        its own lock; never nest the two)."""
        with self._lock:
            self._callbacks.append(fn)

    # -- seam: engine._dispatch_padded / _finalize_padded ------------------
    def call_started(self, bucket: int, budget_scale: float = 1.0):
        """Open a supervision token around one device call.
        ``budget_scale`` multiplies the watchdog budget for THIS call
        (see _Token — pipelined segment dispatches pass 2.0)."""
        tok = _Token(int(bucket), budget_scale)
        with self._lock:
            tid = next(self._token_ids)
            self._inflight[tid] = tok
        return tid

    def call_abandoned(self, token) -> None:
        """Discard a token without feeding the breaker either way: a
        pipelined speculative dispatch thrown away because the
        segment ahead of it failed was never fetched, so it proves
        nothing about the device — counting it as a failure would
        double-step the breaker for one fault, counting it as a success
        would reset consecutive_failures that the real failure just
        earned."""
        if token is None:
            return
        with self._lock:
            self._inflight.pop(token, None)

    def call_finished(self, token, ok: bool) -> None:
        """Close a token. A call that was already declared hung counts as
        a late success at best — it can never close the breaker (only a
        verified probe does)."""
        if token is None:
            return
        fire = None
        with self._lock:
            tok = self._inflight.pop(token, None)
            if tok is None:
                return
            if ok:
                # only a COMPLETED round trip proves the width's kernel
                # runs: a call that failed at dispatch (before any build
                # or launch) must not spend the width's first-call hang
                # exemption
                self._seen_widths.add(tok.bucket)
            if tok.hung:
                if ok:
                    self.late_successes += 1
                return
            if ok:
                if self.state == WARMING:
                    fire = self._transition_locked(HEALTHY, "first success")
                elif self.state == HEALTHY:
                    self.consecutive_failures = 0
            else:
                self.failures += 1
                fire = self._record_failure_locked(tok.bucket, "error")
        self._fire(fire)

    # -- breaker -----------------------------------------------------------
    def record_failure(self, bucket: Optional[int], kind: str) -> None:
        """Feed the breaker from outside the seam (host verification —
        ``kind='bad-result'`` — catches a poisoned program whose device
        call *succeeded*)."""
        fire = None
        with self._lock:
            if kind == "bad-result":
                self.bad_results += 1
            else:
                self.failures += 1
            fire = self._record_failure_locked(bucket, kind)
        self._fire(fire)

    def _record_failure_locked(self, bucket: Optional[int], kind: str):
        """(lock held) Count one failure, quarantine its bucket, advance
        the state machine. Returns the callback payload for _fire."""
        self.consecutive_failures += 1
        if bucket is not None:
            self._quarantined.add(int(bucket))
        if self.consecutive_failures >= self.breaker_threshold:
            if self.state != LOST:
                return self._transition_locked(
                    LOST, f"{self.consecutive_failures} consecutive ({kind})"
                )
        elif self.state in (WARMING, HEALTHY):
            return self._transition_locked(DEGRADED, kind)
        return None

    def _transition_locked(self, to_state: str, reason: str):
        """(lock held) Switch states; returns (old, new) for _fire."""
        old = self.state
        if old == to_state:
            return None
        self.state = to_state
        self._since = time.monotonic()
        self._transitions.append(
            {
                "t": round(self._since, 3),
                "from": old,
                "to": to_state,
                "reason": reason,
            }
        )
        if to_state in (DEGRADED, LOST):
            # first half-open probe a full interval out — immediate
            # re-probing would mostly re-hit the fault that just tripped
            # the breaker; a fresh LOST episode owes one rebuild first
            self._probe_due = time.monotonic() + self.probe_interval_s
            if to_state == LOST:
                self._rebuilt_this_episode = not self.auto_rebuild
        if to_state == HEALTHY:
            self.consecutive_failures = 0
            self._quarantined.clear()
            # calls still in flight started BEFORE the device was
            # re-proven: mark them hung-equivalent so neither their late
            # failure nor a late watchdog trip can feed the breaker as
            # fresh evidence against the re-admitted device (a stale
            # 30s-old call re-tripping DEGRADED seconds after a verified
            # probe was a live race in the chaos soak); their clean
            # finishes count as late successes, and NEW traffic re-trips
            # immediately if the device is genuinely still bad
            for tok in self._inflight.values():
                tok.hung = True
        logger.warning(
            "engine supervisor: %s -> %s (%s)", old, to_state, reason
        )
        return (old, to_state)

    def _fire(self, payload) -> None:
        """Run transition callbacks outside the lock."""
        if payload is None:
            return
        with self._lock:
            callbacks = list(self._callbacks)
        for fn in callbacks:
            try:
                fn(*payload)
            except Exception:  # noqa: BLE001 — a bad hook must not kill serving
                logger.exception("supervisor transition callback failed")

    # -- serving-path queries ----------------------------------------------
    def should_fallback(self) -> bool:
        """True while the single-board serving path must bypass the
        device (DEGRADED or LOST)."""
        return self.state in (DEGRADED, LOST)

    @property
    def is_lost(self) -> bool:
        return self.state == LOST

    def quarantined_widths(self) -> frozenset:
        """Bucket widths routing must avoid — except on the probe's own
        thread (the probe's whole point is to re-try the quarantined
        program; other threads keep routing around it meanwhile)."""
        if getattr(self._probe_tls, "active", False):
            return frozenset()
        with self._lock:
            return frozenset(self._quarantined)

    # -- degraded-mode serving ---------------------------------------------
    def fallback_solve(self, board, deadline_s: Optional[float] = None):
        """Answer one request from the trusted host oracle
        (models/oracle.py) under bounded concurrency. Same contract as
        ``engine.solve_one``: (solution | None, info); ``info`` carries
        ``degraded: True`` (the HTTP layer turns it into the
        ``X-Degraded`` response header) and ``routed: "oracle-fallback"``.
        Correct by construction — slower, never wrong, never hung.

        ``deadline_s`` (absolute monotonic, the admission budget): the
        semaphore IS a queue under load, and a request whose deadline
        passed while it waited there sheds (DeadlineExceeded → 429)
        instead of being served long-expired while pinning a request
        thread — the same queue-wait-only contract as the
        coalescer's batch-formation drop.

        The solve itself runs under ``fallback_budget_s``: an
        adversarial deep board trips ``OracleBudgetExceeded`` — counted,
        propagated, answered as a clean 503 by the HTTP layer — instead
        of pinning a host core for the exponential tail.

        The request's span (obs/trace.current_trace, when a tracer is on)
        gets the ``fallback`` stage — semaphore wait plus oracle solve —
        and its ``fallback`` and ``degraded`` flags."""
        arr = np.asarray(board, np.int32)
        tr = current_trace()
        t0 = time.monotonic()
        with self._fallback_sem:
            if deadline_s is not None and time.monotonic() > deadline_s:
                from .admission import DeadlineExceeded

                raise DeadlineExceeded(
                    "deadline expired waiting for the fallback slot"
                )
            try:
                solution = oracle_solve(
                    arr.tolist(), budget_s=self.fallback_budget_s
                )
            except OracleBudgetExceeded:
                with self._lock:
                    self.fallback_budget_trips += 1
                if tr is not None:
                    tr.mark("fallback", time.monotonic() - t0)
                    tr.fallback = True
                    tr.degraded = True
                logger.warning(
                    "host-oracle fallback exceeded its %.1fs budget — "
                    "answering 503 (degraded and over budget)",
                    self.fallback_budget_s,
                )
                raise
        if tr is not None:
            tr.mark("fallback", time.monotonic() - t0)
            tr.fallback = True
            tr.degraded = True
        with self._lock:
            self.fallback_served += 1
            state = self.state
        return solution, {
            "validations": 0,
            "guesses": 0,
            "routed": "oracle-fallback",
            "degraded": True,
            "health": state,
        }

    def verify_unsat(self, board):
        """Cross-check a device "proven UNSAT" claim against the oracle —
        the sibling silent-wrong-answer shape to a corrupted grid: a
        poisoned program that CLEARS the solved flag would otherwise
        serve "No solution found" for solvable boards with nothing
        tripping the breaker. Returns ``(None, {})`` when
        the claim holds (genuinely unsatisfiable — the device answer is
        served as-is), or ``(solution, degraded-info)`` when the device
        was wrong (the caller records a bad-result failure and serves
        the oracle's answer). Runs under the fallback semaphore: this is
        fallback work, bounded the same way.

        Cost gate: the cross-check runs only for 9×9 boards, where the
        MRV oracle is effectively instant. At 16×16/25×25 an UNSAT
        refutation can be exponential, and paying it per device-UNSAT
        answer on a HEALTHY node would hand clients a cheap host-CPU
        DoS — those sizes accept the device's claim (the probe plane
        still catches poisoned programs; ROADMAP notes the gap). A
        cross-check that trips the fallback budget also accepts the
        claim — an undetermined refutation must not 503 a request the
        device DID answer."""
        arr = np.asarray(board, np.int32)
        if arr.shape[0] > 9:
            return None, {}
        with self._fallback_sem:
            try:
                solution = oracle_solve(
                    arr.tolist(), budget_s=self.fallback_budget_s
                )
            except OracleBudgetExceeded:
                with self._lock:
                    self.fallback_budget_trips += 1
                logger.warning(
                    "UNSAT cross-check exceeded the fallback budget — "
                    "accepting the device's claim"
                )
                return None, {}
        if solution is None:
            return None, {}
        logger.error(
            "device claimed UNSAT for a solvable board — poisoned "
            "program? serving the oracle's solution"
        )
        tr = current_trace()
        if tr is not None:
            # the cross-check's oracle answer IS fallback serving (its
            # wall time rides the verify stage the engine stamps around
            # this call)
            tr.fallback = True
            tr.degraded = True
        with self._lock:
            self.fallback_served += 1
            state = self.state
        return solution, {
            "validations": 0,
            "guesses": 0,
            "routed": "oracle-fallback",
            "degraded": True,
            "health": state,
        }

    def check_solution(self, board, solution) -> bool:
        """Host-side ground truth for a device answer: the clues survive
        and the grid satisfies the sudoku rules. The defense against a
        poisoned program — a wrong answer must never leave the node
        silently."""
        try:
            arr = np.asarray(board, np.int32)
            n = arr.shape[0]
            for i in range(n):
                for j in range(n):
                    v = int(arr[i][j])
                    if v and int(solution[i][j]) != v:
                        return False
            return oracle_is_valid_solution(solution)
        except Exception:  # noqa: BLE001 — malformed answer = invalid answer
            return False

    # -- watchdog / half-open loop -----------------------------------------
    def _watch_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self._tick_s)
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                logger.exception("engine watchdog tick failed")

    def _tick(self) -> None:
        now = time.monotonic()
        # engine-warmed widths, read BEFORE taking the supervisor lock
        # (engine state is never read under it — never nest the two)
        try:
            warm_widths = set(self._engine._watched_widths())
        except Exception:  # noqa: BLE001 — engines without the warm plane
            warm_widths = set()
        fires = []
        probe = False
        rebuild = False
        with self._lock:
            # 1) hung-call detection — only for widths that have proven a
            # completed call before (or that warmup marked warm): a
            # width's first call may legitimately include the kernel
            # build (see _seen_widths above)
            for tok in self._inflight.values():
                if (
                    not tok.hung
                    and now - tok.t0
                    > self.watchdog_budget_s * tok.budget_scale
                    and (
                        tok.bucket in self._seen_widths
                        or tok.bucket in warm_widths
                    )
                ):
                    tok.hung = True
                    self.hangs += 1
                    logger.warning(
                        "device call (bucket %d) exceeded %.3fs watchdog "
                        "budget — declared hung, bucket quarantined",
                        tok.bucket,
                        self.watchdog_budget_s,
                    )
                    fires.append(
                        self._record_failure_locked(tok.bucket, "hang")
                    )
            # 2) warm promotion: an engine whose tier-0 warm-up finished
            # ran what one request needs — WARMING has nothing left to
            # wait for (the rest of the ladder may still be widening)
            if self.state == WARMING and getattr(self._engine, "warmed", False):
                fires.append(
                    self._transition_locked(HEALTHY, "engine warm")
                )
            # 3) a probe thread stuck in a truly hung device call (or a
            # hung rebuild) must not wedge recovery forever: past the
            # abandon horizon the flag is reclaimed so a LATER probe can
            # run once the device comes back — the zombie thread is
            # daemon and its epoch check keeps it from clearing the flag
            # under a newer probe
            if (
                self._probe_inflight
                and now - self._probe_started > self._probe_abandon_s()
            ):
                logger.warning(
                    "half-open probe unresponsive for %.1fs — abandoning "
                    "it (a later probe will retry)",
                    now - self._probe_started,
                )
                self.probes_abandoned += 1
                self._probe_inflight = False
            # 4) half-open probe scheduling
            if (
                self.state in (DEGRADED, LOST)
                and not self._probe_inflight
                and now >= self._probe_due
            ):
                self._probe_inflight = True
                self._probe_started = now
                self._probe_epoch += 1
                epoch = self._probe_epoch
                self._probe_due = now + self.probe_interval_s
                probe = True
                rebuild = self.state == LOST and not self._rebuilt_this_episode
                if rebuild:
                    self._rebuilt_this_episode = True
        for payload in fires:
            self._fire(payload)
        if probe:
            # a hung probe must never stall this loop: it runs on its own
            # daemon thread; the watchdog supervises its device call like
            # any other and the abandon horizon above reclaims the slot
            threading.Thread(
                target=self._probe_and_maybe_rebuild,
                args=(rebuild, epoch),
                name="engine-probe",
                daemon=True,
            ).start()

    def _probe_abandon_s(self) -> float:
        """How long a probe thread may stay silent before its slot is
        reclaimed: past every legitimate cause (a watchdog budget of
        device wall time, a rebuild's warm-up, plus the probe cadence
        itself)."""
        return max(
            2.0 * self.watchdog_budget_s, 4.0 * self.probe_interval_s, 1.0
        )

    def _probe_and_maybe_rebuild(self, rebuild: bool, epoch: int) -> None:
        try:
            if rebuild:
                self._rebuild()
            self.probe()
        finally:
            with self._lock:
                # only the CURRENT probe may clear the flag: an abandoned
                # zombie finishing late must not release a newer probe's
                # slot
                if self._probe_epoch == epoch:
                    self._probe_inflight = False

    def _rebuild(self) -> None:
        """LOST recovery step: re-warm the engine (``engine.warmup``:
        every bucket width and the segment pool once; the kernel library
        is already built, so this costs launches, not a build). Failure
        is fine: the probe after it will fail and the breaker stays
        open."""
        with self._lock:
            self.rebuilds += 1
        logger.warning("engine supervisor: LOST — re-warming the engine")
        try:
            self._engine.warmup()
        except Exception:  # noqa: BLE001 — a failed rebuild keeps LOST
            logger.exception("engine rebuild (warmup) failed")

    def probe(self) -> bool:
        """One half-open probe: a real device round trip through the
        guarded seam, verified host-side. Success — and only success —
        re-admits the device (state → HEALTHY, breaker reset, quarantine
        cleared). Safe to call directly from tests."""
        with self._lock:
            self.probes += 1
        self._probe_tls.active = True
        spec = self._engine.spec
        board = np.zeros((spec.size, spec.size), np.int32)
        ok = False
        verify_failed = False
        try:
            # the empty board: solvable at every spec, answered by the
            # DFS kernel at the smallest unquarantined bucket
            rows = self._engine._solve_padded(board[None])
            row = rows[0]
            C = spec.cells
            solution = row[:C].reshape(spec.size, spec.size).tolist()
            ok = bool(row[C]) and self.check_solution(board, solution)
            verify_failed = not ok
        except Exception:  # noqa: BLE001 — probe failure keeps the breaker open
            # the guarded seam already fed this exception to the breaker
            # (call_finished ok=False); only count the probe attempt here
            logger.info("half-open probe raised", exc_info=True)
            ok = False
        finally:
            self._probe_tls.active = False
        fire = None
        with self._lock:
            if ok:
                fire = self._transition_locked(HEALTHY, "probe verified")
            else:
                self.probe_failures += 1
                if verify_failed:
                    # the device ANSWERED but answered wrong (poisoned
                    # program): the seam saw a clean call, so the breaker
                    # must hear about it here
                    self.bad_results += 1
                    fire = self._record_failure_locked(
                        None, "probe-bad-result"
                    )
        self._fire(fire)
        return ok

    # -- observability ------------------------------------------------------
    def snapshot(self) -> dict:
        """The supervisor's operator view (the JAX node serves it as the
        ``health`` block of ``GET /metrics``): state machine, breaker,
        quarantine, fallback and probe counters, recent transitions."""
        with self._lock:
            return {
                "state": self.state,
                "since_s": round(time.monotonic() - self._since, 3),
                "consecutive_failures": self.consecutive_failures,
                "breaker_threshold": self.breaker_threshold,
                "watchdog_budget_s": self.watchdog_budget_s,
                "quarantined_buckets": sorted(self._quarantined),
                "inflight_calls": len(self._inflight),
                "failures": self.failures,
                "hangs": self.hangs,
                "bad_results": self.bad_results,
                "late_successes": self.late_successes,
                "probes": self.probes,
                "probe_failures": self.probe_failures,
                "probes_abandoned": self.probes_abandoned,
                "rebuilds": self.rebuilds,
                "fallback": {
                    "served": self.fallback_served,
                    "concurrency": self.fallback_concurrency,
                    "budget_s": self.fallback_budget_s,
                    "budget_trips": self.fallback_budget_trips,
                },
                "transitions": list(self._transitions),
            }
