"""Request-coalescing micro-batch scheduler: live traffic fills the buckets.

The engine solves boards in fixed-width buckets, one kernel launch a
bucket. Served one board per request, concurrent ``/solve`` clients would
each pay a width-1 call. This module batches them, closed loop:

  * concurrent ``solve_one_async`` callers enqueue (board, Future) pairs on
    a shared queue;
  * ONE dispatcher thread drains the queue into the smallest bucket ≥ the
    pending count — waiting at most ``max_wait_s`` (default 2 ms) past the
    oldest request's arrival, so a lone request still dispatches soon —
    and launches ONE device call. When requests are still actively
    ARRIVING at the deadline (a completion fan-out wakes a cohort of
    closed-loop clients, whose next requests trickle in over several ms of
    handler scheduling), it keeps absorbing until arrivals pause for
    ``quiescence_s`` or the ``burst_wait_s`` cap — a Nagle-style extension
    that engages only when the queue is visibly filling;
  * the host side is double-buffered: the dispatcher enqueues batch N's
    device work (``engine._dispatch_padded`` returns without waiting for
    the device) and immediately starts stacking batch N+1 while a separate
    completion thread waits for batch N's rows (``engine._finalize_padded``)
    and fans them back to the waiting futures. ``inflight_depth`` bounds
    the pipeline (default 2); the bounded hand-off queue is the
    backpressure.

There every dispatched batch runs to completion before its futures
resolve (closed loop). The serving default is CONTINUOUS batching instead
(``continuous=True``, what the engine passes unless built with
``continuous=False``): one segment-loop thread runs the device loop open
loop over a fixed-width lane pool. Each bounded segment of the segment
kernel (engine.dispatch_segment) carries the pool's whole solver state
from one segment to the next on the device; at every boundary the segment loop
answers finished lanes at once, drops queued requests whose deadline
passed, evicts lanes past the step budget to the deep retry, and injects
queued boards into the freed lanes. The pipelined segment loop (the default;
``segment_pipeline=False`` on the engine gives the serial one) also
dispatches segment N+1 before fanning out segment N's answers, chains a
segment ahead when there is nothing to inject, and stages the refill
boards on the device while a segment runs (``_InjectionPrestager``).

A batch or segment whose dispatch or completion raises — a kernel that
does not build or launch, say — fails every future it holds with the
exception (for a segment: every resident lane, and the pool is rebuilt);
the loop goes on. Nothing reruns elsewhere.

Counters (``stats()``): dispatched batches/boards, the realized batch-fill
(boards per device call — the number the whole layer exists to raise),
queue depth, and request wait time; with continuous batching also
segments, refills, active lanes, the pool width and the pipeline's
counters. Served on the opt-in ``/stats`` serving block
(net/http_api.py) and the ``/metrics`` ``engine.coalescer`` block.

Request spans (obs/trace.py): each queued request carries the span of the
thread that submitted it, and the coalescer's threads stamp its
``queue``, ``coalesce`` and ``device`` stages, its ``bucket`` (the batch
or pool width), ``batch_id`` and, on the open loop, ``segments``, always
BEFORE resolving its future. Every dispatched batch, and every segment
that boards requests, also feeds the engine's cost plane a formation
sample (``cost.note_formation``: the oldest rider's wait and the fill).
With overlapping segments the per-segment ``device`` stamps of a request
can sum past its wall time, as in the JAX node.

The port of ``sudoku_solver_distributed_tpu/parallel/coalescer.py``.
"""

from __future__ import annotations

import heapq
import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from ..obs.trace import current_trace
from ..ops.solver import RUNNING, pad_board
from ..serving.admission import DeadlineExceeded
from ..utils.profiling import annotate

logger = logging.getLogger(__name__)

_SENTINEL = object()

# continuous batching's slot assignment: the pseudo-deadline a request
# without one boards under when lanes are contended, which bounds how long
# deadline-carrying traffic can keep it waiting
NO_DEADLINE_HORIZON_S = 60.0

# a board still RUNNING after this many segment boundaries counts as deep
# for the deep-lane cap (easy boards resolve within about one segment)
DEEP_RESIDENT_SEGMENTS = 4


def _edf_key(r: "_Request") -> float:
    """Earliest-deadline-first boarding key, with the liveness floor for
    requests without a deadline: one definition for the boundary's slot
    assignment and the prestager, so a staged stack covers the take."""
    return (
        r.deadline
        if r.deadline is not None
        else r.enqueued + NO_DEADLINE_HORIZON_S
    )


def _resolve(future: Future, result=None, exc=None) -> None:
    """Deliver a result/exception to a future that a caller may cancel
    concurrently: the ``done()`` pre-check alone races that cancel, and an
    unguarded ``set_result`` raising InvalidStateError would kill the
    coalescer thread that calls it."""
    if future.done():
        return
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:  # noqa: BLE001 — cancelled in the race window
        logger.debug("future resolved after caller cancelled it")


class _Request:
    __slots__ = ("board", "future", "enqueued", "deadline", "trace")

    def __init__(self, board: np.ndarray, deadline: Optional[float] = None):
        self.board = board
        self.future: Future = Future()
        self.enqueued = time.monotonic()
        # absolute monotonic deadline (serving/admission.py) or None; an
        # expired request is dropped at batch-formation time so the device
        # never solves a board nobody is waiting for
        self.deadline = deadline
        # the submitting thread's request span (obs/trace.py), captured at
        # enqueue: the coalescer's threads stamp its stages strictly
        # BEFORE resolving the future, so the handler thread's read after
        # the future resolves sees them. None (no tracer) costs one slot.
        self.trace = current_trace()


class _InjectionPrestager:
    """Places the next boundary's refill boards on the device while the
    current segment runs (pipelined continuous arm).

    Which queued board lands in which freed lane is known only at the
    boundary, but the (width, N, N) stack of boards can be copied as soon
    as the requests are queued: the source map (``src``) the boundary sends
    then decouples board values from lane positions. A worker thread
    snapshots the queue earliest-deadline first (``_edf_key``, as the
    boundary takes), stacks the first ``width`` boards and copies them on
    the engine's staging stream (``engine._stage_boards``); the segment loop
    claims the stage at the boundary and builds the stack inline when a
    taken request is not in it. A stale stage costs only its copy."""

    def __init__(self, coalescer: "BatchCoalescer", width: int):
        self._co = coalescer
        self._width = width
        self._cond = threading.Condition()
        self._wanted = False
        self._shutdown = False
        # (id(request) -> staged row, staged boards, request refs: the
        # refs keep the ids stable while the map lives)
        self._staged: Optional[tuple] = None
        self._thread = threading.Thread(
            target=self._run, name="coalescer-prestage", daemon=True
        )
        self._thread.start()

    def poke(self) -> None:
        """A segment was dispatched: rebuild the stage for the next
        boundary from the queue as it is now. Paced by the segment loop, once a
        segment, never by arrivals."""
        with self._cond:
            self._wanted = True
            self._cond.notify()

    def poke_if_unstaged(self) -> None:
        """Arrival-path nudge: stage only when nothing is staged or asked
        for (the empty-queue-then-first-arrival case). The unlocked
        pre-check is a benign race: a missed nudge is repaired by the next
        dispatch's poke."""
        if self._staged is not None or self._wanted:
            return
        with self._cond:
            if self._staged is None and not self._wanted:
                self._wanted = True
                self._cond.notify()

    def claim(self) -> Optional[tuple]:
        """Take the current stage once: ``(rowmap, staged, refs)`` or None."""
        with self._cond:
            staged, self._staged = self._staged, None
            return staged

    def close(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        eng = self._co._engine
        N = eng.spec.size
        while True:
            with self._cond:
                while not self._wanted and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                self._wanted = False
            with self._co._cond:
                # a bounded snapshot, EDF over a FIFO prefix: under
                # overload the queue holds thousands, and a full scan per
                # segment would cost more than the copy it stages
                pending = [
                    r for _, r in zip(range(4 * self._width), self._co._pending)
                ]
            if not pending:
                continue
            ordered = heapq.nsmallest(self._width, pending, key=_edf_key)
            boards_np = np.zeros((self._width, N, N), np.int32)
            rowmap = {}
            for j, r in enumerate(ordered):
                boards_np[j] = r.board
                rowmap[id(r)] = j
            try:
                staged = eng._stage_boards(boards_np)
            except Exception:  # noqa: BLE001 — staging is best-effort
                logger.exception("injection prestage failed")
                continue
            with self._cond:
                if not self._shutdown:
                    self._staged = (rowmap, staged, ordered)


class BatchCoalescer:
    """Batches concurrent single-board requests into one device call.

    Args:
      engine: the owning SolverEngine (bucket ladder, ``_dispatch_padded``
        / ``_finalize_padded``, ``_account_coalesced``, ``_row_result``).
      max_wait_s: longest a request may sit waiting for co-riders before its
        batch dispatches anyway — when the queue is quiescent. A lone
        request's added cost over the direct path is bounded by this.
      quiescence_s: burst detector. At the ``max_wait_s`` deadline the
        dispatcher checks whether a request arrived within the last
        ``quiescence_s``; if so the queue is still filling and it keeps
        absorbing until arrivals pause that long, bounded by
        ``burst_wait_s``. A lone request has no trailing arrivals, so this
        never delays it.
      burst_wait_s: hard cap on the absorb extension, measured from the
        oldest pending request's arrival (defaults to 10 × ``max_wait_s``).
      inflight_depth: dispatched-but-unfetched batches allowed (≥1). 2 =
        double buffering: stack batch N+1 while batch N runs.
      max_batch: cap on boards per dispatched batch (None → the largest
        bucket).
      max_pending: queue bound; ``submit`` blocks past it (backpressure —
        the HTTP thread pool is the natural concurrency cap above us).
      wait_policy: optional serving.load.AdaptiveWaitPolicy — when set,
        the three wait budgets above become CAPS and each batch formation
        asks the policy for the current values (near-zero when idle,
        stretched toward the caps under load).
      continuous: run the open-loop segment loop instead of the
        closed-loop dispatcher/completer pair (module docstring): the
        engine's ``segment_pipeline`` picks the pipelined or the serial
        segment loop. The wait budgets do not apply there except to an idle
        pool, which absorbs a burst of arrivals for at most ``max_wait_s``
        (``quiescence_s`` between arrivals) before its first segment;
        a request otherwise boards at the next segment boundary.
      deep_lane_cap: (continuous only) while requests queue, boards
        resident past ``DEEP_RESIDENT_SEGMENTS`` boundaries may hold at
        most this many lanes; the overage, longest resident first and no
        more than the unmet demand, is evicted to the deep retry (the
        board still answers, its counters accumulated). 0: off.
    """

    def __init__(
        self,
        engine,
        *,
        max_wait_s: float = 0.002,
        quiescence_s: float = 0.001,
        burst_wait_s: Optional[float] = None,
        inflight_depth: int = 2,
        max_batch: Optional[int] = None,
        max_pending: int = 8192,
        wait_policy=None,
        continuous: bool = False,
        deep_lane_cap: int = 0,
    ):
        if inflight_depth < 1:
            raise ValueError("inflight_depth must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if quiescence_s < 0:
            raise ValueError("quiescence_s must be >= 0")
        if max_batch is not None and max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._engine = engine
        self.max_wait_s = max_wait_s
        self.quiescence_s = quiescence_s
        if burst_wait_s is None:
            burst_wait_s = 10.0 * max_wait_s
        self.burst_wait_s = max(burst_wait_s, max_wait_s)
        self.wait_policy = wait_policy
        self.max_pending = max_pending
        self._max_batch = min(engine.buckets[-1], max_batch or engine.buckets[-1])
        self._pending: deque = deque()
        self._last_arrival = 0.0  # monotonic time of the newest submit
        self._cond = threading.Condition()
        # bounded dispatcher→completer hand-off; its maxsize IS the
        # double-buffer depth (put blocks when the pipeline is full)
        self._inflight: queue.Queue = queue.Queue(maxsize=inflight_depth)
        self._shutdown = False
        self._started = False
        self._start_lock = threading.Lock()
        self._dispatcher: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.batches = 0
        self.boards = 0
        self.last_batch_fill = 0
        self.max_batch_fill = 0
        self.max_queue_depth = 0
        self.expired = 0  # requests dropped at batch formation (deadline)
        # whole batches failed by a device-call exception (dispatch or
        # completion): every future in such a batch got the exception
        self.failed_batches = 0
        self._wait_sum_s = 0.0
        self._wait_max_s = 0.0
        # the continuous segment loop's state
        self.continuous = bool(continuous)
        self._segment_thread: Optional[threading.Thread] = None
        self.segments = 0       # device segments dispatched
        self.refills = 0        # boards injected into freed lanes
        self._occupied = 0      # lanes holding a live request (gauge)
        self._retry_threads: list = []  # in-flight capped-lane deep retries
        # speculative dispatches (issued before the previous digest was
        # read) and the prestager's hits and misses
        self.pipelined = 0
        self.prestage_hits = 0
        self.prestage_misses = 0
        self._prestager: Optional[_InjectionPrestager] = None
        self.deep_lane_cap = max(0, int(deep_lane_cap))
        self.deep_evictions = 0  # residents evicted over the cap

    def _continuous_active(self) -> bool:
        """Whether the open-loop segment loop serves (the port's engine always
        has its segment kernel, so the flag decides)."""
        return self.continuous

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
            if self._continuous_active():
                pipelined = bool(
                    getattr(self._engine, "segment_pipeline", False)
                )
                # the prestager overlaps the refill stack's copy with the
                # running segment; on a host with one CPU there is nothing
                # to overlap it with, so it arms only on more.
                # SUDOKU_SEGMENT_PRESTAGE=1 or 0 overrides
                env = os.environ.get("SUDOKU_SEGMENT_PRESTAGE")
                prestage = (
                    env == "1" if env in ("0", "1")
                    else (os.cpu_count() or 1) > 1
                )
                if pipelined and prestage:
                    self._prestager = _InjectionPrestager(
                        self, self._engine.segment_pool_width()
                    )
                self._segment_thread = threading.Thread(
                    target=(
                        self._segment_loop_pipelined
                        if pipelined
                        else self._segment_loop
                    ),
                    name="coalescer-segments",
                    daemon=True,
                )
                self._segment_thread.start()
                return
            self._dispatcher = threading.Thread(
                target=self._dispatcher_loop,
                name="coalescer-dispatch",
                daemon=True,
            )
            self._completer = threading.Thread(
                target=self._completer_loop,
                name="coalescer-complete",
                daemon=True,
            )
            self._dispatcher.start()
            self._completer.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain everything already queued, join.

        Every pending/in-flight future resolves before this returns: the
        dispatcher keeps draining after the flag flips and only then hands
        the completer its sentinel; the segment loop runs segments until
        every resident lane resolved (deep retries included)."""
        with self._cond:
            if self._shutdown:
                return
            self._shutdown = True
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=timeout)
        if self._completer is not None:
            self._completer.join(timeout=timeout)
        if self._segment_thread is not None:
            self._segment_thread.join(timeout=timeout)
        if self._prestager is not None:
            self._prestager.close()
        for t in list(self._retry_threads):
            t.join(timeout=timeout)

    # -- client surface ----------------------------------------------------
    def submit(
        self, board: np.ndarray, deadline_s: Optional[float] = None
    ) -> Future:
        """Enqueue one board; the Future resolves to (solution | None, info)
        with the same contract as ``SolverEngine.solve_one``. Raises
        ValueError synchronously on a wrong-shape board — an unvalidated
        board must fail ITS caller, not the np.stack of everyone coalesced
        into the same batch.

        ``deadline_s`` is an absolute ``time.monotonic()`` deadline
        (serving/admission.py): a request still queued past it is dropped
        at batch-formation time and its future raises DeadlineExceeded. A
        request whose batch already dispatched is delivered normally (the
        deadline guards queue wait, not service time already paid)."""
        self.start()
        if self.wait_policy is not None:
            self.wait_policy.on_arrival()
        req = _Request(np.asarray(board, np.int32), deadline_s)
        size = self._engine.spec.size
        if req.board.shape != (size, size):
            raise ValueError(
                f"board must be {size}x{size}, got {req.board.shape}"
            )
        with self._cond:
            if self._shutdown:
                raise RuntimeError("coalescer is shut down")
            while len(self._pending) >= self.max_pending:
                self._cond.wait(timeout=0.1)
                if self._shutdown:
                    raise RuntimeError("coalescer is shut down")
            self._pending.append(req)
            self._last_arrival = req.enqueued
            depth = len(self._pending)
            self._cond.notify_all()
        if self._prestager is not None:
            # stage an empty stage from the arrival path; rebuilds are
            # paced by the segment loop's per-dispatch poke
            self._prestager.poke_if_unstaged()
        if depth > self.max_queue_depth:
            # benign race on a monotone high-water mark
            self.max_queue_depth = depth
        return req.future

    def solve(self, board: np.ndarray):
        """Blocking convenience for library/test callers."""
        return self.submit(board).result()

    def stats(self) -> dict:
        with self._stats_lock:
            batches = self.batches
            boards = self.boards
            fill = boards / batches if batches else 0.0
            out = {
                "batches": batches,
                "boards": boards,
                "batch_fill_avg": round(fill, 3),
                "batch_fill_last": self.last_batch_fill,
                "batch_fill_max": self.max_batch_fill,
                "avg_wait_ms": round(
                    (self._wait_sum_s / boards * 1e3) if boards else 0.0, 3
                ),
                "max_wait_ms": round(self._wait_max_s * 1e3, 3),
                "max_wait_budget_ms": round(self.max_wait_s * 1e3, 3),
                # observed max_wait_ms legitimately exceeds the budget when
                # the pipeline-full / burst-absorb extensions engage; these
                # two bound the second
                "quiescence_ms": round(self.quiescence_s * 1e3, 3),
                "burst_wait_budget_ms": round(self.burst_wait_s * 1e3, 3),
                "expired": self.expired,
                "failed_batches": self.failed_batches,
            }
            if self._continuous_active():
                # the open-loop segment loop's view: "batches" above count
                # segments there, "boards" the injected requests
                out["continuous"] = True
                out["segments"] = self.segments
                out["refills"] = self.refills
                out["active_lanes"] = self._occupied
                out["pipeline"] = bool(
                    getattr(self._engine, "segment_pipeline", False)
                )
                out["pipelined_segments"] = self.pipelined
                out["prestage_hits"] = self.prestage_hits
                out["prestage_misses"] = self.prestage_misses
                out["deep_lane_cap"] = self.deep_lane_cap
                out["deep_evictions"] = self.deep_evictions
                out["segment_width"] = (
                    self._engine.segment_pool_width()
                    if hasattr(self._engine, "segment_pool_width")
                    else None
                )
        with self._cond:
            out["queue_depth"] = len(self._pending)
        out["max_queue_depth"] = self.max_queue_depth
        if self.wait_policy is not None:
            out["adaptive"] = True
            out["current_max_wait_ms"] = round(
                self.wait_policy.current_max_wait_s * 1e3, 3
            )
            out["arrival_rate_hz"] = round(
                self.wait_policy.arrivals.rate(), 3
            )
        return out

    # -- dispatcher side ---------------------------------------------------
    def _next_batch(self) -> Optional[List[_Request]]:
        """Block for work, then coalesce: wait until the largest bucket
        could fill or ``max_wait_s`` has passed since the OLDEST pending
        request arrived. Past that deadline two extensions apply, in
        order:

          * pipeline FULL — keep accumulating: a batch dispatched now
            would only sit in the hand-off queue behind ``inflight_depth``
            earlier batches, so the extra wait costs no latency and every
            arrival in it raises the realized batch-fill for free;
          * burst still ARRIVING — a request landed within the last
            ``quiescence_s``, so keep absorbing until arrivals pause that
            long, capped at ``burst_wait_s`` past the oldest arrival. A
            lone request has no trailing arrivals and is never delayed
            past ``max_wait_s``.

        Drains up to the batch cap, dropping requests whose deadline
        already passed (their futures raise DeadlineExceeded — the device
        never solves a board nobody is waiting for). Returns None when
        shut down and fully drained."""
        while True:
            with self._cond:
                while not self._pending and not self._shutdown:
                    # bounded: the timeout guards a lost wakeup (a notify
                    # that raced this thread between the predicate check
                    # and the park would otherwise stall the only
                    # dispatcher of the engine)
                    self._cond.wait(timeout=0.25)
                if not self._pending:
                    return None  # shutdown, queue drained
                # fixed budgets, or the adaptive policy's current values
                # (read once per batch)
                if self.wait_policy is not None:
                    max_wait_s, quiescence_s, burst_wait_s = (
                        self.wait_policy.budgets(len(self._pending))
                    )
                    burst_wait_s = max(burst_wait_s, max_wait_s)
                else:
                    max_wait_s = self.max_wait_s
                    quiescence_s = self.quiescence_s
                    burst_wait_s = self.burst_wait_s
                deadline = self._pending[0].enqueued + max_wait_s
                burst_cap = self._pending[0].enqueued + burst_wait_s
                while (
                    len(self._pending) < self._max_batch
                    and not self._shutdown
                ):
                    now = time.monotonic()
                    if now < deadline:
                        self._cond.wait(timeout=deadline - now)
                    elif self._inflight.full():
                        # pipeline full: the completer notifies _cond when
                        # it frees a slot; the timeout guards a lost wakeup
                        self._cond.wait(timeout=0.05)
                    else:
                        quiet_at = self._last_arrival + quiescence_s
                        if now >= burst_cap or now >= quiet_at:
                            break
                        self._cond.wait(
                            timeout=min(quiet_at, burst_cap) - now
                        )
                    if not self._pending:
                        if self._shutdown:
                            return None
                        deadline = time.monotonic() + max_wait_s
                        burst_cap = time.monotonic() + burst_wait_s
                # drain up to a batch of LIVE requests; expired ones are
                # dropped here — after the wait, right before dispatch —
                # so every board that reaches the device still has a
                # waiting caller
                now = time.monotonic()
                batch: List[_Request] = []
                dropped: List[_Request] = []
                while self._pending and len(batch) < self._max_batch:
                    req = self._pending.popleft()
                    if req.deadline is not None and now > req.deadline:
                        dropped.append(req)
                    else:
                        batch.append(req)
                self._cond.notify_all()  # free submit() blocked on the cap
            if dropped:
                with self._stats_lock:
                    self.expired += len(dropped)
                # resolve outside the condition lock: future callbacks run
                # inline in set_exception and must not re-enter the queue
                for r in dropped:
                    if r.trace is not None:
                        # the expired request's whole life was queue wait
                        r.trace.mark("queue", now - r.enqueued)
                    _resolve(
                        r.future,
                        exc=DeadlineExceeded(
                            "deadline expired in the coalescer queue"
                        ),
                    )
            if batch:
                return batch
            # every drained request had expired: go back to waiting (or
            # drain the remainder on shutdown)

    def _dispatcher_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                break
            now = time.monotonic()
            try:
                # host phase: stack + pad into the bucket and enqueue ONE
                # batch's device work; returns before the device finishes,
                # so the next batch's host work overlaps this batch's
                with annotate(f"coalescer_dispatch_b{len(batch)}"):
                    boards = np.stack([r.board for r in batch])
                    handle = self._engine._dispatch_padded(boards)
            except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
                logger.exception("coalescer dispatch failed")
                with self._stats_lock:
                    self.failed_batches += 1
                for r in batch:
                    if r.trace is not None:
                        r.trace.mark("queue", now - r.enqueued)
                    _resolve(r.future, exc=e)
                continue
            t_dispatched = time.monotonic()
            with self._stats_lock:
                self.batches += 1
                batch_id = self.batches
                self.boards += len(batch)
                self.last_batch_fill = len(batch)
                if len(batch) > self.max_batch_fill:
                    self.max_batch_fill = len(batch)
                for r in batch:
                    w = now - r.enqueued
                    self._wait_sum_s += w
                    if w > self._wait_max_s:
                        self._wait_max_s = w
            # the cost plane's formation sample: the oldest rider's wait is
            # the latency this batch's coalescing added (one per BATCH)
            self._engine.cost.note_formation(now - batch[0].enqueued, len(batch))
            # span stamps, outside every lock: queue wait ended at batch
            # formation (now); coalesce is the stack/pad + device enqueue
            # that just ran; the padded width is the bucket
            bucket = int(handle.boards.shape[0])
            for r in batch:
                tr = r.trace
                if tr is not None:
                    tr.mark("queue", now - r.enqueued)
                    tr.mark("coalesce", t_dispatched - now)
                    tr.bucket = bucket
                    tr.batch_id = batch_id
            # blocks at pipeline depth
            self._inflight.put((handle, batch, t_dispatched))
        self._inflight.put(_SENTINEL)

    # -- completion side ---------------------------------------------------
    def _completer_loop(self) -> None:
        while True:
            item = self._inflight.get()
            # a hand-off slot just freed: wake a dispatcher that is
            # accumulating past its deadline because the pipeline was full
            with self._cond:
                self._cond.notify_all()
            if item is _SENTINEL:
                break
            handle, batch, t_dispatched = item
            try:
                # waits for this batch's rows; the dispatcher is already
                # stacking the next batch meanwhile
                with annotate("coalescer_device_wait"):
                    rows = self._engine._finalize_padded(handle)
                self._engine._account_coalesced(rows)
                results = [self._engine._row_result(row) for row in rows]
            except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
                logger.exception("coalescer completion failed")
                with self._stats_lock:
                    self.failed_batches += 1
                t_done = time.monotonic()
                for r in batch:
                    if r.trace is not None and not r.future.done():
                        # the failed call's wall time is still device time,
                        # but a future a starved caller already cancelled
                        # is never stamped (its handler may be finishing
                        # the span; Tracer.finish's stage snapshot covers
                        # the check-then-mark window)
                        r.trace.mark("device", t_done - t_dispatched)
                    _resolve(r.future, exc=e)
                continue
            # device stage: dispatch -> rows on the host, stamped before
            # the futures resolve; cancelled futures skipped, as above
            t_done = time.monotonic()
            for r in batch:
                if r.trace is not None and not r.future.done():
                    r.trace.mark("device", t_done - t_dispatched)
            for r, res in zip(batch, results):
                # a caller may cancel() its future while the batch is in
                # flight; _resolve absorbs the done-check/cancel race
                _resolve(r.future, result=res)

    # -- continuous batching: the segment loops --------------------------
    def _drain_expired_locked(self, now: float):
        """(cond held) Remove queued requests whose deadline passed — at
        every boundary, free lanes or not, so a request that expires while
        a segment runs is answered at the next boundary, not when a lane
        frees."""
        dropped = []
        if any(
            r.deadline is not None and now > r.deadline for r in self._pending
        ):
            live = []
            for r in self._pending:
                if r.deadline is not None and now > r.deadline:
                    dropped.append(r)
                else:
                    live.append(r)
            self._pending.clear()
            self._pending.extend(live)
        return dropped

    def _take_for_slots_locked(self, free: int):
        """(cond held) Deadline-aware slot assignment: when demand exceeds
        the freed lanes, earliest deadline boards first (a request without
        one counts as due ``NO_DEADLINE_HORIZON_S`` after its arrival);
        ``nsmallest``, not a sort, since only ``free`` board."""
        if free <= 0 or not self._pending:
            return []
        if len(self._pending) <= free:
            take = list(self._pending)
            self._pending.clear()
            return take
        take = heapq.nsmallest(free, self._pending, key=_edf_key)
        chosen = set(map(id, take))
        live = [r for r in self._pending if id(r) not in chosen]
        self._pending.clear()
        self._pending.extend(live)
        return take

    def _resolve_expired(self, dropped, now: float) -> None:
        if not dropped:
            return
        with self._stats_lock:
            self.expired += len(dropped)
        for r in dropped:
            if r.trace is not None:
                r.trace.mark("queue", now - r.enqueued)
            _resolve(
                r.future,
                exc=DeadlineExceeded("deadline expired in the coalescer queue"),
            )

    def _wait_for_work_locked(self, slots) -> bool:
        """(cond held) Block until a request is queued or a lane is busy;
        then, when the pool is idle, absorb a burst of arrivals (at most
        ``max_wait_s`` past the oldest, until ``quiescence_s`` passes with
        no arrival) so the first segment runs full. Never while lanes are
        busy: the segment cadence is the admission wait there. Returns
        False when shut down with nothing left."""
        busy = any(s is not None for s in slots)
        while not self._pending and not busy and not self._shutdown:
            self._cond.wait()
        if self._shutdown and not self._pending and not busy:
            return False
        if not busy:
            cap_at = (
                self._pending[0].enqueued if self._pending else time.monotonic()
            ) + self.max_wait_s
            while len(self._pending) < len(slots) and not self._shutdown:
                now = time.monotonic()
                quiet_at = self._last_arrival + self.quiescence_s
                if now >= cap_at or now >= quiet_at:
                    break
                self._cond.wait(timeout=min(cap_at, quiet_at) - now)
        return True

    def _note_segment(self, take, n_active: int, t_inject: float,
                      width: int) -> None:
        """Count one dispatched segment and its boarding requests: the
        stats, the cost plane's formation sample when requests board, and
        the boarding requests' queue and coalesce stamps, bucket (the pool
        width) and batch_id (the segment's)."""
        with self._stats_lock:
            self.batches += 1  # a segment is a device dispatch
            segment_id = self.batches
            self.segments += 1
            self.boards += len(take)
            self.refills += len(take)
            self.last_batch_fill = n_active
            self._occupied = n_active
            if n_active > self.max_batch_fill:
                self.max_batch_fill = n_active
            for r in take:
                w = t_inject - r.enqueued
                self._wait_sum_s += w
                if w > self._wait_max_s:
                    self._wait_max_s = w
        if take:
            self._engine.cost.note_formation(
                t_inject - min(r.enqueued for r in take), n_active
            )
        t_disp = time.monotonic()
        for r in take:
            if r.trace is not None:
                r.trace.mark("queue", t_inject - r.enqueued)
                r.trace.mark("coalesce", t_disp - t_inject)
                r.trace.bucket = width
                r.trace.batch_id = segment_id

    @staticmethod
    def _stamp_segment(slots, device_s: float) -> None:
        """Every resident request's span: one more segment, and its
        dispatch-to-fetch time as device time — stamped before any future
        of the boundary resolves."""
        for r in slots:
            if r is not None and r.trace is not None and not r.future.done():
                r.trace.mark("device", device_s)
                r.trace.segments += 1

    def _classify(self, slots, ages, stale, rows, C: int):
        """Boundary bookkeeping shared by both segment loops: free the lanes whose
        board finished (returned as (request, row)), evict lanes past the
        step budget and, under queue pressure, deep residents over
        ``deep_lane_cap`` (returned as (request, row copy) for the deep
        retry; their lanes go to ``stale`` for re-seeding), and age the
        rest."""
        eng = self._engine
        resolved, deep_entries = [], []
        for i, r in enumerate(slots):
            if r is None:
                continue
            row = rows[i]
            if int(row[C + 1]) != RUNNING:
                slots[i] = None
                resolved.append((r, row))
            elif int(row[C + 4]) >= eng.max_iters:
                # the lane exhausted its step budget: finish it on the deep
                # retry, off this loop; its device row still reads RUNNING,
                # so the lane is re-seeded at the next boundary
                slots[i] = None
                stale.add(i)
                deep_entries.append((r, row.copy()))
            else:
                ages[i] += 1
        if self.deep_lane_cap > 0:
            now = time.monotonic()
            with self._cond:
                # live demand only: requests that expired mid-segment are
                # answered 429 at the next drain, not seated
                demand = sum(
                    1 for r in self._pending
                    if r.deadline is None or r.deadline >= now
                )
            if demand > 0:
                deep = [
                    i for i, r in enumerate(slots)
                    if r is not None and ages[i] >= DEEP_RESIDENT_SEGMENTS
                ]
                free = sum(1 for s in slots if s is None)
                # an eviction re-solves from scratch: free only the lanes
                # the queue cannot fill from this boundary's free lanes
                overage = min(len(deep) - self.deep_lane_cap,
                              max(0, demand - free))
                if overage > 0:
                    deep.sort(key=lambda i: -ages[i])
                    for i in deep[:overage]:
                        deep_entries.append((slots[i], rows[i].copy()))
                        slots[i] = None
                        stale.add(i)
                        with self._stats_lock:
                            self.deep_evictions += 1
        return resolved, deep_entries

    def _fail_residents(self, slots, exc, t_anchor: Optional[float]) -> None:
        """A segment failed: every resident lane's future gets ``exc``; the
        time since ``t_anchor`` (the failed segment's dispatch) is its
        device time."""
        with self._stats_lock:
            self.failed_batches += 1
        t_done = time.monotonic()
        for i, r in enumerate(slots):
            if r is not None:
                slots[i] = None
                if (t_anchor is not None and r.trace is not None
                        and not r.future.done()):
                    r.trace.mark("device", t_done - t_anchor)
                _resolve(r.future, exc=exc)

    def _segment_loop(self) -> None:
        """The serial open-loop segment loop (``segment_pipeline=False``): one
        thread, one lane pool, one segment at a time with its full rows
        read back. Between segments it answers finished lanes, evicts
        capped lanes to the deep retry, drops expired requests and refills
        freed lanes. The pool's state never visits the host."""
        eng = self._engine
        width = eng.segment_pool_width()
        N = eng.spec.size
        C = eng.spec.cells
        slots: list = [None] * width
        ages = [0] * width  # boundaries each resident has survived
        state = None
        zeros = np.zeros((width, N, N), np.int32)
        pad_np = pad_board(eng.spec).numpy()
        # lanes whose resident went to the deep retry: the device row
        # still reads RUNNING, so the lane is re-seeded (with a request or
        # the pad board) at the next boundary, or it would search on for
        # nobody
        stale: set = set()
        idle_boards = eng._device_batch(zeros)
        idle_inject = np.zeros((width,), np.int32)
        # The budget doubles per boundary that resolved and injected
        # nothing (every resident is deep in its search, so boundaries buy
        # nothing), up to 4 doublings, and snaps back on any progress.
        boost = 0
        base_k = int(eng.segment_iters)
        # when the previous segment's rows arrived, while lanes stay busy:
        # the boundary host gap the cost plane reports (None across idle
        # waits, so waiting for work never reads as boundary cost)
        last_done = None
        while True:
            with self._cond:
                if not self._pending and not any(s is not None for s in slots):
                    last_done = None  # pool idle: the gap is no boundary
                if not self._wait_for_work_locked(slots):
                    break
                now = time.monotonic()
                dropped = self._drain_expired_locked(now)
                free_idx = [i for i, s in enumerate(slots) if s is None]
                take = self._take_for_slots_locked(len(free_idx))
                self._cond.notify_all()  # submit() blocked on max_pending
            self._resolve_expired(dropped, now)
            if not take and not any(s is not None for s in slots):
                continue  # everything drained had expired
            t_inject = time.monotonic()
            if take or stale:
                inject = np.zeros((width,), np.int32)
                boards = zeros.copy()
                for r, i in zip(take, free_idx):
                    slots[i] = r
                    ages[i] = 0
                    inject[i] = 1
                    boards[i] = r.board
                    stale.discard(i)
                for i in stale:
                    inject[i] = 1
                    boards[i] = pad_np
                stale.clear()
            else:
                boards, inject = idle_boards, idle_inject
            active = np.array([s is not None for s in slots])
            n_active = int(active.sum())
            if state is None:
                state = eng.new_segment_pool(width)
            self._note_segment(take, n_active, t_inject, width)
            if take:
                boost = 0
            t_call = time.monotonic()
            try:
                with annotate(f"coalescer_segment_a{n_active}"):
                    state, rows, device_s = eng.run_segment_supervised(
                        state, boards, inject, active=active,
                        seg_iters=base_k << boost, injected=len(take),
                        boundary_host_s=(
                            t_call - last_done if last_done is not None else 0.0
                        ),
                    )
                last_done = time.monotonic()
            except Exception as e:  # noqa: BLE001 — fail residents, not the loop
                logger.exception("continuous segment failed")
                self._fail_residents(slots, e, t_call)
                state = None  # the pool is suspect: rebuild on demand
                stale.clear()
                # the failed span is fault time, not boundary host time
                last_done = None
                continue
            self._stamp_segment(slots, device_s)
            resolved, deep_entries = self._classify(slots, ages, stale, rows, C)
            for r, row in resolved:
                _resolve(r.future, result=eng._row_result(row, routed="continuous"))
            for r, row in deep_entries:
                self._spawn_deep_retry(r, row)
            if resolved:
                eng._account_coalesced(np.stack([row for _, row in resolved]))
            boost = 0 if (resolved or take) else min(boost + 1, 4)

    def _segment_loop_pipelined(self) -> None:
        """The pipelined open-loop segment loop, the default: ``_segment_loop``'s
        contract with the boundary overlapped three ways.

          * dispatch before resolve: once segment N's digest is read,
            segment N+1 is dispatched first, and the answers, deep-retry
            spawns and accounting of N run while N+1 is on the device;
          * one-deep speculation: when the next boundary provably has
            nothing to inject (an empty, quiet queue and no stale lanes),
            N+1 is chained onto N's pool handle before N's digest is read,
            so the device runs them back to back;
          * pre-staging: the prestager copies the refill boards to the
            device while a segment runs, and the boundary sends only the
            per-lane source map.

        Any dispatch or fetch failure fails the resident futures and
        rebuilds the pool (its state was updated in place by a segment
        that failed, and a speculative successor is abandoned unread)."""
        eng = self._engine
        width = eng.segment_pool_width()
        N = eng.spec.size
        C = eng.spec.cells
        slots: list = [None] * width
        ages = [0] * width
        state = None
        stale: set = set()
        zeros = np.zeros((width, N, N), np.int32)
        # the idle (no-injection) pair on the device, reused: speculative
        # dispatches always send it
        idle_boards = eng._device_batch(zeros)
        idle_src = eng._device_batch(np.full((width,), -1, np.int32))
        boost = 0
        base_k = int(eng.segment_iters)
        inflight = None         # a dispatched segment whose digest is unread
        last_fetch_done = None  # when the previous digest arrived

        def fail_pool(exc, t_anchor) -> None:
            nonlocal state, last_fetch_done
            last_fetch_done = None
            self._fail_residents(slots, exc, t_anchor)
            stale.clear()
            state = None

        def build_and_dispatch(take, free_idx, t_inject):
            """Seat ``take`` in the freed lanes, build the injection (the
            staged stack when it covers the take, else inline), and
            dispatch one segment; returns its handle."""
            nonlocal state, boost
            if take or stale:
                src = np.full((width,), -1, np.int32)
                staged = (
                    self._prestager.claim() if self._prestager is not None
                    else None
                )
                use_staged = staged is not None and all(
                    id(r) in staged[0] for r in take
                )
                for r, i in zip(take, free_idx):
                    slots[i] = r
                    ages[i] = 0
                    stale.discard(i)
                # abandoned deep-retry lanes the queue did not refill
                # re-seed from the pad board (src -2)
                for i in stale:
                    src[i] = -2
                stale.clear()
                if use_staged:
                    rowmap, staged_boards, _refs = staged
                    for r, i in zip(take, free_idx):
                        src[i] = rowmap[id(r)]
                    boards = eng._claim_staged(staged_boards)
                    if take:
                        with self._stats_lock:
                            self.prestage_hits += 1
                else:
                    boards = zeros.copy()
                    for j, (r, i) in enumerate(zip(take, free_idx)):
                        boards[j] = r.board
                        src[i] = j
                    boards = boards if take else idle_boards
                    if take and self._prestager is not None:
                        with self._stats_lock:
                            self.prestage_misses += 1
            else:
                boards, src = idle_boards, idle_src
            n_active = sum(1 for s in slots if s is not None)
            if state is None:
                state = eng.new_segment_pool(width)
            self._note_segment(take, n_active, t_inject, width)
            if take:
                boost = 0
            with annotate(f"coalescer_segment_a{n_active}"):
                handle = eng.dispatch_segment(
                    state, boards, src=src, seg_iters=base_k << boost,
                    injected=len(take),
                    boundary_host_s=(
                        time.monotonic() - last_fetch_done
                        if last_fetch_done is not None else 0.0
                    ),
                )
            state = handle.state
            if self._prestager is not None:
                self._prestager.poke()
            return handle

        while True:
            # -- a segment in flight (pool-idle intake) ------------------
            if inflight is None:
                with self._cond:
                    if not self._pending and not any(
                        s is not None for s in slots
                    ):
                        last_fetch_done = None  # idle time is no boundary
                    if not self._wait_for_work_locked(slots):
                        break
                    now = time.monotonic()
                    dropped = self._drain_expired_locked(now)
                    free_idx = [i for i, s in enumerate(slots) if s is None]
                    take = self._take_for_slots_locked(len(free_idx))
                    self._cond.notify_all()
                self._resolve_expired(dropped, now)
                if not take and not any(s is not None for s in slots):
                    continue  # everything drained had expired
                try:
                    inflight = build_and_dispatch(
                        take, free_idx, time.monotonic()
                    )
                except Exception as e:  # noqa: BLE001
                    logger.exception("continuous segment dispatch failed")
                    fail_pool(e, time.monotonic())
                    continue
            # -- one-deep speculation: nothing to inject, chain N+1 -----
            # Only on an empty queue that is also quiet: right after a
            # fan-out, the woken clients' next requests are usually on
            # their way, and a speculative segment would make them wait
            # it out.
            spec_handle = None
            spec_exc = None
            if not stale and not self._shutdown:
                with self._cond:
                    queue_empty = not self._pending
                    quiet = (
                        time.monotonic() - self._last_arrival
                        >= self.quiescence_s
                    )
                if queue_empty and quiet and any(s is not None for s in slots):
                    try:
                        spec_handle = eng.dispatch_segment(
                            state, idle_boards, src=idle_src,
                            seg_iters=base_k << boost, injected=0,
                            pipelined=True,
                        )
                        state = spec_handle.state
                        with self._stats_lock:
                            self.batches += 1
                            self.segments += 1
                            self.pipelined += 1
                    except Exception as e:  # noqa: BLE001
                        spec_exc = e
            # -- finalize segment N ----------------------------------------
            try:
                rows, device_s = eng.finalize_segment(
                    inflight, active=np.array([s is not None for s in slots])
                )
            except Exception as e:  # noqa: BLE001
                logger.exception("continuous segment failed")
                if spec_handle is not None:
                    eng.abandon_segment(spec_handle)
                fail_pool(e, inflight.t0)
                inflight = None
                continue
            last_fetch_done = time.monotonic()
            self._stamp_segment(slots, device_s)
            # -- boundary N: classify lanes (no fan-out yet) --------------
            resolved, deep_entries = self._classify(slots, ages, stale, rows, C)
            now = time.monotonic()
            with self._cond:
                dropped = self._drain_expired_locked(now)
            # -- dispatch segment N+1 before the host-side fan-out --------
            next_handle = spec_handle
            if next_handle is None and spec_exc is None:
                with self._cond:
                    free_idx = [i for i, s in enumerate(slots) if s is None]
                    take = self._take_for_slots_locked(len(free_idx))
                    self._cond.notify_all()
                if take or stale or any(s is not None for s in slots):
                    try:
                        next_handle = build_and_dispatch(
                            take, free_idx, time.monotonic()
                        )
                    except Exception as e:  # noqa: BLE001
                        logger.exception("continuous segment dispatch failed")
                        spec_exc = e
            # -- host-side fan-out, overlapped with segment N+1 -----------
            self._resolve_expired(dropped, now)
            for r, row in resolved:
                _resolve(r.future, result=eng._row_result(row, routed="continuous"))
            for r, row in deep_entries:
                self._spawn_deep_retry(r, row)
            if resolved:
                eng._account_coalesced(np.stack([row for _, row in resolved]))
            injected_next = next_handle.injected if next_handle is not None else 0
            boost = 0 if (resolved or injected_next) else min(boost + 1, 4)
            if spec_exc is not None:
                fail_pool(spec_exc, last_fetch_done)
                next_handle = None
            inflight = next_handle

    def _spawn_deep_retry(self, req, row) -> None:
        """Finish an evicted lane's board on the closed-loop path
        (``engine._solve_padded``: its own depth stages and deep retry) on
        a thread of its own, so a long solve never holds up the segment
        cadence; the segments' guesses and validations add to its
        answer's, as across depth stages. Answered as routed
        ``"continuous-deep"``."""
        C = self._engine.spec.cells

        def run():
            t0 = time.monotonic()
            try:
                out = self._engine._solve_padded(req.board[None])[0].copy()
                out[C + 2] += row[C + 2]
                out[C + 3] += row[C + 3]
                if req.trace is not None and not req.future.done():
                    req.trace.mark("device", time.monotonic() - t0)
                self._engine._account_coalesced(out[None])
                _resolve(
                    req.future,
                    result=self._engine._row_result(out, routed="continuous-deep"),
                )
            except Exception as e:  # noqa: BLE001 — fail the one request
                logger.exception("capped-lane deep retry failed")
                _resolve(req.future, exc=e)
            finally:
                self._retry_threads.remove(t)

        t = threading.Thread(target=run, name="coalescer-deep-retry", daemon=True)
        self._retry_threads.append(t)
        t.start()
