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

Every dispatched batch runs to completion before its futures resolve
(closed loop): continuous batching, which refills finished lanes
mid-flight, needs the resumable segment kernel and is not here yet.

A batch whose dispatch or completion raises — a kernel that does not build
or launch, say — fails every future of that batch with the exception; the
loop goes on with the next batch. Nothing reruns elsewhere.

Counters (``stats()``): dispatched batches/boards, the realized batch-fill
(boards per device call — the number the whole layer exists to raise),
queue depth, and request wait time. Served on the opt-in ``/stats``
serving block (net/http_api.py).

The closed-loop part of ``sudoku_solver_distributed_tpu/parallel/
coalescer.py``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from ..serving.admission import DeadlineExceeded
from ..utils.profiling import annotate

logger = logging.getLogger(__name__)

_SENTINEL = object()


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
    __slots__ = ("board", "future", "enqueued", "deadline")

    def __init__(self, board: np.ndarray, deadline: Optional[float] = None):
        self.board = board
        self.future: Future = Future()
        self.enqueued = time.monotonic()
        # absolute monotonic deadline (serving/admission.py) or None; an
        # expired request is dropped at batch-formation time so the device
        # never solves a board nobody is waiting for
        self.deadline = deadline


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

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._started = True
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
        the completer its sentinel."""
        with self._cond:
            if self._shutdown:
                return
            self._shutdown = True
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=timeout)
        if self._completer is not None:
            self._completer.join(timeout=timeout)

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
                    _resolve(r.future, exc=e)
                continue
            with self._stats_lock:
                self.batches += 1
                self.boards += len(batch)
                self.last_batch_fill = len(batch)
                if len(batch) > self.max_batch_fill:
                    self.max_batch_fill = len(batch)
                for r in batch:
                    w = now - r.enqueued
                    self._wait_sum_s += w
                    if w > self._wait_max_s:
                        self._wait_max_s = w
            # blocks at pipeline depth
            self._inflight.put((handle, batch))
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
            handle, batch = item
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
                for r in batch:
                    _resolve(r.future, exc=e)
                continue
            for r, res in zip(batch, results):
                # a caller may cancel() its future while the batch is in
                # flight; _resolve absorbs the done-check/cancel race
                _resolve(r.future, result=res)
