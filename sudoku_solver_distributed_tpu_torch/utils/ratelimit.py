"""The "handicap" rate limiter — the reference's simulated compute cost.

A copy of ``sudoku_solver_distributed_tpu/utils/ratelimit.py``: the port
imports nothing from the JAX package.

Reproduces the sliding-window throttle contract of reference sudoku.py:13-30 /
node.py:89-95: every validation call is timestamped; if more than ``threshold``
calls landed in the last ``interval`` seconds, the caller sleeps
``base_delay * (n - threshold + 1)``. In the reference this is the course's
mandated unit of measured effort; here it gates only the *host-facing*
``Sudoku.check*`` API (wire-parity accounting), never the device kernels.

Differences from the reference (defect fixes, not behavior changes):
  * the timestamp deque is pruned, where the reference grows it forever
    (reference sudoku.py:23, node.py:90 — unbounded memory);
  * thread-safe (the reference mutates the deque from two threads unlocked).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class HandicapLimiter:
    def __init__(
        self,
        base_delay: float = 0.01,
        interval: float = 10.0,
        threshold: int = 5,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self.base_delay = base_delay
        self.interval = interval
        self.threshold = threshold
        self._sleep = sleep
        self._clock = clock
        self._recent: deque[float] = deque()
        self._lock = threading.Lock()

    def tick(
        self,
        base_delay: float | None = None,
        interval: float | None = None,
        threshold: int | None = None,
    ) -> float:
        """Record one call; sleep if over threshold. Returns the delay applied."""
        base_delay = self.base_delay if base_delay is None else base_delay
        interval = self.interval if interval is None else interval
        threshold = self.threshold if threshold is None else threshold

        now = self._clock()
        with self._lock:
            self._recent.append(now)
            while self._recent and now - self._recent[0] >= interval:
                self._recent.popleft()
            num = len(self._recent)
        delay = 0.0
        if num > threshold:
            delay = base_delay * (num - threshold + 1)
            if delay > 0:
                self._sleep(delay)
        return delay
