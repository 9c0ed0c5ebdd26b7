"""Serving control planes: overload control and engine supervision for
the ``/solve`` path.

  * admission.py — ``AdmissionController``: a bounded pending budget and
    per-request deadlines. Overload is answered with a cheap ``429`` and
    ``Retry-After`` at the door, and requests that expire while queued are
    dropped before the device sees them (parallel/coalescer.py).
  * load.py — ``EwmaRate`` / ``WindowRate`` / ``AdaptiveWaitPolicy``: event
    rates for the admission projection and the adaptive coalescer wait.
  * health.py — ``EngineSupervisor``: watchdog, circuit breaker, host-oracle
    fallback and half-open probes around every device call of the engine.

Copies of the JAX package's modules of the same names. Everything
defaults off: a node started without admission or a supervisor serves as
it would without this package.
"""

from .admission import AdmissionController, Decision, DeadlineExceeded
from .load import AdaptiveWaitPolicy, EwmaRate, WindowRate

__all__ = [
    "AdaptiveWaitPolicy",
    "AdmissionController",
    "DeadlineExceeded",
    "Decision",
    "EwmaRate",
    "WindowRate",
]
