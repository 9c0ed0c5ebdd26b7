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
  * autopilot.py — ``Autopilot``: the telemetry plane's closed control
    loops (burn-aware admission, telemetry-ranked farming, hedged
    dispatch, elastic membership).

Copies of the JAX package's modules of the same names. Admission
and supervision default off: a node started without them serves as it
would without this package. The CLI turns the autopilot on.
"""

from .admission import AdmissionController, Decision, DeadlineExceeded
from .autopilot import Autopilot
from .load import AdaptiveWaitPolicy, EwmaRate, WindowRate

__all__ = [
    "AdaptiveWaitPolicy",
    "AdmissionController",
    "Autopilot",
    "DeadlineExceeded",
    "Decision",
    "EwmaRate",
    "WindowRate",
]
