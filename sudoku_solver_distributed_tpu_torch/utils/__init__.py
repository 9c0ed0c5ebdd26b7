"""Host-side utilities: the handicap rate limiter, the engine and wire
fault injectors (``faults.py``); request metrics, torch.profiler
captures and spans live in ``utils/profiling.py``."""

from .faults import EngineFaultInjector, FaultInjector, InjectedEngineFault
from .ratelimit import HandicapLimiter

__all__ = [
    "EngineFaultInjector",
    "FaultInjector",
    "HandicapLimiter",
    "InjectedEngineFault",
]
