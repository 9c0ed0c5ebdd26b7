"""Host-side utilities: the handicap rate limiter, board rendering, the
engine and wire fault injectors (``faults.py``); request metrics,
torch.profiler captures and spans live in ``utils/profiling.py``."""

from .faults import EngineFaultInjector, FaultInjector, InjectedEngineFault
from .ratelimit import HandicapLimiter
from .render import render_board, render_board_highlight_zeros

__all__ = [
    "EngineFaultInjector",
    "FaultInjector",
    "HandicapLimiter",
    "InjectedEngineFault",
    "render_board",
    "render_board_highlight_zeros",
]
