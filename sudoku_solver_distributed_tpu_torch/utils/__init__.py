"""Host-side utilities: the handicap rate limiter; profiler spans live in
``utils/profiling.py``."""

from .ratelimit import HandicapLimiter

__all__ = ["HandicapLimiter"]
