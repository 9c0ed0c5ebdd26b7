"""Host-side utilities: the handicap rate limiter."""

from .ratelimit import HandicapLimiter

__all__ = ["HandicapLimiter"]
