"""Request scheduling: the closed-loop coalescer that batches concurrent
single-board requests into one device call (coalescer.py)."""

from .coalescer import BatchCoalescer

__all__ = ["BatchCoalescer"]
