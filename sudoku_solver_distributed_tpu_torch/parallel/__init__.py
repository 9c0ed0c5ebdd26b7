"""Request scheduling and the search frontier: the closed-loop coalescer
that batches concurrent single-board requests into one device call
(coalescer.py), and one hard board's disjoint subtrees raced on one device
(frontier.py)."""

from .coalescer import BatchCoalescer
from .frontier import frontier_solve, seed_frontier, state_handoff_frontier

__all__ = [
    "BatchCoalescer",
    "frontier_solve",
    "seed_frontier",
    "state_handoff_frontier",
]
