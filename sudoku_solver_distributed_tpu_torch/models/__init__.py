"""Host-side model components: the trusted oracle solver, the puzzle generator."""

from .oracle import (
    OracleBudgetExceeded,
    count_solutions,
    oracle_is_valid_solution,
    oracle_solve,
)
from .generator import generate_board, generate_batch

__all__ = [
    "OracleBudgetExceeded",
    "oracle_solve",
    "oracle_is_valid_solution",
    "count_solutions",
    "generate_board",
    "generate_batch",
]
