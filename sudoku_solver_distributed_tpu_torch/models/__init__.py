"""Host-side model components: the trusted oracle solver."""

from .oracle import (
    OracleBudgetExceeded,
    count_solutions,
    oracle_is_valid_solution,
    oracle_solve,
)

__all__ = [
    "OracleBudgetExceeded",
    "oracle_solve",
    "oracle_is_valid_solution",
    "count_solutions",
]
