"""Board-size specs for generalized N×N sudoku (N = n², n in {2, 3, 4, 5}).

A copy of ``sudoku_solver_distributed_tpu/ops/spec.py`` (the port imports
nothing from the JAX package). The board size is a static parameter so the
same code serves 9×9, 16×16 hexadoku and 25×25 giant boards: every
candidate set is an int32 bitmask, and the CUDA kernel is templated on the
box edge.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class BoardSpec:
    """Static geometry of an N×N sudoku board.

    Attributes:
      box: box edge n (3 for classic sudoku).
      size: board edge N = n*n; values are 1..N, 0 = empty.
      cells: N*N flattened cell count.
      full_mask: int with the low N bits set — the "all candidates" set.
    """

    box: int

    def __post_init__(self):
        # Candidate sets are int32 bitmasks (one bit per value), so N must fit
        # a 32-bit lane; box 2..5 covers 4×4 test boards through 25×25 giants.
        if not 2 <= self.box <= 5:
            raise ValueError(
                f"box edge must be in [2, 5] (board size 4..25, candidate "
                f"masks must fit int32); got box={self.box}"
            )

    @property
    def size(self) -> int:
        return self.box * self.box

    @property
    def cells(self) -> int:
        return self.size * self.size

    @property
    def full_mask(self) -> int:
        return (1 << self.size) - 1

    @property
    def unit_sum(self) -> int:
        # Sum of 1..N, the reference's weak validity criterion (node.py:97-114).
        n = self.size
        return n * (n + 1) // 2

    @property
    def max_depth(self) -> int:
        """Default DFS guess-stack capacity: the safe upper bound (one frame
        per cell — a guess always fills a previously-empty cell, so depth can
        never exceed the number of cells). Hard 9×9 puzzles rarely exceed ~20
        live frames; perf-tuned callers may pass a smaller ``max_depth`` to
        ``solve_batch`` to shrink the stack's HBM footprint."""
        return self.cells


SPEC_9 = BoardSpec(box=3)
SPEC_16 = BoardSpec(box=4)
SPEC_25 = BoardSpec(box=5)


@functools.lru_cache(maxsize=None)
def spec_for_size(size: int) -> BoardSpec:
    """Spec for a board edge length N (perfect square, 4 ≤ N ≤ 25)."""
    box = round(size ** 0.5)
    if box * box != size:
        raise ValueError(f"board size {size} is not a perfect square")
    return BoardSpec(box=box)
