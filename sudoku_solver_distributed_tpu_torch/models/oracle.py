"""Trusted host-side (pure Python) sudoku solver — the test oracle.

A copy of ``sudoku_solver_distributed_tpu/models/oracle.py``: the port
imports nothing from the JAX package.

The reference has no tests at all (SURVEY.md §4); its only complete solver is
a naive recursive backtracker that is dead code (reference node.py:62-74).
This oracle exists so the device kernels can be property-tested against an
independent implementation: a bitmask MRV backtracker over plain Python ints.
It is intentionally written in a different style from both the reference and
the device kernels (recursive, dict-free, host ints) so that agreement between
oracle and kernel is meaningful evidence of correctness.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

Board = List[List[int]]

# deadline-check cadence for budgeted solves: one time.monotonic() per
# this many MRV steps keeps the check under ~1 ns amortized per step while
# still bounding overrun to a few hundred microseconds of host work
_BUDGET_CHECK_EVERY = 128


class OracleBudgetExceeded(Exception):
    """A budgeted ``oracle_solve`` ran past its wall-time budget.

    The host MRV backtracker's worst case is exponential (adversarial
    16×16/25×25 refutations), and its serving-path callers — the
    supervisor's degraded-mode fallback (serving/health.py) — must answer
    a clean 503 instead of pinning a host core for minutes. Deliberately
    NOT a subclass of ValueError
    or RuntimeError: a budget trip means "undetermined", never "invalid
    board" or "no solution", and callers must not conflate them.
    """


def _geometry(board: Sequence[Sequence[int]]):
    size = len(board)
    box = math.isqrt(size)
    if box * box != size or any(len(r) != size for r in board):
        raise ValueError("board must be N×N with N a perfect square")
    return size, box


def oracle_is_valid_solution(board: Sequence[Sequence[int]]) -> bool:
    """Strict check: every row/col/box is a permutation of 1..N."""
    size, box = _geometry(board)
    want = set(range(1, size + 1))
    for i in range(size):
        if set(board[i]) != want:
            return False
        if {board[r][i] for r in range(size)} != want:
            return False
    for bi in range(0, size, box):
        for bj in range(0, size, box):
            vals = {
                board[bi + di][bj + dj] for di in range(box) for dj in range(box)
            }
            if vals != want:
                return False
    return True


def _masks(board: Sequence[Sequence[int]], size: int, box: int):
    rows = [0] * size
    cols = [0] * size
    boxes = [0] * size
    for i in range(size):
        for j in range(size):
            v = board[i][j]
            if v:
                if v < 0 or v > size:
                    return None  # out-of-range clue: unsatisfiable as given
                bit = 1 << (v - 1)
                b = (i // box) * box + (j // box)
                if rows[i] & bit or cols[j] & bit or boxes[b] & bit:
                    return None  # clue conflict: unsatisfiable as given
                rows[i] |= bit
                cols[j] |= bit
                boxes[b] |= bit
    return rows, cols, boxes


def oracle_solve(
    board: Sequence[Sequence[int]], budget_s: Optional[float] = None
) -> Optional[Board]:
    """Return a solved copy, or None if unsatisfiable. MRV backtracking.

    ``budget_s`` bounds wall time: past it the search raises
    :class:`OracleBudgetExceeded` (checked every ``_BUDGET_CHECK_EVERY``
    MRV steps — amortized free, bounded overrun). None (default): the old
    unbudgeted contract, unchanged for every test-oracle caller."""
    size, box = _geometry(board)
    deadline = None
    if budget_s is not None:
        if budget_s <= 0:
            raise OracleBudgetExceeded(
                f"oracle budget {budget_s}s already spent"
            )
        deadline = time.monotonic() + budget_s
    steps = 0
    grid = [list(r) for r in board]
    m = _masks(grid, size, box)
    if m is None:
        return None
    rows, cols, boxes = m
    full = (1 << size) - 1
    empties = [(i, j) for i in range(size) for j in range(size) if not grid[i][j]]

    def step() -> bool:
        nonlocal steps
        if deadline is not None:
            steps += 1
            # first check at step 1 (an already-blown budget trips before
            # any work — deterministic for callers and tests), then every
            # _BUDGET_CHECK_EVERY steps (amortized free)
            if steps % _BUDGET_CHECK_EVERY in (0, 1) and (
                time.monotonic() > deadline
            ):
                raise OracleBudgetExceeded(
                    f"oracle budget {budget_s}s exceeded after "
                    f"{steps} MRV steps"
                )
        best = -1
        best_cand = 0
        best_n = size + 1
        for k, (i, j) in enumerate(empties):
            if grid[i][j]:
                continue
            b = (i // box) * box + (j // box)
            cand = full & ~(rows[i] | cols[j] | boxes[b])
            n = cand.bit_count()
            if n == 0:
                return False
            if n < best_n:
                best, best_cand, best_n = k, cand, n
                if n == 1:
                    break
        if best < 0:
            return True
        i, j = empties[best]
        b = (i // box) * box + (j // box)
        cand = best_cand
        while cand:
            bit = cand & -cand
            cand &= ~bit
            grid[i][j] = bit.bit_length()
            rows[i] |= bit
            cols[j] |= bit
            boxes[b] |= bit
            if step():
                return True
            grid[i][j] = 0
            rows[i] &= ~bit
            cols[j] &= ~bit
            boxes[b] &= ~bit
        return False

    return grid if step() else None


def count_solutions(board: Sequence[Sequence[int]], limit: int = 2) -> int:
    """Count solutions up to ``limit`` (used to certify unique-solution puzzles)."""
    size, box = _geometry(board)
    if limit <= 0:
        return 0
    grid = [list(r) for r in board]
    m = _masks(grid, size, box)
    if m is None:
        return 0
    rows, cols, boxes = m
    full = (1 << size) - 1
    found = 0

    def step() -> bool:  # returns True when the limit is reached
        nonlocal found
        best = None
        best_cand = 0
        best_n = size + 1
        for i in range(size):
            for j in range(size):
                if grid[i][j]:
                    continue
                b = (i // box) * box + (j // box)
                cand = full & ~(rows[i] | cols[j] | boxes[b])
                n = cand.bit_count()
                if n == 0:
                    return False
                if n < best_n:
                    best, best_cand, best_n = (i, j), cand, n
        if best is None:
            found += 1
            return found >= limit
        i, j = best
        b = (i // box) * box + (j // box)
        cand = best_cand
        while cand:
            bit = cand & -cand
            cand &= ~bit
            grid[i][j] = bit.bit_length()
            rows[i] |= bit
            cols[j] |= bit
            boxes[b] |= bit
            done = step()
            grid[i][j] = 0
            rows[i] &= ~bit
            cols[j] &= ~bit
            boxes[b] &= ~bit
            if done:
                return True
        return False

    step()
    return found
