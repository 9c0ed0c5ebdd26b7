"""Puzzle generation — the test-input fabric (reference gen.py:6-66 equivalent).

The port's copy of ``sudoku_solver_distributed_tpu/models/generator.py``:
the same recipe and the same random stream, so a seed gives the JAX
package's boards, with the native oracle on both sides or off on both
(above 9×9 the two complete a board differently). Fill the n
independent diagonal boxes with random permutations, complete the board
with a real backtracker, then blank a requested number of distinct cells
(reference gen.py:31-52). Extended beyond the reference with: arbitrary
board sizes, seeded determinism, batch generation, and an optional
unique-solution certificate (the reference can emit multi-solution
puzzles, which makes golden testing flaky).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from .oracle import Board, count_solutions, oracle_solve
from .. import native


def _solve(board: Board) -> Optional[Board]:
    """Native C++ oracle when available (bit-identical results), else Python."""
    if native.available():
        return native.native_solve(board)
    return oracle_solve(board)


# Uniqueness-probe node budget: bounds the pathological tail (a single
# near-multi-solution probe on a 16×16 can otherwise take minutes). An
# inconclusive probe reads as "not proven unique", so the blank is reverted —
# certification stays sound, the puzzle just keeps one more clue.
_COUNT_NODE_BUDGET = 30_000


def _count(board: Board, limit: int) -> int:
    if native.available():
        rc = native.native_count_solutions_budget(
            board, limit=limit, max_nodes=_COUNT_NODE_BUDGET
        )
        return limit if rc is None else rc
    return count_solutions(board, limit=limit)


def generate_board(
    empty_boxes: int = 0,
    *,
    size: int = 9,
    rng: Optional[random.Random] = None,
    unique: bool = False,
) -> Board:
    """Generate one puzzle with ``empty_boxes`` blanked cells.

    With ``unique=True`` cells are only blanked while the puzzle keeps a
    single solution (so ``empty_boxes`` becomes an upper bound).
    """
    rng = rng or random.Random()
    box = int(round(size ** 0.5))
    board = [[0] * size for _ in range(size)]

    # Diagonal boxes are mutually independent: fill each with a permutation.
    for n in range(0, size, box):
        nums = list(range(1, size + 1))
        rng.shuffle(nums)
        for i in range(box):
            for j in range(box):
                board[n + i][n + j] = nums.pop()

    solved = None
    if size > 9:
        # Completing a near-empty large board with the deterministic MRV
        # solver has a pathological tail (minutes on some 16×16 diagonal
        # seeds); the randomized-restart native solver finishes in
        # milliseconds and stays deterministic in the rng stream. 9×9 keeps
        # the historical deterministic path so existing seeded corpora
        # reproduce bit-for-bit. The seed is drawn unconditionally so the
        # rng stream (and thus the blanking order below) is identical with
        # or without the native toolchain.
        solver_seed = rng.getrandbits(64)
        if native.available():
            try:
                solved = native.native_solve_seeded(board, solver_seed)
            except RuntimeError:
                solved = None  # all restarts exhausted: exhaustive fallback
    if solved is None:
        solved = _solve(board)
    assert solved is not None, "diagonal seed must always be completable"
    board = solved

    filled = [(i, j) for i in range(size) for j in range(size)]
    rng.shuffle(filled)
    removed = 0
    for i, j in filled:
        if removed >= empty_boxes:
            break
        keep = board[i][j]
        board[i][j] = 0
        if unique and _count(board, limit=2) != 1:
            board[i][j] = keep
            continue
        removed += 1
    return board


def generate_batch(
    batch: int,
    empty_boxes: int,
    *,
    size: int = 9,
    seed: int = 0,
    unique: bool = False,
) -> np.ndarray:
    """(batch, size, size) int32 array of puzzles, deterministic in ``seed``."""
    rng = random.Random(seed)
    out = np.empty((batch, size, size), dtype=np.int32)
    for k in range(batch):
        out[k] = generate_board(empty_boxes, size=size, rng=rng, unique=unique)
    return out
