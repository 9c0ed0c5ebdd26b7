"""Importable solver-object surface of the reference's node module.

The port of ``sudoku_solver_distributed_tpu/net/solver_api.py``. The
reference's ``node.py`` defines a ``SudokuSolver`` class (reference
node.py:21-132) that scripts import directly. This module provides the
same surface — constructor signature, method names, counter attributes —
backed by this package's engine (the CUDA kernels by default) instead of
the reference's per-cell Python prober:

* ``solve_sudoku``       → one engine solve.
* ``is_valid_move``      → the batched validation ops (ops/validate.py) on
  the engine's device, with the reference's include-the-queried-cell
  semantics (node.py:42-60).
* ``solve_sudoku_destributed`` [sic — reference spelling, node.py:77-81]
  → answers the queried cell from a full engine solve.
* ``check``              → strict full-board validation.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..engine import SolverEngine
from ..ops import spec_for_size, validate
from ..utils.render import render_board


class SudokuSolver:
    """Engine-backed drop-in for the reference's ``SudokuSolver``.

    ``base_delay`` is accepted for signature parity; the engine does not
    simulate work (the handicap belongs to ``api.Sudoku`` and the CLI's
    ``-h`` flag). The default engine runs on CUDA; pass
    ``engine=SolverEngine(device="cpu")`` to run on the CPU."""

    def __init__(self, base_delay: float = 0.01, *, engine: Optional[SolverEngine] = None):
        self.sudoku_board = None
        self.recent_requests: deque = deque()
        self.solved_puzzles = 0
        self.base_delay = base_delay
        self._engine = engine if engine is not None else SolverEngine()

    @property
    def validations(self) -> int:
        # the engine's analysis-sweep count, the reference counter's analog
        return self._engine.validations

    def _as_batch1(self, board):
        """``board`` as a (1, N, N) int32 tensor on the engine's device,
        and its spec."""
        arr = np.asarray(board, dtype=np.int32)
        return (
            torch.as_tensor(arr[None], device=self._engine.device),
            spec_for_size(arr.shape[-1]),
        )

    def solve_sudoku(self, sudoku):
        """Solve; returns the solved board or None (reference node.py:31-40).

        The reference solves by MUTATING the caller's nested lists, so when
        the input is a mutable nested-list board the solved grid is copied
        back into it; immutable inputs (tuples, numpy arrays) just get the
        return value."""
        self.sudoku_board = sudoku
        solution, _ = self._engine.solve_one(sudoku, frontier=False)
        if solution is None:
            return None
        self.sudoku_board = solution
        self.solved_puzzles += 1
        if isinstance(sudoku, list) and all(isinstance(r, list) for r in sudoku):
            for row, solved_row in zip(sudoku, solution):
                row[:] = solved_row
        return solution

    def solve_sudoku_async(self, sudoku):
        """Extension (not a reference surface): enqueue one board on the
        engine's request coalescer and return a ``concurrent.futures``
        Future resolving to ``(solution | None, info)``. The input is never
        mutated and ``solved_puzzles`` is not incremented (the engine's own
        counters still account the work)."""
        return self._engine.solve_one_async(sudoku, frontier=False)

    def is_valid_move(self, board, row: int, col: int, num: int) -> bool:
        """Reference node.py:42-60 — including its quirk that a fully valid
        board short-circuits True before looking at (row, col, num)."""
        if self.check(board):
            return True
        batch, spec = self._as_batch1(board)
        return bool(validate.is_valid_move(batch, row, col, num, spec)[0])

    def solve_sudoku_destributed(self, board, row: int, col: int):
        """Answer one cell (reference node.py:77-81, its task-farm unit)
        from a full engine solve; None means the board is unsatisfiable."""
        solution, _ = self._engine.solve_one(board, frontier=False)
        if solution is None:
            return None
        return int(solution[row][col])

    def check(self, board) -> bool:
        """Strict full-board validation (complete + consistent)."""
        batch, spec = self._as_batch1(board)
        return bool(validate.check_boards(batch, spec)[0])

    def __str__(self, board=None) -> str:  # reference passes the board in
        target = board if board is not None else self.sudoku_board
        if target is None:
            return "<no board>"
        return render_board(target)
