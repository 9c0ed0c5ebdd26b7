"""Board pretty-printers, matching both reference render styles.

A copy of ``sudoku_solver_distributed_tpu/utils/render.py``: the port
imports nothing from the JAX package.

The reference has two: ``Sudoku.__str__`` highlights zeros in ANSI yellow
(reference sudoku.py:32-49) and ``SudokuSolver.__str__`` renders plain
(reference node.py:118-131). Both draw `| - ... - |` separators around each
band. Generalized here to any board size (the reference hardwires 9).
"""

from __future__ import annotations

import math
from typing import Sequence


def _render(board: Sequence[Sequence[int]], highlight_zeros: bool) -> str:
    size = len(board)
    box = math.isqrt(size)
    # separator matches the reference's 9×9 art exactly for size 9
    sep = "| " + "- " * (size + box - 1) + "|\n"
    out = sep
    for i in range(size):
        out += "| "
        for j in range(size):
            v = board[i][j]
            if highlight_zeros and v == 0:
                out += f"\033[93m{v}\033[0m"
            else:
                out += str(v)
            out += " | " if j % box == box - 1 else " "
        if i % box == box - 1:
            out += "\n" + sep.rstrip("\n")
        out += "\n"
    return out


def render_board(board: Sequence[Sequence[int]]) -> str:
    """Plain render (reference node.py:118-131 style)."""
    return _render(board, highlight_zeros=False)


def render_board_highlight_zeros(board: Sequence[Sequence[int]]) -> str:
    """Zeros-in-yellow render (reference sudoku.py:32-49 style)."""
    return _render(board, highlight_zeros=True)
