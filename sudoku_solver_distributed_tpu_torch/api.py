"""Host-facing ``Sudoku`` class — the reference's public board API.

The port of ``sudoku_solver_distributed_tpu/api.py``, surface-compatible
with reference sudoku.py:5-140: the same constructor signature, ``grid``
attribute, ANSI ``__str__``, ``update_row`` / ``update_column`` helpers,
and the rate-limited ``check_is_valid`` / ``check_row`` / ``check_column``
/ ``check_square`` / ``check`` methods (with the per-call ``base_delay`` /
``interval`` / ``threshold`` overrides).

Every check runs the batched validation ops (ops/validate.py) on the board
as a tensor on the object's device: CUDA unless the keyword-only
``device`` says otherwise (``device="cpu"``). The handicap rate limiter
(reference sudoku.py:13-30) gates these host-facing calls only — it is the
course's simulated compute cost, not a property of the device ops.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .engine import resolve_device
from .ops import spec_for_size
from .ops.validate import (
    check_boxes,
    check_cols,
    check_rows,
    is_valid_move,
)
from .utils import HandicapLimiter, render_board_highlight_zeros

class Sudoku:
    """A hosted board with rate-limited validation (reference sudoku.py:5-140)."""

    def __init__(
        self,
        sudoku: Sequence[Sequence[int]],
        base_delay: float = 0.01,
        interval: float = 10,
        threshold: int = 5,
        *,
        device=None,
    ):
        self.grid: List[List[int]] = [list(r) for r in sudoku]
        self.base_delay = base_delay
        self.interval = interval
        self.threshold = threshold
        self.device = resolve_device(device)
        self._limiter = HandicapLimiter(base_delay, interval, threshold)
        self._size = len(self.grid)
        self._spec = spec_for_size(self._size)
        # number of rate-limited validation calls made through this object —
        # the accounting unit of reference node.py:87
        self.validations = 0

    # -- rendering ---------------------------------------------------------
    def __str__(self) -> str:
        return render_board_highlight_zeros(self.grid)

    # -- mutation helpers (reference sudoku.py:51-58) ----------------------
    def update_row(self, row: int, values: Sequence[int]) -> None:
        self.grid[row] = list(values)

    def update_column(self, col: int, values: Sequence[int]) -> None:
        for row in range(self._size):
            self.grid[row][col] = values[row]

    # -- validation surface ------------------------------------------------
    def _tick(self, base_delay, interval, threshold) -> None:
        self.validations += 1
        self._limiter.tick(base_delay, interval, threshold)

    def _device_grid(self) -> torch.Tensor:
        return torch.tensor([self.grid], dtype=torch.int32, device=self.device)

    def check_is_valid(
        self, row: int, col: int, num: int,
        base_delay=None, interval=None, threshold=None,
    ) -> bool:
        """True iff ``num`` appears nowhere in the row/col/box of (row, col)
        (the queried cell included — reference sudoku.py:60-78 semantics)."""
        self._tick(base_delay, interval, threshold)
        out = is_valid_move(self._device_grid(), row, col, num, self._spec)
        return bool(out[0])

    def check_row(self, row: int, base_delay=None, interval=None, threshold=None) -> bool:
        self._tick(base_delay, interval, threshold)
        return bool(check_rows(self._device_grid(), self._spec)[0, row])

    def check_column(self, col: int, base_delay=None, interval=None, threshold=None) -> bool:
        self._tick(base_delay, interval, threshold)
        return bool(check_cols(self._device_grid(), self._spec)[0, col])

    def check_square(self, row: int, col: int, base_delay=None, interval=None, threshold=None) -> bool:
        """Check the box whose top-left corner is (row, col) — the reference
        calls this with (i*3, j*3) (reference sudoku.py:103-117, 135-137)."""
        self._tick(base_delay, interval, threshold)
        box = self._spec.box
        box_id = (row // box) * box + (col // box)
        return bool(check_boxes(self._device_grid(), self._spec)[0, box_id])

    def check(self, base_delay=None, interval=None, threshold=None) -> bool:
        """Strict whole-board check (reference sudoku.py:119-140).

        The reference issues one rate-limited call per unit (N rows, N
        columns, N boxes, short-circuiting on the first failure); that
        accounting is kept by ticking the limiter per unit while every unit
        is validated in one pass on the device."""
        g = self._device_grid()
        units = torch.cat(
            [check_rows(g, self._spec)[0], check_cols(g, self._spec)[0],
             check_boxes(g, self._spec)[0]]
        ).tolist()
        for ok in units:
            self._tick(base_delay, interval, threshold)
            if not ok:
                return False
        return True
