"""Batched board validation, in PyTorch.

The port of ``sudoku_solver_distributed_tpu/ops/validate.py``: the strict
checker (every row/col/box a permutation of 1..N) on the same saturating
once/twice bitmask reductions the analysis sweep uses. A unit is a
permutation iff its used-mask is the full mask AND its duplicate-mask is
empty; empty and out-of-range cells contribute no bits (their shift is
masked, never wrapped), so either also fails the full-mask test.
"""

from __future__ import annotations

import torch

from .encode import cell_used_mask, value_bitmask
from .propagate import _box_major, _once_twice
from .spec import BoardSpec


def _unit_masks(grid: torch.Tensor, spec: BoardSpec):
    """Per-unit (used, dup) value bitmasks for rows / cols / boxes, each
    (B, N) int32."""
    vmask = value_bitmask(grid, spec)
    rows = _once_twice(vmask)
    cols = _once_twice(vmask.transpose(1, 2))
    boxes = _once_twice(_box_major(vmask, spec))
    return rows, cols, boxes


def _unit_ok(masks, spec: BoardSpec) -> torch.Tensor:
    """(used, dup) → (B, N) bool: unit is a permutation of 1..N."""
    used, dup = masks
    return (used == spec.full_mask) & (dup == 0)


def check_rows(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N) bool: row r of board b is a permutation of 1..N."""
    rows, _, _ = _unit_masks(grid, spec)
    return _unit_ok(rows, spec)


def check_cols(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N) bool per column."""
    _, cols, _ = _unit_masks(grid, spec)
    return _unit_ok(cols, spec)


def check_boxes(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N) bool per box (box id as in encode.box_index)."""
    _, _, boxes = _unit_masks(grid, spec)
    return _unit_ok(boxes, spec)


def check_boards(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B,) bool: the whole board is a valid complete solution."""
    rows, cols, boxes = _unit_masks(grid, spec)
    return (
        _unit_ok(rows, spec).all(dim=-1)
        & _unit_ok(cols, spec).all(dim=-1)
        & _unit_ok(boxes, spec).all(dim=-1)
    )


def is_valid_move(grid, row, col, num, spec: BoardSpec) -> torch.Tensor:
    """(B,) bool: ``num`` occurs nowhere in the row, column, or box of
    (row, col) — the cell itself included, as the reference's
    ``check_is_valid`` scans it too. row/col/num may be ints or (B,)
    tensors."""
    used = cell_used_mask(grid, spec)  # (B, N, N)
    B = grid.shape[0]
    dev = grid.device

    def per_board(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev).expand(B)

    b = torch.arange(B, device=dev)
    row, col, num = per_board(row), per_board(col), per_board(num)
    bit = (torch.ones_like(num) << (num - 1)).to(torch.int32)
    return (used[b, row, col] & bit) == 0
