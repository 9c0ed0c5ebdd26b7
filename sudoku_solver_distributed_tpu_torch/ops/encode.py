"""Batched bitmask encoding of sudoku boards, in PyTorch.

The port of ``sudoku_solver_distributed_tpu/ops/encode.py``. A batch of
boards is a ``(B, N, N) int32`` tensor of values 0..N (0 = empty);
candidate sets are int32 bitmasks (bit v ⇔ value v+1 allowed).

PyTorch has no integer popcount, so bit counts are sums of the N bits
(``popcount``), the same trick the Pallas kernel's ``_val_of`` uses.
"""

from __future__ import annotations

import torch

from .spec import BoardSpec


def box_index(spec: BoardSpec, device=None) -> torch.Tensor:
    """(N, N) int64 map from cell (i, j) to its box id 0..N-1."""
    n, N = spec.box, spec.size
    i = torch.arange(N, device=device)
    return (i[:, None] // n) * n + (i[None, :] // n)


def value_bitmask(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """Bitmask of each cell's value: ``1 << (v-1)`` for values in 1..N, 0
    otherwise. Shift amounts are clamped to [0, 31] before shifting, so an
    out-of-range value (36 on a 9×9 board) contributes no bit instead of
    aliasing onto another value's bit; the analysis flags such cells."""
    g = grid.to(torch.int32)
    in_range = (g >= 1) & (g <= spec.size)
    bits = torch.ones_like(g) << (g - 1).clamp(0, 31)
    return torch.where(in_range, bits, torch.zeros_like(g))


def popcount(mask: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """Number of set bits among the low N bits of each int32 mask."""
    out = torch.zeros_like(mask)
    for v in range(spec.size):
        out = out + ((mask >> v) & 1)
    return out


def mask_to_value(mask: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """Value 1..N for a single-bit mask (0 for an empty mask).

    Σ (v+1)·bit_v over the N value bits; only meaningful when the mask
    has at most one bit set."""
    out = torch.zeros_like(mask)
    for v in range(spec.size):
        out = out + (v + 1) * ((mask >> v) & 1)
    return out


def cell_used_mask(grid: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N, N) int32: values excluded at each cell by its row ∪ col ∪ box."""
    from .propagate import _box_major, _once_twice

    vmask = value_bitmask(grid, spec)
    row_used, _ = _once_twice(vmask)
    col_used, _ = _once_twice(vmask.transpose(1, 2))
    box_used, _ = _once_twice(_box_major(vmask, spec))
    bidx = box_index(spec, grid.device)
    return row_used[:, :, None] | col_used[:, None, :] | box_used[:, bidx]
