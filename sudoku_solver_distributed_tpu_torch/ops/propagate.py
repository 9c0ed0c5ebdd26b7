"""Board analysis + constraint propagation (naked & hidden singles), in PyTorch.

The port of ``sudoku_solver_distributed_tpu/ops/propagate.py``. ``analyze``
is the fused per-sweep analysis that the plain solver (ops/solver.py) runs
every step and the CUDA kernel (csrc/dfs_solver.cu) mirrors per board: from
a batch of grids it derives the candidate masks, the forced-assignment mask
(naked ∪ hidden singles), and the per-board contradiction / solved verdicts.

  * naked single  — an empty cell whose candidate set has exactly one value;
  * hidden single — a (unit, value) pair with exactly one admitting cell.

Only the singles analysis is ported so far: the locked-candidate and
naked-pair eliminations (``analyze(locked=True)``) come with the kernel's
serving-config sweeps, and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encode import box_index, mask_to_value, popcount, value_bitmask
from .spec import BoardSpec


class Analysis(NamedTuple):
    cand: torch.Tensor           # (B, N, N) int32 candidate bitmask (0 if filled)
    assign: torch.Tensor         # (B, N, N) int32 single-bit forced-value mask
    contradiction: torch.Tensor  # (B,) bool — unsatisfiable as-is
    solved: torch.Tensor         # (B,) bool — strict: every unit a permutation


def _box_major(x: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N, N) cell tensor → (B, N, N) with axis 1 = box id (matching
    ``box_index``) and axis 2 = cell position within the box."""
    n, N = spec.box, spec.size
    B = x.shape[0]
    return x.reshape(B, n, n, n, n).permute(0, 1, 3, 2, 4).reshape(B, N, N)


def _once_twice(x: torch.Tensor):
    """Saturating 2-bit bitmask accumulation along the last axis.

    For per-cell masks x[..., k], returns (once, twice): bits set in ≥1 /
    ≥2 of the cells. ``once`` is the unit's used/admitting mask; ``twice``
    exposes duplicates (on value masks) and multi-cell candidates (on
    candidate masks: once & ~twice = values with exactly one admitting
    cell — the hidden singles)."""
    once = torch.zeros_like(x[..., 0])
    twice = once
    for k in range(x.shape[-1]):
        m = x[..., k]
        twice = twice | (once & m)
        once = once | m
    return once, twice


def analyze(
    grid: torch.Tensor, spec: BoardSpec, locked: bool = False
) -> Analysis:
    """Fused singles analysis of a (B, N, N) batch.

    Contradiction covers: a duplicated value in a unit, an empty cell with
    an empty candidate set, and out-of-range cell values (anything outside
    0..N). Solved is the strict criterion — every row/col/box a
    permutation of 1..N."""
    if locked:
        raise NotImplementedError(
            "locked-candidate / naked-pair analysis is not ported yet; "
            "the port runs singles-only sweeps"
        )
    N = spec.size
    g = grid.to(torch.int32)
    vmask = value_bitmask(g, spec)  # out-of-range cells contribute nothing

    bidx = box_index(spec, g.device)
    row_used, row_dup = _once_twice(vmask)                  # (B, N) each
    col_used, col_dup = _once_twice(vmask.transpose(1, 2))
    box_used, box_dup = _once_twice(_box_major(vmask, spec))
    dup = (
        (row_dup != 0).any(dim=1)
        | (col_dup != 0).any(dim=1)
        | (box_dup != 0).any(dim=1)
    )

    used = row_used[:, :, None] | col_used[:, None, :] | box_used[:, bidx]
    empty = g == 0
    zero = torch.zeros_like(g)
    cand = torch.where(empty, ~used & spec.full_mask, zero)

    # Hidden singles: "this cell admits v AND v has one admitting cell in
    # one of my units" identifies them without per-(unit, value) counts.
    row_o, row_t = _once_twice(cand)
    col_o, col_t = _once_twice(cand.transpose(1, 2))
    box_o, box_t = _once_twice(_box_major(cand, spec))
    exact1 = (
        (row_o & ~row_t)[:, :, None]
        | (col_o & ~col_t)[:, None, :]
        | (box_o & ~box_t)[:, bidx]
    )
    hidden_mask = cand & exact1

    naked = popcount(cand, spec) == 1
    assign = torch.where(naked, cand, hidden_mask)
    assign = assign & -assign  # one value per cell per sweep

    dead = (empty & (cand == 0)).flatten(1).any(dim=1)
    bad_value = ((g < 0) | (g > N)).flatten(1).any(dim=1)
    # filled + no unit duplicate + all values in range ⇔ every unit holds N
    # distinct in-range values ⇔ every unit is a permutation of 1..N.
    solved = (~empty).flatten(1).all(dim=1) & ~dup & ~bad_value
    return Analysis(cand, assign, dup | dead | bad_value, solved)


def propagate_step(grid: torch.Tensor, spec: BoardSpec):
    """One parallel singles-assignment sweep. Returns (new_grid, changed)
    with changed (B,) bool. Simultaneous assignment can write conflicting
    values on an unsatisfiable board; the next sweep's ``analyze`` flags
    the contradiction."""
    g = grid.to(torch.int32)
    a = analyze(g, spec)
    new_grid = torch.where(
        (g == 0) & (a.assign != 0), mask_to_value(a.assign, spec), g
    )
    changed = (new_grid != g).flatten(1).any(dim=1)
    return new_grid, changed


def propagate(grid: torch.Tensor, spec: BoardSpec, max_iters: int | None = None):
    """Run singles propagation to fixed point across the batch.

    Returns (grid, iters): iters is the number of sweeps executed."""
    if max_iters is None:
        max_iters = spec.cells + 1  # each sweep fills ≥1 cell of an active board
    g = grid.to(torch.int32)
    changed = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
    iters = 0
    while iters < max_iters and bool(changed.any()):
        g, changed = propagate_step(g, spec)
        iters += 1
    return g, iters
