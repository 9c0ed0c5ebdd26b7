"""Board analysis + constraint propagation (naked & hidden singles), in PyTorch.

The port of ``sudoku_solver_distributed_tpu/ops/propagate.py``. ``analyze``
is the fused per-sweep analysis that the plain solver (ops/solver.py) runs
every step and the CUDA kernel (csrc/dfs_solver.cu) mirrors per board: from
a batch of grids it derives the candidate masks, the forced-assignment mask
(naked ∪ hidden singles), and the per-board contradiction / solved verdicts.

  * naked single  — an empty cell whose candidate set has exactly one value;
  * hidden single — a (unit, value) pair with exactly one admitting cell.

``analyze(locked=True)`` first narrows the candidates with locked-set
eliminations (pointing and claiming, and optionally naked pairs), as the
serving configuration does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import packed_default
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


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (torch has no bitwise reduction)."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


def _or_others(x: torch.Tensor, dim: int) -> torch.Tensor:
    """OR over the other n-1 entries along ``dim`` (size n), per entry:
    leave-one-out from prefix and suffix ORs."""
    parts = x.unbind(dim)
    n = len(parts)
    fwd = [parts[0]]
    for k in range(1, n):
        fwd.append(fwd[-1] | parts[k])
    bwd = [None] * n
    bwd[n - 1] = parts[n - 1]
    for k in range(n - 2, -1, -1):
        bwd[k] = bwd[k + 1] | parts[k]
    outs = [bwd[1]]
    for k in range(1, n - 1):
        outs.append(fwd[k - 1] | bwd[k + 1])
    outs.append(fwd[n - 2])
    return torch.stack(outs, dim)


def _segment_elims(m: torch.Tensor) -> torch.Tensor:
    """Pointing and claiming from the (B, band, s, bc) segment ORs ``m`` of
    one line direction: the elimination mask of every line segment."""
    # pointing: a value confined to segment s of box (band, bc) leaves the
    # other boxes' cells of line (band, s)
    only_seg = m & ~_or_others(m, 2)
    row_other_boxes = _or_others(only_seg, 3)
    # claiming: a value confined to box bc within line (band, s) leaves
    # that box's other segments
    only_box = m & ~_or_others(m, 3)
    box_other_rows = _or_others(only_box, 2)
    return row_other_boxes | box_other_rows


def _broadcast_segments(elim: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, band, s, bc) per-segment masks → (B, N, N) per cell."""
    n, N = spec.box, spec.size
    B = elim.shape[0]
    return elim[..., None].expand(B, n, n, n, n).reshape(B, N, N)


def _locked_candidate_elims(cand: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N, N) candidate-bit elimination masks from locked candidates
    (pointing and claiming), rows then columns via transpose."""
    n = spec.box
    B = cand.shape[0]
    out = torch.zeros_like(cand)
    for transpose in (False, True):
        c = cand.transpose(1, 2) if transpose else cand
        m = _or_reduce(c.reshape(B, n, n, n, n), 4)  # (B, band, s, bc)
        elim = _broadcast_segments(_segment_elims(m), spec)
        out = out | (elim.transpose(1, 2) if transpose else elim)
    return out


_PLANE_MASK = 0xFFFF  # low half of an int32 lane: one 16-bit bitplane


def _lsr16(p: torch.Tensor) -> torch.Tensor:
    """Logical (zero-fill) right shift by one plane width. ``>>`` on int32
    is arithmetic and would smear a set bit 31 (N=16's value bit 15 in the
    high plane) across the result, so the shifted value is masked."""
    return (p >> 16) & _PLANE_MASK


def _locked_candidate_elims_packed(
    cand: torch.Tensor, spec: BoardSpec
) -> torch.Tensor:
    """``_locked_candidate_elims`` with the row pass and the transposed
    column pass packed as two 16-bit bitplanes of one int32 lane: every
    operation is bitwise, so both planes ride one reduction. Bit-identical
    to the unpacked pass; needs N <= 16."""
    n = spec.box
    B = cand.shape[0]
    c2 = cand | (cand.transpose(1, 2) << 16)
    m = _or_reduce(c2.reshape(B, n, n, n, n), 4)
    elim = _broadcast_segments(_segment_elims(m), spec)
    return (elim & _PLANE_MASK) | _lsr16(elim).transpose(1, 2)


def _naked_pair_elims(cand: torch.Tensor, spec: BoardSpec) -> torch.Tensor:
    """(B, N, N) candidate-bit elimination masks from naked pairs: two cells
    of a unit with the same 2-value candidate set take those values from
    every other cell of the unit (a cell of a pair keeps its own set)."""
    N = spec.size
    pc2 = popcount(cand, spec) == 2
    eye = torch.eye(N, dtype=torch.bool, device=cand.device)[None, None]
    out = torch.zeros_like(cand)
    for mode in ("row", "col", "box"):
        if mode == "row":
            c, p2 = cand, pc2
        elif mode == "col":
            c, p2 = cand.transpose(1, 2), pc2.transpose(1, 2)
        else:
            c, p2 = _box_major(cand, spec), _box_major(pc2, spec)
        eqm = (
            (c[:, :, :, None] == c[:, :, None, :])
            & p2[:, :, :, None]
            & p2[:, :, None, :]
            & ~eye
        )
        paired = torch.where(eqm.any(-1), c, torch.zeros_like(c))
        elim = _or_reduce(paired, 2)[:, :, None] & ~paired  # (B, U, N)
        if mode == "col":
            elim = elim.transpose(1, 2)
        elif mode == "box":
            elim = _box_major(elim, spec)  # an involution: maps back
        out = out | elim
    return out


def analyze(
    grid: torch.Tensor,
    spec: BoardSpec,
    locked: bool = False,
    naked_pairs: bool | None = None,
    packed: bool | None = None,
) -> Analysis:
    """Fused sweep analysis of a (B, N, N) batch.

    ``locked=True`` applies locked-set eliminations to the candidates
    before single detection: locked candidates (pointing and claiming)
    and, unless ``naked_pairs`` is False, naked pairs (None follows
    ``locked``). ``packed`` picks the bitplane form of the locked pass
    (None → ``ops.config.packed_default``); it needs N <= 16 and raises
    ValueError otherwise. Every elimination is computed from the
    candidates before any of them.

    Contradiction covers: a duplicated value in a unit, an empty cell with
    an empty candidate set (after the eliminations), and out-of-range cell
    values (anything outside 0..N). Solved is the strict criterion —
    every row/col/box a permutation of 1..N."""
    N = spec.size
    if packed is None:
        packed = packed_default(N)
    if packed and N > 16:
        raise ValueError(
            f"packed bitplane analysis needs N <= 16 (a value mask must fit "
            f"one 16-bit plane); got N={N}"
        )
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
    if locked:
        elim = (
            _locked_candidate_elims_packed(cand, spec)
            if packed
            else _locked_candidate_elims(cand, spec)
        )
        if naked_pairs or naked_pairs is None:
            elim = elim | _naked_pair_elims(cand, spec)
        cand = cand & ~elim

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
