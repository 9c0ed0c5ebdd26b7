"""The plain reference: a sudoku solver written from the rules alone.

It shares no code with the program under test. A board is an N x N array
of ints (0 an empty cell, N = box * box). Each cell holds a bit mask of
its candidates; a fixed cell's value is struck from its peers, a value
that fits one cell of a unit only is placed there, and the search guesses
on a cell with the fewest candidates, depth first. ``solutions(board, 2)``
tells a unique board from one with several solutions.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np


@functools.cache
def _geometry(n: int):
    box = int(round(n ** 0.5))
    if box * box != n:
        raise ValueError(f"a board's edge must be a square, got {n}")
    rows = [[r * n + c for c in range(n)] for r in range(n)]
    cols = [[r * n + c for r in range(n)] for c in range(n)]
    boxes = [
        [(br + r) * n + bc + c for r in range(box) for c in range(box)]
        for br in range(0, n, box)
        for bc in range(0, n, box)
    ]
    units = rows + cols + boxes
    peers = [set() for _ in range(n * n)]
    for unit in units:
        for cell in unit:
            peers[cell].update(unit)
    for cell, p in enumerate(peers):
        p.discard(cell)
    return units, [tuple(sorted(p)) for p in peers], (1 << n) - 1


def _propagate(cand: list, queue: list, n: int) -> bool:
    """Strike each fixed cell's value from its peers and place every value
    that fits one cell of a unit, until nothing changes. False on a
    contradiction."""
    units, peers, full = _geometry(n)
    while True:
        while queue:
            cell = queue.pop()
            m = cand[cell]
            for p in peers[cell]:
                pm = cand[p]
                if pm & m:
                    pm &= ~m
                    if not pm:
                        return False
                    cand[p] = pm
                    if not pm & (pm - 1):
                        queue.append(p)
        for unit in units:
            once = twice = 0
            for cell in unit:
                m = cand[cell]
                twice |= once & m
                once |= m
            if once != full:
                return False
            single = once & ~twice
            if not single:
                continue
            for cell in unit:
                m = cand[cell]
                hit = m & single
                if hit and m & (m - 1):
                    if hit & (hit - 1):
                        return False
                    cand[cell] = hit
                    queue.append(cell)
        if not queue:
            return True


def _search(cand: list, n: int, limit: int, found: list) -> None:
    best, best_count = -1, n + 1
    for cell, m in enumerate(cand):
        k = m.bit_count()
        if 1 < k < best_count:
            best, best_count = cell, k
            if k == 2:
                break
    if best < 0:
        found.append(list(cand))
        return
    m = cand[best]
    while m and len(found) < limit:
        bit = m & -m
        m ^= bit
        trial = list(cand)
        trial[best] = bit
        if _propagate(trial, [best], n):
            _search(trial, n, limit, found)


def solutions(board, limit: int = 1) -> List[np.ndarray]:
    """Up to ``limit`` solutions of ``board``, each an N x N int32 array."""
    grid = np.asarray(board, dtype=np.int64)
    n = grid.shape[0]
    if grid.shape != (n, n):
        raise ValueError(f"a board is square, got {grid.shape}")
    _, _, full = _geometry(n)
    cand, queue = [], []
    for cell, v in enumerate(grid.reshape(-1).tolist()):
        if v < 0 or v > n:
            raise ValueError(f"cell value {v} outside 0..{n}")
        if v:
            cand.append(1 << (v - 1))
            queue.append(cell)
        else:
            cand.append(full)
    found: list = []
    if _propagate(cand, queue, n):
        _search(cand, n, limit, found)
    return [
        np.array([m.bit_length() for m in sol], dtype=np.int32).reshape(n, n)
        for sol in found
    ]


def solve(board) -> Optional[np.ndarray]:
    """The first solution of ``board`` in the search's order, or None."""
    found = solutions(board, 1)
    return found[0] if found else None


def valid_completions(boards: np.ndarray, grids: np.ndarray) -> np.ndarray:
    """For each pair of (B, N, N) ``boards`` and ``grids``, whether the grid
    keeps every clue of its board and holds each of 1..N once in every
    row, column and box. Vectorised over the batch."""
    boards = np.asarray(boards)
    grids = np.asarray(grids)
    B, n, _ = grids.shape
    box = int(round(n ** 0.5))
    keeps = ((boards == 0) | (boards == grids)).all(axis=(1, 2))
    in_range = ((grids >= 1) & (grids <= n)).all(axis=(1, 2))
    onehot = np.zeros((B, n, n, n + 1), dtype=bool)
    np.put_along_axis(onehot, np.clip(grids, 0, n)[..., None].astype(np.int64),
                      True, axis=3)
    onehot = onehot[..., 1:]
    rows = onehot.sum(axis=2)
    cols = onehot.sum(axis=1)
    boxes = onehot.reshape(B, box, box, box, box, n).sum(axis=(2, 4))
    units = (
        (rows == 1).all(axis=(1, 2))
        & (cols == 1).all(axis=(1, 2))
        & (boxes == 1).all(axis=(1, 2, 3))
    )
    return keeps & in_range & units
