"""The port's host APIs (``api.Sudoku``, ``net/solver_api.SudokuSolver``,
``utils/render``) beside the JAX package's: the same check results,
validation counters, handicap ticks (the limiter's sleeps recorded, not
slept) and ``__str__`` bytes on the same boards (cf. tests/test_api.py and
tests/test_solver_api.py). The port's objects run on the CPU here
(``device="cpu"``, a CPU engine); by default they run on CUDA.
"""

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.api import Sudoku as JaxSudoku
from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch, oracle_solve
from sudoku_solver_distributed_tpu.net.solver_api import (
    SudokuSolver as JaxSudokuSolver,
)
from sudoku_solver_distributed_tpu.utils import render as jax_render
from sudoku_solver_distributed_tpu_torch import Sudoku, SudokuSolver
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.utils import render

GOOD = [
    [8, 9, 7, 1, 2, 4, 6, 3, 5],
    [5, 3, 1, 6, 7, 9, 2, 8, 4],
    [6, 4, 2, 3, 8, 5, 1, 7, 9],
    [1, 5, 4, 2, 9, 3, 8, 6, 7],
    [2, 8, 9, 7, 1, 6, 4, 5, 3],
    [3, 7, 6, 4, 5, 8, 9, 1, 2],
    [9, 2, 3, 8, 6, 7, 5, 4, 1],
    [7, 6, 5, 9, 4, 1, 3, 2, 8],
    [4, 1, 8, 5, 3, 2, 7, 9, 6],
]


def boards(readme_puzzle):
    bad_row = [row[:] for row in GOOD]
    bad_row[4][4] = bad_row[4][5]
    bad_first = [row[:] for row in GOOD]
    bad_first[0][0] = bad_first[0][1]
    rng = np.random.default_rng(20261017)
    noisy = rng.integers(0, 12, (9, 9)).tolist()  # out-of-range cells too
    hexa = generate_batch(1, 100, size=16, seed=62)[0].tolist()
    return [GOOD, bad_row, bad_first, readme_puzzle, [[5] * 9] * 9, noisy, hexa]


def drive(make, board):
    """Every check of one hosted board, with the handicap engaged (a
    threshold of 2, sleeps recorded): results, counter and sleeps."""
    sleeps = []
    s = make(board, base_delay=0.01, threshold=2)
    s._limiter._sleep = sleeps.append
    n = len(board)
    box = int(round(n ** 0.5))
    out = [str(s)]
    out += [s.check_row(i) for i in range(n)]
    out += [s.check_column(i) for i in range(n)]
    out += [s.check_square(i * box, j * box) for i in range(box) for j in range(box)]
    out += [s.check_is_valid(r, c, v) for r in (0, n - 1) for c in (0, 3)
            for v in (1, n)]
    # per-call overrides of the limiter
    out.append(s.check_row(0, base_delay=0.5, interval=100, threshold=0))
    out.append(s.check())
    out.append(s.check(threshold=1000))
    s.update_row(1, list(range(n, 0, -1)))
    s.update_column(2, list(range(1, n + 1)))
    out += [s.grid, str(s), s.check(), s.validations]
    return out, sleeps


def test_sudoku_matches_jax(readme_puzzle):
    for board in boards(readme_puzzle):
        want = drive(JaxSudoku, board)
        got = drive(lambda b, **kw: Sudoku(b, device="cpu", **kw), board)
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1])
        assert len(got[1]) > 0


def test_sudoku_defaults_and_device(monkeypatch, readme_puzzle):
    s = Sudoku(GOOD, base_delay=0.0, device="cpu")
    j = JaxSudoku(GOOD, base_delay=0.0)
    assert (s.base_delay, s.interval, s.threshold) == (j.base_delay, j.interval,
                                                      j.threshold)
    assert (Sudoku(GOOD, device="cpu").base_delay, Sudoku(GOOD, device="cpu").interval,
            Sudoku(GOOD, device="cpu").threshold) == (0.01, 10, 5)
    assert s.device == torch.device("cpu") and s._device_grid().device.type == "cpu"
    assert s.check() and s.validations == 27
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sudoku(GOOD)  # the default device is CUDA
    with pytest.raises(TypeError):
        Sudoku(GOOD, 0.0, 10, 5, "cpu")  # the device is keyword-only


def test_render_matches_jax(readme_puzzle):
    for board in boards(readme_puzzle):
        assert render.render_board(board) == jax_render.render_board(board)
        assert render.render_board_highlight_zeros(board) == (
            jax_render.render_board_highlight_zeros(board)
        )


def solver_run(solver):
    """The JAX solver_api tests' steps on one solver; what each answered."""
    board = generate_batch(1, 40, seed=7, unique=True)[0]
    out = []
    sol = solver.solve_sudoku(board.tolist())
    out += [sol, solver.solved_puzzles, str(solver)]
    out += [solver.check(sol), solver.check(board.tolist())]
    r, c = np.argwhere(board > 0)[0]
    out.append(solver.is_valid_move(board.tolist(), int(r), int(c), int(board[r, c])))
    hr, hc = np.argwhere(board == 0)[0]
    out.append(solver.is_valid_move(board.tolist(), int(hr), int(hc), 1))
    out.append(solver.is_valid_move(sol, 0, 0, 1))
    out.append(solver.solve_sudoku_destributed(board.tolist(), int(hr), int(hc)))
    bad = board.copy()
    rr, cc = np.argwhere(bad > 0)[0]
    bad[rr, np.argwhere(bad[rr] == 0).ravel()[0]] = bad[rr, cc]
    out.append(solver.solve_sudoku_destributed(bad.tolist(), int(hr), int(hc)))
    out.append(solver.__str__(sol))
    # the reference's in-place contract: a nested-list board is mutated
    caller = generate_batch(1, 40, seed=11, unique=True)[0].tolist()
    out += [solver.solve_sudoku(caller), caller]
    immutable = tuple(tuple(row) for row in board.tolist())
    out.append(solver.solve_sudoku(immutable))
    unsat = board.tolist()
    unsat[0][0] = unsat[0][1] = 5
    before = [row[:] for row in unsat]
    out += [solver.solve_sudoku(unsat), unsat == before, solver.solved_puzzles]
    fut = solver.solve_sudoku_async(generate_batch(1, 30, seed=9)[0].tolist())
    out.append(fut.result(timeout=120)[0])
    out.append(solver.validations)
    return out, board


def test_sudoku_solver_matches_jax():
    jax_solver = JaxSudokuSolver(engine=JaxEngine(buckets=(1,), coalesce=False))
    port_engine = SolverEngine(device="cpu", buckets=(1,), continuous=False)
    solver = SudokuSolver(engine=port_engine)
    try:
        want, board = solver_run(jax_solver)
        got, _ = solver_run(solver)
        assert got == want
        assert got[0] == oracle_solve(board.tolist())
        assert str(SudokuSolver(engine=port_engine)) == "<no board>"
        assert solver.base_delay == jax_solver.base_delay == 0.01
    finally:
        port_engine.close()


def test_sudoku_solver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SudokuSolver()
