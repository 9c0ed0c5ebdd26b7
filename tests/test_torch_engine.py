"""The port's SolverEngine on the CPU held against the JAX package's engine
with the serving configuration of both (locked candidates, ``waves=3`` on
9×9 buckets wider than 1), the JAX engine's coalescer off and the port's
closed loop (the open loop is tests/test_torch_continuous.py's): solutions,
solved masks, info counters, the deep retry, and the engine counters must be
equal. One case runs both in the kernel's singles configuration.
"""

import os

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
BUCKETS = (1, 8, 64)

README_PUZZLE = [
    [0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 3, 2, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 9, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 7, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 9, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 9, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 3],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
]


def corpus(name, n):
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][:n].astype(np.int32)


_OPEN = []


@pytest.fixture(autouse=True)
def _close_engines():
    yield
    while _OPEN:
        _OPEN.pop().close()


def engines(**kw):
    """The JAX engine (its coalescer off) and the port's default engine in
    the closed loop, both with ``kw``. The port's coalescer, on by default,
    serves ``solve_one``; its threads stop when the test ends."""
    jax_kw = {k: v for k, v in kw.items() if k != "coalesce"}
    jax_eng = JaxEngine(coalesce=False, buckets=BUCKETS, **jax_kw)
    eng = SolverEngine(device="cpu", buckets=BUCKETS, continuous=False, **kw)
    _OPEN.append(eng)
    return jax_eng, eng


def solve_one(eng, board):
    """``eng.solve_one`` without the coalescer's ``routed`` tag (the JAX
    reference engine runs without its coalescer)."""
    solution, info = eng.solve_one(board)
    return solution, {k: v for k, v in info.items() if k != "routed"}


def assert_batch_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def mixed_batch(n):
    """Corpus boards plus an unsolvable and an empty board."""
    b = corpus("corpus_9x9_hard_4096.npz", n)
    b[3] = 0
    b[4, 0, 0] = b[4, 0, 1] = 2
    return b


@pytest.mark.parametrize("n", [5, 70])
def test_solve_batch_np_matches_jax(n):
    """5 boards pad into bucket 8; 70 tile over bucket 64 (64 + 6 → 8)."""
    jax_eng, eng = engines()
    boards = mixed_batch(n)
    ref = jax_eng.solve_batch_np(boards)
    got = eng.solve_batch_np(boards)
    assert_batch_equal(got, ref)
    assert not got[1][4] and got[1][3]
    assert eng.validations == jax_eng.validations > 0
    assert eng.solved_puzzles == jax_eng.solved_puzzles == n - 1


def test_solve_one_matches_jax():
    jax_eng, eng = engines()
    bad = [[0] * 9 for _ in range(9)]
    bad[4][4] = bad[4][5] = 9
    for board in (README_PUZZLE, bad):
        assert solve_one(eng, board) == jax_eng.solve_one(board)
    assert eng.validations == jax_eng.validations
    assert eng.solved_puzzles == jax_eng.solved_puzzles == 1


def test_deep_retry_matches_jax():
    """max_iters=6: boards still RUNNING rerun once at 16× the budget in
    the smallest covering bucket; guesses and validations accumulate."""
    jax_eng, eng = engines(max_iters=6)
    boards = corpus("corpus_9x9_hard_4096.npz", 8)
    ref = jax_eng.solve_batch_np(boards)
    got = eng.solve_batch_np(boards)
    assert_batch_equal(got, ref)
    assert got[1].all() and got[2]["capped"] == 0


def test_capped_after_deep_retry_matches_jax():
    jax_eng, eng = engines(max_iters=1, deep_retry_factor=2)
    boards = corpus("corpus_9x9_hard_4096.npz", 3)
    ref = jax_eng.solve_batch_np(boards)
    got = eng.solve_batch_np(boards)
    assert_batch_equal(got, ref)
    assert got[2]["capped"] == 3
    sol, info = eng.solve_one(boards[0])
    assert sol is None and info["capped"] == 1


def test_singles_config_matches_jax():
    """Both engines in the kernel's singles configuration (no locked
    candidates, one sweep a step), as the port served before K2."""
    singles = dict(locked_candidates=False, waves=1, naked_pairs=False)
    jax_eng, eng = engines(**singles)
    boards = mixed_batch(12)
    assert_batch_equal(eng.solve_batch_np(boards), jax_eng.solve_batch_np(boards))
    got = solve_one(eng, README_PUZZLE)
    assert got == jax_eng.solve_one(README_PUZZLE)
    assert got[1]["validations"] == 109  # 49 steps at depth 32, then 60
    assert eng.validations == jax_eng.validations


def test_warmup_and_ready():
    _, eng = engines()
    assert not eng.ready()
    eng.warmup()
    assert eng.ready()
    assert eng.validations == 0  # warm-up bills no work


@pytest.mark.parametrize(
    "kw",
    [
        {"locked_candidates": True},
        {"waves": 3},
        {"naked_pairs": True},
        {"coalesce": True},
    ],
)
def test_serving_knobs_match_jax(kw):
    """The knobs the port refused before K2 and the coalescer: each one
    set explicitly gives the JAX engine's answers and counters."""
    jax_eng, eng = engines(**kw)
    boards = mixed_batch(5)
    assert_batch_equal(eng.solve_batch_np(boards), jax_eng.solve_batch_np(boards))
    for board in (README_PUZZLE, boards[4]):
        assert solve_one(eng, board) == jax_eng.solve_one(board)
    assert eng.validations == jax_eng.validations


@pytest.mark.parametrize(
    "kw",
    [
        {"mesh": "auto"},
        {"solver_config": "legacy"},
        {"frontier_mesh": ["cpu", "cpu"]},  # a race across two devices
    ],
)
def test_unported_knobs_raise(kw):
    with pytest.raises(NotImplementedError):
        SolverEngine(device="cpu", **kw)


def test_unknown_knob_and_backend_raise():
    with pytest.raises(TypeError):
        SolverEngine(device="cpu", no_such_knob=1)
    with pytest.raises(NotImplementedError, match="backend"):
        SolverEngine(device="cpu", backend="xla")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverEngine()
