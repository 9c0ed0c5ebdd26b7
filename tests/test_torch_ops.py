"""The port's board operations (sudoku_solver_distributed_tpu_torch/ops) held
against the JAX package's, exactly: everything here is integers.

Inputs are slices of the committed corpora, numpy-seeded partial boards
(clues blanked from solved boards, so multi-solution tie-breaks are
exercised), and the degenerate boards of tests/test_ops_pallas.py
(duplicates, out-of-range values including the shift-aliasing 36, a hole).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.models import oracle_solve
from sudoku_solver_distributed_tpu.ops import spec_for_size as jspec_for_size
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size as tspec_for_size

# the ops packages re-export functions named like their modules
# (``propagate``), so the modules are imported by name
jencode = importlib.import_module("sudoku_solver_distributed_tpu.ops.encode")
jprop = importlib.import_module("sudoku_solver_distributed_tpu.ops.propagate")
jvalidate = importlib.import_module("sudoku_solver_distributed_tpu.ops.validate")
tencode = importlib.import_module("sudoku_solver_distributed_tpu_torch.ops.encode")
tprop = importlib.import_module("sudoku_solver_distributed_tpu_torch.ops.propagate")
tvalidate = importlib.import_module(
    "sudoku_solver_distributed_tpu_torch.ops.validate"
)

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")


def corpus(name, n):
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][:n].astype(np.int32)


def degenerate_boards():
    """tests/test_ops_pallas.py::test_pallas_fused_validate_parity's boards:
    solved, row duplicate, out of range (17), one hole, plus the
    shift-aliasing board (every 4 replaced by 36) and a clue conflict."""
    solved = np.asarray(
        oracle_solve(corpus("corpus_9x9_hard_4096.npz", 1)[0].tolist()), np.int32
    )
    batch = np.stack([solved] * 6)
    batch[1, 0, 0] = batch[1][0][1]
    batch[2, 0, 0] = 17
    batch[3, 8, 8] = 0
    batch[4][batch[4] == 4] = 36
    batch[5] = 0
    batch[5, 0, 0] = batch[5, 0, 1] = 4
    return batch


def partial_boards(seed, n, keep):
    """Solved boards with all but ``keep`` cells blanked (numpy seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in corpus("corpus_9x9_hard_4096.npz", n):
        sol = np.asarray(oracle_solve(b.tolist()), np.int32).reshape(-1)
        mask = np.zeros(81, bool)
        mask[rng.choice(81, keep, replace=False)] = True
        out.append(np.where(mask, sol, 0).reshape(9, 9))
    return np.stack(out)


CASES = {
    "hard9": lambda: (9, corpus("corpus_9x9_hard_4096.npz", 32)),
    "deep9": lambda: (9, corpus("corpus_9x9_deep_128.npz", 16)),
    "partial9": lambda: (9, partial_boards(7, 16, 30)),
    "hex16": lambda: (16, corpus("corpus_16x16_hard_2048.npz", 4)),
    "giant25": lambda: (25, corpus("corpus_25x25_hard_512.npz", 2)),
    "degenerate9": lambda: (9, degenerate_boards()),
}


def both(case):
    size, boards = CASES[case]()
    return jspec_for_size(size), tspec_for_size(size), boards


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyze_matches_jax(case):
    jspec, tspec, boards = both(case)
    ja = jax.jit(lambda g: jprop.analyze(g, jspec))(jnp.asarray(boards))
    ta = tprop.analyze(torch.as_tensor(boards), tspec)
    for field in ("cand", "assign", "contradiction", "solved"):
        np.testing.assert_array_equal(
            getattr(ta, field).numpy(), np.asarray(getattr(ja, field)), field
        )


@pytest.mark.parametrize("case", sorted(CASES))
def test_checks_match_jax(case):
    jspec, tspec, boards = both(case)
    jfn = jax.jit(
        lambda g: (
            jvalidate.check_rows(g, jspec),
            jvalidate.check_cols(g, jspec),
            jvalidate.check_boxes(g, jspec),
            jvalidate.check_boards(g, jspec),
            jencode.cell_used_mask(g, jspec),
        )
    )
    want = jfn(jnp.asarray(boards))
    g = torch.as_tensor(boards)
    got = (
        tvalidate.check_rows(g, tspec),
        tvalidate.check_cols(g, tspec),
        tvalidate.check_boxes(g, tspec),
        tvalidate.check_boards(g, tspec),
        tencode.cell_used_mask(g, tspec),
    )
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagate_matches_jax(case):
    jspec, tspec, boards = both(case)
    jg, jit_ = jax.jit(lambda g: jprop.propagate(g, jspec))(jnp.asarray(boards))
    tg, tit = tprop.propagate(torch.as_tensor(boards), tspec)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tit == int(jit_)
    jg1, jch = jax.jit(lambda g: jprop.propagate_step(g, jspec))(
        jnp.asarray(boards)
    )
    tg1, tch = tprop.propagate_step(torch.as_tensor(boards), tspec)
    np.testing.assert_array_equal(tg1.numpy(), np.asarray(jg1))
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))


def test_shift_aliasing_board_is_not_valid():
    """Value 36 = 4 + 32 must not alias value 4's bit (a wrapped shift
    would let the board pass the strict checker)."""
    _, tspec, boards = both("degenerate9")
    ok = tvalidate.check_boards(torch.as_tensor(boards), tspec).tolist()
    assert ok == [True, False, False, False, False, False]


@pytest.mark.parametrize("size", [4, 9, 16, 25])
def test_mask_to_value_matches_jax(size):
    jspec, tspec = jspec_for_size(size), tspec_for_size(size)
    masks = np.array([0] + [1 << v for v in range(size)], np.int32)
    want = jax.jit(jencode.mask_to_value)(jnp.asarray(masks))
    got = tencode.mask_to_value(torch.as_tensor(masks), tspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == list(range(size + 1))


def test_is_valid_move_matches_jax():
    jspec, tspec, boards = both("partial9")
    rng = np.random.default_rng(11)
    B = boards.shape[0]
    row, col = rng.integers(0, 9, B), rng.integers(0, 9, B)
    num = rng.integers(1, 10, B)
    want = jax.jit(lambda g, r, c, v: jvalidate.is_valid_move(g, r, c, v, jspec))(
        jnp.asarray(boards), jnp.asarray(row), jnp.asarray(col), jnp.asarray(num)
    )
    got = tvalidate.is_valid_move(
        torch.as_tensor(boards), torch.as_tensor(row), torch.as_tensor(col),
        torch.as_tensor(num), tspec,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_locked_analysis_matches_jax(case):
    """``analyze(locked=True)`` with its default arms (naked pairs follow
    ``locked``; the packed form by board size). Every arm is held apart in
    tests/test_torch_serving_config.py."""
    jspec, tspec, boards = both(case)
    ja = jax.jit(lambda g: jprop.analyze(g, jspec, locked=True))(
        jnp.asarray(boards)
    )
    ta = tprop.analyze(torch.as_tensor(boards), tspec, locked=True)
    for field in ("cand", "assign", "contradiction", "solved"):
        np.testing.assert_array_equal(
            getattr(ta, field).numpy(), np.asarray(getattr(ja, field)), field
        )
