"""The port's puzzle generator (models/generator.py) and native oracle
(native/) against the JAX package's on the CPU: the native functions give
the JAX native oracle's results, and ``generate_board`` /
``generate_batch`` give the JAX package's boards for the same seed at sizes
4, 9 and 16, with the native oracle on in both packages and off in both.
The port's oracle builds through its own store (compilecache/), under
``<root>/native`` with a compile cache.
"""

import os
import random

import numpy as np
import pytest

from sudoku_solver_distributed_tpu import native as jax_native
from sudoku_solver_distributed_tpu.models import generator as jax_gen
from sudoku_solver_distributed_tpu_torch import native
from sudoku_solver_distributed_tpu_torch.compilecache import (
    enable_persistent_cache,
    store as store_mod,
)
from sudoku_solver_distributed_tpu_torch.models import (
    count_solutions,
    generate_batch,
    generate_board,
    oracle_is_valid_solution,
    oracle_solve,
)

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")


def corpus(name, n):
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][:n].astype(np.int32)


def test_native_oracle_loads_where_a_compiler_exists():
    assert native.available() == jax_native.available() == (
        native._compiler() is not None)


@pytest.mark.parametrize(
    "name, n", [("corpus_9x9_hard_64.npz", 4), ("corpus_16x16_hard_2048.npz", 2),
                ("corpus_9x9_deep_128.npz", 2)],
)
def test_native_solve_and_counts_equal_the_jax_oracle(name, n):
    for board in corpus(name, n):
        b = board.tolist()
        got = native.native_solve(b)
        assert got == jax_native.native_solve(b) == oracle_solve(b)
        assert oracle_is_valid_solution(got)
        assert native.native_count_solutions(b) == jax_native.native_count_solutions(b) == 1
        holes = [row[:] for row in b]
        holes[0] = [0] * len(holes[0])  # a row of holes: more solutions
        for limit in (1, 2, 5):
            want = jax_native.native_count_solutions(holes, limit=limit)
            assert native.native_count_solutions(holes, limit=limit) == want
            for nodes in (0, 10, 10_000):
                assert native.native_count_solutions_budget(
                    holes, limit=limit, max_nodes=nodes
                ) == jax_native.native_count_solutions_budget(
                    holes, limit=limit, max_nodes=nodes)


@pytest.mark.parametrize("size", [4, 9, 16, 25])
def test_native_seeded_solve_equals_the_jax_oracle(size):
    empty = [[0] * size for _ in range(size)]
    for seed in (0, 1, 2**63 + 5):
        got = native.native_solve_seeded(empty, seed)
        assert got == jax_native.native_solve_seeded(empty, seed)
        assert oracle_is_valid_solution(got)


def test_native_unsat_and_bad_geometry_equal_the_jax_oracle():
    conflict = [[0] * 9 for _ in range(9)]
    conflict[0][0] = conflict[0][1] = 5
    assert native.native_solve(conflict) is None is jax_native.native_solve(conflict)
    assert native.native_count_solutions(conflict) == 0
    for fn in (native.native_solve, jax_native.native_solve):
        with pytest.raises(ValueError):
            fn([[0] * 5 for _ in range(5)])
        with pytest.raises(ValueError):
            fn([[0] * 4 for _ in range(3)])


def _native(monkeypatch, on: bool):
    if not on:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)


# 4x4 seeds whose diagonal seed completes (some 4x4 seeds cannot: both
# packages then raise the same AssertionError, checked below)
@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
@pytest.mark.parametrize(
    "size, empty, unique, batch, seed",
    [(4, 8, True, 1, 0), (4, 6, False, 1, 4), (9, 50, True, 4, 7),
     (9, 40, False, 8, 3), (16, 120, False, 2, 7), (16, 60, True, 1, 7)],
)
def test_generate_batch_equals_the_jax_package(monkeypatch, native_on, size,
                                               empty, unique, batch, seed):
    _native(monkeypatch, native_on)
    want = jax_gen.generate_batch(batch, empty, size=size, seed=seed, unique=unique)
    got = generate_batch(batch, empty, size=size, seed=seed, unique=unique)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for board in got:
        if unique:
            assert count_solutions(board.tolist(), limit=2) == 1
        assert oracle_solve(board.tolist()) is not None


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
def test_generate_board_consumes_the_jax_random_stream(monkeypatch, native_on):
    """One rng across several boards of several sizes: the stream stays in
    step (above 9x9 a 64-bit seed is drawn with or without the native
    oracle), and the 4x4 seeds that cannot complete fail alike."""
    _native(monkeypatch, native_on)
    mine, theirs = random.Random(11), random.Random(11)
    for size, empty in ((9, 45), (16, 100), (4, 6), (9, 30)):
        try:
            want = jax_gen.generate_board(empty, size=size, rng=theirs)
        except AssertionError:
            with pytest.raises(AssertionError):
                generate_board(empty, size=size, rng=mine)
            continue
        assert generate_board(empty, size=size, rng=mine) == want
    assert mine.getrandbits(64) == theirs.getrandbits(64)
    with pytest.raises(AssertionError):
        jax_gen.generate_batch(1, 8, size=4, seed=1)
    with pytest.raises(AssertionError):
        generate_batch(1, 8, size=4, seed=1)


def test_native_oracle_builds_through_the_store(tmp_path, monkeypatch):
    """With a compile cache the native oracle builds under
    ``<root>/native``; a second process (a fresh store) loads it. Without a
    compiler the port gives way to the Python oracle, as the JAX module."""
    monkeypatch.setitem(store_mod._PROCESS, "root", None)
    monkeypatch.setitem(store_mod._PROCESS, "fixed", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_checked", False)
    native.native_store.cache_clear()
    try:
        assert enable_persistent_cache(str(tmp_path))
        assert native.available()
        store = native.native_store()
        assert store.root == tmp_path / "native"
        assert store.stats() == {"loaded": 0, "saved": 1, "errors": 0}
        board = corpus("corpus_9x9_hard_64.npz", 1)[0].tolist()
        assert native.native_solve(board) == oracle_solve(board)
        native.native_store.cache_clear()
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_checked", False)
        assert native.available()
        assert native.native_store().stats() == {"loaded": 1, "saved": 0, "errors": 0}
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_checked", False)
        monkeypatch.setattr(native, "_compiler", lambda: None)
        assert not native.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.native_solve(board)
    finally:
        native.native_store.cache_clear()
