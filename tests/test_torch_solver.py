"""The port's plain solver (sudoku_solver_distributed_tpu_torch/ops/solver.py)
and its kernel wrapper on the CPU, held against the JAX package's solvers in
the kernel's configuration (``locked_candidates=False, waves=1``): grid,
status, guesses and validations must be equal per board. ``iters`` is a
schedule counter and is compared only where both loops are flat.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SYMMETRY_SEED, symmetry_transforms
from sudoku_solver_distributed_tpu.ops import spec_for_size as jspec_for_size
from sudoku_solver_distributed_tpu.ops.pallas_solver import solve_batch_pallas
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size as tspec_for_size
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    dfs_solver,
    solve_batch_cuda,
)

jsolver = importlib.import_module("sudoku_solver_distributed_tpu.ops.solver")
tsolver = importlib.import_module("sudoku_solver_distributed_tpu_torch.ops.solver")

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
FIELDS = ("grid", "status", "guesses", "validations")


def corpus(name, n):
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][:n].astype(np.int32)


def jax_solve(boards, size, **kw):
    spec = jspec_for_size(size)
    fn = jax.jit(
        lambda g: jsolver.solve_batch(
            g, spec, locked_candidates=False, waves=1, **kw
        )
    )
    return fn(jnp.asarray(boards))


def assert_same(port, ref, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)), f
        )


def overflow_batch():
    """A batch whose empty board needs ~47 frames (overflows a shallow
    stage), with a conflict board and two corpus boards beside it."""
    b = np.zeros((4, 9, 9), np.int32)
    b[1, 0, 0] = b[1, 0, 1] = 7
    b[2:] = corpus("corpus_9x9_hard_4096.npz", 2)
    return b


CASES = {
    "hard64": (corpus("corpus_9x9_hard_4096.npz", 64), 9, (32, 81), 4096),
    "deep16": (corpus("corpus_9x9_deep_128.npz", 16), 9, (32, 81), 4096),
    "hex4": (corpus("corpus_16x16_hard_2048.npz", 4), 16, (64, 256), 16384),
    # symmetry transforms move MRV ties and singles to other cells, and so
    # across the kernel's lane boundaries (cells 31/32, 63/64)
    "hard64_sym": (
        symmetry_transforms(corpus("corpus_9x9_hard_4096.npz", 64), 64, SYMMETRY_SEED),
        9, (32, 81), 4096,
    ),
    "hex4_sym": (
        symmetry_transforms(corpus("corpus_16x16_hard_2048.npz", 4), 4, SYMMETRY_SEED),
        16, (64, 256), 16384,
    ),
}
SYMMETRY_CASES = ["hard64_sym", "hex4_sym"]


@functools.cache
def jax_case(case):
    boards, size, depth, iters = CASES[case]
    return jax_solve(boards, size, max_depth=depth, max_iters=iters)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batch_matches_jax(case):
    boards, size, depth, iters = CASES[case]
    ref = jax_case(case)
    port = tsolver.solve_batch(
        torch.as_tensor(boards), tspec_for_size(size), max_depth=depth,
        max_iters=iters,
    )
    assert_same(port, ref)
    assert bool(port.solved.all())


@pytest.mark.parametrize("depth", [(8, 81), 81, 8])
def test_staged_and_flat_depth_match_jax(depth):
    """Staged: OVERFLOW boards rerun deeper with pad boards in the other
    lanes and accumulate counters; flat 8: the empty board ends OVERFLOW."""
    boards = overflow_batch()
    ref = jax_solve(boards, 9, max_depth=depth)
    port = tsolver.solve_batch(torch.as_tensor(boards), tspec_for_size(9),
                               max_depth=depth)
    assert_same(port, ref)
    want = [tsolver.OVERFLOW if depth == 8 else tsolver.SOLVED,
            tsolver.UNSAT, tsolver.SOLVED, tsolver.SOLVED]
    assert port.status.tolist() == want


def test_staged_grid_equals_flat_grid():
    boards = overflow_batch()
    spec = tspec_for_size(9)
    staged = tsolver.solve_batch(torch.as_tensor(boards), spec, max_depth=(8, 81))
    flat = tsolver.solve_batch(torch.as_tensor(boards), spec, max_depth=81)
    assert torch.equal(staged.grid, flat.grid)
    assert torch.equal(staged.status, flat.status)
    # the overflowing board's counters accumulate across the two stages
    assert int(staged.guesses[0]) > int(flat.guesses[0])


@pytest.mark.parametrize("cap", [1, 7, 25])
def test_iteration_cap_matches_jax(cap):
    """Boards still RUNNING at the cap stay RUNNING with exactly ``cap``
    validations; a board completed on the capped step reads SOLVED."""
    boards = corpus("corpus_9x9_hard_4096.npz", 16)
    ref = jax_solve(boards, 9, max_depth=(32, 81), max_iters=cap)
    port = tsolver.solve_batch(torch.as_tensor(boards), tspec_for_size(9),
                               max_depth=(32, 81), max_iters=cap)
    assert_same(port, ref)
    running = port.status == tsolver.RUNNING
    assert bool(running.any())
    assert (port.validations[running] == cap).all()
    assert port.iters == int(ref.iters) == cap


def test_kernel_wrapper_on_cpu_matches_jax_and_plain():
    """On a CPU tensor the kernel's wrapper runs the plain version; the
    staged glue around it must agree with the JAX solver and the plain
    solve_batch, including the per-board step counts' maximum."""
    boards = np.concatenate([overflow_batch(), corpus("corpus_9x9_hard_4096.npz", 12)])
    ref = jax_solve(boards, 9, max_depth=(32, 81))
    before = dfs_solver.launches
    res, stats = solve_batch_cuda(torch.as_tensor(boards), tspec_for_size(9),
                                  max_depth=(32, 81), return_stats=True)
    assert dfs_solver.launches == before  # the plain version is no launch
    assert_same(res, ref)
    plain = tsolver.solve_batch(torch.as_tensor(boards), tspec_for_size(9),
                                max_depth=(32, 81))
    assert int(res.iters) == plain.iters
    assert stats.idle_lane_steps == 0


@pytest.mark.parametrize("case", SYMMETRY_CASES)
def test_kernel_wrapper_on_cpu_matches_jax_on_symmetry_transforms(case):
    """``dfs_solver`` on a CPU tensor, through the staged glue, against the
    JAX solver on seeded symmetry transforms of hard boards."""
    boards, size, depth, iters = CASES[case]
    before = dfs_solver.launches
    port = solve_batch_cuda(torch.as_tensor(boards), tspec_for_size(size),
                            max_depth=depth, max_iters=iters)
    assert dfs_solver.launches == before
    assert_same(port, jax_case(case))
    assert bool(port.solved.all())


def test_matches_pallas_kernel_interpret():
    """The Pallas kernel itself (interpret mode, block=8) on 8 boards."""
    boards = corpus("corpus_9x9_hard_4096.npz", 8)
    ref = solve_batch_pallas(jnp.asarray(boards), jspec_for_size(9), block=8,
                             max_depth=(32, 81), max_iters=4096, interpret=True)
    port = solve_batch_cuda(torch.as_tensor(boards), tspec_for_size(9),
                            max_depth=(32, 81), max_iters=4096)
    assert_same(port, ref)


def test_state_from_numpy_continues_jax_search():
    """A JAX search stopped mid-way (non-empty stack) continues in the port
    to the same end as JAX's own continuation."""
    boards = corpus("corpus_9x9_hard_4096.npz", 16)
    jspec, tspec = jspec_for_size(9), tspec_for_size(9)
    D, k, cap = 81, 12, 4096

    @jax.jit
    def first_k(g):
        st = jsolver.init_state(g, jspec, D)
        return jax.lax.fori_loop(0, k, lambda _, s: jsolver.step(s, jspec), st)

    @jax.jit
    def finish(st):
        st = jax.lax.while_loop(
            lambda s: (s.status == jsolver.RUNNING).any() & (s.iters < cap),
            lambda s: jsolver.step(s, jspec),
            st,
        )
        return jsolver.finalize_status(st, jspec)

    mid = first_k(jnp.asarray(boards))
    mid_np = jax.tree.map(np.asarray, mid)
    assert (mid_np.depth > 0).any()
    ref = finish(mid)

    port = tsolver.state_from_numpy(mid_np)
    assert port.iters == k
    port, _ = tsolver.run_loop(port, tspec, cap)
    for f in ("grid", "status", "guesses", "validations", "depth"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), f
        )
    assert port.iters == int(ref.iters)
