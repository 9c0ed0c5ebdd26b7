"""The port's serving configuration held against the JAX package's, exactly
(integers, tolerance 0): ``analyze(locked=True)`` with its naked-pair and
packed arms, ``solve_batch(**serving_config(n))`` for 9×9, 16×16 and 25×25,
the sweep knobs one at a time on 9×9, the golden work counters of
``tests/golden_counters.json``, and the default engines against each other
at bucket widths 1 and 8.

Inputs are the committed corpora, numpy-seeded partial boards and the
degenerate boards of tests/test_torch_ops.py. On the CPU the kernel's
wrapper runs its plain version; ``chip_smoke.py`` holds the kernel itself
against that plain version on the card.
"""

import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import CASES, both, corpus, partial_boards
from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.ops import spec_for_size as jspec_for_size
from sudoku_solver_distributed_tpu.ops.config import (
    serving_config as jserving_config,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size as tspec_for_size
from sudoku_solver_distributed_tpu_torch.ops.config import (
    SERVING_CONFIG,
    serving_config,
)
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    dfs_solver,
    solve_batch_cuda,
)

jprop = importlib.import_module("sudoku_solver_distributed_tpu.ops.propagate")
tprop = importlib.import_module("sudoku_solver_distributed_tpu_torch.ops.propagate")
jsolver = importlib.import_module("sudoku_solver_distributed_tpu.ops.solver")
tsolver = importlib.import_module("sudoku_solver_distributed_tpu_torch.ops.solver")

REPO = os.path.join(os.path.dirname(__file__), "..")
FIELDS = ("grid", "status", "guesses", "validations")

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


def assert_same(port, ref, fields=FIELDS + ("iters",)):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)), f
        )


# -- analyze(locked=True) ------------------------------------------------------

ANALYZE_CASES = [
    (case, pairs, packed)
    for case in sorted(CASES)
    for pairs in (False, True)
    for packed in ((False,) if case == "giant25" else (False, True))
]


@pytest.mark.parametrize("case,pairs,packed", ANALYZE_CASES)
def test_locked_analyze_matches_jax(case, pairs, packed):
    jspec, tspec, boards = both(case)
    ja = jax.jit(
        lambda g: jprop.analyze(
            g, jspec, locked=True, naked_pairs=pairs, packed=packed
        )
    )(jnp.asarray(boards))
    ta = tprop.analyze(
        torch.as_tensor(boards), tspec, locked=True, naked_pairs=pairs,
        packed=packed,
    )
    for field in ("cand", "assign", "contradiction", "solved"):
        np.testing.assert_array_equal(
            getattr(ta, field).numpy(), np.asarray(getattr(ja, field)), field
        )


def test_locked_analyze_eliminates_and_defaults_match_jax():
    """The default arms (``naked_pairs`` None follows ``locked``, ``packed``
    None follows ops.config.PACKED_DEFAULT) equal JAX's defaults, and the
    eliminations really remove candidates on the hard corpus."""
    jspec, tspec, boards = both("hard9")
    ja = jax.jit(lambda g: jprop.analyze(g, jspec, locked=True))(
        jnp.asarray(boards)
    )
    ta = tprop.analyze(torch.as_tensor(boards), tspec, locked=True)
    np.testing.assert_array_equal(ta.cand.numpy(), np.asarray(ja.cand))
    singles = tprop.analyze(torch.as_tensor(boards), tspec)
    assert int((ta.cand != singles.cand).sum()) > 0
    assert bool(((ta.cand & ~singles.cand) == 0).all())


def test_packed_analyze_refuses_25x25_like_jax():
    jspec, tspec, boards = both("giant25")
    with pytest.raises(ValueError, match="N <= 16"):
        tprop.analyze(torch.as_tensor(boards), tspec, locked=True, packed=True)
    with pytest.raises(ValueError, match="N <= 16"):
        jprop.analyze(jnp.asarray(boards), jspec, locked=True, packed=True)
    with pytest.raises(ValueError, match="N <= 16"):
        tsolver.solve_batch(
            torch.as_tensor(boards), tspec, locked_candidates=True, packed=True
        )


@pytest.mark.parametrize("bits", [0x8000, 0x8001, 0xFFFF])
def test_lsr16_is_logical_on_the_high_plane(bits):
    """Value bit 15 of a 16×16 board's high plane is int32 bit 31: the
    shift must fill zeros, as jax.lax.shift_right_logical does."""
    x = np.array([bits << 16], dtype=np.uint32).view(np.int32)
    got = tprop._lsr16(torch.as_tensor(x)).numpy()
    want = np.asarray(jprop._lsr16(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == bits


# -- solve_batch under the serving config and each knob -----------------------

SERVING_CASES = {
    9: lambda: corpus("corpus_9x9_hard_4096.npz", 48),
    16: lambda: corpus("corpus_16x16_hard_2048.npz", 4),
    25: lambda: corpus("corpus_25x25_hard_512.npz", 2),
}


@functools.cache
def jax_solve(size, boards_key, **kw):
    boards = BOARDS[boards_key]()
    spec = jspec_for_size(size)
    return jax.jit(lambda g: jsolver.solve_batch(g, spec, **kw))(
        jnp.asarray(boards)
    )


def _overflow_mix():
    """An empty board (overflows the 32-frame stage), a clue conflict, an
    out-of-range value and hard corpus boards."""
    b = np.zeros((12, 9, 9), np.int32)
    b[1, 0, 0] = b[1, 0, 1] = 6
    b[2:] = corpus("corpus_9x9_hard_4096.npz", 10)
    b[2, 4, 4] = 11
    return b


BOARDS = {
    "serving9": SERVING_CASES[9],
    "serving16": SERVING_CASES[16],
    "serving25": SERVING_CASES[25],
    # hard boards whose slowest takes ~30 steps, and seeded 30-clue boards
    # with many solutions (tie-breaks)
    "hard9": lambda: np.concatenate(
        [corpus("corpus_9x9_hard_4096.npz", 96)[72:], partial_boards(7, 8, 30)]
    ),
    "mix9": _overflow_mix,
}


def test_serving_config_copy_equals_jax():
    for n in (9, 16, 25):
        assert serving_config(n) == jserving_config(n)
    assert sorted(SERVING_CONFIG) == [9, 16, 25]


@pytest.mark.parametrize("size", [9, 16, 25])
def test_solve_batch_serving_config_matches_jax(size):
    cfg = serving_config(size)
    ref = jax_solve(size, f"serving{size}", **cfg)
    port = tsolver.solve_batch(
        torch.as_tensor(BOARDS[f"serving{size}"]()), tspec_for_size(size), **cfg
    )
    assert_same(port, ref)
    assert bool(port.solved.all())


KNOBS = {
    "waves1": dict(locked_candidates=True, waves=1, naked_pairs=False),
    "waves2": dict(locked_candidates=True, waves=2, naked_pairs=False),
    "waves3": dict(locked_candidates=True, waves=3, naked_pairs=False),
    "light": dict(locked_candidates=True, waves=3, light_waves=True,
                  naked_pairs=False),
    "pairs": dict(locked_candidates=True, waves=3, naked_pairs=True),
    "pairs_default": dict(locked_candidates=True, waves=2),
    "singles_waves3": dict(locked_candidates=False, waves=3),
}


@pytest.mark.parametrize("boards_key", ["hard9", "mix9"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_solve_batch_knobs_match_jax(knob, boards_key):
    kw = dict(KNOBS[knob], max_depth=(32, 81), max_iters=4096)
    ref = jax_solve(9, boards_key, **kw)
    port = tsolver.solve_batch(
        torch.as_tensor(BOARDS[boards_key]()), tspec_for_size(9), **kw
    )
    assert_same(port, ref)


@pytest.mark.parametrize("cap", [1, 5])
def test_step_cap_counts_steps_not_sweeps(cap):
    """``max_iters`` caps steps: a board still RUNNING at the cap has
    swept ``waves`` times a step (validations = 3 × cap on 9×9)."""
    kw = dict(serving_config(9), max_iters=cap)
    ref = jax_solve(9, "hard9", **kw)
    port = tsolver.solve_batch(
        torch.as_tensor(BOARDS["hard9"]()), tspec_for_size(9), **kw
    )
    assert_same(port, ref)
    running = port.status == tsolver.RUNNING
    assert bool(running.any())
    assert (port.validations[running] == 3 * cap).all()


@pytest.mark.parametrize("knob", ["waves3", "light", "pairs"])
def test_kernel_wrapper_knobs_on_cpu_match_jax(knob):
    """``solve_batch_cuda`` on a CPU tensor passes its sweep knobs to the
    plain version (no launch) and agrees with the JAX solver."""
    kw = dict(KNOBS[knob], max_depth=(32, 81), max_iters=4096)
    before = dfs_solver.launches
    port = solve_batch_cuda(
        torch.as_tensor(BOARDS["mix9"]()), tspec_for_size(9), **kw
    )
    assert dfs_solver.launches == before
    assert_same(port, jax_solve(9, "mix9", **kw))


def test_kernel_wrapper_refuses_bad_knobs():
    flat = torch.zeros((1, 81), dtype=torch.int32)
    with pytest.raises(ValueError, match="waves"):
        dfs_solver(flat, tspec_for_size(9), 32, 10, waves=0)
    flat25 = torch.zeros((1, 625), dtype=torch.int32)
    with pytest.raises(ValueError, match="N <= 16"):
        dfs_solver(flat25, tspec_for_size(25), 32, 10, locked_candidates=True,
                   packed=True)


def _golden():
    with open(os.path.join(REPO, "tests", "golden_counters.json")) as f:
        golden = json.load(f)
    with np.load(os.path.join(REPO, "benchmarks", golden["corpus"])) as d:
        boards = d["boards"].astype(np.int32)
    assert boards.shape[0] == golden["boards"]
    cfg = {**serving_config(9), "max_iters": golden["config"]["max_iters"]}
    assert {k: cfg[k] for k in ("max_iters", "locked_candidates", "waves",
                                "naked_pairs")} == {
        k: golden["config"][k] for k in ("max_iters", "locked_candidates",
                                         "waves", "naked_pairs")}
    return golden, boards, cfg


# The whole deep-union corpus takes the plain version ~45 s alone on the
# CPU (its slowest board runs 3,022 steps) and several minutes beside
# other test workers, so the CPU test holds the 32-board slice whose
# slowest board is shortest against JAX; chip_smoke.py and the cuda test
# of tests/test_torch_isolation.py hold the kernel to the committed goldens
# on all 256 boards.
GOLDEN_SLICE = slice(224, 256)


def test_golden_counters_slice_matches_jax():
    golden, boards, cfg = _golden()
    sub = boards[GOLDEN_SLICE]
    ref = jax.jit(lambda g: jsolver.solve_batch(g, jspec_for_size(9), **cfg))(
        jnp.asarray(sub)
    )
    port = tsolver.solve_batch(torch.as_tensor(sub), tspec_for_size(9), **cfg)
    assert_same(port, ref)
    assert bool(port.solved.all())


# -- the default engines --------------------------------------------------------


def _default_engines():
    return (
        JaxEngine(coalesce=False, buckets=(1, 8)),
        SolverEngine(device="cpu", buckets=(1, 8), coalesce=False),
    )


def test_default_engine_width1_readme_matches_jax():
    """A width-1 bucket sweeps once a step: the README board answers 105
    validations and 67 guesses in both packages."""
    jax_eng, eng = _default_engines()
    want = jax_eng.solve_one(README_PUZZLE)
    got = eng.solve_one(README_PUZZLE)
    assert got == want
    assert got[1]["validations"] == 105 and got[1]["guesses"] == 67
    assert eng.validations == jax_eng.validations == 105


def test_default_engine_width8_matches_jax():
    """Eight hard boards in bucket 8 run ``waves=3``: 95 validations in all,
    equal per board."""
    jax_eng, eng = _default_engines()
    boards = corpus("corpus_9x9_hard_4096.npz", 8)
    want = jax_eng.solve_batch_np(boards)
    got = eng.solve_batch_np(boards)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[2]["validations"] == 95


def test_default_engine_resolves_serving_config():
    eng = SolverEngine(device="cpu", coalesce=False)
    jax_eng = JaxEngine(coalesce=False)
    for attr in ("max_depth", "max_iters", "locked_candidates", "waves",
                 "naked_pairs", "coalesce_max_wait_s"):
        assert getattr(eng, attr) == getattr(jax_eng, attr), attr
    assert eng._sweeps(1)["waves"] == 1 and eng._sweeps(8)["waves"] == 3
    assert SolverEngine(device="cpu").coalesce
    hexa = SolverEngine(tspec_for_size(16), device="cpu", coalesce=False)
    assert hexa.waves == 1 and hexa.max_depth == (64, 256)
