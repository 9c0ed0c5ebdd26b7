"""The port's frontier race held against the JAX package's, on the CPU.

Every case feeds the same numpy inputs to both packages and compares
exactly. The JAX race runs on a ONE-device mesh (``default_mesh(jax.
devices()[:1])``): the suite's conftest gives JAX 8 host devices, and with
those its padding differs (``states_per_device`` per device). Seeding
(``seed_frontier``) with and without ``initial_states`` and ``locked``;
the handoff probe's state and its decomposition
(``state_handoff_frontier``); the plain race's packed row against JAX
``_make_racer`` (9×9 in the serving configuration, 16×16 and 25×25 deep
boards, UNSAT, capped); the fold of the race kernel (``fold_race``) on
each state's own run, cut where a warp of the kernel may cut it, against
the lockstep race, including two states solving at t* and states flipped
by ``finalize_status``; ``frontier_solve``; the engine's routing cases of
``tests/test_frontier_routing.py`` with counters and ``health()``; the
fallback, which here happens only on a device fault; ``/solve`` on a
frontier node beside a JAX node (bodies, ``/stats``, ``X-Timing``); and
the CLI flags.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net.cli import build_parser as jax_build_parser
from sudoku_solver_distributed_tpu.net.http_api import (
    make_http_server as jax_make_http_server,
)
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu.obs.trace import Tracer as JaxTracer
from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu import parallel as jparallel
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh
from sudoku_solver_distributed_tpu.serving.health import EngineSupervisor as JaxSupervisor
from sudoku_solver_distributed_tpu.serving.admission import (
    DeadlineExceeded as JaxDeadlineExceeded,
)
from sudoku_solver_distributed_tpu_torch import parallel as tparallel
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.models.oracle import oracle_solve
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.obs import Tracer
from sudoku_solver_distributed_tpu_torch.ops import solver as TS
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    KernelLaunchError,
    dfs_race,
)
from sudoku_solver_distributed_tpu_torch.ops.propagate import analyze
from sudoku_solver_distributed_tpu_torch.parallel import frontier as TF
from sudoku_solver_distributed_tpu_torch.serving.admission import DeadlineExceeded
from sudoku_solver_distributed_tpu_torch.serving.health import EngineSupervisor
from sudoku_solver_distributed_tpu_torch.utils.faults import InjectedEngineFault

README = [
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
# the serving configuration of every size (ops/config.py): locked
# candidates without naked pairs, three sweeps a step on 9x9
SERVING = {9: dict(locked=True, waves=3, naked_pairs=False),
           16: dict(locked=True, waves=1, naked_pairs=False),
           25: dict(locked=True, waves=1, naked_pairs=False)}


def _corpus(name):
    return np.load(f"benchmarks/{name}.npz")["boards"]


DEEP9 = _corpus("corpus_9x9_deep_128")
DEEP16 = _corpus("corpus_16x16_deep_anneal_64")
DEEP25 = _corpus("corpus_25x25_deep_anneal_32")


def _unsat_board():
    board = np.zeros((9, 9), np.int32)
    board[0] = [0, 0, 2, 3, 4, 5, 6, 7, 8]
    board[1, 0] = 1
    board[2, 1] = 1
    return board


@pytest.fixture(scope="module")
def mesh1():
    """One JAX device: the port races on one device."""
    return default_mesh(jax.devices()[:1])


def _jax_race(mesh, states, size, max_iters, depth, cfg):
    racer = JF._make_racer(
        mesh, jax_spec_for_size(size), max_iters, depth, cfg["locked"],
        cfg["waves"], cfg["naked_pairs"],
    )
    return np.asarray(racer(jnp.asarray(states)))


def _port_race(states, size, max_iters, depth, cfg):
    spec = spec_for_size(size)
    flat = torch.from_numpy(np.ascontiguousarray(states.reshape(len(states), -1)))
    return dfs_race(
        flat, spec, depth, max_iters, locked_candidates=cfg["locked"],
        waves=cfg["waves"], naked_pairs=cfg["naked_pairs"],
    )


def _seeded(board, size, target, locked):
    states, early = TF.seed_frontier(
        board, spec_for_size(size), target=target, locked=locked, device="cpu"
    )
    assert early is None
    return TF.bucket_states(states, spec_for_size(size), target).numpy()


# -- seeding ------------------------------------------------------------------


@pytest.mark.parametrize("name, size, board, target, locked", [
    ("readme", 9, README, 32, False),
    ("readme-locked", 9, README, 32, True),
    ("deep", 9, DEEP9[0], 64, True),
    ("hexadoku", 16, DEEP16[0], 8, True),
    ("25x25", 25, DEEP25[8], 8, True),
    ("unsat", 9, _unsat_board(), 8, False),
    ("easy", 9, generate_batch(1, 25, seed=4)[0], 64, False),
])
def test_seed_frontier_matches_jax(name, size, board, target, locked):
    js, je = JF.seed_frontier(
        np.asarray(board), jax_spec_for_size(size), target=target, locked=locked
    )
    ts, te = TF.seed_frontier(
        np.asarray(board), spec_for_size(size), target=target, locked=locked,
        device="cpu",
    )
    assert ts.dtype == np.int32 and ts.shape == js.shape
    assert np.array_equal(ts, js)
    assert (je is None) == (te is None)
    if je is not None:
        assert np.array_equal(te, je)
        assert oracle_is_valid_solution(te.tolist())


@pytest.mark.parametrize("locked", [False, True])
def test_seed_frontier_from_initial_states_matches_jax(locked):
    eng = JaxEngine(buckets=(1,), frontier_escalate_iters=4)
    _, st = eng._solve_quick_state(jnp.asarray(np.asarray(README, np.int32)[None]))
    seeds = JF.state_handoff_frontier(jax.device_get(st), JF.SPEC_9)
    js, je = JF.seed_frontier(None, JF.SPEC_9, target=32, locked=locked,
                              initial_states=seeds)
    ts, te = TF.seed_frontier(None, spec_for_size(9), target=32, locked=locked,
                              initial_states=seeds, device="cpu")
    assert np.array_equal(ts, js) and je is None and te is None
    eng.close()


def test_seed_frontier_checks_the_deadline_between_rounds():
    for seed, kw in ((JF.seed_frontier, {}), (TF.seed_frontier, {"device": "cpu"})):
        exc = JaxDeadlineExceeded if seed is JF.seed_frontier else DeadlineExceeded
        with pytest.raises(exc):
            seed(np.asarray(README), target=32, deadline_s=time.monotonic() - 1, **kw)


# -- the handoff probe's state ------------------------------------------------


@pytest.mark.parametrize("board, iters", [(README, 4), (README, 40), (DEEP9[0], 512)])
def test_quick_state_and_handoff_seeds_match_jax(mesh1, board, iters):
    """One K3 segment over a one-lane pool (flat depth, one sweep a step)
    then ``finalize_status``: the JAX ``_run_quick_state``'s status,
    guesses, validations, depth and stack arrays, and the same unexplored
    subtrees from ``state_handoff_frontier``."""
    arr = np.asarray(board, np.int32)
    jeng = JaxEngine(buckets=(1,), frontier_mesh=mesh1, frontier_escalate_iters=iters)
    teng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                        frontier_escalate_iters=iters)
    try:
        jpacked, jst = jeng._solve_quick_state(jnp.asarray(arr[None]))
        jpacked, jst = np.asarray(jpacked), jax.device_get(jst)
        tpacked, pool = teng._quick_state(arr)
        assert np.array_equal(tpacked, jpacked)
        tst = pool.state
        depth = int(tst.depth[0])
        assert depth == int(jst.depth[0]) and int(tst.status[0]) == int(jst.status[0])
        for field in ("grid", "guesses", "validations"):
            assert np.array_equal(getattr(tst, field).numpy(),
                                  np.asarray(getattr(jst, field))), field
        for field in ("stack_grid", "stack_cell", "stack_mask"):
            assert np.array_equal(getattr(tst, field).numpy()[0, :depth],
                                  np.asarray(getattr(jst, field))[0, :depth]), field
        seeds = TF.state_handoff_frontier(tst, spec_for_size(9))
        assert np.array_equal(seeds, JF.state_handoff_frontier(jst, JF.SPEC_9))
    finally:
        jeng.close()
        teng.close()


def test_handoff_seeds_cover_the_solution_once():
    teng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                        frontier_escalate_iters=4)
    arr = np.asarray(README, np.int32)
    packed, pool = teng._quick_state(arr)
    assert int(packed[81]) == TS.RUNNING
    seeds = TF.state_handoff_frontier(pool.state, spec_for_size(9))
    solution = np.asarray(oracle_solve(README), np.int32)
    compatible = [s for s in seeds if bool(((s == 0) | (s == solution)).all())]
    assert len(compatible) == 1
    for s in seeds:
        assert bool((s[arr > 0] == arr[arr > 0]).all())
    teng.close()


# -- the race's packed row -----------------------------------------------------


# a 4x4 board with one clue: its seeding at 8 leaves 12 states (raced as
# 16); every 4x4 board with more clues is solved by its seeding
ONE_CLUE_4 = np.zeros((4, 4), np.int32)
ONE_CLUE_4[0, 0] = 1
# a 4x4 node's knobs (no serving config: the engine's defaults, naked pairs
# following locked candidates)
ENGINE_4 = dict(locked=True, waves=1, naked_pairs=True)

RACE_CASES = {
    # name: (size, board, states_per_device, max_iters, depth, config)
    "readme-serving": (9, README, 8, JF.DEFAULT_MAX_ITERS, 81, SERVING[9]),
    "readme-capped": (9, README, 8, 6, 81, SERVING[9]),
    "deep-capped": (9, DEEP9[0], 8, 24, 81, SERVING[9]),
    "hexadoku-deep": (16, DEEP16[0], 8, JF.DEFAULT_MAX_ITERS, 256, SERVING[16]),
    "25x25-deep": (25, DEEP25[31], 8, JF.DEFAULT_MAX_ITERS, 625, SERVING[25]),
    "readme-singles": (9, README, 16, JF.DEFAULT_MAX_ITERS, 81,
                       dict(locked=False, waves=1, naked_pairs=None)),
    "4x4-one-clue": (4, ONE_CLUE_4, 8, JF.DEFAULT_MAX_ITERS, 16, ENGINE_4),
}


@pytest.mark.parametrize("name", sorted(RACE_CASES))
def test_plain_race_row_matches_jax_racer(mesh1, name):
    size, board, spd, max_iters, depth, cfg = RACE_CASES[name]
    states = _seeded(board, size, spd, cfg["locked"])
    row, fold, meta = _port_race(states, size, max_iters, depth, cfg)
    assert np.array_equal(row.numpy(), _jax_race(mesh1, states, size, max_iters, depth, cfg))
    # the per-state fold adds up to the row
    assert int(fold[:, 1].sum()) == int(row[-2])


def test_unsat_race_is_a_proof_in_both(mesh1):
    board = np.zeros((9, 9), np.int32)
    board[0, 0] = board[0, 1] = 5
    states, early = TF.seed_frontier(board, spec_for_size(9), target=8, device="cpu")
    assert early is None and len(states) == 8
    cfg = SERVING[9]
    row, _, _ = _port_race(states, 9, JF.DEFAULT_MAX_ITERS, 81, cfg)
    jrow = _jax_race(mesh1, states, 9, JF.DEFAULT_MAX_ITERS, 81, cfg)
    assert np.array_equal(row.numpy(), jrow)
    assert row[81] == 0 and row[83] == 0  # not found, and decided


# -- the fold of the race kernel ---------------------------------------------


def _own_runs(states, spec, depth, max_iters, sweeps, rng):
    """Each state's own search, cut where a block of the race kernel may
    stop it: the trajectories are independent, and a block stops anywhere
    from one step past t* (the earliest solve) to its own end or the step
    cap. Returns (meta, grid) as the kernel writes them."""
    M = len(states)
    grid0 = torch.from_numpy(np.asarray(states, np.int32))
    st = TS.init_state(grid0, spec, depth)
    end = np.full(M, max_iters)
    steps = 0
    while steps < max_iters and bool((st.status == TS.RUNNING).any()):
        before = (st.status == TS.RUNNING).numpy()
        st = TS._step(st, spec, **sweeps)
        steps += 1
        end[before & (st.status != TS.RUNNING).numpy()] = steps
    status = st.status.numpy()
    solved = status == TS.SOLVED
    t_star = int(end[solved].min()) if solved.any() else int(end.max())
    lo = np.minimum(end, t_star + 1)
    cut = np.array([rng.integers(lo[i], end[i] + 1) for i in range(M)])

    st = TS.init_state(grid0, spec, depth)
    meta = np.zeros((M, 4), np.int32)
    grids = np.zeros((M, spec.cells), np.int32)
    for i in np.flatnonzero(cut == 0):
        meta[i] = [TS.RUNNING, 0, 0, 0]
        grids[i] = st.grid[i].numpy()
    for k in range(1, int(cut.max()) + 1):
        st = TS._step(st, spec, **sweeps)
        for i in np.flatnonzero(cut == k):
            meta[i, :3] = [int(st.status[i]), k, int(st.validations[i])]
            grids[i] = st.grid[i].numpy()
    running = meta[:, 0] == TS.RUNNING
    full = analyze(torch.from_numpy(grids.reshape(M, spec.size, spec.size)), spec).solved
    meta[:, 3] = running & full.numpy()
    return torch.from_numpy(meta), torch.from_numpy(grids)


@pytest.mark.parametrize("name", ["readme-serving", "readme-capped", "hexadoku-deep",
                                  "readme-singles", "4x4-one-clue"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fold_of_cut_runs_equals_the_lockstep_race(name, seed):
    size, board, spd, max_iters, depth, cfg = RACE_CASES[name]
    spec = spec_for_size(size)
    states = _seeded(board, size, spd, cfg["locked"])
    sweeps = TS.sweep_knobs(spec, cfg["locked"], cfg["waves"], False, cfg["naked_pairs"])
    row, fold, meta = TS.race(torch.from_numpy(states), spec, max_iters, depth, **sweeps)
    kmeta, kgrid = _own_runs(states, spec, depth, max_iters, sweeps,
                             np.random.default_rng(seed))
    krow, kfold = TS.fold_race(kmeta, kgrid, spec, cfg["waves"])
    assert torch.equal(krow, row) and torch.equal(kfold, fold)
    # the lockstep record folds to itself
    pgrid = _grids_of(states, spec, depth, max_iters, sweeps)
    prow, pfold = TS.fold_race(meta, pgrid, spec, cfg["waves"])
    assert torch.equal(prow, row) and torch.equal(pfold, fold)


def _grids_of(states, spec, depth, max_iters, sweeps):
    """The lockstep race's grids before ``finalize_status``."""
    st = TS.init_state(torch.from_numpy(states), spec, depth)
    while st.iters < max_iters and bool((st.status == TS.RUNNING).any()):
        st = TS._step(st, spec, **sweeps)
        if bool((st.status == TS.SOLVED).any()):
            break
    return st.grid


def _solution():
    return np.asarray(oracle_solve(README), np.int32)


@pytest.mark.parametrize("waves", [1, 3])
def test_fold_flips_and_ties_as_finalize_status(mesh1, waves):
    """Index 0 has one blank cell: it assigns it at step 1 and reads
    SOLVED only at step 2, so the lockstep race (stopped after step 1 by
    the full boards at 1 and 2) flips it in ``finalize_status`` and it
    wins; indices 1 and 2 both solve at t* = 1."""
    full = _solution()
    blank = full.copy()
    blank[4, 4] = 0
    pad = JF._unsat_pad(JF.SPEC_9)
    states = np.stack([blank, full, full, pad])
    cfg = dict(SERVING[9], waves=waves)
    row, fold, meta = _port_race(states, 9, JF.DEFAULT_MAX_ITERS, 81, cfg)
    assert np.array_equal(row.numpy(),
                          _jax_race(mesh1, states, 9, JF.DEFAULT_MAX_ITERS, 81, cfg))
    assert row[81] == 1 and np.array_equal(row[:81].numpy(), full.reshape(-1))
    assert fold[:, 0].tolist() == [TS.SOLVED, TS.SOLVED, TS.SOLVED, TS.UNSAT]
    assert fold[:, 1].tolist() == [waves, 1, 1, 1]
    spec = spec_for_size(9)
    sweeps = TS.sweep_knobs(spec, True, waves, False, False)
    for seed in range(3):
        kmeta, kgrid = _own_runs(states, spec, 81, JF.DEFAULT_MAX_ITERS, sweeps,
                                 np.random.default_rng(seed))
        assert kmeta[0, :2].tolist() == [TS.SOLVED, 2]  # solved at t* + 1
        krow, kfold = TS.fold_race(kmeta, kgrid, spec, waves)
        assert torch.equal(krow, row) and torch.equal(kfold, fold)


def test_fold_flips_a_board_completed_on_the_capped_step(mesh1):
    full = _solution()
    blank = full.copy()
    blank[0, 0] = 0
    states = np.stack([JF._unsat_pad(JF.SPEC_9), blank])
    cfg = SERVING[9]
    row, fold, _ = _port_race(states, 9, 1, 81, cfg)
    assert np.array_equal(row.numpy(), _jax_race(mesh1, states, 9, 1, 81, cfg))
    assert row[81] == 1 and fold[1, 0] == TS.SOLVED
    spec = spec_for_size(9)
    sweeps = TS.sweep_knobs(spec, True, 3, False, False)
    kmeta, kgrid = _own_runs(states, spec, 81, 1, sweeps, np.random.default_rng(0))
    assert kmeta[1].tolist() == [TS.RUNNING, 1, 3, 1]  # capped, complete
    krow, kfold = TS.fold_race(kmeta, kgrid, spec, 3)
    assert torch.equal(krow, row) and torch.equal(kfold, fold)


# -- frontier_solve -----------------------------------------------------------


@pytest.mark.parametrize("name, board, kw", [
    ("readme-default", README, dict(states_per_device=16)),
    ("readme-serving", README, dict(states_per_device=8, max_depth=(32, 81),
                                    **SERVING[9])),
    ("capped", README, dict(states_per_device=8, max_iters=2)),
    ("depth-1", README, dict(states_per_device=8, max_depth=1, max_iters=256)),
    ("unsat", _unsat_board(), dict(states_per_device=8)),
    ("easy", generate_batch(1, 25, seed=4)[0], dict(states_per_device=64)),
])
def test_frontier_solve_matches_jax(mesh1, name, board, kw):
    jsol, jinfo = JF.frontier_solve(board, mesh1, JF.SPEC_9, **kw)
    tsol, tinfo = TF.frontier_solve(board, "cpu", spec_for_size(9), **kw)
    assert tsol == jsol and tinfo == jinfo
    if tsol is not None:
        assert oracle_is_valid_solution(tsol)


def test_frontier_solve_from_handoff_seeds_matches_jax(mesh1):
    eng = JaxEngine(buckets=(1,), frontier_escalate_iters=4)
    _, st = eng._solve_quick_state(jnp.asarray(np.asarray(README, np.int32)[None]))
    seeds = JF.state_handoff_frontier(jax.device_get(st), JF.SPEC_9)
    kw = dict(states_per_device=8, max_depth=(32, 81), initial_states=seeds,
              **SERVING[9])
    jsol, jinfo = JF.frontier_solve(README, mesh1, JF.SPEC_9, **kw)
    tsol, tinfo = TF.frontier_solve(README, "cpu", spec_for_size(9), **kw)
    assert tsol == jsol and tinfo == jinfo and tinfo["handoff"] is True
    eng.close()


def test_frontier_solve_deadline_and_devices():
    with pytest.raises(DeadlineExceeded):
        TF.frontier_solve(README, "cpu", states_per_device=8,
                          deadline_s=time.monotonic() - 0.001)
    # a race across two CUDA devices is ported; without a card it raises
    # as every CUDA entry point does, and a device named twice is no mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TF.frontier_solve(README, ["cuda:0", "cuda:1"], states_per_device=8)
    with pytest.raises(ValueError, match="repeat"):
        TF.frontier_solve(README, ["cpu", "cpu"], states_per_device=8)
    assert TF.race_device(["cpu"]).type == "cpu"


# -- engine routing, as tests/test_frontier_routing.py ------------------------


def _engines(mesh1, **kw):
    """A JAX engine on the one-device mesh and a port engine on the CPU,
    each with a spy on its race."""
    jeng = JaxEngine(buckets=(1,), frontier_mesh=mesh1, frontier_states_per_device=8, **kw)
    teng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                        frontier_states_per_device=8, **kw)
    calls = {"jax": [], "port": []}
    for name, eng in (("jax", jeng), ("port", teng)):
        orig = eng._frontier_solve

        def spy(arr, seed_states=None, deadline_s=None, orig=orig, name=name):
            out = orig(arr, seed_states, deadline_s)
            calls[name].append(out[1])
            return out

        eng._frontier_solve = spy
    return jeng, teng, calls


def _counters(eng):
    h = eng.health()
    return (eng.validations, eng.solved_puzzles, eng.frontier_escalations,
            eng.frontier_fallbacks,
            {k: h[k] for k in ("frontier_enabled", "frontier_route",
                               "frontier_handoff", "frontier_fallbacks",
                               "frontier_escalations")})


def _same(jeng, teng, board, **kw):
    jout = jeng.solve_one(board, **kw)
    tout = teng.solve_one(board, **kw)
    assert tout == jout
    assert _counters(teng) == _counters(jeng)
    return tout


ROUTING = {
    "easy-stays-on-probe": (dict(), dict()),
    "deep-escalates": (dict(frontier_escalate_iters=4), dict()),
    "probe-overflow-escalates": (dict(max_depth=1), dict()),
    "explicit-frontier": (dict(), dict(frontier=True)),
    "always-races": (dict(frontier_route="always"), dict()),
    "worker-cells-never-race": (dict(), dict(frontier=False)),
    "handoff": (dict(frontier_escalate_iters=4, frontier_handoff=True), dict()),
    "handoff-easy": (dict(frontier_handoff=True), dict()),
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_engine_routing_matches_jax(mesh1, name):
    ekw, call_kw = ROUTING[name]
    jeng, teng, calls = _engines(mesh1, **ekw)
    try:
        solution, info = _same(jeng, teng, README, **call_kw)
        assert [dict(c) for c in calls["port"]] == [dict(c) for c in calls["jax"]]
        routed = "race" if calls["port"] else info.get("routed")
        want = {
            "easy-stays-on-probe": "bucket-quick",
            "deep-escalates": "race",
            "probe-overflow-escalates": "race",
            "explicit-frontier": "race",
            "always-races": "race",
            "worker-cells-never-race": "continuous",
            "handoff": "race",
            "handoff-easy": "bucket-quick",
        }[name]
        assert routed == want, (routed, info)
        if solution is not None:
            assert oracle_is_valid_solution(solution)
        if name == "handoff":
            assert info["handoff"] is True and teng.frontier_escalations == 1
        if name == "deep-escalates":
            assert info["handoff"] is False
            assert teng.validations > calls["port"][0]["validations"]
    finally:
        jeng.close()
        teng.close()


def test_unsat_is_answered_by_the_probe(mesh1):
    board = np.zeros((9, 9), np.int32)
    board[0, 0] = board[0, 1] = 5
    jeng, teng, calls = _engines(mesh1)
    try:
        solution, info = _same(jeng, teng, board)
        assert solution is None and info["routed"] == "bucket-quick"
        assert calls == {"jax": [], "port": []}
    finally:
        jeng.close()
        teng.close()


def test_deep_mined_board_escalates_under_the_default_budget(mesh1):
    jeng, teng, calls = _engines(mesh1)
    try:
        solution, info = _same(jeng, teng, DEEP9[0].tolist())
        assert oracle_is_valid_solution(solution) and info["frontier"] is True
        assert len(calls["port"]) == 1 and teng.frontier_escalations == 1
        assert teng.cost.snapshot()["frontier"]["races"] == 1
    finally:
        jeng.close()
        teng.close()


def test_route_validation_and_frontier_mesh_forms():
    with pytest.raises(ValueError, match="frontier_route"):
        SolverEngine(device="cpu", buckets=(1,), frontier_route="sometimes")
    with pytest.raises(ValueError, match="repeat"):  # only virtual_mesh repeats
        SolverEngine(device="cpu", buckets=(1,), frontier_mesh=["cpu", "cpu"])
    off = SolverEngine(device="cpu", buckets=(1,))
    assert off.frontier_enabled is False and off.health()["frontier_enabled"] is False
    for mesh in ("auto", True, "cpu", ["cpu"]):
        eng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh=mesh)
        assert eng.frontier_enabled and eng.frontier_device.type == "cpu"
        assert eng.health()["frontier_enabled"] is True


def test_deadline_cancels_the_escalation_leg(mesh1):
    for which in ("jax", "port"):
        jeng, teng, calls = _engines(mesh1, frontier_escalate_iters=4)
        eng = jeng if which == "jax" else teng
        exc = JaxDeadlineExceeded if which == "jax" else DeadlineExceeded
        try:
            with pytest.raises(exc):
                eng.solve_one(README, deadline_s=time.monotonic() - 0.001)
            assert calls[which] == []
            with pytest.raises(exc):
                eng.solve_one_supervised(README, deadline_s=time.monotonic() + 1e-4)
            solution, info = eng.solve_one(README, deadline_s=time.monotonic() + 120)
            assert oracle_is_valid_solution(solution) and info["frontier"] is True
        finally:
            jeng.close()
            teng.close()


@pytest.mark.parametrize("fault, falls_back", [
    (InjectedEngineFault("injected"), True),
    (KernelLaunchError("dfs_race launch failed: cudaError 700"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("nvcc failed (1) building dfs_solver.cu"), False),
    (TypeError("a programming error"), False),
])
@pytest.mark.parametrize("supervised", [False, True])
def test_race_falls_back_only_on_a_device_fault(mesh1, monkeypatch, fault,
                                                falls_back, supervised):
    """A race that fails with a device fault is answered from the bucket
    path, as the JAX engine answers every race failure (its answer and
    counters); any other failure reaches the caller."""
    jeng, teng, _ = _engines(mesh1, frontier_route="always")

    def boom(*a, **k):
        raise fault

    # each engine imports the race at call time: the JAX engine from its
    # parallel package, the port's from parallel/frontier.py
    monkeypatch.setattr(jparallel, "frontier_solve", boom)
    monkeypatch.setattr(TF, "frontier_solve", boom)
    sups = []
    if supervised:
        # the race's failed token feeds each breaker the same way, so the
        # bucket path then answers as the JAX supervised engine's does
        sups = [EngineSupervisor(teng, watchdog_budget_s=30.0),
                JaxSupervisor(jeng, watchdog_budget_s=30.0)]
        for eng, sup in zip((teng, jeng), sups):
            eng.warmup()  # a supervisor leaves WARMING once its engine is warm
            deadline = time.monotonic() + 30
            while sup.state != "healthy" and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sup.state == "healthy"
    try:
        call = teng.solve_one_supervised if supervised else teng.solve_one
        if falls_back:
            jcall = jeng.solve_one_supervised if supervised else jeng.solve_one
            jout = jcall(README)
            assert call(README) == jout
            assert teng.frontier_fallbacks == jeng.frontier_fallbacks == 1
            assert teng.validations == jeng.validations
        else:
            with pytest.raises(type(fault)):
                call(README)
            assert teng.frontier_fallbacks == 0 and teng.solved_puzzles == 0
    finally:
        for sup in sups:
            sup.close()
        jeng.close()
        teng.close()


def test_warmup_warms_the_race_without_counting(mesh1):
    teng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                        frontier_states_per_device=8, frontier_handoff=True)
    teng.warmup()
    assert teng.fully_warmed and teng.warm_info()["skipped"] == []
    assert (teng.validations, teng.solved_puzzles, teng.frontier_escalations) == (0, 0, 0)
    assert teng.cost.snapshot().get("frontier") is None
    teng.close()
    cut = SolverEngine(device="cpu", buckets=(1, 8), frontier_mesh="auto",
                       frontier_states_per_device=8)
    cut.warmup(budget_s=0.0)
    assert not cut.fully_warmed and cut.warm_info()["skipped"]
    cut.close()


# -- /solve on a frontier node beside a JAX node ------------------------------


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:  # the unsolvable board's 400
        return e.code, e.headers, e.read()


@pytest.mark.parametrize("route", ["always", "auto"])
def test_frontier_node_solve_matches_jax_node(mesh1, route):
    """``/solve`` on a ``--frontier 8`` node: the JAX node's bodies and
    ``/stats``, and the span stamps of the route (a race stamps seeding as
    ``coalesce`` and the race as ``device``; a probe answer is ``device``
    time too)."""
    boards = [README, DEEP9[0].tolist(), _unsat_board().tolist()]
    kw = dict(frontier_route=route, frontier_states_per_device=8)
    jeng = JaxEngine(buckets=(1,), frontier_mesh=mesh1, **kw)
    teng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto", **kw)
    servers, out = [], {}
    try:
        for name, eng, node_cls, make, tracer_cls in (
            ("jax", jeng, JaxNode, jax_make_http_server, JaxTracer),
            ("port", teng, P2PNode, make_http_server, Tracer),
        ):
            tracer = tracer_cls()
            node = node_cls("127.0.0.1", _free_udp_port(), engine=eng,
                            metrics=tracer.routes)
            node.tracer = tracer
            httpd = make(node, "127.0.0.1", 0, legacy_transport=True)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            servers.append((httpd, node))
            port = httpd.server_address[1]
            bodies, timings = [], []
            for board in boards:
                status, headers, raw = _post(port, "/solve", {"sudoku": board},
                                             {"X-Timing": "1"})
                bodies.append((status, json.loads(raw)))
                timings.append(json.loads(headers["X-Timing"]))
            stats = json.loads(_post(port, "/stats")[2])
            for entry in stats["nodes"]:
                entry.pop("address")  # each node's own UDP port
            out[name] = (bodies, stats, timings)
        assert out["port"][0] == out["jax"][0]
        assert out["port"][1] == out["jax"][1]
        assert oracle_is_valid_solution(out["port"][0][0][1])
        for tj, tt in zip(out["jax"][2], out["port"][2]):
            assert set(tt) == set(tj)
            assert (tt["device_ms"] > 0) == (tj["device_ms"] > 0)
            assert (tt["coalesce_ms"] > 0) == (tj["coalesce_ms"] > 0)
        deep = out["port"][2][1]
        assert deep["coalesce_ms"] > 0 and deep["device_ms"] > 0  # seeding, race
        assert teng.frontier_escalations == jeng.frontier_escalations
    finally:
        for httpd, node in servers:
            httpd.shutdown()
            httpd.server_close()
            node.shutdown()
        jeng.close()
        teng.close()


def test_frontier_node_with_peers_races_instead_of_farming(mesh1):
    """With the race enabled, a node with peers answers ``/solve`` from its
    own race and farms nothing, as the JAX node does (its peer here is an
    address nobody listens on: a farm would dispatch to it)."""
    out = {}
    for name, eng, node_cls in (
        ("jax", JaxEngine(buckets=(1,), frontier_mesh=mesh1,
                          frontier_states_per_device=8, frontier_route="always"),
         JaxNode),
        ("port", SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                              frontier_states_per_device=8, frontier_route="always"),
         P2PNode),
    ):
        node = node_cls("127.0.0.1", _free_udp_port(), engine=eng)
        try:
            node.membership.on_connected(f"127.0.0.1:{_free_udp_port()}")
            assert node.membership.total_peers()
            out[name] = node.peer_sudoku_solve_info(README)
            assert out[name][1]["frontier"] is True
            assert "farm" not in eng.cost.snapshot()
        finally:
            node.shutdown()
            eng.close()
    assert out["port"] == out["jax"]
    assert oracle_is_valid_solution(out["port"][0])


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--frontier", "8"],
    ["--frontier", "8", "--frontier-route", "always",
     "--frontier-escalate-iters", "64", "--frontier-handoff"],
])
def test_cli_frontier_flags_match_jax(argv):
    keys = ("frontier", "frontier_route", "frontier_escalate_iters", "frontier_handoff")
    j = jax_build_parser().parse_args(["-p", "8001", "-s", "7001", *argv])
    t = cli.build_parser().parse_args(["-p", "8001", "-s", "7001", *argv])
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}


def test_cli_wires_the_frontier_engine():
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1", "--no-warmup",
         "--no-autopilot", "--frontier", "8", "--frontier-route", "always",
         "--frontier-escalate-iters", "64", "--frontier-handoff"])
    node, httpd = cli.build_node(args)
    try:
        eng = node.engine
        assert eng.frontier_enabled and eng.frontier_device == eng.device
        assert (eng.frontier_states_per_device, eng.frontier_route,
                eng.frontier_escalate_iters, eng.frontier_handoff) == (8, "always", 64, True)
        assert tparallel.frontier_solve is TF.frontier_solve
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()
    off = cli.build_node(cli.build_parser().parse_args(
        ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1", "--no-warmup",
         "--no-autopilot"]))
    try:
        assert not off[0].engine.frontier_enabled
    finally:
        off[1].server_close()
        off[0].shutdown()
        off[0].engine.close()
