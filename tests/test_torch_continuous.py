"""Continuous batching in the port, held against the JAX package on the CPU.

The segment API of ops/solver.py (the plain version of the segment kernels
K3/K3b), the engine's segment seam and the coalescer's open-loop segment loops,
with the same numpy inputs (corpora and seeded boards) through both
packages and exact equality: integers, tolerance 0. A board's trajectory
and counters must not depend on how its steps are cut into segments or on
what runs in the other lanes, so a chain of ragged segments equals one
flat solve at the flat depth, and the default coalesced engines answer the
README board with 109 validations and 35 guesses on a pool of 8 lanes
(three sweeps a step) and 57 / 35 on a pool of one, as the JAX node does.

The segment kernels' tests on the card are in
tests/test_torch_isolation.py (this file imports JAX, which that machine
lacks); ``python3 chip_smoke.py`` runs the full comparison there.
"""

import functools
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.ops import config as jconfig
from sudoku_solver_distributed_tpu.ops import (
    init_segment_state as j_init_segment_state,
)
from sudoku_solver_distributed_tpu.ops import inject_lanes_src as j_inject_lanes_src
from sudoku_solver_distributed_tpu.ops import run_segment as j_run_segment
from sudoku_solver_distributed_tpu.ops import segment_digest as j_segment_digest
from sudoku_solver_distributed_tpu.ops import solve_batch as j_solve_batch
from sudoku_solver_distributed_tpu.ops import spec_for_size as jspec_for_size
from sudoku_solver_distributed_tpu.ops.solver import SegmentState as JSegmentState
from sudoku_solver_distributed_tpu.parallel.coalescer import (
    BatchCoalescer as JaxCoalescer,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.ops import config as tconfig
from sudoku_solver_distributed_tpu_torch.ops import solver as ts
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    SegmentPool,
    _dfs_segment_plain,
    dfs_segment,
)
from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size as tspec_for_size
from sudoku_solver_distributed_tpu_torch.parallel.coalescer import BatchCoalescer
from sudoku_solver_distributed_tpu_torch.serving import DeadlineExceeded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
FIELDS = ("grid", "stack_grid", "stack_cell", "stack_mask", "depth", "status",
          "guesses", "validations", "board_iters")


def corpus(name, n=None):
    with np.load(os.path.join(REPO, "benchmarks", name)) as d:
        boards = d["boards"].astype(np.int32)
    return boards if n is None else boards[:n]


def sweeps(size):
    cfg = jconfig.serving_config(size)
    return {k: cfg[k] for k in ("locked_candidates", "waves", "naked_pairs")}


def flat_depth(size):
    depth = jconfig.serving_config(size)["max_depth"]
    if isinstance(depth, (tuple, list)):
        return max(depth)
    return depth if depth is not None else jspec_for_size(size).max_depth


@functools.cache
def jax_flat_solve(size, max_iters=None):
    """The segment loop's closed-loop twin in the JAX package: the serving
    sweeps, the flat loop (``compact=False``) at the flat depth."""
    cfg = dict(jconfig.serving_config(size), compact=False,
               max_depth=flat_depth(size))
    if max_iters is not None:
        cfg["max_iters"] = max_iters
    return jax.jit(lambda g: j_solve_batch(
        g, jspec_for_size(size), return_stats=True, **cfg))


@functools.cache
def jax_segment_program(size, prefix_gather):
    """JAX's pipelined segment program (engine.py): inject from a source
    map, run the segment, build the digest."""
    spec = jspec_for_size(size)

    def prog(state, boards, src, k):
        state = j_inject_lanes_src(state, boards, src, spec)
        entry = state.status == ts.RUNNING
        state, stats = j_run_segment(state, k, spec, **sweeps(size))
        digest, block = j_segment_digest(state, entry, stats, prefix_gather)
        return state, digest, block

    return jax.jit(prog)


def port_chain(size, boards, ks):
    """Drive a port lane pool over ``boards`` to the end with the (cycled)
    segment budgets ``ks``; returns the state and the summed LoopStats."""
    spec = tspec_for_size(size)
    state = ts.init_segment_state(torch.as_tensor(boards), spec, flat_depth(size))
    lane = idle = 0
    for i in range(100_000):
        state, st = ts.run_segment(state, ks[i % len(ks)], spec, **sweeps(size))
        lane += st.lane_steps
        idle += st.idle_lane_steps
        if not bool((state.status == ts.RUNNING).any()):
            return state, lane, idle
    raise AssertionError("segmented solve did not finish")


_JAX_ENGINES = {}


def jax_engine(**kw):
    """A JAX engine per knob set, kept for the module (its compiled segment
    program is reused by every test that asks for the same knobs)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JaxEngine(**kw)
    return _JAX_ENGINES[key]


@pytest.fixture(scope="module", autouse=True)
def _close_jax_engines():
    yield
    while _JAX_ENGINES:
        _JAX_ENGINES.popitem()[1].close()


_OPEN = []


@pytest.fixture(autouse=True)
def _close_port_engines():
    yield
    while _OPEN:
        _OPEN.pop().close()


def port_engine(**kw):
    eng = SolverEngine(device="cpu", **kw)
    _OPEN.append(eng)
    return eng


def answers(eng, boards):
    """Every board submitted at once through ``solve_one_async``."""
    futs = [eng.solve_one_async(np.asarray(b).tolist()) for b in boards]
    return [f.result(timeout=300) for f in futs]


# -- the plain segment API against the JAX package ------------------------------


@pytest.mark.parametrize(
    "size,boards_fn",
    [
        (9, lambda: corpus("corpus_9x9_hard_64.npz", 16)),
        (16, lambda: generate_batch(4, 140, size=16, seed=12)),
    ],
    ids=["9x9", "16x16"],
)
def test_segment_chain_matches_jax_flat_solve(size, boards_fn):
    """Ragged segments (3, 7, 1, 13) over a pool equal one flat JAX solve:
    grids, statuses, guesses, validations, the LoopStats, and the largest
    per-lane step count equal to the flat loop's ``iters``."""
    boards = boards_fn()
    res, st = jax_flat_solve(size)(jnp.asarray(boards))
    assert bool(np.asarray(res.solved).all())
    state, lane, idle = port_chain(size, boards, (3, 7, 1, 13))
    B = boards.shape[0]
    np.testing.assert_array_equal(state.grid.numpy(),
                                  np.asarray(res.grid).reshape(B, -1))
    for f in ("status", "guesses", "validations"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(res, f)))
    assert (lane, idle) == (int(st.lane_steps), int(st.idle_lane_steps))
    assert int(state.board_iters.max()) == int(res.iters)


def _mid_search_pool(width):
    """A JAX pool of ``width`` lanes, some mid-search: hard boards injected
    into a pad pool and stepped twice."""
    spec = jspec_for_size(9)
    pad = np.broadcast_to(np.asarray(ts.pad_board(tspec_for_size(9))),
                          (width, 9, 9))
    state = j_init_segment_state(jnp.asarray(pad), spec, flat_depth(9))
    boards = corpus("corpus_9x9_deep_128.npz", width)
    prog = jax_segment_program(9, True)
    for src, k in ((np.arange(width), 5), (np.full(width, -1), 9)):
        state, _, _ = prog(state, jnp.asarray(boards),
                           jnp.asarray(src, jnp.int32), jnp.int32(k))
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


@pytest.mark.parametrize("prefix_gather", [True, False], ids=["prefix", "masked"])
def test_segments_match_jax_from_a_mid_search_pool(prefix_gather):
    """From the same mid-search pool (``segment_state_from_numpy``), segment
    by segment with injections (rows, pad re-seeds, untouched lanes) made
    from a seed: the port's ``inject_lanes_src`` + ``run_segment`` +
    ``segment_digest`` give JAX's state (stack included), digest and
    solution block."""
    width = 8
    rng = np.random.default_rng(7)
    jstate_np = _mid_search_pool(width)
    assert (jstate_np["depth"] > 0).any()
    pstate = ts.segment_state_from_numpy(jstate_np)
    jstate = JSegmentState(**{f: jnp.asarray(v) for f, v in jstate_np.items()})
    stock = np.concatenate([corpus("corpus_9x9_hard_64.npz", 6),
                            generate_batch(4, 45, seed=3)])
    prog = jax_segment_program(9, prefix_gather)
    spec = tspec_for_size(9)
    for seg, k in enumerate((4, 1, 7, 3, 12, 2)):
        src = rng.choice([-1, -1, -1, -2, 0, 3, 5, 9], size=width).astype(np.int32)
        jstate, jd, jb = prog(jstate, jnp.asarray(stock), jnp.asarray(src),
                              jnp.int32(k))
        pstate, pd, pb = _dfs_segment_plain(
            pstate, torch.as_tensor(stock.reshape(len(stock), -1)),
            torch.as_tensor(src), k, spec, prefix_gather, **sweeps(9),
        )
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(pstate, f).numpy(), np.asarray(getattr(jstate, f)),
                err_msg=f"segment {seg} field {f}",
            )
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


def test_stranger_rotation_leaves_residents_bit_identical():
    """Boards injected into lanes 2 and 5 mid-flight do not move the
    residents by a bit, and solve as they would alone."""
    residents = corpus("corpus_9x9_hard_64.npz", 8)
    strangers = generate_batch(8, 40, seed=9)
    ref_res, _ = jax_flat_solve(9)(jnp.asarray(residents))
    ref_str, _ = jax_flat_solve(9)(jnp.asarray(strangers))
    spec = tspec_for_size(9)
    kw = sweeps(9)
    state = ts.init_segment_state(torch.as_tensor(residents), spec, flat_depth(9))
    for _ in range(3):
        state, _ = ts.run_segment(state, 5, spec, **kw)
    mask = torch.zeros(8, dtype=torch.int32)
    mask[2] = mask[5] = 1
    state = ts.inject_lanes(state, torch.as_tensor(strangers), mask, spec)
    assert int(state.board_iters[2]) == 0  # a fresh lane
    while bool((state.status == ts.RUNNING).any()):
        state, _ = ts.run_segment(state, 6, spec, **kw)
    keep = [0, 1, 3, 4, 6, 7]
    for ref, lanes in ((ref_res, keep), (ref_str, [2, 5])):
        np.testing.assert_array_equal(
            state.grid.numpy()[lanes], np.asarray(ref.grid).reshape(8, -1)[lanes]
        )
        for f in ("guesses", "validations"):
            np.testing.assert_array_equal(
                getattr(state, f).numpy()[lanes], np.asarray(getattr(ref, f))[lanes]
            )


@pytest.mark.parametrize("arm", ["state", "digest"])
def test_golden_slice_under_segmentation_matches_jax(arm):
    """The golden-counter corpus's 32-board slice (tests/
    test_torch_serving_config.py's) under segments of (997, 251) steps
    equals the flat JAX solve per board; on the digest arm every solution
    arrives through the solution block exactly once. The whole corpus runs
    on the card (chip_smoke.py)."""
    with open(os.path.join(REPO, "tests", "golden_counters.json")) as f:
        golden = json.load(f)
    boards = corpus(golden["corpus"])[224:256]
    max_iters = golden["config"]["max_iters"]
    ref, _ = jax_flat_solve(9, max_iters)(jnp.asarray(boards))
    B = len(boards)
    if arm == "state":
        state, _, _ = port_chain(9, boards, (997, 251))
        grids, status = state.grid.numpy(), state.status.numpy()
        guesses, vals = state.guesses.numpy(), state.validations.numpy()
        iters = int(state.board_iters.max())
    else:
        spec = tspec_for_size(9)
        pool = SegmentPool.fresh(torch.zeros((B, 9, 9), dtype=torch.int32),
                                 spec, flat_depth(9))
        flat = torch.as_tensor(boards.reshape(B, -1))
        src = torch.arange(B, dtype=torch.int32)
        grids = np.zeros((B, spec.cells), np.int32)
        fetched = 0
        for i in range(10_000):
            pool, d, block = dfs_segment(
                pool, flat, src, (997, 251)[i % 2], prefix_gather=True,
                **sweeps(9),
            )
            d = d.numpy()
            lanes = np.flatnonzero(d[:, 5] >= 0)
            grids[lanes] = block.numpy()[d[lanes, 5]]
            fetched += lanes.size
            src = torch.full((B,), -1, dtype=torch.int32)
            if not (d[:, 0] == ts.RUNNING).any():
                break
        assert fetched == B
        status, guesses, vals, iters = d[:, 0], d[:, 2], d[:, 3], int(d[:, 4].max())
    np.testing.assert_array_equal(grids, np.asarray(ref.grid).reshape(B, -1))
    np.testing.assert_array_equal(status, np.asarray(ref.status))
    np.testing.assert_array_equal(guesses, np.asarray(ref.guesses))
    np.testing.assert_array_equal(vals, np.asarray(ref.validations))
    assert iters == int(ref.iters)
    assert (status == ts.SOLVED).all()


# -- the engine's segment seam and the segment loops -----------------------------------


@pytest.mark.parametrize(
    "buckets,pipeline,want",
    [
        ((1, 8), True, (109, 35)),
        ((1, 8), False, (109, 35)),
        ((1,), True, (57, 35)),
        ((1,), False, (57, 35)),
    ],
    ids=["pool8-pipelined", "pool8-full-rows", "pool1-pipelined", "pool1-full-rows"],
)
def test_default_engine_readme_matches_jax(buckets, pipeline, want):
    """The default coalesced engines serve open loop in both packages: the
    README board answers 109 validations and 35 guesses on a pool of 8
    lanes (three sweeps a step at the flat depth) and 57 / 35 on a pool of
    one, in both boundary arms; the engine counters agree."""
    jax_eng = jax_engine(buckets=buckets, segment_pipeline=pipeline)
    eng = port_engine(buckets=buckets, segment_pipeline=pipeline)
    assert eng.continuous and eng.continuous_active
    assert eng.segment_pool_width() == buckets[-1]
    before = jax_eng.validations
    want_answer = jax_eng.solve_one(README_PUZZLE)
    got = eng.solve_one(README_PUZZLE)
    assert got == want_answer
    assert (got[1]["validations"], got[1]["guesses"]) == want
    assert got[1]["routed"] == "continuous"
    assert eng.validations == jax_eng.validations - before == want[0]
    st = eng.coalescer.stats()
    assert st["continuous"] and st["pipeline"] is pipeline
    assert st["refills"] == 1 and st["segment_width"] == buckets[-1]


def test_pipelined_and_full_row_arms_answer_alike():
    """The two boundary arms on the same requests, a mix of seeded and hard
    boards submitted together: the same answers, counters included, and
    the JAX engine's."""
    boards = np.concatenate([generate_batch(6, 40, seed=77),
                             corpus("corpus_9x9_hard_64.npz", 2)])
    want = answers(jax_engine(buckets=(1, 8), segment_pipeline=True), boards)
    for pipeline in (True, False):
        eng = port_engine(buckets=(1, 8), segment_iters=4,
                          segment_pipeline=pipeline)
        assert answers(eng, boards) == want
        st = eng.coalescer.stats()
        assert st["pipeline"] is pipeline and st["refills"] == len(boards)
        if not pipeline:
            assert st["pipelined_segments"] == 0


def test_injection_prestager_forced_on_serves_correctly(monkeypatch):
    """The prestager forced on: boards staged ahead of the boundary answer
    as the JAX engine does, and the boundary consults the stage."""
    monkeypatch.setenv("SUDOKU_SEGMENT_PRESTAGE", "1")
    boards = generate_batch(24, 40, seed=91)
    eng = port_engine(buckets=(1, 8), coalesce_max_batch=8, segment_iters=4)
    got = answers(eng, boards)
    assert got == answers(jax_engine(buckets=(1, 8), segment_pipeline=True), boards)
    st = eng.coalescer.stats()
    assert eng.coalescer._prestager is not None
    assert st["prestage_hits"] + st["prestage_misses"] >= 1


def test_capped_lane_evicts_to_deep_retry_and_pool_keeps_serving():
    """A lane past its step budget (``max_iters=2``) is finished by the deep
    retry off the pool, answered as ``continuous-deep`` with its segment
    counters added; its lane is re-seeded and later requests are served.
    Every answer equals the JAX engine's."""
    kw = dict(buckets=(4,), max_iters=2, deep_retry_factor=128, segment_iters=2)
    jax_eng = jax_engine(**kw)
    eng = port_engine(**kw)
    board = corpus("corpus_9x9_hard_64.npz", 1)[0].tolist()
    got = eng.solve_one(board)
    assert got == jax_eng.solve_one(board)
    assert got[0] is not None and got[1]["routed"] == "continuous-deep"
    assert oracle_is_valid_solution(got[0])
    for seed in (8, 9):
        b = generate_batch(1, 45, seed=seed)[0].tolist()
        assert eng.solve_one(b) == jax_eng.solve_one(b)
    assert eng.validations == jax_eng.validations


def test_deep_lane_cap_evicts_a_long_resident_under_demand():
    """``deep_lane_cap=1`` on a two-lane pool: with requests queued, a
    board resident past ``DEEP_RESIDENT_SEGMENTS`` boundaries beyond the
    cap goes to the deep retry; every request still answers a valid
    solution."""
    eng = port_engine(buckets=(2,), segment_iters=1, deep_lane_cap=1)
    relabel = np.array([0, 2, 3, 4, 5, 6, 7, 8, 9, 1], np.int32)
    deep = [README_PUZZLE, relabel[np.asarray(README_PUZZLE)].tolist()]
    futs = [eng.solve_one_async(b) for b in deep]
    deadline = time.monotonic() + 60
    while eng.coalescer.stats()["segments"] < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    easy = [b.tolist() for b in generate_batch(2, 40, seed=5)]
    futs += [eng.solve_one_async(b) for b in easy]
    results = [f.result(timeout=300) for f in futs]
    for board, (sol, _) in zip(deep + easy, results):
        clues = np.asarray(board) != 0
        assert oracle_is_valid_solution(sol)
        assert (np.asarray(sol)[clues] == np.asarray(board)[clues]).all()
    st = eng.coalescer.stats()
    assert st["deep_lane_cap"] == 1 and st["deep_evictions"] >= 1
    assert "continuous-deep" in {info["routed"] for _, info in results[:2]}
    assert eng.validations == sum(info["validations"] for _, info in results)


def test_mid_flight_deadline_expiry_answers_deadline_exceeded(monkeypatch):
    """A queued request whose deadline passes while a segment runs is
    dropped at the next boundary, not when a lane frees, and raises
    ``DeadlineExceeded``; the resident answers as the JAX engine does."""
    eng = port_engine(buckets=(1,), segment_iters=2)
    real = eng.finalize_segment

    def slow_finalize(handle, *, active):
        time.sleep(0.15)  # every segment's fetch takes at least 150 ms
        return real(handle, active=active)

    monkeypatch.setattr(eng, "finalize_segment", slow_finalize)
    board = generate_batch(1, 40, seed=4)[0].tolist()
    resident = eng.solve_one_async(board)
    time.sleep(0.03)  # the first slow segment is in flight
    t0 = time.monotonic()
    doomed = eng.solve_one_async(generate_batch(1, 40, seed=5)[0].tolist(),
                                 deadline_s=t0 + 0.02)
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=30)
    assert time.monotonic() - t0 < 5.0
    want = jax_engine(buckets=(1,), segment_pipeline=True).solve_one(board)
    assert resident.result(timeout=120) == want
    assert eng.coalescer.stats()["expired"] == 1


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "full-rows"])
def test_donated_pool_handle_is_refused(pipeline):
    """A pool handle consumed by a dispatch is refused at the seam with the
    JAX engine's "donated" RuntimeError (and by ``dfs_segment``); the
    handle the dispatch returned goes on, and its rows equal the JAX
    engine's."""
    kw = dict(buckets=(4,), segment_pipeline=pipeline)
    eng = port_engine(**kw)
    jax_eng = jax_engine(**kw)
    width = eng.segment_pool_width()
    boards = np.zeros((width, 9, 9), np.int32)
    inject = np.zeros((width,), np.int32)
    idle = np.zeros(width, bool)
    state = eng.new_segment_pool(width)
    h = eng.dispatch_segment(state, boards, inject)
    rows, _ = eng.finalize_segment(h, active=idle)
    with pytest.raises(RuntimeError, match="donated"):
        eng.dispatch_segment(state, boards, inject)
    with pytest.raises(RuntimeError, match="donated"):
        dfs_segment(state, torch.zeros((1, 81), dtype=torch.int32),
                    torch.full((width,), -1, dtype=torch.int32), 1,
                    prefix_gather=False)
    h2 = eng.dispatch_segment(h.state, boards, inject)
    rows2, _ = eng.finalize_segment(h2, active=idle)
    assert rows2.shape == (width, eng.spec.cells + 7)
    jh = jax_eng.dispatch_segment(jax_eng.new_segment_pool(width), boards, inject)
    jrows, _ = jax_eng.finalize_segment(jh, active=idle)
    np.testing.assert_array_equal(rows, jrows)


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "full-rows"])
def test_failed_segment_fails_residents_and_pool_recovers(pipeline, monkeypatch):
    """A segment that fails (a kernel that does not launch, say) fails the
    futures of its resident lanes with the error, nothing reruns
    elsewhere, and the rebuilt pool serves the next requests as the JAX
    engine does."""
    eng = port_engine(buckets=(4,), segment_pipeline=pipeline)
    real = eng.dispatch_segment
    calls = []

    def boom(*args, **kw):
        calls.append(1)
        raise RuntimeError("dfs_segment launch failed: cudaError 700")

    monkeypatch.setattr(eng, "dispatch_segment", boom)
    with pytest.raises(RuntimeError, match="cudaError"):
        eng.solve_one(README_PUZZLE)
    assert calls and eng.coalescer.stats()["failed_batches"] >= 1
    assert eng.validations == 0
    monkeypatch.setattr(eng, "dispatch_segment", real)
    jax_eng = jax_engine(buckets=(4,), segment_pipeline=pipeline)
    for seed in (21, 22):
        b = generate_batch(1, 40, seed=seed)[0].tolist()
        assert eng.solve_one(b) == jax_eng.solve_one(b)


def test_concurrent_clients_are_answered_with_the_stats_sum():
    """16 client threads at once on a default engine: every answer right,
    refills count every request, and the engine's validations are the
    answers' sum."""
    eng = port_engine(buckets=(1, 8, 64))
    boards = corpus("corpus_9x9_hard_4096.npz", 16)
    results = [None] * 16
    start = threading.Barrier(16)

    def client(i):
        start.wait()
        results[i] = eng.solve_one(boards[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    st = eng.coalescer.stats()
    assert st["refills"] == 16 and st["segments"] >= 1
    for i, (sol, _) in enumerate(results):
        clues = boards[i] != 0
        assert oracle_is_valid_solution(sol)
        assert (np.asarray(sol)[clues] == boards[i][clues]).all()
    assert eng.validations == sum(info["validations"] for _, info in results)


# -- knobs, config, stats and the CLI -----------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"continuous": False},
        {"coalesce": False},
        {"segment_pipeline": False},
        {"segment_iters": 5, "deep_lane_cap": 3},
        {"coalesce_max_batch": 8},
    ],
)
def test_engine_knobs_resolve_as_jax(kw):
    """``continuous``, ``segment_pipeline``, ``segment_iters`` and
    ``deep_lane_cap`` resolve as in the JAX engine, and so does the pool
    width."""
    jax_eng = JaxEngine(buckets=(1, 8, 64), **kw)
    eng = SolverEngine(device="cpu", buckets=(1, 8, 64), **kw)
    try:
        for attr in ("continuous", "segment_pipeline", "segment_iters",
                     "segment_shape", "deep_lane_cap", "continuous_active"):
            assert getattr(eng, attr) == getattr(jax_eng, attr), attr
        assert eng.segment_pool_width() == jax_eng.segment_pool_width()
    finally:
        jax_eng.close()
        eng.close()


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(coalesce=False, continuous=True), "coalesce"),
        (dict(segment_iters=0), "segment_iters"),
        (dict(continuous=False, segment_pipeline=True), "segment_pipeline"),
    ],
)
def test_engine_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxEngine(buckets=(1,), **kw)
    with pytest.raises(ValueError, match=match):
        SolverEngine(device="cpu", buckets=(1,), **kw)


def test_config_copies_match_jax():
    assert tconfig.SEGMENT == jconfig.SEGMENT
    assert tconfig._SEGMENT_DEFAULT == jconfig._SEGMENT_DEFAULT
    assert tconfig.CONTINUOUS_SERVING == jconfig.CONTINUOUS_SERVING
    assert tconfig.SEGMENT_PIPELINE == jconfig.SEGMENT_PIPELINE
    for size in (4, 9, 16, 25):
        assert tconfig.segment_config(size) == jconfig.segment_config(size)
        for k in (None, 1, 7):
            assert tconfig.resolved_segment_shape(size, k) == (
                jconfig.resolved_segment_shape(size, k))
    for width in (1, 8, 64, 202, 203, 512, 4096):
        for cells in (16, 81, 256, 625):
            assert tconfig.segment_prefix_gather(width, cells) == (
                jconfig.segment_prefix_gather(width, cells))


@pytest.mark.parametrize("pipeline", [True, False])
def test_stats_keys_match_jax_continuous(pipeline):
    """The /stats serving block renders ``stats()``: the continuous keys and
    values of the JAX coalescer's open loop."""
    stub = types.SimpleNamespace(
        buckets=(1, 8), spec=tspec_for_size(9), segment_pipeline=pipeline,
        segment_pool_width=lambda: 8, _segment_program=object(),
        mesh_runner=None,
    )
    mine = BatchCoalescer(stub, continuous=True, deep_lane_cap=2)
    theirs = JaxCoalescer(stub, continuous=True, deep_lane_cap=2)
    assert mine.stats() == theirs.stats()
    assert mine.stats()["continuous"] is True


def test_cli_continuous_flags():
    """The JAX CLI's continuous-batching flags build the same engine knobs,
    and a default CLI node serves open loop."""
    def build(*argv):
        args = cli.build_parser().parse_args(
            ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1,8",
             "--no-warmup", *argv]
        )
        node, httpd = cli.build_node(args)
        httpd.server_close()
        node.shutdown()
        node.engine.close()
        return node.engine

    eng = build()
    assert eng.continuous and eng.segment_pipeline
    assert eng.segment_iters == tconfig.SEGMENT[9]["k"] and eng.deep_lane_cap == 0
    eng = build("--segment-iters", "4", "--no-segment-pipeline",
                "--deep-lane-cap", "2")
    assert eng.continuous and not eng.segment_pipeline
    assert eng.segment_iters == 4 and eng.deep_lane_cap == 2
    assert not build("--no-continuous").continuous
    assert not build("--no-coalesce").continuous


def test_segment_wrapper_refuses_bad_input():
    spec = tspec_for_size(9)
    pool = SegmentPool.fresh(torch.zeros((2, 9, 9), dtype=torch.int32), spec, 81)
    boards = torch.zeros((1, 81), dtype=torch.int32)
    src = torch.full((2,), -1, dtype=torch.int32)
    before = dfs_segment.launches
    bad = [
        (boards.to(torch.int64), src, 1, TypeError),
        (boards, src.to(torch.int64), 1, TypeError),
        (torch.zeros((1, 80), dtype=torch.int32), src, 1, ValueError),
        (torch.zeros((0, 81), dtype=torch.int32), src, 1, ValueError),
        (boards, torch.full((3,), -1, dtype=torch.int32), 1, ValueError),
        (boards, src, -1, ValueError),
        (boards.to("meta"), src, 1, ValueError),
    ]
    for b, s, k, error in bad:
        with pytest.raises(error):
            dfs_segment(pool, b, s, k, prefix_gather=False)
    assert dfs_segment.launches == before
    assert not pool.donated


def test_default_engine_without_a_card_raises(monkeypatch):
    """No fallback hides the device: with no GPU and no CPU request the
    continuous engine and the CLI raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverEngine(segment_iters=4)
    args = cli.build_parser().parse_args(["-p", "0", "-s", "0", "--no-warmup"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.build_node(args)
