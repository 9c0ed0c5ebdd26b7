"""The port's closed-loop request coalescer (parallel/coalescer.py) on the
CPU — engines built with ``continuous=False``, since the coalesced path
serves open loop by default (tests/test_torch_continuous.py) — held against the JAX package's closed-loop coalescer where the batch
composition is fixed (a long ``max_wait_s`` and ``max_batch=K``: the batch
dispatches when its K-th request arrives), plus its own contract: a lone
request dispatches, an expired deadline raises ``DeadlineExceeded`` without
a launch, ``close()`` drains, a board of the wrong shape raises
``ValueError``, a failing launch fails its batch's futures (nothing reruns
elsewhere), and concurrent clients share launches.
"""

import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.parallel.coalescer import (
    BatchCoalescer as JaxCoalescer,
)
from sudoku_solver_distributed_tpu.serving.load import (
    AdaptiveWaitPolicy as JaxAdaptiveWaitPolicy,
)
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.parallel.coalescer import BatchCoalescer
from sudoku_solver_distributed_tpu_torch.serving import (
    AdaptiveWaitPolicy,
    DeadlineExceeded,
)

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
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


def corpus(n):
    with np.load(os.path.join(BENCH, "corpus_9x9_hard_4096.npz")) as d:
        return d["boards"][:n].astype(np.int32)


def batch_of(k):
    """``k`` boards: the README board, an unsolvable board, hard boards."""
    b = corpus(k)
    b[0] = README_PUZZLE
    b[1] = 0
    b[1, 0, 0] = b[1, 0, 1] = 3
    return b


@pytest.fixture
def engine():
    eng = SolverEngine(device="cpu", buckets=(1, 8), continuous=False)
    yield eng
    eng.close()


@pytest.mark.parametrize("k", [3, 8])
def test_fixed_batch_matches_jax_coalescer(k):
    """K requests coalesce into one bucket-8 launch (``waves=3``) in both
    packages: every (solution, info) and the engine counters are equal."""
    boards = batch_of(k)
    knobs = dict(buckets=(1, 8), coalesce_max_wait_s=5.0, coalesce_max_batch=k)
    jax_eng = JaxEngine(continuous=False, **knobs)
    eng = SolverEngine(device="cpu", continuous=False, **knobs)
    try:
        want = [f.result(timeout=120) for f in
                [jax_eng.coalescer.submit(b) for b in boards]]
        got = [f.result(timeout=120) for f in
               [eng.coalescer.submit(b) for b in boards]]
        assert got == want
        assert got[1][0] is None and got[0][0] is not None
        for st in (eng.coalescer.stats(), jax_eng.coalescer.stats()):
            assert (st["batches"], st["boards"], st["batch_fill_max"]) == (1, k, k)
        assert eng.validations == jax_eng.validations
        assert eng.solved_puzzles == jax_eng.solved_puzzles == k - 1
    finally:
        jax_eng.close()
        eng.close()


def test_lone_request_dispatches_at_width_one(engine):
    t0 = time.monotonic()
    solution, info = engine.solve_one(README_PUZZLE)
    assert solution is not None and oracle_is_valid_solution(solution)
    # a width-1 bucket sweeps once a step: the README board's 105
    assert info == {"validations": 105, "guesses": 67, "capped": 0,
                    "routed": "coalesced"}
    st = engine.coalescer.stats()
    assert (st["batches"], st["boards"], st["batch_fill_last"]) == (1, 1, 1)
    assert time.monotonic() - t0 < 60


def test_expired_deadline_raises_without_a_launch(engine):
    calls = []
    real = engine._dispatch_padded

    def spy(boards):
        calls.append(boards.shape[0])
        return real(boards)

    engine._dispatch_padded = spy
    fut = engine.solve_one_async(README_PUZZLE, deadline_s=time.monotonic() - 1)
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=30)
    assert calls == [] and engine.coalescer.stats()["expired"] == 1
    # the inline route (coalescer off) checks the deadline before solving
    inline = SolverEngine(device="cpu", buckets=(1,), coalesce=False)
    with pytest.raises(DeadlineExceeded):
        inline.solve_one_async(
            README_PUZZLE, deadline_s=time.monotonic() - 1
        ).result()


def test_close_drains_queued_requests(engine):
    co = BatchCoalescer(engine, max_wait_s=10.0, max_batch=8)
    futs = [co.submit(b) for b in batch_of(3)]
    co.close()
    assert all(f.done() for f in futs)
    results = [f.result() for f in futs]
    assert results[0][0] is not None and results[1][0] is None
    assert co.stats()["batches"] == 1
    with pytest.raises(RuntimeError, match="shut down"):
        co.submit(np.asarray(README_PUZZLE, np.int32))
    co.close()  # idempotent


@pytest.mark.parametrize("shape", [(4, 4), (9, 8), (81,)])
def test_wrong_shape_raises_value_error(engine, shape):
    with pytest.raises(ValueError, match="9x9"):
        engine.coalescer.submit(np.zeros(shape, np.int32))
    assert engine.coalescer.stats()["queue_depth"] == 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_stats_keys_match_jax_closed_loop(adaptive):
    """The opt-in /stats serving block renders ``stats()``: same keys as
    the JAX coalescer's closed loop, with and without the adaptive wait."""
    stub = types.SimpleNamespace(buckets=(1, 8), spec=spec_for_size(9))

    def policy(cls):
        return cls(max_wait_s=0.002, quiescence_s=0.001) if adaptive else None

    mine = BatchCoalescer(stub, wait_policy=policy(AdaptiveWaitPolicy))
    theirs = JaxCoalescer(stub, wait_policy=policy(JaxAdaptiveWaitPolicy))
    assert sorted(mine.stats()) == sorted(theirs.stats())
    assert mine.stats() == theirs.stats()


@pytest.mark.parametrize("side", ["_dispatch_padded", "_finalize_padded"])
def test_failed_launch_fails_its_batch_only(engine, side):
    """A kernel that does not build or launch fails the futures of its
    batch with the error; the next batch is served. No fallback solve."""
    real = getattr(engine, side)

    def boom(*args):
        raise RuntimeError("dfs_solver launch failed: cudaError 700")

    setattr(engine, side, boom)
    co = engine.coalescer
    with pytest.raises(RuntimeError, match="cudaError"):
        co.submit(np.asarray(README_PUZZLE, np.int32)).result(timeout=30)
    assert co.stats()["failed_batches"] == 1
    assert engine.validations == 0
    setattr(engine, side, real)
    solution, _ = co.submit(np.asarray(README_PUZZLE, np.int32)).result(timeout=60)
    assert solution is not None


def test_concurrent_clients_share_launches():
    """16 client threads at once: batches of more than one board, every
    answer right, and the engine's validations are the answers' sum."""
    eng = SolverEngine(device="cpu", buckets=(1, 8, 64), coalesce_max_wait_s=0.05,
                       continuous=False)
    boards = batch_of(16)
    results = [None] * 16
    start = threading.Barrier(16)

    def client(i):
        start.wait()
        results[i] = eng.solve_one(boards[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = eng.coalescer.stats()
    finally:
        eng.close()
    assert st["batch_fill_max"] > 1 and st["boards"] == 16
    for i, (solution, info) in enumerate(results):
        if i == 1:
            assert solution is None and info["capped"] == 0
            continue
        clues = boards[i] != 0
        assert oracle_is_valid_solution(solution)
        assert (np.asarray(solution)[clues] == boards[i][clues]).all()
    assert eng.validations == sum(info["validations"] for _, info in results)


def test_stress_more_threads_than_cores():
    """More client threads than cores, with a shortened interpreter switch
    interval: every request is answered once, the coalescer counts every
    board, and the engine's counters equal the answers' sums — a lost
    update in the shared queue or counters would break one of them."""
    n = min(64, 2 * (len(os.sched_getaffinity(0)) or 1) + 8)
    boards = corpus(n)
    results = [None] * n
    eng = SolverEngine(device="cpu", buckets=(1, 8, 64), coalesce_max_wait_s=0.005,
                       continuous=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [
            threading.Thread(
                target=lambda i=i: results.__setitem__(i, eng.solve_one(boards[i]))
            )
            for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        st = eng.coalescer.stats()
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert all(r is not None and r[0] is not None for r in results)
    assert st["boards"] == n and st["failed_batches"] == 0
    assert eng.solved_puzzles == n
    assert eng.validations == sum(info["validations"] for _, info in results)
