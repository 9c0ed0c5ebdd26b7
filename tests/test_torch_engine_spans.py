"""The engine's stage spans, card-clock stage times and lockstep lane counts.

``solve_batch_np`` marks each engine stage with a ``torch.profiler`` span
(utils/profiling.py lists them), so that a capture puts each idle gap of
the card down to a stage; with no capture recording, ``annotate`` enters
no RecordFunction range. On one card the cost plane times each device
stage by CUDA events (``gpu_s``), which the CPU never records, and counts
lockstep lane-steps from each stage's summed and longest steps
(``ops.cuda_solver.lockstep_loop``). The ``cuda`` test runs on the card alone
(``python -m pytest --noconftest -m cuda tests/test_torch_engine_spans.py``);
this file imports no JAX module.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import lockstep_loop, lockstep_stats
from sudoku_solver_distributed_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
STAGES = ("engine.pad", "engine.h2d", "engine.launch", "engine.wait",
          "engine.rows", "engine.rerun", "engine.cost", "engine.deep_retry",
          "engine.merge")


def corpus(name, n):
    with np.load(os.path.join(BENCH, name)) as d:
        return d["boards"][:n].astype(np.int32)


def overflow_batch():
    """Eight boards: the empty board (~47 frames, past the first stage's 32:
    a depth rerun), a conflict board and six corpus boards."""
    b = np.zeros((8, 9, 9), np.int32)
    b[1, 0, 0] = b[1, 0, 1] = 7
    b[2:] = corpus("corpus_9x9_hard_4096.npz", 6)
    return b


# the batch, the engine's step budget, and the stage the batch must reach
CASES = {
    "rerun": (overflow_batch, 4096, "engine.rerun"),
    # six steps leave boards RUNNING: the deep retry at 16x the budget
    "deep_retry": (overflow_batch, 6, "engine.deep_retry"),
}


def _engine(**kw):
    return SolverEngine(device="cpu", buckets=(1, 8, 64), continuous=False,
                        coalesce=False, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_capture_holds_the_stage_spans_in_order_covering_the_call(case):
    """A CPU capture of one ``solve_batch_np``, in a span of the caller's
    as a benchmark wraps each call: the stage spans follow one another
    inside it, without overlap, covering at least 95 % of it, pad first
    and merge last."""
    make, iters, reached = CASES[case]
    eng = _engine(max_iters=iters)
    try:
        boards = make()
        eng.solve_batch_np(boards)  # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("caller.call"):
                eng.solve_batch_np(boards)
        spans = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.name.startswith("engine.") or e.name == "caller.call"
        )
    finally:
        eng.close()
    call = [s for s in spans if s[2] == "caller.call"]
    assert len(call) == 1
    b0, b1, _ = call[0]
    # the outermost stages: those no other stage holds
    stages = [s for s in spans if s[2] in STAGES]
    top = [s for s in stages
           if not any(o is not s and o[0] <= s[0] and s[1] <= o[1] for o in stages)]
    names = [s[2] for s in top]
    assert names[:4] == ["engine.pad", "engine.h2d", "engine.launch", "engine.wait"]
    assert names[-1] == "engine.merge" and reached in names
    assert set(names) <= set(STAGES)
    for (a0, a1, _), (c0, _, _) in zip(top, top[1:]):
        assert a1 <= c0  # in order, no overlap
    assert all(b0 <= a and c <= b1 for a, c, _ in top)
    assert sum(c - a for a, c, _ in top) >= 0.95 * (b1 - b0)


def test_annotate_enters_no_record_function_without_a_capture(monkeypatch):
    """With no profiler recording, a whole call enters no RecordFunction
    range (one flag check a span); under a capture every span enters one."""
    entered = []
    real = profiling._range or torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(profiling, "_range", counting)
    eng = _engine()
    try:
        boards = overflow_batch()
        eng.solve_batch_np(boards)
        assert entered == []
        assert profiling.annotate("x") is profiling.annotate("y")
        with profile(activities=[ProfilerActivity.CPU]):
            eng.solve_batch_np(boards)
        assert entered[0] == "engine.pad" and "engine.rerun" in entered
    finally:
        eng.close()


def test_the_cpu_records_no_card_clock_time():
    """``gpu_s`` is the card's clock: the plain path on the CPU times no
    stage, so the cost block and its buckets carry no ``gpu_s`` and the
    /metrics key tree stays the JAX engine's."""
    eng = _engine(max_iters=6)
    try:
        eng.solve_batch_np(overflow_batch())
        snap = eng.cost.snapshot()
    finally:
        eng.close()
    assert snap["buckets"]["8"]["deep_retries"] == 1
    assert snap.get("gpu_s", 0) == 0 and "gpu_s_by_stage" not in snap
    assert all(b.get("gpu_s", 0) == 0 for b in snap["buckets"].values())
    assert SolverEngine._gpu_s(None) is None


def test_lockstep_counts_are_width_times_turns_less_own_steps():
    """lane = B x max(steps), idle = lane - sum(steps): from a steps tensor
    (a mesh shard's ``lockstep_stats``) and from the summed and longest
    steps the engine reads off one card's stages (``lockstep_loop``), alike;
    a 4096-wide stage of 1,048,576 steps (2**32 lane-steps) does not wrap.
    On the CPU a call's counters are its width times its steps, idle 0."""
    steps = torch.tensor([5, 1, 3, 0], dtype=torch.int32)
    assert tuple(map(int, lockstep_stats(steps))) == (20, 11)
    assert lockstep_loop(9, 5, 4) == (20, 11)
    wide = torch.full((4096,), 1 << 20, dtype=torch.int32)
    wide[7] = 1
    lane, idle = lockstep_stats(wide)
    assert (int(lane), int(idle)) == (1 << 32, (1 << 20) - 1)
    own = int(wide.to(torch.int64).sum())
    assert lockstep_loop(own, int(wide.max()), 4096) == (1 << 32, (1 << 20) - 1)
    # two stages: the turns are the sum of each stage's most steps
    assert lockstep_loop(2 + 4, 4 + 5, 2) == (18, 12)
    eng = _engine()
    try:
        # the engine's helper over a call's stages: the wide stage, then a
        # one-step rerun of every lane
        call = SimpleNamespace(boards=np.zeros((4096, 9, 9), np.int32),
                               loops=[torch.tensor([own, 1 << 20]), torch.tensor([4096, 1])])
        assert eng._loop_stats(call, None) == (4096 * ((1 << 20) + 1), (1 << 20) - 1)
        eng.solve_batch_np(corpus("corpus_9x9_hard_4096.npz", 8))
        snap = eng.cost.snapshot()["buckets"]["8"]
    finally:
        eng.close()
    assert snap["lane_steps"] > 0 and snap["lane_steps"] % 8 == 0
    assert snap["idle_lane_steps"] == 0


@pytest.mark.cuda
def test_on_the_card_a_call_records_card_time_and_straggler_occupancy():
    """One call of 63 hard boards and one deep board on the card: the cost
    plane holds the first stage's card-clock time, and the lanes are busy
    for less than the whole call (the deep board runs on alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    boards = np.concatenate([corpus("corpus_9x9_hard_4096.npz", 63),
                             corpus("corpus_9x9_deep_128.npz", 1)])
    eng = SolverEngine(device="cuda", buckets=(64,), continuous=False, coalesce=False)
    try:
        _, solved, _ = eng.solve_batch_np(boards)
        snap = eng.cost.snapshot()
    finally:
        eng.close()
    assert solved.all()
    assert snap["gpu_s_by_stage"]["first"] > 0
    assert snap["gpu_s"] >= snap["gpu_s_by_stage"]["first"]
    assert 0 < snap["buckets"]["64"]["gpu_s"] <= snap["buckets"]["64"]["device_s"] + 1e-3
    assert 0 < snap["lane_util_pct"] < 100
    assert 0 < snap["idle_lane_steps"] < snap["lane_steps"]
