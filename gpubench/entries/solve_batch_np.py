"""A batch job's closed loop: ``SolverEngine.solve_batch_np`` back to back.

One client calls the engine with the mix's next batch as soon as the last
one returned, for the run's seconds; the window ends with the first call
that returns past them, and every call in it counts. Set-up builds the
engine, warms the one width the mix's calls use with a call of the mix's
own (drawn from a seed the window never draws from), times a second such
call, draws the window's calls ahead from that time (where they would run
out, the loop draws on), and freezes the garbage collector's heap, as the
node does once warm. In the window the harness only gathers each call's
boards into one buffer it reuses, and keeps the answers the check reads.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from gpubench.harness.check import Answers
from gpubench.harness.runner import Run
from gpubench.harness.trace import CALL, DRAW
from gpubench.harness.traffic import BatchPlan

_WARM_SEED_OFFSET = 0x5EED
# calls drawn ahead: this many times the window over one warm call, at
# most _AHEAD_BYTES of source indices
_AHEAD = 1.5
_AHEAD_BYTES = 1 << 27


def _devices(engine) -> list:
    mesh = getattr(engine, "mesh", None)
    devices = mesh.devices if mesh is not None else [engine.device]
    return [d.index if d.index is not None else 0 for d in devices]


def _sync(devices: list) -> None:
    import torch

    if torch.cuda.is_available():
        for d in devices:
            torch.cuda.synchronize(d)


def run(ctx) -> Run:
    mix = ctx.cell.traffic
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError("this entry drives one client in a closed loop")
    t_build = time.perf_counter()
    engine = ctx.build_engine()
    devices = _devices(engine)
    t_warm = time.perf_counter()
    plan = BatchPlan(ctx.pools, mix, ctx.seed)
    warm = BatchPlan(ctx.pools, mix, ctx.seed + _WARM_SEED_OFFSET)
    engine.solve_batch_np(warm.call(0).boards)
    _sync(devices)
    t_call = time.perf_counter()
    engine.solve_batch_np(warm.call(1).boards)
    call_s = max(time.perf_counter() - t_call, 1e-6)
    ahead = min(int(_AHEAD * ctx.seconds / call_s) + 1, _AHEAD_BYTES // (4 * plan.width))
    t_draw = time.perf_counter()
    drawn = [plan.call(k) for k in range(ahead)]
    buf = plan.buffer()
    # as the node does once warm (net/cli.py _freeze_after_warmup): the
    # set-up's heap moves out of the collector's way
    gc.collect()
    gc.freeze()
    answers = Answers(plan.width)
    calls = []
    cost_before = engine.cost.snapshot()
    t_setup = time.perf_counter()
    setup_s = t_setup - ctx.t_process
    phases = {
        # interpreter, imports, CUDA's first touch, the pools
        "start_s": t_build - ctx.t_process,
        # SolverEngine: the mesh's contexts and streams, the kernel store
        "engine_s": t_warm - t_build,
        # two calls of the mix: the kernel library's load (or build), the
        # width's first launch, then the call that sizes the draw
        "warm_s": t_draw - t_warm,
        # the window's calls drawn ahead
        "draw_s": t_setup - t_draw,
    }
    with ctx.window():
        start = time.perf_counter()
        deadline = start + ctx.seconds
        k = 0
        while True:
            with ctx.span(DRAW):
                call = drawn[k] if k < ahead else plan.call(k)
                boards = call.gather(buf)
            with ctx.span(CALL):
                t0 = time.perf_counter()
                solutions, solved, info = engine.solve_batch_np(boards)
                t1 = time.perf_counter()
            with ctx.span(DRAW):
                calls.append((t0, t1, len(boards), int(info["validations"])))
                answers.keep(call, solutions, solved)
            k += 1
            if t1 >= deadline:
                break
        end = time.perf_counter()
    in_calls = sum(c[1] - c[0] for c in calls)
    cost_after = engine.cost.snapshot()
    return Run(
        calls=calls,
        window_s=end - start,
        setup_s=setup_s,
        answers=answers,
        plan=plan,
        cells=engine.spec.cells,
        locked=bool(engine.locked_candidates),
        devices=devices,
        cost_before=cost_before,
        cost_after=cost_after,
        engine=engine,
        context={
            "buckets": list(engine.buckets),
            "mesh_shards": len(devices) if getattr(engine, "mesh", None) is not None else 1,
            "max_iters": engine.max_iters,
            "waves": engine.waves,
            "setup_phases_s": phases,
            "calls_drawn_ahead": ahead,
            # the window's time outside the program's calls (the harness's
            # gathers and kept answers), a call
            "harness_ms_per_call": 1e3 * ((end - start) - in_calls) / len(calls),
            "call_ms_quantiles": [
                round(float(q), 4) for q in np.percentile(
                    [1e3 * (c[1] - c[0]) for c in calls], [5, 50, 90, 95, 99, 100])
            ],
        },
    )
