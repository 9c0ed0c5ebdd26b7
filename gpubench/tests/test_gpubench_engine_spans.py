"""The readers of the engine's stage spans and card-clock time, on
synthetic Chrome-trace events: the launch and finalize readers split a
known idle gap exactly, a deep retry's own stages count to the retry, a
program without the spans reads nothing, and ``device_ms_per_call.batch``
divides the cost plane's growth by the window's calls."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from gpubench_testlib import ROOT  # noqa: F401  (puts the checkout on the path)

from gpubench.harness.catalog import Catalog
from gpubench.harness.trace import Trace

READ = {name: Catalog().reader(name) for name in (
    "launch_idle_ms_per_call.batch", "finalize_idle_ms_per_call.batch",
    "device_ms_per_call.batch", "host_ms_per_call.batch")}


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void dfs_solver_kernel<3>(int*)",
            "ts": ts, "dur": dur, "pid": 0, "tid": 9, "args": {"device": 0}}


def _call(t):
    """One call at ``t`` (µs), 1000 µs long: pad 100, h2d 50 (a 20 µs copy in
    it), launch 50, wait 500 (the kernel runs 220..720), rows 50, a deep
    retry 200 holding its own h2d and wait (a 100 µs kernel), merge 30; 20 µs
    at the call's ends lie in no stage."""
    return [
        _host("gpubench.call", t, 1000),
        _host("engine.pad", t + 10, 100),
        _host("engine.h2d", t + 110, 50),
        _host("engine.launch", t + 160, 50),
        _host("engine.wait", t + 210, 500),
        _host("engine.rows", t + 710, 50),
        _host("engine.deep_retry", t + 760, 200),
        _host("engine.h2d", t + 770, 20),
        _host("engine.wait", t + 800, 150),
        _host("engine.merge", t + 960, 30),
        {**_kernel(t + 130, 20), "cat": "gpu_memcpy", "name": "Memcpy HtoD"},
        _kernel(t + 220, 500),
        _kernel(t + 820, 100),
    ]


def _run(events, calls=2, before=None, after=None):
    return SimpleNamespace(trace=Trace(events), calls=[(0, 1, 8, 1)] * calls,
                           cost_before=before or {}, cost_after=after or {},
                           context={})


def test_the_idle_readers_split_a_known_gap_by_stage():
    events = [_host("gpubench.window", 0, 5000)] + _call(1000) + _call(3000)
    run = _run(events)
    # idle a call: pad 100 + h2d 50 - 20 copied + launch 50 (the kernel
    # starts after it)
    assert READ["launch_idle_ms_per_call.batch"](run) == pytest.approx(0.180)
    # wait 500 - 490 busy, rows 50 - 10, deep retry 200 - 100, merge 30
    assert READ["finalize_idle_ms_per_call.batch"](run) == pytest.approx(0.180)
    assert run.context["idle_ms_per_call_by_stage"] == pytest.approx({
        "engine.pad": 0.100, "engine.h2d": 0.030, "engine.launch": 0.050,
        "engine.wait": 0.010, "engine.rows": 0.040, "engine.deep_retry": 0.100,
        "engine.merge": 0.030})
    assert run.context["idle_ms_per_call_unstaged"] == pytest.approx(0.020)
    # the stages and the rest of the call make up the call's host time
    assert READ["host_ms_per_call.batch"](run) == pytest.approx(0.180 + 0.180 + 0.020)


def test_a_program_without_stage_spans_reads_nothing():
    events = [_host("gpubench.window", 0, 5000), _host("gpubench.call", 1000, 1000),
              _kernel(1200, 500)]
    run = _run(events, calls=1)
    assert READ["launch_idle_ms_per_call.batch"](run) is None
    assert READ["finalize_idle_ms_per_call.batch"](run) is None
    assert run.context == {}


def test_device_ms_divides_the_cost_planes_growth_by_the_calls():
    events = [_host("gpubench.window", 0, 5000)] + _call(1000) + _call(3000)
    before = {"gpu_s": 0.25, "gpu_s_by_stage": {"first": 0.2, "rerun": 0.05,
                                                "deep_retry": 0.0}}
    after = {"gpu_s": 0.25 + 4e-3, "gpu_s_by_stage": {"first": 0.2023, "rerun": 0.0505,
                                                      "deep_retry": 0.0012}}
    run = _run(events, calls=4, before=before, after=after)
    assert READ["device_ms_per_call.batch"](run) == pytest.approx(1.0)
    assert run.context["device_ms_per_call_by_stage"] == pytest.approx(
        {"first": 0.575, "rerun": 0.125, "deep_retry": 0.3})
    # the trace's busy ms inside a call: 20 + 500 + 100 µs
    assert run.context["trace_busy_ms_per_call"] == pytest.approx(0.620)
    # a cost plane without gpu_s (a program that does not time its stages)
    assert READ["device_ms_per_call.batch"](_run(events, before={}, after={})) is None
