"""The port's device cost plane, SLO engine and trace export against the JAX
package's.

The single-node cases of ``tests/test_fleet_obs.py`` run on the port
(CPU): cost accounting under coalesced load and its block in
``engine.health()``, the pad attribution (no mesh: every pad row bills the
coalescer), the SLO burn math with explicit clocks, ``parse_slo``, a fast
burn dumping the flight recorder, injected device latency driving the
burn with the offending spans in the dump, the trace-export tree, and
``GET /debug/trace`` with its 404. The copied modules (obs/cost, obs/slo,
obs/export) get the same seeded inputs as the JAX package's and must give
identical outputs; the closed loop's dispatch, board and pad counts must
equal the JAX engine's on the same batches (its lane counts differ by
design: ops/cuda_solver.py).
"""

import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.obs import cost as jcost
from sudoku_solver_distributed_tpu.obs import export as jexport
from sudoku_solver_distributed_tpu.obs import slo as jslo
from sudoku_solver_distributed_tpu.obs.histo import StageMetrics as JaxStageMetrics
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.obs import (
    FlightRecorder,
    SloEngine,
    StageMetrics,
    Tracer,
    parse_slo,
)
from sudoku_solver_distributed_tpu_torch.obs import cost as tcost
from sudoku_solver_distributed_tpu_torch.obs import export as texport
from sudoku_solver_distributed_tpu_torch.obs import slo as tslo
from sudoku_solver_distributed_tpu_torch.obs.export import build_trace
from sudoku_solver_distributed_tpu_torch.obs.slo import good_bad_counts
from sudoku_solver_distributed_tpu_torch.utils import EngineFaultInjector

BOARD = [[0] * 9 for _ in range(9)]
BOARD[0][0] = 5


def free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout
        ) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post(port, path, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode()
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, json.loads(r.read())


@pytest.fixture(scope="module")
def engine():
    eng = SolverEngine(device="cpu", buckets=(1, 4))
    eng.warmup()
    yield eng
    eng.close()


# -- the device cost plane ------------------------------------------------------


def test_cost_accounting_coalesced_load(engine):
    """Three concurrent requests on the default (continuous) engine: the
    segments at the pool width record device wall time, fill, pad and
    lane counters from the segment digest; the boarding requests feed
    formation samples; warm-up time reads as the amortization's cost."""
    before = engine.cost.snapshot()
    futs = [engine.solve_one_async(BOARD) for _ in range(3)]
    for f in futs:
        assert f.result(timeout=60)[0] is not None
    snap = engine.cost.snapshot(warm_info=engine.warm_info())
    assert snap["dispatches"] > before["dispatches"]
    assert snap["device_s"] > 0 and snap["pps"] > 0
    assert snap["lane_util_pct"] > 0
    b4 = snap["buckets"].get("4")
    assert b4 is not None and b4["lane_steps"] > 0
    assert b4["pad_coalesce_pct"] > 0 and b4["pad_mesh_pct"] == 0.0
    assert 0 < b4["fill_pct"] < 100.0
    assert snap["formation"]["batches"] >= 1
    assert snap["formation"]["avg_fill"] >= 1
    cont = snap["continuous"]
    assert cont["segments"] == b4["dispatches"]
    assert cont["injected"] >= 3 and cont["resolved"] >= 3
    am = snap["compile_amortization"]
    assert am["compile_s"] > 0 and am["device_s"] > 0


def test_cost_block_rides_engine_health(engine):
    health = engine.health()
    assert health["cost"]["boards"] >= 1
    assert health["backend"] == "plain"
    assert health["frontier_enabled"] is False
    assert health["continuous"] == {
        "enabled": True, "configured": True,
        "segment_iters": engine.segment_iters, "pipeline": True,
    }
    assert health["warm"]["buckets"]["4"]["warm"] is True
    assert health["warm"]["order"] == [1, 4]
    assert health["warm"]["programs"] >= 3  # solve@1, solve@4, segment@4


def test_closed_loop_cost_counts_match_jax():
    """A fixed batch composition on the closed loop (one batch of three in
    the width-4 bucket, then a lone request, then a direct batch of 5 in
    the width-8 bucket): the same dispatches, boards, fill and pad per
    bucket as the JAX engine, and formation samples alike. Lane counts are
    not compared: the kernel's are its own (ops/cuda_solver.py)."""
    kw = dict(buckets=(1, 4, 8), continuous=False, coalesce_max_wait_s=10.0,
              coalesce_max_batch=3)
    snaps = []
    for eng in (JaxEngine(**kw), SolverEngine(device="cpu", **kw)):
        try:
            eng.warmup()
            futs = [eng.solve_one_async(BOARD) for _ in range(3)]
            for f in futs:
                assert f.result(timeout=60)[0] is not None
            eng.solve_batch_np(np.tile(np.asarray(BOARD, np.int32), (5, 1, 1)))
            snaps.append(eng.cost.snapshot())
        finally:
            eng.close()
    jax_snap, snap = snaps
    for k in ("dispatches", "boards", "fill_pct", "pad_coalesce_pct",
              "pad_mesh_pct", "pad_waste_pct"):
        assert snap[k] == jax_snap[k], k
    assert set(snap["buckets"]) == set(jax_snap["buckets"]) == {"4", "8"}
    for w in snap["buckets"]:
        for k in ("dispatches", "boards", "deep_retries", "fill_pct",
                  "pad_coalesce_pct", "pad_mesh_pct"):
            assert snap["buckets"][w][k] == jax_snap["buckets"][w][k], (w, k)
    assert snap["formation"]["batches"] == jax_snap["formation"]["batches"] == 1
    assert snap["formation"]["avg_fill"] == jax_snap["formation"]["avg_fill"] == 3
    assert "continuous" not in snap and "continuous" not in jax_snap


def test_cost_pad_attribution_bills_the_coalescer():
    """No mesh in this package: every pad row of a bucket call bills the
    coalescer, as on a JAX engine without a mesh."""
    snaps = []
    for eng in (JaxEngine(buckets=(8,), coalesce=False),
                SolverEngine(device="cpu", buckets=(8,), coalesce=False)):
        try:
            eng.solve_batch_np(np.tile(np.asarray(BOARD, np.int32), (5, 1, 1)))
            snaps.append(eng.cost.snapshot()["buckets"]["8"])
        finally:
            eng.close()
    jb, b = snaps
    assert b["pad_coalesce_pct"] == pytest.approx(100 * 3 / 8, abs=0.1)
    assert b["pad_mesh_pct"] == 0.0
    assert (b["pad_coalesce_pct"], b["pad_mesh_pct"], b["fill_pct"]) == (
        jb["pad_coalesce_pct"], jb["pad_mesh_pct"], jb["fill_pct"]
    )


def test_cost_copy_matches_jax():
    """The same seeded calls, segments, formations, farm and frontier
    events give identical snapshots."""
    rng = np.random.default_rng(11)
    calls = []
    for _ in range(60):
        kind = rng.integers(0, 5)
        if kind == 0:
            calls.append(("record_call", dict(
                bucket=int(rng.choice([1, 8, 64])), boards=int(rng.integers(1, 8)),
                pad_coalesce=int(rng.integers(0, 5)), pad_mesh=0,
                device_s=float(rng.uniform(-0.001, 0.01)),
                lane_steps=int(rng.integers(0, 900)),
                idle_lane_steps=int(rng.integers(0, 90)),
                deep_retry=bool(rng.random() < 0.2))))
        elif kind == 1:
            calls.append(("note_segment", dict(
                width=64, active=int(rng.integers(0, 64)),
                injected=int(rng.integers(0, 9)), resolved=int(rng.integers(0, 9)),
                device_s=float(rng.uniform(0, 0.004)),
                lane_steps=int(rng.integers(0, 2000)),
                idle_lane_steps=int(rng.integers(0, 500)),
                pipelined=bool(rng.random() < 0.5),
                boundary_host_s=float(rng.uniform(0, 0.003)),
                fetch_bytes=int(rng.integers(0, 9000)))))
        elif kind == 2:
            calls.append(("note_formation", dict(
                wait_s=float(rng.uniform(-0.001, 0.002)),
                fill=int(rng.integers(1, 64)))))
        elif kind == 3:
            calls.append(("note_farm", dict(dispatches=int(rng.integers(0, 3)),
                                            hedges=int(rng.integers(0, 2)))))
        else:
            calls.append(("note_frontier", dict(
                device_s=float(rng.uniform(0, 0.1)),
                escalated=bool(rng.random() < 0.5))))
    warm = {"buckets": {"1": {"warm": True, "compile_s": 0.5},
                        "8": {"warm": True, "compile_s": 1.25}}}
    snaps = []
    for mod in (jcost, tcost):
        acc = mod.CostAccounting(window=16)
        for name, kw in calls:
            getattr(acc, name)(**kw)
        snaps.append((acc.snapshot(), acc.snapshot(warm_info=warm)))
    assert snaps[0] == snaps[1]
    assert tcost.CostAccounting().snapshot() == jcost.CostAccounting().snapshot()


# -- the SLO burn-rate engine ---------------------------------------------------


def _observe_total(stages, seconds, n):
    for _ in range(n):
        stages.observe("total", seconds)


def test_good_bad_counts_conservative_rounding():
    stages = StageMetrics()
    _observe_total(stages, 0.55, 4)   # lands in the (500, 1000] bucket
    snap = stages.histograms()["total"]
    assert good_bad_counts(snap, 600.0) == (4, 4)
    assert good_bad_counts(snap, 1000.0) == (4, 0)
    assert jslo.good_bad_counts(snap, 600.0) == (4, 4)


def test_burn_rate_math_synthetic_histograms():
    stages = StageMetrics()
    slo = SloEngine(
        stages,
        [parse_slo("latency_p99_ms=500@99")],
        windows_s=(60.0, 600.0),
        tick_interval_s=0.0,
    )
    slo.tick(now=0.0)
    _observe_total(stages, 0.001, 99)
    _observe_total(stages, 1.0, 1)
    slo.tick(now=30.0)
    snap = slo.snapshot()
    obj = snap["objectives"]["latency_p99_ms"]
    assert obj["burn_60s"] == pytest.approx(1.0, abs=0.01)
    assert obj["fast_burn"] is False and snap["fast_burn_active"] is False
    _observe_total(stages, 1.0, 50)
    slo.tick(now=31.0)
    snap = slo.snapshot()
    obj = snap["objectives"]["latency_p99_ms"]
    assert obj["burn_60s"] > 14.4 and obj["burn_600s"] > 14.4
    assert obj["fast_burn"] is True and snap["fast_burn_active"] is True
    assert snap["fast_burn_events"] == 1
    _observe_total(stages, 1.0, 10)
    slo.tick(now=32.0)
    assert slo.snapshot()["fast_burn_events"] == 1


def test_slo_copy_matches_jax():
    """The same seeded latencies and explicit clocks give the same burn
    rates, edges and snapshots; a burn listener sees the same edges."""
    rng = np.random.default_rng(13)
    specs = ["latency_p99_ms=100@99", "device_latency_p95_ms=25@95",
             "queue_latency_p50_ms=1@50"]
    batches = [
        [(float(rng.lognormal(-4.0, 1.5)), float(rng.lognormal(-5.0, 1.5)))
         for _ in range(int(rng.integers(1, 40)))]
        for _ in range(25)
    ]
    outs = []
    for mod, Stages in ((jslo, JaxStageMetrics), (tslo, StageMetrics)):
        stages = Stages()
        # tick_interval_s this long: only the explicit ticks sample
        slo = mod.SloEngine(stages, [mod.parse_slo(s) for s in specs],
                            windows_s=(5.0, 20.0), tick_interval_s=1e9)
        edges = []
        slo.add_burn_listener(edges.append)
        trail = []
        for i, batch in enumerate(batches):
            for total, dev in batch:
                stages.observe_span({"device": dev, "queue": dev / 2}, total)
            slo.tick(now=float(i))
            with slo._lock:
                trail.append([
                    slo._burn_locked(j, o, w, float(i))
                    for j, o in enumerate(slo.objectives) for w in slo.windows_s
                ])
            trail.append(slo.fast_burn_active())
        outs.append((trail, edges, slo.fast_burn_events, slo.ticks,
                     slo.snapshot()))
    assert outs[0] == outs[1]
    assert jslo.DEFAULT_WINDOWS_S == tslo.DEFAULT_WINDOWS_S


def test_parse_slo_shapes_and_errors():
    o = parse_slo("latency_p99_ms=500@99.9")
    assert (o.stage, o.threshold_ms, o.objective_pct) == ("total", 500.0, 99.9)
    assert o.error_budget == pytest.approx(0.001)
    assert parse_slo("device_latency_p95_ms=50@99").stage == "device"
    for spec in ("latency_p99_ms=500@99.9", "device_latency_p95_ms=50@99",
                 "cache_latency_p50_ms=1@50", "verify_latency_p9_ms=2.5@90"):
        assert dataclasses.asdict(parse_slo(spec)) == dataclasses.asdict(
            jslo.parse_slo(spec)
        )
    for bad in ("nonsense", "latency_p99_ms=500", "latency_p99_ms=0@99",
                "latency_p99_ms=500@100", "latency_p99_ms=500@0",
                "devcie_latency_p99_ms=50@99"):
        with pytest.raises(ValueError):
            parse_slo(bad)
        with pytest.raises(ValueError):
            jslo.parse_slo(bad)


def test_fast_burn_triggers_flight_dump(tmp_path):
    flight = FlightRecorder(dump_dir=str(tmp_path), incident_delay_s=0.05)
    stages = StageMetrics()
    slo = SloEngine(
        stages,
        [parse_slo("latency_p99_ms=100@99")],
        recorder=flight,
        windows_s=(60.0, 600.0),
        tick_interval_s=0.0,
    )
    slo.tick(now=0.0)
    _observe_total(stages, 1.0, 20)
    slo.tick(now=1.0)
    assert wait_for(lambda: flight.stats()["dumps"] >= 1, timeout=5.0)
    assert flight.stats()["last_dump_reason"] == "slo-fast-burn"
    with open(flight.stats()["last_dump_path"]) as f:
        payload = json.load(f)
    events = [e for e in payload["events"] if e["kind"] == "slo-fast-burn"]
    assert events and events[0]["slo"] == "latency_p99_ms"
    assert events[0]["burn"]["60s"] > 14.4


def test_injected_latency_drives_fast_burn_with_spans(engine, tmp_path):
    """The engine-seam injector's fetch delay inflates real segments past
    the objective: the fast-burn gauge crosses and the dump holds the SLO
    event and the offending spans, delay visible as device time."""
    flight = FlightRecorder(dump_dir=str(tmp_path), incident_delay_s=0.05)
    tracer = Tracer(recorder=flight)
    slo = SloEngine(
        tracer.stages,
        [parse_slo("latency_p99_ms=10@99")],
        recorder=flight,
        windows_s=(30.0, 60.0),
        tick_interval_s=0.0,
    )
    tracer.slo = slo
    inj = EngineFaultInjector()
    engine.fault_injector = inj
    inj.set_delay(0.05)  # every fetch +50 ms, far past the 10 ms objective
    try:
        for _ in range(6):
            t = tracer.start("/solve")
            solution, _info = engine.solve_one(BOARD)
            tracer.finish(t, 200)
            assert solution is not None
        slo.tick()
        snap = slo.snapshot()
        assert snap["fast_burn_active"] is True, snap
        assert snap["objectives"]["latency_p99_ms"]["burn_30s"] > 14.4
        assert wait_for(lambda: flight.stats()["dumps"] >= 1, timeout=5.0)
        assert flight.stats()["last_dump_reason"] == "slo-fast-burn"
        with open(flight.stats()["last_dump_path"]) as f:
            payload = json.load(f)
        assert "slo-fast-burn" in [e["kind"] for e in payload["events"]]
        slow = [s for s in payload["spans"] if s["device_ms"] >= 40.0]
        assert slow, payload["spans"]
        assert payload["trace"]["traceEvents"]
    finally:
        inj.clear()
        engine.fault_injector = None


# -- trace export -----------------------------------------------------------------


def _span(tracer, route, trace_id, stages_ms, farmed=False):
    t = tracer.start(route, trace_id=trace_id)
    for stage, ms in stages_ms.items():
        t.mark(stage, ms / 1e3)
    t.farmed = farmed
    return tracer.finish(t, 200)


def test_trace_export_tree_assembly():
    flight = FlightRecorder(dump_dir=None)
    tracer = Tracer(recorder=flight)
    _span(tracer, "/solve", "T1",
          {"cache": 0.2, "queue": 1.0, "coalesce": 0.5, "device": 4.0,
           "verify": 0.3})
    _span(tracer, "/solve", "T1", {"device": 2.0})  # a retry, same id
    _span(tracer, "/solve", "T2", {"device": 1.0})
    doc = build_trace(flight.spans())
    events = doc["traceEvents"]
    assert json.loads(json.dumps(doc))["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    for e in xs:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert e["pid"] == 1 and e["tid"] >= 1 and e["name"]
    t1 = [e for e in xs if e.get("args", {}).get("trace_id") == "T1"]
    assert len({e["tid"] for e in t1}) == 1  # one track per request id
    # the first span alone: its stage children laid out in stage order
    first = [e for e in build_trace(flight.spans()[:1])["traceEvents"]
             if e["ph"] == "X"]
    parent = next(e for e in first if e["cat"] == "request")
    stages = [e for e in first if e["cat"] == "stage"]
    assert [s["name"] for s in stages] == [
        "cache", "queue", "coalesce", "device", "verify",
    ]
    assert stages[0]["ts"] == parent["ts"]
    for earlier, later in zip(stages, stages[1:]):
        assert later["ts"] == pytest.approx(earlier["ts"] + earlier["dur"])
    t2 = [e for e in xs if e.get("args", {}).get("trace_id") == "T2"]
    assert {e["tid"] for e in t2} != {e["tid"] for e in t1}
    only = build_trace(flight.spans(), trace_id="T2")
    assert all(e.get("args", {}).get("trace_id") == "T2"
               for e in only["traceEvents"] if e["ph"] == "X")
    assert doc["otherData"]["spans"] == 3 and doc["otherData"]["traces"] == 2


def test_export_copy_matches_jax():
    """The same seeded span records give the same trace-event JSON; only
    the ``otherData.source`` label names the package."""
    rng = np.random.default_rng(17)
    spans = []
    for i in range(30):
        rec = {"trace_id": f"T{int(rng.integers(0, 8))}",
               "route": "farm-task" if rng.random() < 0.2 else "/solve",
               "t": 1.7e9 + float(rng.uniform(0, 10)), "status": 200,
               "total_ms": float(rng.uniform(0, 30))}
        for stage in ("cache", "queue", "coalesce", "device", "verify",
                      "fallback"):
            rec[f"{stage}_ms"] = float(rng.choice([0.0, rng.uniform(0, 5)]))
        rec.update(bucket=8, batch_id=i, degraded=False, fallback=False,
                   farmed=False, segments=2)
        spans.append(rec)
    for tid in (None, "T3"):
        a = jexport.build_trace(spans, trace_id=tid)
        b = texport.build_trace(spans, trace_id=tid)
        assert a["otherData"].pop("source") == (
            "sudoku_solver_distributed_tpu obs/export.py"
        )
        assert b["otherData"].pop("source") == (
            "sudoku_solver_distributed_tpu_torch obs/export.py"
        )
        assert a == b
    assert jexport.span_events(spans[0], 3) == texport.span_events(spans[0], 3)


def test_debug_trace_route_and_404(engine):
    flight = FlightRecorder(dump_dir=None)
    tracer = Tracer(recorder=flight)
    node = P2PNode("127.0.0.1", free_udp_port(), engine=engine,
                   metrics=tracer.routes)
    node.tracer = tracer
    node.flight = flight
    httpd = make_http_server(
        node, "127.0.0.1", 0, expose_metrics=True, legacy_transport=True,
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        post(port, "/solve", {"sudoku": BOARD})
        _s, _h, raw = get(port, "/debug/trace")
        doc = json.loads(raw)
        assert any(e["ph"] == "X" and e["name"] == "/solve"
                   for e in doc["traceEvents"])
        assert any(e["ph"] == "X" and e["cat"] == "stage"
                   and e["name"] == "device" for e in doc["traceEvents"])
    finally:
        httpd.shutdown()
        httpd.server_close()
    bare = P2PNode("127.0.0.1", free_udp_port(), engine=engine)
    httpd2 = make_http_server(
        bare, "127.0.0.1", 0, expose_metrics=True, legacy_transport=True,
    )
    threading.Thread(target=httpd2.serve_forever, daemon=True).start()
    try:
        status, _h, raw = get(httpd2.server_address[1], "/debug/trace")
        assert status == 404 and json.loads(raw) == {"error": "Invalid endpoint"}
    finally:
        httpd2.shutdown()
        httpd2.server_close()


def test_metrics_json_prom_parity_with_cost_and_device_trace(tmp_path):
    """/metrics JSON and its prom rendering agree with the engine.cost block
    and the warm plane's device_trace counters present."""
    eng = SolverEngine(device="cpu", buckets=(1,))
    eng.arm_device_trace(str(tmp_path), calls=0)
    eng.warmup()
    flight = FlightRecorder(dump_dir=None)
    tracer = Tracer(recorder=flight)
    node = P2PNode("127.0.0.1", free_udp_port(), engine=eng,
                   metrics=tracer.routes)
    node.tracer = tracer
    node.flight = flight
    httpd = make_http_server(
        node, "127.0.0.1", 0, expose_metrics=True, legacy_transport=True,
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        post(port, "/solve", {"sudoku": BOARD})
        body = json.loads(get(port, "/metrics")[2])
        assert body["engine"]["cost"]["boards"] >= 1
        trace = body["engine"]["warm"]["device_trace"]
        assert trace["calls_remaining"] == 0 and trace["warmup_traced"] is True
        text = get(port, "/metrics.prom")[2].decode()
        assert text == get(port, "/metrics?format=prom")[2].decode()
        assert "sudoku_engine_cost_lane_util_pct" in text
        assert "sudoku_engine_cost_pps" in text
        assert "sudoku_engine_warm_device_trace_captured_calls 0" in text
        assert 'sudoku_engine_backend_info{value="plain"} 1' in text
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("sudoku_engine_cost_boards "))
        assert float(line.split()[-1]) == body["engine"]["cost"]["boards"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
